"""The pipeline's pairing checks: the pp validation of JAX's ``shard_layout``.

Counterpart of the pipeline half of ``acco_tpu/sharding/layout.py``
(``shard_layout``, lines 17-91): ``pp`` must divide ``num_layers`` into
contiguous equal stages, and a staged model holds no tensor or sequence
group. Pipeline parallelism composed with tensor or context parallelism
(JAX's ``ComposedLayout`` and pp x sp) is not ported yet: ROADMAP.md
queue 1, item 9.4. The mesh (``parallel/mesh.check_mesh``) and the
models (``models/flat.FlatParamModel``) both ask here. JAX's train, eval
and serve state tables are not ported: no module of the port reads them
(ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

COMPOSITION_ITEM = "ROADMAP.md queue 1, item 9.4"


def check_pipeline(pp: int, *, num_layers=None, tp: int = 1, sp: int = 1,
                   tensor_group=None, sequence_group=None) -> int:
    """The layers each stage holds (``num_layers // pp``; None without
    ``num_layers``). Raises NotImplementedError, naming item 9.4, for a
    pipeline together with tensor parallelism (``tp`` > 1 or a
    ``tensor_group``) or context parallelism (``sp`` > 1 or a
    ``sequence_group``), and ValueError where ``pp`` does not divide
    ``num_layers``."""
    pp = int(pp)
    if pp < 1:
        raise ValueError(f"pipeline size must be >= 1, got {pp}")
    with_tp = tp > 1 or tensor_group is not None
    with_sp = sp > 1 or sequence_group is not None
    if with_tp or with_sp:
        what = " and ".join(name for name, on in (("tensor parallelism (tp)", with_tp),
                                                  ("context parallelism (sp)", with_sp)) if on)
        raise NotImplementedError(
            f"pipeline parallelism (pp) composed with {what} is not ported yet: "
            f"{COMPOSITION_ITEM}")
    if num_layers is None:
        return None
    if num_layers % pp:
        raise ValueError(f"pipeline size {pp} must divide num_layers={num_layers} "
                         "(contiguous equal stages)")
    return num_layers // pp
