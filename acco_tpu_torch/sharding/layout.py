"""The mesh/model pairing checks: JAX's ``shard_layout`` validation.

Counterpart of ``acco_tpu/sharding/layout.py`` (``shard_layout``, lines
17-91): ``pp`` must divide ``num_layers`` into contiguous equal stages
(:func:`check_pipeline`, which the models ask at construction), and a
train step's groups must pair with the model it drives
(:func:`check_pairing`): a ring model on the step's sequence group under
context parallelism, a model built on the groups' tensor group under
tensor parallelism (tp x pp included: the stages' layer all-reduces run
on it, JAX's review note at ``tests/test_pipeline_parallel.py:396-400``),
a stage on the groups' pipeline group under pipeline parallelism, and
the vocab split over the groups' model group (the combined (pp, tp)
group when both model axes are on). The duck-typed checks import
nothing of ``parallel/`` or ``models/``. JAX's train, eval and serve
state tables are not ported: no module of the port reads them
(ROADMAP.md queue 1, item 12).
"""

from __future__ import annotations

from typing import Optional


def check_pipeline(pp: int, *, num_layers: Optional[int] = None) -> Optional[int]:
    """The layers each stage holds (``num_layers // pp``; None without
    ``num_layers``). Raises ValueError where ``pp`` is below 1 or does not
    divide ``num_layers``."""
    pp = int(pp)
    if pp < 1:
        raise ValueError(f"pipeline size must be >= 1, got {pp}")
    if num_layers is None:
        return None
    if num_layers % pp:
        raise ValueError(f"pipeline size {pp} must divide num_layers={num_layers} "
                         "(contiguous equal stages)")
    return num_layers // pp


def _group_of(tg):
    return None if tg is None else tg.group


def check_pairing(model, groups, sequence_group) -> None:
    """Raises ValueError where a train step's ``groups`` (a
    ``parallel.mesh.RankGroups``, or None) and ``sequence_group`` do not
    pair with ``model``: every axis the groups run must be the model's,
    on the same process group, and no other."""
    if sequence_group is not None and getattr(model, "sequence_group", None) is not sequence_group:
        raise ValueError("context parallelism needs a ring-attention model built on the "
                         "same sequence group")
    pairs = (
        ("tensor", getattr(model, "tensor_group", None),
         None if groups is None else groups.tensor_group()),
        ("pipeline", getattr(model, "pipeline_group", None),
         None if groups is None else groups.pipeline_group()),
        ("model (vocab)", getattr(model, "model_group", None),
         None if groups is None else groups.model_group()),
    )
    for name, mine, theirs in pairs:
        if (mine is None) != (theirs is None) or _group_of(mine) is not _group_of(theirs):
            raise ValueError(
                f"the model's {name} group is not the groups' {name} group: tensor or "
                "pipeline parallelism needs a model built on the step's tensor, pipeline and "
                "model groups (tp x pp: all three; the model group the combined (pp, tp) "
                "one), and a model built on such groups needs those groups")
