"""Collective census: every byte on the wire accounted for.

Counterpart of ``acco_tpu/analysis/census.py``. JAX's analytic model of a
round's communication (``tools/step_estimate.py``): the gradient path
moves one reduce-scatter of float32 gradients and one all-gather of
param-dtype params, ``(ns-1)/ns · Pp · (4 + itemsize)`` bytes on the wire
however the collectives are spelled (:func:`ring_comm_bytes`). The port's
ZeRO-1 step issues exactly those two (``parallel/zero1.py``); this gate
diffs what a round measured (:mod:`acco_tpu_torch.analysis.trace`: from
its profiler trace on the card, at its call sites on gloo) against the
model, so an extra all-reduce of the gradient or a re-gather of the
params fails with a byte count.

Small collectives (the count, health and loss sums, at most
``small_elems`` elements) are counted and capped, not modelled.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_TOLERANCE = 0.10
DEFAULT_MAX_SMALL_OPS = 16


def ring_comm_bytes(padded_size: int, num_shards: int, param_itemsize: int) -> float:
    """The analytic bytes on the wire of one round's gradient path: a
    reduce-scatter of float32 gradients and an all-gather of the params,
    ``(ns-1)/ns · Pp · (4 + itemsize)``."""
    ns = max(num_shards, 1)
    return (ns - 1) / ns * padded_size * (4 + param_itemsize)


@dataclass
class CensusReport:
    ok: bool
    measured_bytes: float
    expected_bytes: float
    large_ops: int
    small_ops: int
    kinds: dict = field(default_factory=dict)  # kind -> count (large only)
    errors: list = field(default_factory=list)

    def summary(self) -> str:
        s = (f"{self.large_ops} large collectives {self.kinds}, "
             f"{self.measured_bytes / 1e3:.1f} kB on wire "
             f"(model: {self.expected_bytes / 1e3:.1f} kB), {self.small_ops} small")
        if self.errors:
            s += f"; {'; '.join(self.errors)}"
        return s


def check_census(collectives: list, expected_bytes: float, expected_ops=None,
                 tolerance: float = DEFAULT_TOLERANCE, small_elems: int = 1_000_000,
                 max_small_ops: int = DEFAULT_MAX_SMALL_OPS) -> CensusReport:
    """Diff one round's :class:`~acco_tpu_torch.analysis.trace.Collective`
    list against the comm model. ``expected_bytes == 0`` with no
    ``expected_ops`` asserts a collective-free program (one rank with no
    group, serving); ``expected_ops``, an inclusive ``(lo, hi)``, bounds
    the large collectives (2 for the round's reduce-scatter and
    all-gather, which move nothing at one rank)."""
    large = [c for c in collectives if c.elems > small_elems]
    small = [c for c in collectives if c.elems <= small_elems]
    measured = sum(c.wire_bytes() for c in large)
    kinds: dict = {}
    for c in large:
        kinds[c.kind] = kinds.get(c.kind, 0) + 1
    errors = []
    if expected_bytes == 0:
        if measured or (large and expected_ops is None):
            errors.append(f"expected a collective-free gradient path, found {len(large)} "
                          f"large collectives ({kinds}) moving {measured / 1e3:.1f} kB")
    else:
        lo, hi = expected_bytes * (1 - tolerance), expected_bytes * (1 + tolerance)
        if not lo <= measured <= hi:
            errors.append(f"wire bytes {measured:.0f} outside model [{lo:.0f}, {hi:.0f}] "
                          f"({kinds}) — an extra or missing gradient-path collective")
    if expected_ops is not None:
        olo, ohi = expected_ops
        if not olo <= len(large) <= ohi:
            errors.append(f"large-collective op count {len(large)} outside expected "
                          f"[{olo}, {ohi}]")
    if len(small) > max_small_ops:
        errors.append(f"{len(small)} small collectives exceed the bookkeeping cap "
                      f"{max_small_ops} — scalar sums are accreting")
    return CensusReport(ok=not errors, measured_bytes=measured, expected_bytes=expected_bytes,
                        large_ops=len(large), small_ops=len(small), kinds=kinds, errors=errors)
