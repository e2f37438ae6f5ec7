"""Overlap gate: the round's communication runs beside its compute.

Counterpart of ``acco_tpu/analysis/overlap.py``. The paper's structural
claim (the reference's two CUDA streams) is read here from a profiled
ACCO round's trace, as ``telemetry/profile.py``'s reader names its
streams (:func:`~acco_tpu_torch.telemetry.profile.event_sides`: the
compute stream; the comm side, ACCO's comm stream or NCCL's streams; a
captured replay's branches by their probes):

- no large collective on the compute side (a collective at most
  ``small_elems`` elements, the count, health and loss sums, is exempt);
- at least one comm-side window (a maximal interval of comm-side device
  activity); and
- at least 1/4 of those windows have compute-side kernels inside them,
  JAX's bar (a chain of comm work runs back to back past the compute, so
  full coverage is neither possible nor required).

The CPU has no streams: the verdict is tested on canned traces in
tier-1, as JAX tests its verdict on canned HLO, and runs on the card in
``chip_smoke.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from acco_tpu_torch.analysis.trace import collectives_from_trace
from acco_tpu_torch.telemetry.profile import _union, event_sides

DEFAULT_SMALL_ELEMS = 1_000_000


@dataclass
class OverlapReport:
    ok: bool
    windows: int  # comm-side windows
    covered_windows: int  # windows with compute-side kernels inside
    blocking_large: int  # large collectives on the compute side
    blocking_small: int
    details: list = field(default_factory=list)

    def summary(self) -> str:
        return (f"{self.windows} comm windows ({self.covered_windows} with compute inside), "
                f"{self.blocking_large} large / {self.blocking_small} small collectives on the "
                f"compute stream -> {'OVERLAPPED' if self.ok else 'NOT PROVEN'}")


def check_overlap(events: list, small_elems: int = DEFAULT_SMALL_ELEMS) -> OverlapReport:
    """The overlap verdict on one profiled round's Chrome trace events."""
    sides = event_sides(events)
    compute_streams = {k for k, s in sides.stream_side.items() if s == "compute"}
    blocking = [c for c in collectives_from_trace(events) if c.stream in compute_streams]
    large = [c for c in blocking if c.elems > small_elems]
    kernels = {i for i, e in enumerate(events) if e.get("cat") == "kernel"}
    compute = _union([iv for i, _, iv, s in sides if s == "compute" and i in kernels])
    windows = _union([iv for _, _, iv, s in sides if s == "comm"])
    covered = sum(1 for beg, end in windows
                  if any(b < end and e > beg for b, e in compute))
    ok = bool(not large and windows and covered * 4 >= len(windows))
    return OverlapReport(ok=ok, windows=len(windows), covered_windows=covered,
                         blocking_large=len(large), blocking_small=len(blocking) - len(large),
                         details=[f"{c.kind} {c.elems} {c.dtype} on the compute stream"
                                  for c in large])
