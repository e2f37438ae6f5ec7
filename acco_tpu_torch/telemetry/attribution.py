"""Per-round step attribution: where did the round's wall time go?

A copy of ``acco_tpu/telemetry/attribution.py`` for the port, with one
change: :func:`load_estimate_row` reads no default file. The JAX
package's default, the repo's ``ESTIMATES.json``, holds analytic
estimates made for the TPU, and no TPU number may become a target on
the card; so the trainer passes no estimate row, and
:func:`split_device_residual` reports the whole device residual as
``compute_ms``. The comm stream's measured overlap comes from a profiled
trace instead (``telemetry/profile.py``, ``train.profile_steps``).

The measurement uses only host timestamps around work the trainer
already does — the same zero-added-syncs contract as the tracer:

* the trainer accumulates host-stall buckets per attribution *window*
  (one window = the rounds between two logging boundaries, whose
  existing read-back is the sync fence that makes the window's wall
  time an honest device-inclusive measurement): ``loader`` (blocked on
  the prefetch queue), ``ckpt`` (the snapshot portion of a save),
  ``host_stall`` (the dispatch, the boundary's read-back itself, eval);
* :meth:`StepAttribution.boundary` closes the window: the per-round
  **device residual** is wall minus the host buckets — everything the
  device spent computing and communicating beyond what the host waited
  for;
* :func:`split_device_residual` splits that residual against an
  analytic row when one is given: exposed comm = residual beyond the
  analytic compute window, clamped to [0, comm_total]; measured overlap
  = the comm fraction NOT exposed. With no row the split is skipped and
  the residual reports as ``compute`` alone.

Bucket identity: ``loader + ckpt + host_stall + compute + exposed_comm
== round wall`` by construction (the residual is defined as the
difference), modulo clamping the residual at zero — the clamped mass is
tracked and reported, so a ±5% bound is a real check that the host
buckets never overrun the measured wall.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List, Optional

HOST_BUCKETS = ("loader", "ckpt", "host_stall")
BUCKETS = HOST_BUCKETS + ("compute", "exposed_comm")

# |measured - analytic| comm-hidden percentage points before the
# divergence warning fires (config: telemetry.overlap_divergence_pct).
DEFAULT_DIVERGENCE_PCT = 25.0

_module_log = logging.getLogger(__name__)

class StepAttribution:
    """Accumulates host-stall buckets and closes sync-fenced windows."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {b: 0.0 for b in HOST_BUCKETS}
        self.windows: List[Dict[str, float]] = []
        self.clamped_ms = 0.0  # host buckets overran the measured wall

    def note(self, bucket: str, ms: float) -> None:
        """Add ``ms`` of host stall to the current window's bucket."""
        if bucket not in self._acc:
            raise KeyError(
                f"attribution bucket {bucket!r} not in {HOST_BUCKETS}"
            )
        self._acc[bucket] += max(0.0, float(ms))

    def boundary(self, n_rounds: int, wall_ms: float) -> Optional[dict]:
        """Close the window at a logging boundary (the existing
        device_get there is the sync fence): per-round averages of the
        accumulated host buckets plus the device residual. Returns the
        window record (None when no round ran)."""
        acc, self._acc = self._acc, {b: 0.0 for b in HOST_BUCKETS}
        if n_rounds <= 0 or wall_ms <= 0:
            return None
        per_round = {b: acc[b] / n_rounds for b in HOST_BUCKETS}
        round_ms = wall_ms / n_rounds
        residual = round_ms - sum(per_round.values())
        if residual < 0:
            self.clamped_ms += -residual * n_rounds
            residual = 0.0
        window = {
            "rounds": int(n_rounds),
            "round_wall_ms": round_ms,
            "device_ms": residual,
            **per_round,
        }
        self.windows.append(window)
        return window

    def summary(self) -> Optional[dict]:
        """Aggregate over all closed windows (round-weighted means, so
        the bucket-sum identity survives aggregation). None until a
        window has closed."""
        if not self.windows:
            return None
        rounds = sum(w["rounds"] for w in self.windows)

        def mean(key: str) -> float:
            return sum(w[key] * w["rounds"] for w in self.windows) / rounds

        return {
            "rounds": rounds,
            "windows": len(self.windows),
            "round_wall_ms": mean("round_wall_ms"),
            "device_ms": mean("device_ms"),
            **{b: mean(b) for b in HOST_BUCKETS},
            "clamped_ms": self.clamped_ms,
        }


def load_estimate_row(
    devices: int, path: Optional[str] = None
) -> Optional[dict]:
    """The row of the estimates file at ``path`` whose ``devices``
    matches, or None (no path, no file, no row). Unlike the JAX
    package's, no path means no row: the repo's ``ESTIMATES.json`` holds
    TPU estimates, which are no target on the card."""
    if path is None:
        return None
    try:
        with open(path, encoding="utf-8") as f:
            rows = json.load(f).get("rows", [])
    except (OSError, json.JSONDecodeError):
        return None
    for row in rows:
        if int(row.get("devices", -1)) == int(devices):
            return row
    return None


def split_device_residual(
    device_ms: float, est_row: Optional[dict]
) -> Dict[str, float]:
    """Split the measured device residual into compute vs exposed comm
    against the analytic model, and derive the measured overlap.

    The analytic compute window (compute + the comm hidden under it) is
    ``acco_est_ms - acco_comm_exposed_ms``; whatever the measured
    residual exceeds it by is comm the device actually exposed, clamped
    to [0, analytic comm total]. ``measured_overlap_pct`` is then the
    comm fraction NOT exposed — same definition as the analytic
    ``acco_pct_comm_hidden`` it sits next to."""
    if not est_row:
        return {"compute_ms": float(device_ms), "exposed_comm_ms": 0.0}
    comm = float(est_row.get("acco_comm_ms", 0.0))
    if comm <= 0:
        return {"compute_ms": float(device_ms), "exposed_comm_ms": 0.0}
    compute_window = float(est_row["acco_est_ms"]) - float(
        est_row["acco_comm_exposed_ms"]
    )
    exposed = min(max(float(device_ms) - compute_window, 0.0), comm)
    return {
        "compute_ms": float(device_ms) - exposed,
        "exposed_comm_ms": exposed,
        "measured_overlap_pct": 100.0 * (1.0 - exposed / comm),
        "analytic_overlap_pct": float(est_row.get("acco_pct_comm_hidden", 0.0)),
    }


def attribution_report(
    summary: Optional[dict],
    est_row: Optional[dict],
    *,
    divergence_pct: float = DEFAULT_DIVERGENCE_PCT,
    log: Optional[logging.Logger] = None,
) -> Optional[dict]:
    """The full per-round attribution record: buckets summing to the
    measured round wall, plus, given an analytic row, the measured
    against the analytic overlap and the divergence verdict (a loud
    warning, not an error)."""
    if summary is None:
        return None
    log = log or _module_log
    split = split_device_residual(summary["device_ms"], est_row)
    buckets = {
        "loader_ms": summary["loader"],
        "ckpt_ms": summary["ckpt"],
        "host_stall_ms": summary["host_stall"],
        "compute_ms": split["compute_ms"],
        "exposed_comm_ms": split["exposed_comm_ms"],
    }
    report: Dict[str, Any] = {
        "rounds": summary["rounds"],
        "windows": summary["windows"],
        "round_wall_ms": round(summary["round_wall_ms"], 3),
        "buckets_ms": {k: round(v, 3) for k, v in buckets.items()},
        "bucket_sum_ms": round(sum(buckets.values()), 3),
        "clamped_ms": round(summary["clamped_ms"], 3),
    }
    measured = split.get("measured_overlap_pct")
    if measured is not None:
        analytic = split["analytic_overlap_pct"]
        divergence = abs(measured - analytic)
        report.update(
            measured_overlap_pct=round(measured, 2),
            analytic_overlap_pct=round(analytic, 2),
            overlap_divergence_pct=round(divergence, 2),
            diverged=divergence > divergence_pct,
        )
        if report["diverged"]:
            log.warning(
                "OVERLAP DIVERGENCE: measured comm-hidden %.1f%% vs "
                "analytic %.1f%% (|Δ|=%.1f > %.1f threshold) — the "
                "analytic estimate and the measured round disagree; "
                "re-calibrate the estimate or investigate the round",
                measured, analytic, divergence, divergence_pct,
            )
    return report
