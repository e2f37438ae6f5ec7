"""Slow-marker audit: the tier-1 window is a budget, not a hope.

A copy of ``acco_tpu/analysis/slow_markers.py`` (framework-free), which
audits the port's tests. ROADMAP's tier-1 verify runs ``-m 'not slow'``
under a hard timeout. The enforcement loop:

- ``tests/conftest.py`` records every test's call-phase duration and
  whether it carried ``@pytest.mark.slow`` into
  ``outputs/test_durations.json`` (merged across runs, so a full run's
  recording survives partial re-runs);
- this audit flags any recorded test of the port (``tests/test_torch_*``,
  :data:`PORT_TESTS`) whose duration exceeds the threshold without the
  marker; ``python -m acco_tpu_torch.analysis --ci`` fails on it.

No recording file yet (fresh clone) is a pass-with-note, not a
failure: the gate enforces against evidence, it doesn't manufacture it.
The durations are the machine's (a loaded run's are longer), not the
tree's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

# One test may use ~3% of the tier-1 window before it must be marked.
DEFAULT_THRESHOLD_S = 25.0
DEFAULT_RECORD_PATH = os.path.join("outputs", "test_durations.json")
PORT_TESTS = "tests/test_torch_"


@dataclass
class SlowMarkerReport:
    ok: bool
    checked: int
    threshold_s: float
    violations: list[str] = field(default_factory=list)
    note: str | None = None

    def summary(self) -> str:
        if self.note and not self.checked:
            return self.note
        s = f"{self.checked} recorded tests under {self.threshold_s:.0f}s"
        if self.violations:
            s = (
                f"{len(self.violations)} unmarked slow tests: "
                + "; ".join(self.violations[:5])
            )
        return s


def audit_durations(
    records: dict[str, dict], threshold_s: float = DEFAULT_THRESHOLD_S,
    prefix: str = "",
) -> SlowMarkerReport:
    """``records``: nodeid -> {"duration": seconds, "slow": bool} (the
    conftest recorder's schema); only nodeids starting with ``prefix``
    are audited."""
    records = {k: v for k, v in records.items() if k.startswith(prefix)}
    violations = []
    for nodeid in sorted(records):
        rec = records[nodeid]
        dur = float(rec.get("duration", 0.0))
        if dur > threshold_s and not rec.get("slow", False):
            violations.append(
                f"{nodeid} ran {dur:.1f}s without @pytest.mark.slow"
            )
    return SlowMarkerReport(
        ok=not violations,
        checked=len(records),
        threshold_s=threshold_s,
        violations=violations,
    )


def audit_recorded(
    path: str = DEFAULT_RECORD_PATH,
    threshold_s: float = DEFAULT_THRESHOLD_S,
    prefix: str = PORT_TESTS,
) -> SlowMarkerReport:
    if not os.path.exists(path):
        return SlowMarkerReport(
            ok=True, checked=0, threshold_s=threshold_s,
            note=f"no recorded durations at {path} — run the test suite "
            "once to produce them (pass-with-note)",
        )
    with open(path, encoding="utf-8") as f:
        records = json.load(f)
    return audit_durations(records, threshold_s, prefix)


def merge_records(path: str, new_records: dict[str, dict]) -> None:
    """Merge one session's recordings into the on-disk file (the
    conftest sessionfinish hook): newest duration wins per nodeid."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    existing: dict[str, dict] = {}
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                existing = json.load(f)
        except (json.JSONDecodeError, OSError):
            existing = {}
    existing.update(new_records)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
