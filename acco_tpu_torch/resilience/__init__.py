"""Resilience: survive being killed, never stall to save, and survive
going numerically bad.

Counterpart of ``acco_tpu/resilience/`` (its serve fault kinds wait for
the port's serving):

- :class:`CheckpointManager` (manager.py) — overlapped checkpointing:
  the train loop blocks only for the device-to-host snapshot into pinned
  buffers; the commit (rank files, the file gate, ``meta.json`` last,
  retention) runs on a background thread under the next rounds.
- :class:`ShutdownHandler` (preemption.py) — SIGTERM/SIGINT become a
  checkpoint-at-round-boundary request; the trainer drains the
  prefetcher and the in-flight save and returns resumably.
- crash recovery — ``utils.checkpoint.latest_checkpoint``'s validating
  fallback chain plus the startup GC: a saver killed mid-write costs at
  most the in-flight checkpoint.
- training-health watchdog (watchdog.py + the in-program guards in
  ``parallel/{acco,ddp}.py``) — anomalous rounds are skipped on the
  device as bit-exact no-ops; :class:`TrainingHealthMonitor` classifies
  spikes against drift and escalates persistent anomalies into a
  rollback to the newest complete checkpoint, fencing the poisoned data
  window. Drilled by the fault registry (faults.py, the
  ``fault_injection:`` train key).
"""

from acco_tpu_torch.resilience.faults import FaultInjector, parse_fault_specs
from acco_tpu_torch.resilience.manager import CheckpointManager
from acco_tpu_torch.resilience.preemption import ShutdownHandler
from acco_tpu_torch.resilience.watchdog import HealthVerdict, TrainingHealthMonitor

__all__ = [
    "CheckpointManager",
    "FaultInjector",
    "HealthVerdict",
    "ShutdownHandler",
    "TrainingHealthMonitor",
    "parse_fault_specs",
]
