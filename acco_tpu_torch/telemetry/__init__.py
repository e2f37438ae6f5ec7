"""Runtime telemetry of the port: tracer, closed-world metrics,
attribution, and the profiled rounds.

Counterpart of ``acco_tpu/telemetry/``. The first three are copies,
with no framework import and no added device sync — every timestamp
wraps work the train loop already does, and the one per-cadence read
stays the trainer's existing logging-boundary read-back:

* :mod:`~acco_tpu_torch.telemetry.trace` — span/event tracer exporting a
  Chrome/Perfetto ``trace_<id_run>.json`` per run;
* :mod:`~acco_tpu_torch.telemetry.metrics` — the declared counter /
  gauge / histogram registry (unknown names raise) with TensorBoard /
  results.csv / Prometheus sinks;
* :mod:`~acco_tpu_torch.telemetry.attribution` — per-round wall time
  split into loader / ckpt / host-stall / compute buckets.

:mod:`~acco_tpu_torch.telemetry.profile` (new; it imports torch) is
``train.profile_steps``: a few steady-state rounds under
``torch.profiler``, and the reader of that trace (the compute stream,
the comm side, the prefetch copy stream, their overlap and the device's
idle share).
"""

from acco_tpu_torch.telemetry import metrics
from acco_tpu_torch.telemetry.attribution import (
    StepAttribution,
    attribution_report,
    load_estimate_row,
    split_device_residual,
)
from acco_tpu_torch.telemetry.metrics import (
    REGISTRY,
    MetricSpec,
    MetricsRegistry,
    UndeclaredMetricError,
)
from acco_tpu_torch.telemetry.trace import (
    SPAN_NAMES,
    Tracer,
    UndeclaredSpanError,
    test_duration_records,
    validate_trace,
)

__all__ = [
    "metrics",
    "REGISTRY",
    "MetricSpec",
    "MetricsRegistry",
    "UndeclaredMetricError",
    "StepAttribution",
    "attribution_report",
    "load_estimate_row",
    "split_device_residual",
    "SPAN_NAMES",
    "Tracer",
    "UndeclaredSpanError",
    "test_duration_records",
    "validate_trace",
]
