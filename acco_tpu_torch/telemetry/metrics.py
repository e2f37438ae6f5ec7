"""Closed-world metrics registry: every metric is declared or it raises.

A copy of ``acco_tpu/telemetry/metrics.py`` (the standard library only)
for the port, which imports nothing of the JAX package, with the same
declared names, kinds, units and help: the counters, gauges and
histograms that the trainer, the watchdog, the prefetcher, the
checkpoint manager and (once ported) the serve scheduler emit are
*declared* below, and emitting an undeclared name raises
:class:`UndeclaredMetricError`. Names that no code of the port emits yet
(the compile cache's, the serve side's) stay declared, so that one name
means one metric in both packages.

Sinks (one source of names for every consumer):

* ``scalar_row()`` — flat name->number dict for ``results.csv`` and a
  bench record (histograms project to their p50);
* ``to_tensorboard(writer, step)`` — scalar tags under ``telemetry/``;
* ``to_prometheus_text()`` — the Prometheus text exposition.

Values are plain Python numbers and emission is a locked dict update:
nothing here reads the device.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"
_KINDS = (COUNTER, GAUGE, HISTOGRAM)

# Default bucket bounds: wide enough for ms-scale latencies and
# pct/count gauges alike; an explicit ``buckets=`` on the spec overrides.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)
_QUANTILE_WINDOW = 512  # recent-value reservoir for p50/p95 summaries


class UndeclaredMetricError(KeyError):
    """An emit/read against a name missing from the closed world."""


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str
    unit: str
    help: str
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"{self.name}: kind must be one of {_KINDS}")


class _Histogram:
    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max",
                 "recent")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = tuple(sorted(bounds))
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf tail
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.recent: deque = deque(maxlen=_QUANTILE_WINDOW)

    def observe(self, value: float) -> None:
        self.bucket_counts[bisect_left(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.recent.append(value)

    def quantile(self, q: float) -> Optional[float]:
        if not self.recent:
            return None
        ordered = sorted(self.recent)
        return ordered[min(len(ordered) - 1, int(q * len(ordered)))]

    def summary(self) -> Dict[str, Any]:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": round(self.sum, 3),
            "min": round(self.min, 3),
            "max": round(self.max, 3),
            "p50": round(self.quantile(0.50), 3),
            "p95": round(self.quantile(0.95), 3),
        }


class MetricsRegistry:
    """The closed world plus current values; every method thread-safe."""

    def __init__(self, specs: Iterable[MetricSpec] = ()) -> None:
        self._specs: Dict[str, MetricSpec] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        for spec in specs:
            self.declare(spec)

    # -- declaration ---------------------------------------------------------

    def declare(self, spec: MetricSpec) -> None:
        with self._lock:
            prior = self._specs.get(spec.name)
            if prior is not None and prior != spec:
                raise ValueError(
                    f"metric {spec.name!r} already declared with a "
                    f"different spec"
                )
            self._specs[spec.name] = spec
            self._values.setdefault(spec.name, self._zero(spec))

    @staticmethod
    def _zero(spec: MetricSpec) -> Any:
        if spec.kind == HISTOGRAM:
            return _Histogram(spec.buckets)
        return 0.0 if spec.kind == COUNTER else None

    def spec(self, name: str) -> MetricSpec:
        spec = self._specs.get(name)
        if spec is None:
            raise UndeclaredMetricError(
                f"metric {name!r} is not declared in the telemetry "
                f"registry (closed world — add a MetricSpec to "
                f"acco_tpu_torch/telemetry/metrics.py DECLARED)"
            )
        return spec

    def declared_names(self) -> List[str]:
        with self._lock:
            return sorted(self._specs)

    # -- emission ------------------------------------------------------------

    def emit(self, name: str, value: float) -> None:
        """Counter: add ``value``; gauge: set to ``value``; histogram:
        observe one sample."""
        spec = self.spec(name)
        value = float(value)
        with self._lock:
            if spec.kind == COUNTER:
                if value < 0:
                    raise ValueError(
                        f"counter {name!r} cannot decrease (got {value})"
                    )
                self._values[name] += value
            elif spec.kind == GAUGE:
                self._values[name] = value
            else:
                self._values[name].observe(value)

    def emit_many(self, values: Dict[str, float]) -> None:
        for name, value in values.items():
            self.emit(name, value)

    # -- reads / sinks -------------------------------------------------------

    def value(self, name: str) -> Any:
        """Counter/gauge: the number (gauge None until first emit);
        histogram: its summary dict."""
        spec = self.spec(name)
        with self._lock:
            v = self._values[name]
        return v.summary() if spec.kind == HISTOGRAM else v

    def scalar(self, name: str) -> Optional[float]:
        v = self.value(name)
        if isinstance(v, dict):
            return v.get("p50")
        return v

    def quantile(self, name: str, q: float) -> Optional[float]:
        """Histogram quantile from the recent-value reservoir (None for
        an empty histogram); raises for non-histogram metrics. The load
        harness reads its p50/p99 TTFT through this."""
        spec = self.spec(name)
        if spec.kind != HISTOGRAM:
            raise ValueError(f"metric {name!r} is a {spec.kind}, "
                             "quantile() needs a histogram")
        with self._lock:
            return self._values[name].quantile(q)

    def scalar_row(
        self, names: Optional[Iterable[str]] = None
    ) -> Dict[str, float]:
        """Flat dict for the CSV/JSON ledgers: one number per metric
        (histogram -> p50); never-emitted metrics are omitted so ledger
        schemas don't fill with empty columns."""
        row: Dict[str, float] = {}
        for name in names if names is not None else self.declared_names():
            s = self.scalar(name)
            if s is not None:
                row[name] = s
        return row

    def snapshot(self) -> Dict[str, Any]:
        return {name: self.value(name) for name in self.declared_names()}

    def to_tensorboard(
        self, writer, step: int, names: Optional[Iterable[str]] = None
    ) -> None:
        for name, value in self.scalar_row(names).items():
            writer.add_scalar(f"telemetry/{name}", value, step)

    def to_prometheus_text(self, prefix: str = "acco_") -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for name in self.declared_names():
            spec = self.spec(name)
            full = prefix + name
            with self._lock:
                v = self._values[name]
            lines.append(f"# HELP {full} {spec.help} [{spec.unit}]")
            lines.append(f"# TYPE {full} {spec.kind}")
            if spec.kind == HISTOGRAM:
                cum = 0
                for bound, n in zip(v.bounds, v.bucket_counts):
                    cum += n
                    lines.append(f'{full}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{full}_bucket{{le="+Inf"}} {v.count}')
                lines.append(f"{full}_sum {v.sum:g}")
                lines.append(f"{full}_count {v.count}")
            else:
                lines.append(f"{full} {(v if v is not None else 0):g}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every value (tests; the declarations stay)."""
        with self._lock:
            for name, spec in self._specs.items():
                self._values[name] = self._zero(spec)


def _spec(name: str, kind: str, unit: str, help: str) -> MetricSpec:
    return MetricSpec(name, kind, unit, help)


# The closed world, grouped by emitter, as the JAX package declares it: a
# new emit site means a new line HERE.
DECLARED: Tuple[MetricSpec, ...] = (
    # -- trainer round loop (trainer.py) --
    _spec("train_rounds_total", COUNTER, "rounds",
          "round programs dispatched this process"),
    _spec("train_round_wall_ms", HISTOGRAM, "ms",
          "wall time between round dispatches (steady-state round time)"),
    _spec("train_dispatch_ms", HISTOGRAM, "ms",
          "host time to enqueue one round program (async dispatch)"),
    _spec("train_loader_wait_ms", HISTOGRAM, "ms",
          "train loop blocked on the prefetch queue per block"),
    _spec("train_log_sync_ms", HISTOGRAM, "ms",
          "the logging-boundary device_get (the one per-cadence sync)"),
    _spec("train_eval_ms", HISTOGRAM, "ms", "evaluate() wall per call"),
    _spec("train_warmup_join_ms", GAUGE, "ms",
          "residual wait joining the background AOT compile warmup"),
    _spec("train_loss", GAUGE, "loss", "last boundary's training loss"),
    _spec("train_grad_norm", GAUGE, "norm",
          "last boundary's global gradient norm"),
    _spec("train_grads_committed", GAUGE, "grads",
          "device-side committed-gradient counter at the last boundary"),
    _spec("train_measured_round_ms", GAUGE, "ms",
          "measured mean round wall time over the attribution windows"),
    # -- step attribution (telemetry/attribution.py) --
    _spec("attrib_loader_ms", GAUGE, "ms",
          "per-round input-pipeline stall bucket"),
    _spec("attrib_ckpt_ms", GAUGE, "ms",
          "per-round checkpoint snapshot stall bucket"),
    _spec("attrib_host_stall_ms", GAUGE, "ms",
          "per-round other host stall bucket (log sync, eval)"),
    _spec("attrib_compute_ms", GAUGE, "ms",
          "per-round device compute (incl. hidden comm) bucket"),
    _spec("attrib_exposed_comm_ms", GAUGE, "ms",
          "per-round exposed (unoverlapped) communication bucket"),
    _spec("measured_overlap_pct", GAUGE, "pct",
          "measured fraction of comm hidden behind compute"),
    _spec("overlap_divergence_pct", GAUGE, "pct",
          "|measured - analytic| comm-hidden percentage points"),
    # -- checkpointing (resilience/manager.py; bench phase keys) --
    _spec("ckpt_saves_total", COUNTER, "saves", "checkpoints started"),
    _spec("ckpt_snapshot_ms", HISTOGRAM, "ms",
          "blocking device->host snapshot portion of save()"),
    _spec("ckpt_commit_ms", HISTOGRAM, "ms",
          "background finalize (write + meta commit + retention)"),
    _spec("ckpt_async_stall_ms", GAUGE, "ms",
          "bench: round stall added by one async checkpoint"),
    _spec("ckpt_sync_stall_ms", GAUGE, "ms",
          "bench: round stall added by one synchronous checkpoint"),
    # -- training-health watchdog (resilience/watchdog.py) --
    _spec("health_skipped_rounds", GAUGE, "rounds",
          "lifetime guard-skipped rounds (device counter)"),
    _spec("health_consec_skipped", GAUGE, "rounds",
          "consecutive guard-skipped rounds at the last boundary"),
    _spec("health_spikes_total", COUNTER, "events",
          "grad-norm spike classifications"),
    _spec("health_drifts_total", COUNTER, "events",
          "grad-norm drift episodes"),
    _spec("health_rollbacks_total", COUNTER, "events",
          "auto-rollbacks performed"),
    _spec("guard_overhead_pct", GAUGE, "pct",
          "bench: step-time overhead of the in-program anomaly guard"),
    # -- compile cache (compile/cache.py) --
    _spec("compile_cache_requests_total", COUNTER, "compiles",
          "persistent-cache lookups"),
    _spec("compile_cache_hits_total", COUNTER, "compiles",
          "persistent-cache hits"),
    _spec("compile_cache_time_saved_s", COUNTER, "s",
          "compile seconds served from the persistent cache"),
    # -- input pipeline (data/prefetch.py; bench phase key) --
    _spec("loader_blocks_total", COUNTER, "blocks",
          "microbatch blocks consumed from the prefetch source"),
    _spec("loader_block_wait_ms", HISTOGRAM, "ms",
          "consumer wait per block (0 when the prefetcher ran ahead)"),
    _spec("loader_host_stall_ms", GAUGE, "ms",
          "bench: per-round host stall attributable to data loading"),
    # -- serve scheduler / server (serve/{scheduler,server}.py) --
    _spec("serve_requests_total", COUNTER, "requests",
          "generation requests submitted"),
    _spec("serve_completed_total", COUNTER, "requests",
          "generation requests finished"),
    _spec("serve_failed_total", COUNTER, "requests",
          "generation requests failed by a serving-step error"),
    _spec("serve_preemptions_total", COUNTER, "events",
          "active requests preempted for pages"),
    _spec("serve_tokens_total", COUNTER, "tokens",
          "tokens generated across finished requests"),
    _spec("serve_ttft_ms", HISTOGRAM, "ms",
          "time to first token (submit -> first sampled token)"),
    _spec("serve_request_latency_ms", HISTOGRAM, "ms",
          "full request latency (submit -> finish)"),
    _spec("serve_prefill_ms", HISTOGRAM, "ms",
          "one admitted prefill dispatch"),
    _spec("serve_decode_step_ms", HISTOGRAM, "ms",
          "one batched decode+sample step"),
    _spec("serve_waiting", GAUGE, "requests", "queue depth at last step"),
    _spec("serve_active", GAUGE, "requests", "occupied decode slots"),
    _spec("serve_slots_free", GAUGE, "slots", "free decode slots"),
    _spec("serve_pages_free", GAUGE, "pages", "KV pages free"),
    _spec("serve_pages_in_use", GAUGE, "pages", "KV pages allocated"),
    # -- serving resilience (serve/{scheduler,server}.py) --
    _spec("serve_shed_total", COUNTER, "requests",
          "submissions refused by admission control (429/503)"),
    _spec("serve_cancelled_total", COUNTER, "requests",
          "requests cancelled (timeout, deadline, abandon, drain)"),
    _spec("serve_deadline_expired_total", COUNTER, "requests",
          "cancellations whose cause was an expired deadline"),
    _spec("serve_drains_total", COUNTER, "events",
          "graceful drains initiated (SIGTERM or /admin/drain)"),
    _spec("serve_drain_ms", GAUGE, "ms",
          "wall time of the last graceful drain"),
    _spec("serve_faults_injected_total", COUNTER, "events",
          "serve chaos faults fired (resilience.faults serve kinds)"),
)

# The process-global registry: train, serve, bench, and the sinks all
# share it, so one name means one metric everywhere.
REGISTRY = MetricsRegistry(DECLARED)


def emit(name: str, value: float) -> None:
    """Module-level emit against the global registry — the canonical
    call shape the metrics-gate lint recognizes."""
    REGISTRY.emit(name, value)


def emit_many(values: Dict[str, float]) -> None:
    REGISTRY.emit_many(values)


def declared_names() -> List[str]:
    return REGISTRY.declared_names()
