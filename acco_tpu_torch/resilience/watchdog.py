"""Host half of the training-health watchdog: classify, log, escalate.

A copy of ``acco_tpu/resilience/watchdog.py`` for the port, emitting
into the port's ``telemetry.metrics``. The on-device half lives in every
round (``parallel/acco.py`` / ``parallel/ddp.py``): cheap health signals
(global grad norm, update finiteness, loss finiteness) guard the
optimizer commit with ``torch.where(healthy, new, old)``, so an
anomalous round is a bit-exact no-op with no host sync. The device
CANNOT do two things, and this module does both:

- **classify** — a single static threshold cannot tell a one-batch
  gradient *spike* (skip it and move on) from slow *drift* (the run is
  going somewhere bad). :class:`TrainingHealthMonitor` keeps rolling
  robust statistics — an EMA mean/variance of the log grad norm — and
  z-scores each observation against them. Statistics update only from
  healthy observations, so a spike cannot poison the baseline it is
  judged against.
- **escalate** — the guard turns one bad round into a no-op, but
  *persistent* corruption (a poisoned optimizer shard, a torn restore)
  makes every subsequent round unhealthy: params frozen, progress zero.
  After ``escalate_after`` consecutive skipped rounds the monitor's
  verdict sets ``escalate``, and the trainer rolls back to the newest
  complete checkpoint, fencing the data window at the prefetcher's
  exact-resume position (``Trainer._rollback``).

Feeding cadence: the trainer observes at its existing logging boundary,
where it already reads the rounds back — the health counters ride the
same read, so the watchdog adds no new blocking device read anywhere in
the round loop.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

from acco_tpu_torch.telemetry import metrics

_module_log = logging.getLogger(__name__)


class HealthVerdict(NamedTuple):
    """One observation's classification.

    ``classification``: ``ok`` | ``spike`` (z-score outlier against the
    rolling grad-norm statistics) | ``drift`` (sustained moderate
    z-scores) | ``anomalous`` (the in-program guard skipped rounds since
    the last observation). ``escalate``: consecutive skipped rounds
    crossed the rollback threshold — the caller should restore the
    newest complete checkpoint and fence the data window.
    """

    classification: str
    escalate: bool
    z_score: float
    new_skips: int


class TrainingHealthMonitor:
    """Rolling-statistics health classifier over the round metrics.

    Parameters
    ----------
    escalate_after: consecutive guard-skipped rounds before ``escalate``
        (the config's ``rollback_after_skipped``).
    ema_beta: EMA coefficient for the log-grad-norm mean/variance.
    z_spike: |z| at/above which a single observation is a ``spike``.
    z_drift: |z| at/above which observations count toward ``drift``.
    drift_obs: consecutive moderate-z observations that make ``drift``.
    warmup_obs: healthy observations before z-scores are trusted (the
        EMA needs a baseline; early training legitimately moves fast).
    spike_reseed: consecutive ``spike`` classifications after which the
        level is accepted as a sustained regime shift: the baseline is
        re-seeded at the current observation (spikes never fold into
        the baseline one at a time — an outlier must not normalize
        itself — but a shift that persists this long is the *drift*
        case, and a frozen baseline would otherwise cry spike forever).
    """

    def __init__(
        self,
        *,
        escalate_after: int = 8,
        ema_beta: float = 0.9,
        z_spike: float = 6.0,
        z_drift: float = 3.0,
        drift_obs: int = 3,
        warmup_obs: int = 5,
        spike_reseed: int = 5,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self.escalate_after = max(1, int(escalate_after))
        self.ema_beta = float(ema_beta)
        self.z_spike = float(z_spike)
        self.z_drift = float(z_drift)
        self.drift_obs = max(1, int(drift_obs))
        self.warmup_obs = max(0, int(warmup_obs))
        self.spike_reseed = max(2, int(spike_reseed))
        self.log = log or _module_log
        self._mean: Optional[float] = None
        self._var = 0.0
        self._healthy_obs = 0
        self._drift_run = 0
        self._spike_run = 0
        # counters for the metrics/CSV path (results.csv + summary)
        self.observations = 0
        self.spikes = 0
        self.drifts = 0
        self.rollbacks = 0
        self.last_skipped_rounds = 0

    # -- classification ------------------------------------------------------

    def observe(
        self,
        *,
        grad_norm: float,
        loss: float,
        skipped_rounds: int,
        consec_skipped: int,
    ) -> HealthVerdict:
        """Classify one boundary's health reading.

        ``grad_norm``/``loss`` come from the round metrics read back at
        the boundary; ``skipped_rounds``/``consec_skipped`` from the state's
        device-side :class:`~acco_tpu_torch.parallel.common.HealthState`.
        """
        self.observations += 1
        new_skips = max(0, int(skipped_rounds) - self.last_skipped_rounds)
        self.last_skipped_rounds = int(skipped_rounds)
        escalate = int(consec_skipped) >= self.escalate_after
        # Registry mirror of the boundary's device-side health counters
        # (declared in telemetry/metrics.py — the /metrics and ledger
        # sinks read them from one place instead of loose extra= dicts).
        metrics.emit("health_skipped_rounds", int(skipped_rounds))
        metrics.emit("health_consec_skipped", int(consec_skipped))

        z = 0.0
        if new_skips > 0 or not math.isfinite(loss):
            classification = "anomalous"
            self._drift_run = 0
            self._spike_run = 0
        elif not (math.isfinite(grad_norm) and grad_norm > 0):
            # grad_norm 0.0 = the guard (and its signals) switched off
            classification = "ok"
        else:
            log_norm = math.log10(grad_norm)
            if self._mean is not None and self._healthy_obs >= self.warmup_obs:
                # 1e-3 variance floor: a flat baseline (EMA variance ~0,
                # common early in a run) must not turn percent-level
                # wobble into z=1000 "spikes" — the floor puts the
                # minimum detectable spike at a ~50% norm change.
                z = (log_norm - self._mean) / math.sqrt(self._var + 1e-3)
            if abs(z) >= self.z_spike:
                self._spike_run += 1
                self._drift_run = 0
                if self._spike_run >= self.spike_reseed:
                    # Not a spike anymore: a level that holds for
                    # spike_reseed straight boundaries is a sustained
                    # regime shift. Accept it — re-seed the baseline at
                    # the current observation so the monitor re-learns
                    # instead of warning at every boundary forever.
                    classification = "drift"
                    self.drifts += 1
                    metrics.emit("health_drifts_total", 1)
                    self._mean, self._var = log_norm, 0.0
                    self._spike_run = 0
                else:
                    classification = "spike"
                    self.spikes += 1
                    metrics.emit("health_spikes_total", 1)
            else:
                self._spike_run = 0
                if abs(z) >= self.z_drift:
                    self._drift_run += 1
                else:
                    self._drift_run = 0
                classification = (
                    "drift" if self._drift_run >= self.drift_obs else "ok"
                )
                if classification == "drift" and self._drift_run == self.drift_obs:
                    # count episodes, not boundaries: a drift lasting N
                    # boundaries is one event in the ledger, or the
                    # column becomes a function of the log cadence
                    self.drifts += 1
                    metrics.emit("health_drifts_total", 1)
                # only non-spike observations move the baseline: an
                # outlier must not normalize itself
                self._update_stats(log_norm)
        if classification != "ok":
            self.log.warning(
                "watchdog: %s (grad_norm=%.4g z=%.2f loss=%.4g "
                "skipped_rounds=%d consec=%d)%s",
                classification, grad_norm, z, loss,
                int(skipped_rounds), int(consec_skipped),
                " — escalating to rollback" if escalate else "",
            )
        return HealthVerdict(classification, escalate, z, new_skips)

    def _update_stats(self, log_norm: float) -> None:
        if self._mean is None:
            self._mean, self._var = log_norm, 0.0
        else:
            b = self.ema_beta
            delta = log_norm - self._mean
            self._mean += (1.0 - b) * delta
            self._var = b * (self._var + (1.0 - b) * delta * delta)
        self._healthy_obs += 1

    # -- escalation bookkeeping ---------------------------------------------

    def note_rollback(self) -> None:
        """Record a completed auto-rollback (the trainer performs it)."""
        self.rollbacks += 1
        metrics.emit("health_rollbacks_total", 1)
        self._drift_run = 0
        self._spike_run = 0

    def summary(self) -> dict:
        """Health columns for the metrics/CSV path and train() summary."""
        return {
            "skipped_rounds": int(self.last_skipped_rounds),
            "grad_norm_spikes": int(self.spikes),
            "grad_norm_drifts": int(self.drifts),
            "rollbacks": int(self.rollbacks),
        }
