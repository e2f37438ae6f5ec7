"""Fault injection for the train loop and the serving loop: one registry
for tests, configs and drills on the card.

Counterpart of ``acco_tpu/resilience/faults.py``. Three layers:

**Filesystem/process faults** — the failure modes a preempted or killed
trainer actually produces:

- :func:`strip_meta` — make a committed ``step_*`` dir look
  killed-before-commit (remove the ``meta.json`` commit marker).
- :func:`truncate_state_file` — tear bytes off a committed checkpoint's
  largest state file (a partial write behind a valid ``meta.json``; the
  manifest validation must catch it). ``n_bytes`` larger than the file
  zeroes it.
- :func:`wipe_manifest` — rewrite ``meta.json`` with an empty state
  manifest (a commit that recorded nothing; validation must refuse it).
- :func:`run_saver_killed_subprocess` — a REAL port saver SIGKILLed
  between its rank file and ``meta.json``.
- :class:`ShutdownAfterRounds` — deterministic SIGTERM stand-in: latch
  the shutdown request at the N-th round-boundary poll.
- :func:`send_self_sigterm` — real signal delivery.

**Numerical faults** — the ``fault_injection:`` train key:
:class:`FaultInjector` fires registered kinds at chosen rounds of the
train loop, poisoning the round's *inputs* or the *carried state*, never
the round's code, so the in-program guard and the host watchdog see
exactly what a real anomaly would show them. Each writes on the current
stream, between rounds (after the block's copy event, which the block
source has already made the current stream wait on):

- ``nan_grads`` — NaN the block's ``valid`` column on the device: every
  microbatch gradient and count go NaN through the accumulation, for
  ACCO, DPU and DDP alike.
- ``spike_grads`` — scale the staged ``pending_grads`` by ``factor``
  (a finite spike for ``guard_max_grad_norm`` and the monitor's z-score;
  ACCO/DPU only — DDP stages no gradients).
- ``corrupt_params`` — overwrite the first ``n`` entries of
  ``flat_params`` and of the master shard ``zero1.opt.params`` with
  ``value`` (default NaN): persistent, only the watchdog's rollback
  recovers.
- ``corrupt_opt`` — the same into the first moment ``zero1.opt.mu``: the
  gradients stay finite, the *update* goes nonfinite.

The three state kinds are single-process, as in JAX. Spec formats
accepted by :func:`parse_fault_specs` / ``FaultInjector.from_config``: a
list of dicts (``[{kind: nan_grads, round: 3}, {kind: corrupt_params,
round: 5, n: 128}]``), a single dict, or compact strings
(``"nan_grads@3"``). Round indexes are 0-based dispatch counts of the
current run's train loop (the seed round is not counted); each spec
fires exactly once.

**Serve chaos** — a copy of JAX's: :class:`ServeFaultInjector` fires the
``SERVE_FAULT_KINDS`` (``engine_raise``, ``slow_decode``, ``kv_exhaust``,
``client_abandon``) at scheduler step indices, from ``--chaos``, the
serve config's ``fault_injection:`` or ``ACCO_SERVE_CHAOS``.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import textwrap
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from acco_tpu_torch.resilience.preemption import ShutdownHandler

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_module_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Filesystem / process faults
# ---------------------------------------------------------------------------


class ShutdownAfterRounds(ShutdownHandler):
    """Request shutdown once the trainer has polled ``should_stop()``
    ``n_rounds`` times — i.e. exactly at round boundary N, every run,
    regardless of host speed. Inject via
    ``Trainer(..., shutdown_handler=ShutdownAfterRounds(n))``.
    """

    def __init__(self, n_rounds: int, **kw) -> None:
        super().__init__(**kw)
        self.n_rounds = int(n_rounds)
        self.polls = 0

    def should_stop(self) -> bool:
        self.polls += 1
        if self.polls >= self.n_rounds:
            self.request()
        return super().should_stop()


def strip_meta(step_dir: str) -> str:
    """Make a committed ``step_*`` dir look killed-before-commit by
    removing its meta.json (the commit marker). Returns ``step_dir``."""
    os.remove(os.path.join(step_dir, "meta.json"))
    return step_dir


def truncate_state_file(step_dir: str, n_bytes: int = 64) -> str:
    """Tear ``n_bytes`` off the end of the largest file under
    ``step_dir/state``; returns the truncated file's path."""
    state = os.path.join(step_dir, "state")
    files = [os.path.join(root, name) for root, _, names in os.walk(state) for name in names]
    target = max(files, key=os.path.getsize)
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(size - n_bytes, 0))
    return target


def wipe_manifest(step_dir: str) -> str:
    """Rewrite a committed meta.json with an EMPTY state manifest.
    Returns ``step_dir``."""
    import json

    from acco_tpu_torch.utils.checkpoint import MANIFEST_KEY

    meta_path = os.path.join(step_dir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta[MANIFEST_KEY] = {}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return step_dir


def run_saver_killed_subprocess(ckpt_dir: str, step: int, n: int = 4096,
                                timeout: float = 120.0) -> str:
    """Run the port's saver in a subprocess and SIGKILL it (no cleanup
    handlers) after its rank file is on disk and before ``meta.json``.
    Returns the orphan ``step_<step>`` dir it left behind; asserts the
    process really died by the signal."""
    code = textwrap.dedent(
        f"""
        import os
        from typing import NamedTuple

        import torch

        from acco_tpu_torch.utils import checkpoint as ckpt

        class State(NamedTuple):
            w: torch.Tensor
            step: torch.Tensor

        state = State(torch.arange({int(n)}, dtype=torch.float32),
                      torch.zeros((), dtype=torch.int32))
        path = os.path.join({os.path.abspath(ckpt_dir)!r}, "step_{int(step)}")
        # the rank file, then death before rank 0's gate and meta.json
        ckpt.finalize_meta = lambda *a, **k: os.kill(os.getpid(), 9)
        ckpt.commit(path, ckpt.snapshot(state), {{}})
        """
    )
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO_ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == -9, (
        f"saver subprocess should die by SIGKILL, got rc={proc.returncode}: "
        f"{proc.stderr[-2000:]}"
    )
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{int(step)}")
    assert os.path.isdir(path), "killed saver should leave its state behind"
    return path


def send_self_sigterm() -> None:
    """Deliver a real SIGTERM to this process (the handler only latches a
    flag, so this is safe in-process)."""
    os.kill(os.getpid(), signal.SIGTERM)


# ---------------------------------------------------------------------------
# Numerical fault registry (the config-driven injector)
# ---------------------------------------------------------------------------

# kind -> inject(state, block, **params) -> (state, block). Each writes
# new tensors (or fills in place on the current stream) between rounds;
# the round's code is untouched.
FAULT_KINDS: Dict[str, Callable] = {}


def register_fault(kind: str):
    def wrap(fn: Callable) -> Callable:
        FAULT_KINDS[kind] = fn
        return fn

    return wrap


@register_fault("nan_grads")
def _inject_nan_grads(state, block, **params):
    """NaN the block's ``valid`` weights on the device: the accumulation
    multiplies each microbatch's gradient and count by them, so both go
    NaN for any method. ACCO stages them (the next round's comm consumes
    and skips them); DDP consumes them in the same step."""
    import torch

    return state, block._replace(valid=torch.full_like(block.valid, float("nan")))


@register_fault("spike_grads")
def _inject_spike_grads(state, block, factor: float = 1e6, **params):
    """Scale the staged pending gradients — a finite spike for the
    static norm cap and the host z-score (ACCO & DPU; DDP has no staged
    gradients to spike)."""
    _require_single_process("spike_grads")
    if not hasattr(state, "pending_grads"):
        raise ValueError(
            "spike_grads needs a state with staged gradients (ACCO/DPU); for DDP use "
            "nan_grads (data path) or corrupt_params/corrupt_opt (state path)"
        )
    return state._replace(pending_grads=state.pending_grads * float(factor)), block


def _require_single_process(kind: str) -> None:
    """The state kinds write one rank's view of replicated and sharded
    state; on several ranks they would poison one replica only, so they
    refuse, as JAX's refuse a multi-host mesh (``nan_grads`` stays
    multi-rank safe: it poisons each rank's own data path)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"fault kind {kind!r} mutates replicated/sharded state and is single-process "
            "only; on several ranks use nan_grads (data path) or run the drill on one rank"
        )


def _corrupt_prefix(leaf, n: int, value: float):
    out = leaf.clone()
    out[: max(1, int(n))] = value
    return out


@register_fault("corrupt_params")
def _inject_corrupt_params(state, block, n: int = 64, value: float = float("nan"), **params):
    """Overwrite the first ``n`` parameters in BOTH the working copy and
    the float32 master shard (``zero1.opt.params``): persistent poison.
    The master matters — every commit writes fresh working params FROM
    the master, so corrupting the working copy alone self-heals after
    one committed round. With the master poisoned every tentative update
    is nonfinite, the guard skips every round, and only the watchdog's
    rollback can recover."""
    _require_single_process("corrupt_params")
    opt = state.zero1.opt._replace(params=_corrupt_prefix(state.zero1.opt.params, n, value))
    return state._replace(flat_params=_corrupt_prefix(state.flat_params, n, value),
                          zero1=state.zero1._replace(opt=opt)), block


@register_fault("corrupt_opt")
def _inject_corrupt_opt(state, block, n: int = 64, value: float = float("nan"), **params):
    """Overwrite the first ``n`` entries of the optimizer's first-moment
    shard: gradients stay finite, the UPDATE goes nonfinite — the guard's
    second signal must catch it."""
    _require_single_process("corrupt_opt")
    opt = state.zero1.opt._replace(mu=_corrupt_prefix(state.zero1.opt.mu, n, value))
    return state._replace(zero1=state.zero1._replace(opt=opt)), block


class FaultSpec:
    """One scheduled fault: ``kind`` at 0-based loop ``round``, extra
    params passed through to the registered injector; fires once."""

    def __init__(self, kind: str, round_idx: int, **params: Any) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; registered: {sorted(FAULT_KINDS)}")
        self.kind = kind
        self.round = int(round_idx)
        if self.round < 0:
            raise ValueError(f"fault round must be >= 0, got {self.round}")
        self.params = dict(params)
        self.fired = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        extra = "".join(f", {k}={v!r}" for k, v in self.params.items())
        return f"FaultSpec({self.kind!r}@{self.round}{extra})"


def parse_fault_specs(cfg: Any) -> List[FaultSpec]:
    """Normalize a ``fault_injection:`` config value into FaultSpecs.

    Accepts None/empty (no faults), a single dict, a list of dicts
    (``{kind: ..., round: ..., **params}``), or compact ``"kind@round"``
    strings (also in a list). Unknown kinds and malformed entries raise
    at parse time — a drill that silently injects nothing would report a
    robustness the stack does not have.
    """
    if cfg is None or cfg == "" or cfg is False:
        return []
    if isinstance(cfg, str) or hasattr(cfg, "keys"):
        cfg = [cfg]
    specs: List[FaultSpec] = []
    for entry in cfg:
        if isinstance(entry, str):
            kind, sep, rnd = entry.partition("@")
            if not sep:
                raise ValueError(f"fault string {entry!r} must be 'kind@round'")
            specs.append(FaultSpec(kind.strip(), int(rnd)))
        elif hasattr(entry, "keys"):
            entry = {k: entry[k] for k in entry.keys()}
            kind = entry.pop("kind", None)
            rnd = entry.pop("round", None)
            if kind is None or rnd is None:
                raise ValueError(f"fault dict {entry!r} needs 'kind' and 'round' keys")
            specs.append(FaultSpec(str(kind), int(rnd), **entry))
        else:
            raise ValueError(f"unsupported fault spec entry: {entry!r}")
    return specs


class FaultInjector:
    """Fire scheduled faults into the train loop.

    The trainer calls :meth:`apply` with its run-local dispatch index
    right before each round; matching un-fired specs poison the state
    and/or block. ``pending`` goes False once every spec has fired, so
    the steady-state loop pays one attribute check per round.
    """

    def __init__(self, specs: List[FaultSpec], log: Optional[logging.Logger] = None) -> None:
        self.specs = list(specs)
        self.log = log or _module_log

    @classmethod
    def from_config(cls, cfg: Any,
                    log: Optional[logging.Logger] = None) -> Optional["FaultInjector"]:
        specs = parse_fault_specs(cfg)
        return cls(specs, log=log) if specs else None

    @property
    def pending(self) -> bool:
        return any(not s.fired for s in self.specs)

    def apply(self, round_idx: int, state: Any, block: Any) -> Tuple[Any, Any]:
        for spec in self.specs:
            if spec.fired or spec.round != int(round_idx):
                continue
            spec.fired = True
            self.log.warning("fault injection: %s at round %d %s", spec.kind, round_idx,
                             spec.params or "")
            state, block = FAULT_KINDS[spec.kind](state, block, **spec.params)
        return state, block


# ---------------------------------------------------------------------------
# Serve-side chaos: faults fired at scheduler step indices (a copy of JAX's)
# ---------------------------------------------------------------------------

# kind -> inject(injector, scheduler, **params). Fired by the scheduler
# at the TOP of step() (before admission), on the serving-loop thread —
# so every injection is serialized with normal scheduling exactly like a
# real event would be. Kinds mirror production failure classes:
#
# - ``engine_raise``   — the decode dispatch blows up: the raise
#   propagates out of step() into ServingLoop's fail_all path (every
#   in-flight request fails loudly, the loop survives);
# - ``slow_decode``    — one decode takes ``seconds`` longer (a
#   stragglers/step-time-spike drill for timeouts and deadlines);
# - ``kv_exhaust``     — the page pool drains to ``leave`` free pages
#   for ``hold_steps`` steps: admission must shed (503, never 500) and
#   growth must preempt, then the pool recovers;
# - ``client_abandon`` — the newest in-flight request's client vanishes:
#   the cancellation path must free its pages (the zombie-leak drill).
SERVE_FAULT_KINDS: Dict[str, Callable] = {}


def register_serve_fault(kind: str):
    def wrap(fn: Callable) -> Callable:
        SERVE_FAULT_KINDS[kind] = fn
        return fn

    return wrap


@register_serve_fault("engine_raise")
def _serve_engine_raise(injector, scheduler, **params):
    raise RuntimeError("injected serve fault: engine_raise")


@register_serve_fault("slow_decode")
def _serve_slow_decode(injector, scheduler, seconds: float = 0.05, **params):
    """Make the NEXT engine.decode call sleep ``seconds`` first; the
    wrapper restores the original before delegating, so exactly one
    decode is slow."""
    engine = scheduler.engine
    orig = engine.decode

    def slow_once(*a, **k):
        engine.decode = orig
        time.sleep(float(seconds))
        return orig(*a, **k)

    engine.decode = slow_once


@register_serve_fault("kv_exhaust")
def _serve_kv_exhaust(
    injector, scheduler, leave: int = 0, hold_steps: int = 5, **params
):
    """Allocate the pool down to ``leave`` free pages and hold them for
    ``hold_steps`` scheduler steps (the injector frees them)."""
    n = scheduler.allocator.available - int(leave)
    if n <= 0:
        return
    pages = scheduler.allocator.alloc(n)
    if pages:
        injector.hold_pages(scheduler, pages, hold_steps=int(hold_steps))


@register_serve_fault("client_abandon")
def _serve_client_abandon(injector, scheduler, **params):
    """Cancel the newest in-flight request as an abandoning client
    would (handler gone, nobody waiting) — the scheduler must free its
    pages via the cancellation path."""
    active = [r for r in scheduler.slots if r is not None]
    if active:
        victim = max(active, key=lambda r: r.admit_seq)
    elif scheduler.waiting:
        victim = scheduler.waiting[-1]
    else:
        return
    scheduler.cancel(victim, reason="abandoned")


class ServeFaultSpec:
    """One scheduled serve fault: ``kind`` at 0-based scheduler ``step``
    (counted over step() calls of the current scheduler); fires once."""

    def __init__(self, kind: str, step_idx: int, **params: Any) -> None:
        if kind not in SERVE_FAULT_KINDS:
            raise ValueError(
                f"unknown serve fault kind {kind!r}; registered: "
                f"{sorted(SERVE_FAULT_KINDS)}"
            )
        self.kind = kind
        self.step = int(step_idx)
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        self.params = dict(params)
        self.fired = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        extra = "".join(f", {k}={v!r}" for k, v in self.params.items())
        return f"ServeFaultSpec({self.kind!r}@{self.step}{extra})"


def parse_serve_fault_specs(cfg: Any) -> List["ServeFaultSpec"]:
    """Normalize a serve chaos config (``ACCO_SERVE_CHAOS`` env /
    ``fault_injection:`` serve-yaml key / ``--chaos`` flags) into
    ServeFaultSpecs. Same grammar as the train injector: a list of
    dicts (``{kind: kv_exhaust, step: 4, hold_steps: 8}``), a single
    dict, or compact comma-separable strings (``"client_abandon@5"``).
    Unknown kinds raise at parse time — a drill that silently injects
    nothing would report a robustness the stack does not have."""
    if cfg is None or cfg == "" or cfg is False:
        return []
    if isinstance(cfg, str):
        cfg = [s for s in cfg.split(",") if s.strip()]
    if isinstance(cfg, dict):
        cfg = [cfg]
    specs: List[ServeFaultSpec] = []
    for entry in cfg:
        if isinstance(entry, str):
            kind, sep, step = entry.strip().partition("@")
            if not sep:
                raise ValueError(
                    f"serve fault string {entry!r} must be 'kind@step'"
                )
            specs.append(ServeFaultSpec(kind.strip(), int(step)))
        elif isinstance(entry, dict):
            entry = dict(entry)
            kind = entry.pop("kind", None)
            step = entry.pop("step", None)
            if kind is None or step is None:
                raise ValueError(
                    f"serve fault dict {entry!r} needs 'kind' and 'step'"
                )
            specs.append(ServeFaultSpec(str(kind), int(step), **entry))
        else:
            raise ValueError(f"unsupported serve fault spec: {entry!r}")
    return specs


class ServeFaultInjector:
    """Fire scheduled serve faults into the continuous-batching loop.

    Wire via ``ContinuousBatchingScheduler(fault_injector=...)``; the
    scheduler calls :meth:`before_step` with its 0-based step index at
    the top of every step(). Matching un-fired specs fire (counted in
    ``serve_faults_injected_total``); pages held by ``kv_exhaust`` are
    released here once their hold expires, or at a submit that finds no
    request left to run (:meth:`release_idle`).
    """

    ENV_VAR = "ACCO_SERVE_CHAOS"

    def __init__(
        self,
        specs: List[ServeFaultSpec],
        log: Optional[logging.Logger] = None,
    ) -> None:
        self.specs = list(specs)
        self.log = log or _module_log
        self._holds: List[Tuple[Any, list, int]] = []  # (sched, pages, release)

    @classmethod
    def from_config(
        cls, cfg: Any, log: Optional[logging.Logger] = None
    ) -> Optional["ServeFaultInjector"]:
        specs = parse_serve_fault_specs(cfg)
        return cls(specs, log=log) if specs else None

    @classmethod
    def from_env(
        cls, log: Optional[logging.Logger] = None
    ) -> Optional["ServeFaultInjector"]:
        return cls.from_config(os.environ.get(cls.ENV_VAR), log=log)

    @property
    def pending(self) -> bool:
        return any(not s.fired for s in self.specs) or bool(self._holds)

    @property
    def fired(self) -> List[ServeFaultSpec]:
        return [s for s in self.specs if s.fired]

    def hold_pages(self, scheduler, pages: list, hold_steps: int) -> None:
        release = scheduler._step_idx + max(1, int(hold_steps))
        self._holds.append((scheduler, pages, release))
        self.log.warning(
            "kv_exhaust holding %d pages until scheduler step %d",
            len(pages), release,
        )

    def release_idle(self, scheduler) -> None:
        """Release every ``kv_exhaust`` hold on ``scheduler``, which has no
        request left to run (its ``submit`` calls this): no step would
        come to reach the hold's release, so the pool would stay drained,
        every new request shed for KV pressure, and the pages reported as
        leaked at the drain. A documented difference from JAX's copy,
        which holds them until a step."""
        for hold in self._holds[:]:
            sched, pages, _ = hold
            if sched is scheduler:
                sched.allocator.free(pages)
                self._holds.remove(hold)
                self.log.warning("kv_exhaust released %d pages: no request left to run",
                                 len(pages))

    def before_step(self, scheduler, step_idx: int) -> None:
        from acco_tpu_torch.telemetry import metrics

        for hold in self._holds[:]:
            sched, pages, release = hold
            if sched is scheduler and step_idx >= release:
                sched.allocator.free(pages)
                self._holds.remove(hold)
                self.log.warning(
                    "kv_exhaust released %d pages at step %d",
                    len(pages), step_idx,
                )
        for spec in self.specs:
            if spec.fired or spec.step != int(step_idx):
                continue
            # mark fired BEFORE injecting: engine_raise propagates out
            # of step() by design and must not re-fire forever
            spec.fired = True
            metrics.emit("serve_faults_injected_total", 1)
            self.log.warning(
                "serve fault injection: %s at step %d %s",
                spec.kind, step_idx, spec.params or "",
            )
            SERVE_FAULT_KINDS[spec.kind](self, scheduler, **spec.params)
