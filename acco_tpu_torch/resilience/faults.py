"""Fault injection for the train loop: one registry for tests, configs
and drills on the card.

Counterpart of the train half of ``acco_tpu/resilience/faults.py`` (its
serve kinds wait for the port's serving). Two layers:

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
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import textwrap
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
