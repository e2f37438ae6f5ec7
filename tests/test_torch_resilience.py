"""The port's ``resilience/`` against the JAX package's.

- ``TrainingHealthMonitor``: the observation sequences of
  ``tests/test_watchdog.py`` (spike then escalate, the sustained shift
  that re-seeds, drift counted by episodes) give equal verdicts and
  summaries from both packages.
- ``parse_fault_specs``: equal specs, and the same errors, on
  ``tests/test_watchdog.py``'s inputs; the filesystem faults give the
  validators' verdicts.
- ``ShutdownHandler``: a real SIGTERM is latched and the old handler
  restored; a second signal goes to the previous handler.
- ``CheckpointManager``: the async commit equals the sync one tensor for
  tensor; a commit error surfaces on the caller at the next ``save()``,
  ``wait()`` and ``close()``; startup GC and retention; a saver killed
  between its rank file and ``meta.json`` leaves a step that recovery
  skips; on 2 gloo ranks the async commit writes ``meta.json`` only
  after both rank files, with no collective on its thread.
"""

import json
import logging
import os
import signal
import threading
from typing import NamedTuple

import pytest
import torch

from acco_tpu.resilience import faults as jax_faults
from acco_tpu.resilience.watchdog import TrainingHealthMonitor as JaxMonitor
from acco_tpu_torch.resilience import faults
from acco_tpu_torch.resilience.manager import CheckpointManager
from acco_tpu_torch.resilience.preemption import ShutdownHandler
from acco_tpu_torch.resilience.watchdog import TrainingHealthMonitor
from acco_tpu_torch.utils import checkpoint as ckpt
import torch_ranks
from torch_ranks import run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


class Inner(NamedTuple):
    mu: torch.Tensor
    count: torch.Tensor


class State(NamedTuple):
    flat_params: torch.Tensor
    inner: Inner


def _state(seed=0, n=64):
    g = torch.Generator().manual_seed(seed)
    return State(torch.randn(n, generator=g).to(torch.bfloat16),
                 Inner(torch.randn(n, generator=g), torch.tensor(seed, dtype=torch.int32)))


# -- the host monitor (tests/test_watchdog.py:269-297, :663-691, :551-578) ---

OK = dict(loss=2.0, skipped_rounds=0, consec_skipped=0)
MONITOR_SEQUENCES = {
    "spike-then-escalate": (
        dict(escalate_after=3, warmup_obs=2),
        [dict(OK, grad_norm=1.0 + 0.01 * i) for i in range(6)]
        + [dict(OK, grad_norm=1e6), dict(OK, grad_norm=1.0),
           dict(grad_norm=1.0, loss=float("nan"), skipped_rounds=2, consec_skipped=2),
           dict(grad_norm=1.0, loss=float("nan"), skipped_rounds=3, consec_skipped=3),
           "rollback"],
    ),
    "sustained-shift-reseeds": (
        dict(escalate_after=3, warmup_obs=2, spike_reseed=3),
        [dict(OK, grad_norm=1.0)] * 6 + [dict(OK, grad_norm=1e6)] * 4
        + [dict(OK, grad_norm=1.0)],
    ),
    "drift-episodes": (
        dict(escalate_after=8, warmup_obs=2, ema_beta=0.99, drift_obs=2),
        [dict(OK, grad_norm=1.0)] * 6 + [dict(OK, grad_norm=1.34)] * 4
        + [dict(OK, grad_norm=1.0)] * 4 + [dict(OK, grad_norm=1.5)] * 4,
    ),
}


def _run_monitor(cls, kw, sequence):
    mon = cls(log=logging.getLogger("t"), **kw)
    out = []
    for obs in sequence:
        if obs == "rollback":
            mon.note_rollback()
            out.append("rollback")
        else:
            out.append(tuple(mon.observe(**obs)))
    return out, mon.summary()


@pytest.mark.parametrize("name", sorted(MONITOR_SEQUENCES))
def test_monitor_verdicts_equal_jax(name):
    kw, sequence = MONITOR_SEQUENCES[name]
    got = _run_monitor(TrainingHealthMonitor, kw, sequence)
    want = _run_monitor(JaxMonitor, kw, sequence)
    assert got == want
    classes = [v[0] for v in got[0] if v != "rollback"]
    assert {"spike-then-escalate": "anomalous", "sustained-shift-reseeds": "spike",
            "drift-episodes": "drift"}[name] in classes


# -- fault specs (tests/test_watchdog.py:299-314) and filesystem faults ------

SPEC_INPUTS = [
    [{"kind": "nan_grads", "round": 3}, "corrupt_params@5",
     {"kind": "corrupt_opt", "round": 7, "n": 16}],
    None, "", "spike_grads@2", {"kind": "spike_grads", "round": 1, "factor": 10.0},
    "definitely_not_a_fault@1", [{"round": 1}], "nan_grads", [3],
]


def _parsed(module, cfg):
    try:
        return [(s.kind, s.round, s.params) for s in module.parse_fault_specs(cfg)]
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("cfg", SPEC_INPUTS, ids=[str(i) for i in range(len(SPEC_INPUTS))])
def test_parse_fault_specs_equal_jax(cfg):
    assert _parsed(faults, cfg) == _parsed(jax_faults, cfg)
    assert (faults.FaultInjector.from_config(None) is None
            and jax_faults.FaultInjector.from_config(None) is None)


def test_filesystem_faults_and_killed_saver(tmp_path):
    """Each torn step is skipped with JAX's reason; a real saver killed
    between its rank file and meta.json leaves a step that
    ``latest_checkpoint`` skips and the startup GC removes."""
    from acco_tpu.utils import checkpoint as jax_ckpt

    root = str(tmp_path)
    good = ckpt.save_checkpoint(root, 1, _state(1), {"count_grad_tot": 1})
    for step, fault in ((2, faults.strip_meta), (3, faults.truncate_state_file),
                        (4, faults.wipe_manifest)):
        fault(ckpt.save_checkpoint(root, step, _state(step), {"count_grad_tot": step}))
    reasons = {p: ckpt.validate_checkpoint(p) for p in ckpt.checkpoint_candidates(root)}
    assert reasons == {p: jax_ckpt.validate_checkpoint(p) for p in reasons}
    assert [r is None for r in reasons.values()] == [False, False, False, True]
    orphan = faults.run_saver_killed_subprocess(root, 9)
    assert os.path.exists(os.path.join(orphan, "state", "rank_0.pt"))
    assert not os.path.exists(os.path.join(orphan, "meta.json"))
    assert ckpt.latest_checkpoint(root) == good
    removed = CheckpointManager(root, gc_on_init=False).gc_incomplete()
    assert sorted(removed) == sorted([orphan, os.path.join(root, "step_2")])


# -- preemption (tests/test_resilience.py:405-430) ---------------------------


def test_shutdown_handler_latches_sigterm_and_escalates():
    prev = signal.getsignal(signal.SIGTERM)
    handler = ShutdownHandler()
    assert handler.install()
    try:
        assert not handler.should_stop()
        faults.send_self_sigterm()
        assert handler.requested and handler.should_stop()
    finally:
        handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev

    hits = []
    original = signal.getsignal(signal.SIGUSR1)
    signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        handler = ShutdownHandler(signals=(signal.SIGUSR1,))
        assert handler.install()
        signal.raise_signal(signal.SIGUSR1)
        assert handler.requested and not hits  # first: latched, absorbed
        signal.raise_signal(signal.SIGUSR1)
        assert hits == [signal.SIGUSR1]  # second: escalated
    finally:
        signal.signal(signal.SIGUSR1, original)


# -- the manager ---------------------------------------------------------------


def _rank0(path):
    return torch.load(os.path.join(path, "state", "rank_0.pt"), weights_only=True)


def test_async_commit_equals_sync(tmp_path):
    """The same states through an async and a sync manager: equal rank
    files tensor for tensor and equal meta (timestamps apart); the async
    save returns before its commit (held open here), invisible to
    recovery until then; the pinned buffers are reused by later saves."""
    gate = threading.Event()
    am = CheckpointManager(str(tmp_path / "a"), async_save=True)
    sm = CheckpointManager(str(tmp_path / "s"), async_save=False)
    for step in (1, 2):
        state = _state(step)
        hold = (lambda p, host: gate.wait(30)) if step == 1 else None
        pa = am.save(step, state, {"count_grad_tot": step}, extra_files=hold)
        if step == 1:
            assert am.in_flight and not os.path.exists(os.path.join(pa, "meta.json"))
            assert ckpt.latest_checkpoint(str(tmp_path / "a")) is None
            gate.set()
        ps = sm.save(step, state, {"count_grad_tot": step})
        assert not sm.in_flight
        am.wait()
        a, s = _rank0(pa), _rank0(ps)
        assert a["state"].keys() == s["state"].keys()
        for key in s["state"]:
            assert torch.equal(a["state"][key], s["state"][key]), key
            assert a["state"][key].dtype == s["state"][key].dtype
        ma, ms = (json.load(open(os.path.join(p, "meta.json"))) for p in (pa, ps))
        for m in (ma, ms):
            m.pop("saved_at_unix")
        assert ma == ms and ckpt.validate_checkpoint(pa) is None
        restored, _ = ckpt.restore_checkpoint(pa, _state(0))
        assert torch.equal(restored.inner.mu, state.inner.mu)
    assert am.buffers.alloc_ms == 0.0  # the second save reused the first's buffers


@pytest.mark.parametrize("where", ["save", "wait", "close"])
def test_commit_error_surfaces_on_caller(tmp_path, where):
    def boom(path, host):
        raise RuntimeError("disk full while writing params.npz")

    mgr = CheckpointManager(str(tmp_path), async_save=True)
    path = mgr.save(1, _state(), {}, extra_files=boom)
    with pytest.raises(RuntimeError, match="disk full"):
        if where == "save":
            mgr.save(2, _state(), {})
        elif where == "wait":
            mgr.wait()
        else:
            mgr.close()
    assert ckpt.validate_checkpoint(path) is not None  # never committed
    mgr.wait()  # raised once, then clear


def test_retention_and_gc(tmp_path):
    """keep_last 1 with a 250 s archive over saves stamped 0..500 s (as
    JAX's ``test_retention_keep_every_s_archives_sparsely``), async; the
    startup GC removes an uncommitted dir only."""
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "step_0", "state"))
    mgr = CheckpointManager(root, async_save=True, keep_last=1, keep_every_s=250)
    assert mgr.gc_incomplete() == [] and not os.path.exists(os.path.join(root, "step_0"))
    for step, ts in enumerate([0, 100, 200, 300, 400, 500], start=1):
        mgr.save(step, _state(step), {"saved_at_unix": ts})
    mgr.close()
    names = sorted(os.listdir(root), key=lambda n: int(n.split("_")[1]))
    assert names == ["step_1", "step_4", "step_6"]


GATE_WORKER = """
import json, threading, time
from typing import NamedTuple
from acco_tpu_torch.resilience.manager import CheckpointManager

class State(NamedTuple):
    w: torch.Tensor

calls = []
for name in ("barrier", "all_reduce", "broadcast", "all_gather", "broadcast_object_list",
             "reduce_scatter", "all_gather_object"):
    original = getattr(dist, name)
    def wrapped(*a, _original=original, _name=name, **k):
        calls.append((_name, threading.current_thread().name))
        return _original(*a, **k)
    setattr(dist, name, wrapped)

root = os.path.join(WORKDIR, "ckpt")
mgr = CheckpointManager(root, async_save=True, rank=RANK, world_size=2, gc_on_init=False)
state = State(torch.full((256,), float(RANK)))
out = {}
if RANK == 0:
    path = mgr.save(5, state, {"count_grad_tot": 5})
    dist.barrier()  # on the loop's thread, while the commit waits at its gate
    out["meta_before_rank1"] = os.path.exists(os.path.join(path, "meta.json"))
    out["in_flight"] = mgr.in_flight
    mgr.wait()
    files = os.path.join(path, "state")
    out["meta_after_rank_files"] = (os.path.getmtime(os.path.join(path, "meta.json"))
                                    >= max(os.path.getmtime(os.path.join(files, f))
                                           for f in os.listdir(files)))
    out["manifest"] = sorted(json.load(open(os.path.join(path, "meta.json")))["state_manifest"])
else:
    dist.barrier()
    time.sleep(0.5)
    mgr.save(5, state, {"count_grad_tot": 5})
    mgr.wait()
out["calls"] = calls
json.dump(out, open(os.path.join(WORKDIR, f"out{RANK}.json"), "w"))
"""


def test_async_commit_gates_on_rank_files(tmp_path):
    run_ranks(GATE_WORKER, 2, tmp_path, timeout=120)
    out0 = json.load(open(tmp_path / "out0.json"))
    assert out0["meta_before_rank1"] is False and out0["in_flight"] is True
    assert out0["meta_after_rank_files"] is True
    assert out0["manifest"] == ["state/rank_0.pt", "state/rank_1.pt"]
    for r in range(2):
        calls = json.load(open(tmp_path / f"out{r}.json"))["calls"]
        assert calls and all(thread == "MainThread" for _, thread in calls), calls


RESAVE_WORKER = """
import json, time
from typing import NamedTuple
from acco_tpu_torch.resilience.manager import CheckpointManager
from acco_tpu_torch.utils import checkpoint as ckpt

class State(NamedTuple):
    w: torch.Tensor

# the test's delay: rank 2 holds its second save's tmp file on disk for 2 s
# before the rename, rank 0 starts its second write 0.5 s late, so rank 0's
# gate and manifest run while rank 2's tmp exists
writes = []
original_save = torch.save
def slow_save(obj, f, *a, **k):
    writes.append(f)
    if RANK == 0 and len(writes) == 2:
        time.sleep(0.5)
    original_save(obj, f, *a, **k)
    if RANK == 2 and len(writes) == 2:
        time.sleep(2.0)
torch.save = slow_save

root = os.path.join(WORKDIR, "ckpt")
mgr = CheckpointManager(root, async_save=True, rank=RANK, world_size=WS, gc_on_init=False)
for value in (1.0, 2.0):  # step_4 twice: a boundary whose round committed nothing
    dist.barrier()
    mgr.save(4, State(torch.full((256,), value + RANK)), {"count_grad_tot": 4})
    mgr.wait()
dist.barrier()
path = os.path.join(root, "step_4")
out = {"valid": ckpt.validate_checkpoint(path), "latest": ckpt.latest_checkpoint(root)}
if out["valid"] is None:
    state, _ = ckpt.restore_checkpoint(path, State(torch.zeros(256)), rank=RANK)
    out["restored"] = state.w.tolist()
    out["manifest"] = sorted(json.load(open(os.path.join(path, "meta.json")))["state_manifest"])
json.dump(out, open(os.path.join(WORKDIR, f"out{RANK}.json"), "w"))
"""


def test_resave_of_a_step_dir_overwrites_it(tmp_path):
    """Two saves of ``step_4`` in a row on 4 gloo ranks, rank 2's second
    write held back: rank 0's commit takes the first commit back and its
    gate waits for the second save's files, so the dir validates, its
    manifest names the four rank files only, and every rank restores the
    second save bit for bit, as JAX's ``force=True`` overwrite does (the
    old gate took rank 2's first file, committing a manifest with its
    ``.tmp``)."""
    run_ranks(RESAVE_WORKER, 4, tmp_path, timeout=120)
    for r in range(4):
        out = json.load(open(tmp_path / f"out{r}.json"))
        assert out["valid"] is None, out["valid"]
        assert out["latest"] == str(tmp_path / "ckpt" / "step_4")
        assert out["manifest"] == [f"state/rank_{i}.pt" for i in range(4)]
        assert out["restored"] == [2.0 + r] * 256
