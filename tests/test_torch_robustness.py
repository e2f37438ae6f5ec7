"""A run that survives, on the port's ``Trainer`` (tiny Llama, float32,
CPU): the counterparts of ``tests/test_resilience.py``'s and
``tests/test_watchdog.py``'s end-to-end scenarios.

- SIGTERM (``ShutdownAfterRounds``, the deterministic stand-in) stops the
  run at a round boundary with a final checkpoint and ``interrupted``;
  the run resumed from it equals the uninterrupted run bit for bit
  (acco, dpu, ddp).
- ``nan_grads``: exactly one guard-skipped round, the target reached, a
  finite final loss (acco, dpu, ddp).
- ``corrupt_params`` with saves on: the watchdog rolls back, and the
  run's final state equals, bit for bit, a run resumed from the same
  checkpoint with the loader set to the fence position (the port's own
  resume, held against JAX in tests/test_torch_resume.py).
- ``rollback_max`` exceeded, and no checkpoint, each raise as JAX's.
- On 2 gloo ranks a stop latched on rank 1 alone stops both ranks at the
  same boundary (``preempt_sync_rounds``).
- ``telemetry.enabled`` true and false give bit-equal rounds; the trace
  validates and the attribution's buckets sum to the round wall.
"""

import json
import os

import numpy as np
import pytest
import torch

from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.loader import ShardedBatchIterator
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.resilience.faults import ShutdownAfterRounds
from acco_tpu_torch.telemetry.trace import validate_trace
from acco_tpu_torch.trainer import Trainer
import torch_ranks
from torch_ranks import run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

ARCH = dict(vocab_size=257, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_position_embeddings=32)
# 7 documents of 63 bytes + EOS: 14 packed rows of 32, 7 batches of 2 an epoch
TEXTS = ["".join(np.random.default_rng(i).choice(list("abcdefghij "), 63)) for i in range(7)]


def _args(method, nb, **over):
    base = dict(method_name=method, batch_size=2, max_length=32, nb_steps_tot=nb,
                const_len_batch=True, scheduler_name="constant", learning_rate=3e-3,
                weight_decay=0.1, adam_beta1=0.9, adam_beta2=0.95, save=False,
                checkpoint_every_s=1e9, n_warmup_steps=0, run_name=method,
                delta_step_for_log=2, handle_signals=False)
    base.update(over)
    return ConfigNode.wrap(base)


def _trainer(method, nb, run_dir, handler=None, **over):
    model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32)
    return Trainer(model, load_tokenizer("byte"), TEXTS, None, _args(method, nb, **over),
                   seed=3, run_dir=str(run_dir), shutdown_handler=handler)


def _leaves(state):
    out = {}
    for name, value in zip(state._fields, state):
        if isinstance(value, tuple):
            out.update({f"{name}/{k}": v for k, v in _leaves(value).items()})
        else:
            out[name] = value.numpy()  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    return out


def _assert_state_equal(got, want):
    lg, lw = _leaves(got), _leaves(want)
    assert lg.keys() == lw.keys()
    for key in lw:
        np.testing.assert_array_equal(lg[key], lw[key], err_msg=key)


@pytest.mark.parametrize("method, stop_at, nb", [("acco", 3, 8), ("dpu", 3, 6), ("ddp", 2, 5)])
def test_sigterm_then_resume_is_bit_exact(tmp_path, method, stop_at, nb):
    """The stop latched at boundary ``stop_at`` (ACCO: after an even,
    speculative round, its grads in flight): ``interrupted``, a committed
    checkpoint at that boundary, and the resumed run equal to A."""
    a = _trainer(method, nb, tmp_path / "a")
    sa = a.train()
    b = _trainer(method, nb, tmp_path / "b", handler=ShutdownAfterRounds(stop_at), save=True,
                 handle_signals=True)
    sb = b.train()
    assert sb["interrupted"] and not sa["interrupted"]
    assert sb["rounds"] == len(sb["round_log"]) == stop_at
    meta = json.load(open(os.path.join(sb["checkpoint"], "meta.json")))
    assert meta["rounds_done"] == stop_at and meta["count_grad_tot"] == sb["count_grad_tot"]
    c = _trainer(method, nb, tmp_path / "c",
                 resume_from=str(tmp_path / "b" / "checkpoints" / method))
    sc = c.train()
    assert not sc["interrupted"] and sc["count_grad_tot"] == sa["count_grad_tot"]
    _assert_state_equal(c.final_state, a.final_state)
    assert [r["loss"] for r in sa["round_log"]] == [
        r["loss"] for r in sb["round_log"] + sc["round_log"]]


@pytest.mark.parametrize("method", ["acco", "dpu", "ddp"])
def test_nan_grads_skips_one_round(tmp_path, method):
    summary = _trainer(method, 6, tmp_path, fault_injection="nan_grads@3",
                       delta_step_for_log=1).train()
    assert summary["skipped_rounds"] == 1 and summary["rollbacks"] == 0
    assert summary["count_grad_tot"] >= 6
    assert np.isfinite(summary["final_loss"])
    assert sum(not np.isfinite(r["loss"]) for r in summary["round_log"]) == 1


def test_rollback_equals_resume_with_fence(tmp_path, monkeypatch):
    """A checkpoint at every boundary; ``corrupt_params`` at round 6
    poisons params and master shard; two boundaries of skips later the
    watchdog restores the newest complete checkpoint and fences the
    loader. Oracle: the same checkpoint resumed with the loader at the
    fence."""
    over = dict(save=True, checkpoint_every_s=0, rollback_after_skipped=2, ckpt_keep_last=0)
    a = _trainer("acco", 14, tmp_path / "a",
                 fault_injection=[{"kind": "corrupt_params", "round": 6, "n": 8}], **over)
    sa = a.train()
    assert sa["rollbacks"] == 1 and len(a.rollback_log) == 1
    assert sa["count_grad_tot"] >= 14 and np.isfinite(sa["final_loss"])
    event = a.rollback_log[0]
    fence = event["fence"]
    meta = json.load(open(os.path.join(event["path"], "meta.json")))
    assert fence != meta["loader"]  # the fence skips the poisoned window

    original = ShardedBatchIterator.set_state
    monkeypatch.setattr(ShardedBatchIterator, "set_state",
                        lambda self, state: original(self, fence))
    b = _trainer("acco", 14, tmp_path / "b", resume_from=event["path"], **over)
    b.train()
    _assert_state_equal(a.final_state, b.final_state)

    # a planted fault: the checkpoint's own loader position (no fence)
    monkeypatch.setattr(ShardedBatchIterator, "set_state", original)
    c = _trainer("acco", 14, tmp_path / "c", resume_from=event["path"], **over)
    c.train()
    assert not torch.equal(c.final_state.flat_params, a.final_state.flat_params)


@pytest.mark.parametrize("save, rollback_max, match", [
    (True, 0, r"0 auto-rollbacks already performed \(rollback_max=0\)"),
    (False, 2, "no complete checkpoint"),
])
def test_rollback_refusals_raise(tmp_path, save, rollback_max, match):
    """JAX's bound (``acco_tpu/trainer.py`` ``_rollback``: more than
    ``rollback_max`` rollbacks raise) and JAX's
    ``test_escalation_without_checkpoint_raises`` (rollback on, nothing
    saved: a RuntimeError, not no-op rounds forever)."""
    t = _trainer("acco", 14, tmp_path, save=save, checkpoint_every_s=0,
                 rollback_after_skipped=2, rollback_max=rollback_max,
                 fault_injection=[{"kind": "corrupt_params", "round": 4, "n": 8}])
    with pytest.raises(RuntimeError, match=match):
        t.train()


def test_telemetry_on_and_off_are_bit_equal(tmp_path):
    runs = []
    for enabled in (True, False):
        t = _trainer("acco", 8, tmp_path / str(enabled), telemetry={"enabled": enabled})
        runs.append((t, t.train()))
    (on, son), (off, soff) = runs
    _assert_state_equal(on.final_state, off.final_state)
    assert [r["loss"] for r in son["round_log"]] == [r["loss"] for r in soff["round_log"]]
    assert son["trace"] and soff["trace"] is None
    trace = json.load(open(son["trace"]))
    assert validate_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"train/round", "train/dispatch", "loader/next_block",
            "train/log_boundary_sync"} <= names
    report = son["attribution"]
    assert report["rounds"] == 8 and report["windows"] == 4
    assert abs(report["bucket_sum_ms"] - report["round_wall_ms"]) <= 0.05 * report["round_wall_ms"]


STOP_WORKER = """
import json
import numpy as np
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel.mesh import Mesh, RankGroups
from acco_tpu_torch.resilience.faults import ShutdownAfterRounds
from acco_tpu_torch.trainer import Trainer

spec = json.load(open(os.path.join(WORKDIR, "spec.json")))
groups, _ = RankGroups.build({"dp": 2}, RANK)
mesh = Mesh(dp=2, sp=1, rank=RANK, device=torch.device("cpu"), groups=groups)
model = LlamaModel(LlamaConfig(**spec["arch"]), dtype=torch.float32)
handler = ShutdownAfterRounds(spec["stop_at"]) if RANK == 1 else None
trainer = Trainer(model, load_tokenizer("byte"), spec["texts"], None,
                  ConfigNode.wrap(spec["args"]), seed=3, mesh=mesh,
                  run_dir=os.path.join(WORKDIR, "run"), shutdown_handler=handler)
summary = trainer.train()
json.dump({k: summary[k] for k in ("interrupted", "rounds", "count_grad_tot")},
          open(os.path.join(WORKDIR, f"out{RANK}.json"), "w"))
"""


def test_stop_on_one_rank_stops_both(tmp_path):
    """Rank 1 latches at its 3rd poll; the flags are MAX-reduced every
    2 rounds, so both ranks stop after round 4, and rank 0's final save
    commits both rank files."""
    args = dict(_args("acco", 16, save=True, preempt_sync_rounds=2).to_container())
    spec = {"arch": ARCH, "texts": TEXTS * 2, "args": args, "stop_at": 3}
    json.dump(spec, open(tmp_path / "spec.json", "w"))
    run_ranks(STOP_WORKER, 2, tmp_path, timeout=120)
    outs = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]
    assert outs[0] == outs[1] and outs[0]["interrupted"] and outs[0]["rounds"] == 4
    step = tmp_path / "run" / "checkpoints" / "acco" / f"step_{outs[0]['count_grad_tot']}"
    assert sorted(os.listdir(step / "state")) == ["rank_0.pt", "rank_1.pt"]
    assert (step / "meta.json").exists()
