"""Exact resume, the logging cadence, the watchdog's escalation and
ACCO's DPU warmup of the port's ``Trainer``.

- Exact resume, the counterpart of ``tests/test_trainer.py::
  test_exact_resume_matches_uninterrupted`` and ``::test_restore_is_
  bitexact``: run A goes uninterrupted to N2 grads; run B stops at N1 with
  its final save; run C resumes from B's checkpoint root to N2. C's final
  flat params, optimizer shard and health counters are bit-equal to A's
  (``assert_array_equal``), and so are its round losses. ``dpu``,
  ``acco`` (stopped on a commit, its pending grads in flight) and ``ddp``
  stop mid-epoch; ``acco`` with ``n_warmup_steps=2`` stops exactly on an
  epoch boundary. A torn ``step_*`` newer than B's is skipped by the root
  and raises when named. One ``acco`` case runs on 2 gloo ranks (each
  rank's optimizer shard and loader position restored), where a dp-1
  checkpoint is refused as another mesh.
- The cadence: rounds read back every round and every 10 grads leave
  the same state and the same logged values; the watchdog escalates at the
  boundary that reads ``rollback_after_skipped`` consecutive skips: a
  rollback with nothing saved raises, ``rollback: false`` aborts (the
  rollback itself: tests/test_torch_robustness.py).
- The DPU warmup: the port's ``acco`` run with ``n_warmup_steps=2``
  against the JAX steps that ``acco_tpu/trainer.py:1137-1160`` runs (the
  DPU seed and 2 DPU rounds, ``round_idx`` reset, ACCO rounds) from the
  same init on the same blocks: the losses at tests/test_acco.py:154's
  bar (rtol 2e-4 / atol 2e-6), the final parameters at the bar the port's
  other JAX-vs-port parameter checks use (rtol 1e-4 / atol 1e-5,
  tests/test_context_parallel.py:67,73). At the simulator's bar 2 of the
  26,816 parameters miss by up to 5.2e-6 after 8 AdamW updates at lr
  3e-3: both stacks sum float32 products in their own order, and AdamW's
  m / sqrt(v) magnifies that on gradients near zero (the simulator's
  reference is one float64 stack, not a second model).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.convert import params_to_jax
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.trainer import Trainer
import torch_ranks
from torch_ranks import run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

ARCH = dict(vocab_size=257, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_position_embeddings=32)
BATCH, SEQ = 2, 32
# 7 documents of 63 bytes + EOS: 14 packed rows of 32, 7 batches an epoch
TEXTS = ["".join(np.random.default_rng(i).choice(list("abcdefghij "), 63)) for i in range(7)]
SIM_TOL = dict(rtol=2e-4, atol=2e-6)  # tests/test_acco.py:154
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_context_parallel.py:67,73


def _args(method, nb, **over):
    base = dict(method_name=method, batch_size=BATCH, max_length=SEQ, nb_steps_tot=nb,
                const_len_batch=True, scheduler_name="constant", learning_rate=3e-3,
                weight_decay=0.1, adam_beta1=0.9, adam_beta2=0.95, save=False,
                checkpoint_every_s=1e9, ckpt_async=False, n_warmup_steps=0, run_name=method)
    base.update(over)
    return ConfigNode.wrap(base)


def _trainer(method, nb, run_dir, **over):
    model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32)
    return Trainer(model, load_tokenizer("byte"), TEXTS, None, _args(method, nb, **over),
                   seed=3, run_dir=str(run_dir))


def _leaves(state):
    out = {}
    for name, value in zip(state._fields, state):
        if isinstance(value, tuple):
            out.update({f"{name}/{k}": v for k, v in _leaves(value).items()})
        else:
            out[name] = value.numpy()  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    return out


def _torn_newer(root, step):
    """A copy of ``step`` under a higher step number with its rank file
    cut short: a save that died after its commit."""
    torn = os.path.join(root, "step_99")
    shutil.copytree(step, torn)
    rank0 = os.path.join(torn, "state", "rank_0.pt")
    with open(rank0, "r+b") as f:
        f.truncate(os.path.getsize(rank0) - 10)
    return torn


@pytest.mark.parametrize(
    "method, n1, n2, over",
    [
        pytest.param("dpu", 3, 6, {}, id="dpu-mid-epoch"),
        pytest.param("acco", 4, 8, {}, id="acco-on-a-commit"),
        pytest.param("ddp", 3, 6, {}, id="ddp-mid-epoch"),
        pytest.param("acco", 6, 10, {"n_warmup_steps": 2}, id="acco-warmup-epoch-end"),
    ],
)
def test_resume_is_bit_exact(tmp_path, method, n1, n2, over):
    a = _trainer(method, n2, tmp_path / "a", **over)
    sa = a.train()
    b = _trainer(method, n1, tmp_path / "b", save=True, **over)
    sb = b.train()
    root = str(tmp_path / "b" / "checkpoints" / method)
    meta = json.load(open(os.path.join(sb["checkpoint"], "meta.json")))
    assert meta["count_grad_tot"] == n1 and meta["mesh"] == {"dp": 1, "sp": 1}
    blocks = (method != "ddp") + over.get("n_warmup_steps", 0) + sb["rounds"]
    assert meta["loader"] == {"epoch": (blocks - 1) // 7, "batch_pos": (blocks - 1) % 7 + 1}
    torn = _torn_newer(root, sb["checkpoint"])
    with pytest.raises(ValueError, match="not restorable.*truncated"):
        _trainer(method, n2, tmp_path / "t", resume_from=torn, **over).train()

    c = _trainer(method, n2, tmp_path / "c", resume_from=root, **over)
    sc = c.train()
    assert sc["seed_loss"] is None and sc["count_grad_tot"] == sa["count_grad_tot"] == n2
    assert sc["rounds"] == sa["rounds"]
    la, lc = _leaves(a.final_state), _leaves(c.final_state)
    assert la.keys() == lc.keys()
    for key in la:
        np.testing.assert_array_equal(lc[key], la[key], err_msg=key)
    tail = [r["loss"] for r in sa["round_log"][-len(sc["round_log"]):]]
    assert [r["loss"] for r in sc["round_log"]] == tail
    assert sb["round_log"] == [dict(r, ms=s["ms"]) for r, s in
                               zip(sa["round_log"], sb["round_log"])]


def test_cadence_leaves_the_rounds_bit_equal(tmp_path):
    """``delta_step_for_log`` 1 (every round read back) and 10 (one read
    at the end of these 8 rounds): the same final state bit for bit, the
    same logged losses, LRs and ``is_real_update``, the same count."""
    runs = []
    for cadence in (1, 10):
        trainer = _trainer("acco", 8, tmp_path / str(cadence), delta_step_for_log=cadence)
        runs.append((trainer, trainer.train()))
    (a, sa), (b, sb) = runs
    la, lb = _leaves(a.final_state), _leaves(b.final_state)
    for key in la:
        np.testing.assert_array_equal(lb[key], la[key], err_msg=key)
    logged = [[{k: r[k] for k in ("round", "loss", "lr", "is_real_update")}
               for r in s["round_log"]] for s in (sa, sb)]
    assert logged[0] == logged[1] and len(logged[0]) == 8
    assert [r["is_real_update"] for r in sa["round_log"]] == [False, True] * 4
    assert sa["count_grad_tot"] == sb["count_grad_tot"] == 8
    assert sa["seed_loss"] == sb["seed_loss"]


@pytest.mark.parametrize("rollback, error, match", [
    pytest.param(True, RuntimeError, "no complete checkpoint .* recovery needs save=True",
                 id="True-NotImplementedError-rollback .*not ported yet: ROADMAP.md queue 1, "
                    "item 8 \\(robustness\\)"),
    (False, RuntimeError, "rollback=False — aborting"),
])
def test_watchdog_escalation_raises(tmp_path, rollback, error, match):
    """A grad-norm cap no round meets: every round is guard-skipped, and at
    the boundary that reads ``rollback_after_skipped`` (2) consecutive
    skips the watchdog escalates. With ``rollback: true`` it rolls back,
    and with ``save`` off there is no checkpoint to roll back to: a
    RuntimeError, as JAX's ``test_escalation_without_checkpoint_raises``
    (the case once raised NotImplementedError, and keeps that id);
    ``rollback: false`` aborts as JAX does. Nothing runs on in silence."""
    trainer = _trainer("dpu", 8, tmp_path, guard_max_grad_norm=1e-12, rollback=rollback,
                       rollback_after_skipped=2, delta_step_for_log=1)
    with pytest.raises(error, match=match):
        trainer.train()


RANK_WORKER = """
import json
import numpy as np
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel.mesh import Mesh, RankGroups
from acco_tpu_torch.trainer import Trainer

spec = json.load(open(os.path.join(WORKDIR, "spec.json")))
groups, _ = RankGroups.build({"dp": 2}, RANK)
mesh = Mesh(dp=2, sp=1, rank=RANK, device=torch.device("cpu"), groups=groups)

def run(nb, name, **over):
    args = dict(spec["args"], nb_steps_tot=nb, **over)
    model = LlamaModel(LlamaConfig(**spec["arch"]), dtype=torch.float32)
    trainer = Trainer(model, load_tokenizer("byte"), spec["texts"], None, ConfigNode.wrap(args),
                      seed=3, mesh=mesh, run_dir=os.path.join(WORKDIR, name))
    return trainer, trainer.train()

a, sa = run(spec["n2"], "a")
b, sb = run(spec["n1"], "b", save=True)
c, sc = run(spec["n2"], "c", resume_from=os.path.join(WORKDIR, "b", "checkpoints", "acco"))
try:
    run(spec["n2"], "d", resume_from=spec["dp1_checkpoint"])
    refused = ""
except ValueError as exc:
    refused = str(exc)
out = {}
for tag, t in (("a", a), ("c", c)):
    s = t.final_state
    out.update({f"{tag}_flat": s.flat_params.numpy(), f"{tag}_pending": s.pending_grads.numpy(),
                f"{tag}_mu": s.zero1.opt.mu.numpy(), f"{tag}_master": s.zero1.opt.params.numpy()})
out["a_losses"] = [r["loss"] for r in sa["round_log"][-len(sc["round_log"]):]]
out["c_losses"] = [r["loss"] for r in sc["round_log"]]
out["loader"] = json.dumps(b.source.iter_state())
out["refused"] = refused
np.savez(os.path.join(WORKDIR, f"out{RANK}.npz"), **out)
"""


def test_resume_on_two_ranks_is_bit_exact(tmp_path):
    """``acco`` at dp 2 on gloo ranks: each rank's flat params, pending
    grads and optimizer shard after the resume equal the uninterrupted
    run's; the ranks' shards have epochs of 4 and 3 batches, and each
    resumes at its own position; a dp-1 checkpoint raises as another mesh."""
    dp1 = _trainer("dpu", 2, tmp_path / "dp1", save=True).train()["checkpoint"]
    spec = dict(arch=ARCH, texts=TEXTS, n1=8, n2=16, dp1_checkpoint=dp1,
                args=dict(_args("acco", 0).to_container()))
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    run_ranks(RANK_WORKER, 2, tmp_path, timeout=180)
    positions = []
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        for key in ("flat", "pending", "mu", "master"):
            np.testing.assert_array_equal(out[f"c_{key}"], out[f"a_{key}"], err_msg=f"{r} {key}")
        np.testing.assert_array_equal(out["c_losses"], out["a_losses"])
        assert "saved on mesh {'dp': 1, 'sp': 1}" in str(out["refused"])
        positions.append(json.loads(str(out["loader"])))
    # 5 blocks (seed + 4 rounds) of epochs of 4 and 3 batches
    assert positions == [{"epoch": 1, "batch_pos": 1}, {"epoch": 1, "batch_pos": 2}]


def test_dpu_warmup_matches_jax(tmp_path):
    """``acco`` with ``n_warmup_steps=2`` from the port's init: its seed
    loss, warmup losses, ACCO round losses and final params against JAX's
    DPU seed and rounds, ``round_idx`` reset to 0, then JAX's ACCO rounds,
    on the blocks the port's loader gives."""
    n_rounds = 6
    trainer = _trainer("acco", 2 + n_rounds, tmp_path, n_warmup_steps=2)
    summary = trainer.train()
    assert len(summary["round_log"]) == n_rounds
    # the blocks the run consumed and its init, made again
    fresh = _trainer("acco", 1, tmp_path / "x")
    batches = infinite_batches(fresh.loader)
    blocks = [stack_microbatches(batches, 1) for _ in range(3 + n_rounds)]
    flat0 = fresh.model.init_flat(torch.Generator().manual_seed(3))

    model = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    kw = dict(param_dtype=jnp.float32, weight_decay=0.1, beta1=0.9, beta2=0.95)
    sched = jax_get_schedule("constant", 3e-3, 0, 8)
    warm = JaxAccoTrainStep(model, mesh, sched, mode="dpu", **kw)
    step = JaxAccoTrainStep(model, mesh, sched, mode="acco", **kw)
    # JAX's valid is [n_acc, dp]
    jb = [{k: jnp.asarray(v.reshape(1, 1) if k == "valid" else v) for k, v in b.items()}
          for b in blocks]
    state = step.init_state(params_to_jax(flat0, LlamaConfig(**ARCH)))
    # the warm step reuses the main step's layout (JAX: trainer.py:1143-1147)
    warm.geom, warm.unravel, warm.tp_layout = step.geom, step.unravel, step.tp_layout
    state, seed_loss = warm.seed_fn()(state, jb[0])
    warm_losses = []
    for i in (1, 2):
        state, m = warm.round_fn()(state, jb[i])
        warm_losses.append(float(m.loss))
    state = state._replace(round_idx=jnp.zeros((), jnp.int32))
    losses, real = [], []
    for i in range(n_rounds):
        state, m = step.round_fn()(state, jb[3 + i])
        losses.append(float(m.loss))
        real.append(bool(m.is_real_update))
    np.testing.assert_allclose(summary["seed_loss"], float(seed_loss), **SIM_TOL)
    np.testing.assert_allclose(summary["warmup_losses"], warm_losses, **SIM_TOL)
    np.testing.assert_allclose([r["loss"] for r in summary["round_log"]], losses, **SIM_TOL)
    assert [r["is_real_update"] for r in summary["round_log"]] == real == [False, True] * 3
    np.testing.assert_allclose(trainer.final_state.flat_params.numpy(),
                               np.asarray(state.flat_params), **PARAM_TOL)
    assert int(trainer.final_state.zero1.grads_committed) == int(
        state.zero1.grads_committed) == summary["count_grad_tot"] == 8


def test_eval_loader_and_epoch_end_position_match_jax():
    """The loader's ``shuffle=False, drop_last=False`` (the eval loader)
    yields JAX's batches, the ragged last one kept; the training loader's
    position after the last batch of an epoch is JAX's ``(epoch,
    len)``, and both resume from it into the next epoch's order."""
    from acco_tpu.data import loader as jax_loader
    from acco_tpu_torch.data import loader

    rows = [list(range(i, i + 5)) for i in range(7)]
    kw = dict(batch_size=2, max_length=6, pad_token_id=0)
    port = list(loader.ShardedBatchIterator(rows, shuffle=False, drop_last=False, **kw))
    ref = list(jax_loader.ShardedBatchIterator([{"input_ids": r} for r in rows], shuffle=False,
                                               drop_last=False, **kw))
    assert len(port) == len(ref) == 4 and port[-1]["input_ids"].shape == (1, 6)
    for got, want in zip(port, ref):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    its = [loader.ShardedBatchIterator(rows, seed=5, **kw),
           jax_loader.ShardedBatchIterator([{"input_ids": r} for r in rows], seed=5, **kw)]
    streams = [loader.infinite_batches(its[0]), jax_loader.infinite_batches(its[1])]
    for _ in range(3):  # one whole epoch of 3 batches
        [next(s) for s in streams]
    assert its[0].iter_state() == its[1].iter_state() == {"epoch": 0, "batch_pos": 3}
    resumed = loader.ShardedBatchIterator(rows, seed=5, **kw)
    resumed.set_state(its[0].iter_state())
    got = next(loader.infinite_batches(resumed))
    np.testing.assert_array_equal(got["input_ids"], next(streams[1])["input_ids"])
    assert resumed.iter_state() == {"epoch": 1, "batch_pos": 1}
