"""The port's DDP step (``parallel/ddp.py``) against the JAX package.

- One step on 2 gloo ranks against the unsharded math of
  tests/test_ddp.py (the gradient averaged over every microbatch of the
  global block, JAX's ``jax.grad``, then the first AdamW step) at its
  bars (rtol 5e-4 / atol 1e-5), and its heterogeneous-mask case.
- Three steps at {dp: 2} and {dp: 2, sp: 2} against JAX's
  ``DDPTrainStep`` on as many virtual CPU devices: the loss at rtol 1e-5
  / atol 1e-6, the parameters and each rank's optimizer shard at rtol
  1e-4 / atol 1e-5; with ``lr_grad_accounting`` the schedule advances by
  the count.
- The guard at one rank: a poisoned microbatch makes the step a bit-exact
  no-op, as in JAX; and ``torchrun ... train=ddp "train.mesh_shape={dp:
  2}"`` end to end.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.common import make_flat_loss_fn as jax_flat_loss_fn
from acco_tpu.parallel.ddp import DDPTrainStep as JaxDDPTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.models.convert import params_to_jax
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.common import block_from_numpy
from acco_tpu_torch.parallel.ddp import DDPTrainStep
import torch_ranks
from torch_ranks import REPO, start_training

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

N_ACC, BATCH, SEQ = 2, 2, 32
ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_position_embeddings=SEQ)
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _blocks(n, dp, seed=0, valid=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, ARCH["vocab_size"], (N_ACC, dp * BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((N_ACC, dp), np.float32) if valid is None
                    else np.asarray(valid, np.float32)})
    return out


def _spec(dp, sp=1, rounds=1, sched=SCHED, accounting=False):
    return dict(family="llama", arch=ARCH, dp=dp, sp=sp, zigzag=True, method="ddp",
                sched=sched, opt=OPT, rounds=rounds, batch=BATCH, lr_grad_accounting=accounting)


def _flat():
    return LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32).init_flat(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("valid", [None, [[1, 1], [1, 0]]], ids=["all-valid", "mask"])
def test_one_step_matches_unsharded_math(valid, tmp_path):
    """tests/test_ddp.py's hand computation (:96, and its mask case :136):
    the gradient averaged over the valid microbatches of the global block
    at the initial parameters, then AdamW's first step (the bias
    corrections cancel: mu_hat = g, nu_hat = g^2)."""
    dp, lr = 2, 1e-3
    flat = _flat()
    blocks = _blocks(1, dp, seed=5, valid=valid)
    spec = _spec(dp, sched=("constant", lr, 0, 1000))
    ranks = start_training(spec, flat.numpy(), blocks, tmp_path)  # beside JAX's math

    params = params_to_jax(flat, LlamaConfig(**ARCH))
    jflat, unravel = ravel_pytree(params)
    model = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32)
    loss_fn = jax_flat_loss_fn(model, unravel, jflat.size, 0.0)
    grad = jax.jit(jax.grad(loss_fn))
    total_g, count = np.zeros(jflat.size, np.float32), 0
    b = blocks[0]
    for a in range(N_ACC):
        for d in range(dp):
            if not b["valid"][a, d]:
                continue
            rows = slice(d * BATCH, (d + 1) * BATCH)
            mb = {k: jnp.asarray(b[k][a, rows]) for k in ("input_ids", "attention_mask", "labels")}
            total_g += np.asarray(grad(jflat, mb), np.float32)
            count += 1
    g_avg = total_g / count
    expected = np.asarray(jflat) * (1 - lr * OPT["weight_decay"]) - lr * g_avg / (
        np.sqrt(g_avg ** 2) + 1e-8)
    n = flat.numel()
    for r, got in enumerate(ranks()):
        assert got["round_grads"][0] == count == (4 if valid is None else 3)
        np.testing.assert_allclose(got["flats"][1][:n], expected, rtol=5e-4, atol=1e-5,
                                   err_msg=f"rank {r}")
        assert not got["flats"][1][n:].any()  # the padded tail stays 0
        assert got["sched"][1] == 1 and got["committed"][1] == count


def _jax_ddp(spec, flat, blocks):
    sp = spec["sp"]
    kw = dict(attention="ring", sequence_axis="sp", zigzag=spec["zigzag"]) if sp > 1 else {}
    model = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32, **kw)
    shape = {"dp": spec["dp"], "sp": sp} if sp > 1 else {"dp": spec["dp"]}
    step = JaxDDPTrainStep(
        model, make_mesh(shape, devices=jax.devices()[:spec["dp"] * sp]),
        jax_get_schedule(*spec["sched"]), param_dtype=jnp.float32,
        seq_axis="sp" if sp > 1 else None, lr_grad_accounting=spec["lr_grad_accounting"],
        **spec["opt"])
    state = step.init_state(params_to_jax(flat, LlamaConfig(**ARCH)))
    out = {"losses": [], "lrs": [], "round_grads": [], "states": []}
    for b in blocks:
        state, m = step.step_fn()(state, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(m.loss))
        out["lrs"].append(float(m.lr))
        out["round_grads"].append(float(m.grads_this_step))
        out["states"].append(jax.tree.map(np.asarray, state))
    return out


@pytest.mark.parametrize(
    "dp, sp, accounting",
    [(2, 1, False), (2, 2, False), (2, 1, True)],
    ids=["dp2", "dp2-sp2", "dp2-lr_grad_accounting"],
)
def test_ddp_matches_jax(dp, sp, accounting, tmp_path):
    steps = 3
    flat = _flat()
    valid = [[1, 1], [0, 1]] if accounting else None
    blocks = _blocks(steps, dp, seed=2, valid=valid)
    spec = _spec(dp, sp, rounds=steps, accounting=accounting)
    ranks = start_training(spec, flat.numpy(), blocks, tmp_path)  # beside JAX's steps
    want = _jax_ddp(spec, flat, blocks)
    ranks = ranks()
    n, final = flat.numel(), want["states"][-1]
    S = ranks[0]["opt_params"].shape[-1]
    for r, got in enumerate(ranks):
        what = f"rank {r} of {{dp: {dp}, sp: {sp}}}"
        np.testing.assert_allclose(got["losses"], want["losses"], err_msg=what, **LOSS_TOL)
        np.testing.assert_allclose(got["lrs"], want["lrs"], rtol=1e-6, err_msg=what)
        assert list(got["round_grads"]) == want["round_grads"], what
        assert list(got["real"]) == [True] * steps
        for i, jstate in enumerate(want["states"]):
            np.testing.assert_allclose(got["flats"][i + 1][:n], jstate.flat_params[:n],
                                       err_msg=f"{what}: params after step {i}", **PARAM_TOL)
        for name, leaf in (("opt_params", final.zero1.opt.params), ("mu", final.zero1.opt.mu),
                           ("nu", final.zero1.opt.nu)):
            np.testing.assert_allclose(got[name][-1], leaf[r * S:(r + 1) * S],
                                       err_msg=f"{what}: {name} shard", **PARAM_TOL)
        assert got["sched"][-1] == int(final.zero1.sched_grads), what
        assert got["committed"][-1] == float(final.zero1.grads_committed), what
    assert int(final.zero1.sched_grads) == (3 * steps if accounting else steps)


def test_poisoned_step_is_a_bit_exact_skip():
    """A NaN microbatch weight: the step commits nothing (parameters, the
    optimizer shard, the schedule and the committed count stay to the
    bit), the skip is counted, and JAX's step makes the same call."""
    model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32)
    step = DDPTrainStep(model, get_schedule(*SCHED), **OPT)
    state = step.init_state(_flat())
    jstep = JaxDDPTrainStep(
        JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32),
        make_mesh(devices=jax.devices()[:1]), jax_get_schedule(*SCHED), param_dtype=jnp.float32,
        **OPT)
    jstate = jstep.init_state(params_to_jax(_flat(), LlamaConfig(**ARCH)))
    blocks = _blocks(3, 1, seed=4)
    blocks[1]["valid"] = np.array([[np.nan], [1.0]], np.float32)
    for i, b in enumerate(blocks):
        before = state
        state, m = step.step(state, block_from_numpy(dict(b, valid=b["valid"][:, 0]), "cpu"))
        jstate, jm = jstep.step_fn()(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        assert bool(m.skipped) == bool(jm.skipped) == (i == 1)
        if i == 1:
            assert torch.equal(state.flat_params, before.flat_params)
            for new, old in zip(state.zero1.opt, before.zero1.opt):
                assert torch.equal(new, old)
            assert torch.equal(state.zero1.sched_grads, before.zero1.sched_grads)
            assert torch.equal(state.zero1.grads_committed, before.zero1.grads_committed)
        np.testing.assert_allclose(state.flat_params.numpy(), np.asarray(jstate.flat_params),  # lint: host-sync-ok: a CPU tensor read in an assertion loop
                                   err_msg=f"step {i}", **PARAM_TOL)
    assert int(state.health.skipped_rounds) == int(jstate.health.skipped_rounds) == 1
    assert int(state.zero1.sched_grads) == int(jstate.zero1.sched_grads) == 2


def test_torchrun_cli_runs_ddp_on_cpu(tmp_path):
    """``torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu
    train=ddp ... train.mesh_shape={dp: 2}`` trains to its summary: every
    step is an update of the two ranks' micro-grads, with no seed round."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "acco_tpu_torch", "--device", "cpu", "train=ddp", "model=tiny128",
         "data=synthetic", "train.max_length=128", "train.batch_size=2",
         "train.nb_steps_tot=6", "train.mesh_shape={dp: 2}", f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summaries = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1, out.stdout[-2000:]
    summary = json.loads(summaries[0])
    assert summary["method"] == "ddp" and summary["mesh"] == {"dp": 2, "sp": 1}
    assert summary["seed_loss"] is None and summary["rounds"] == 3
    assert summary["count_grad_tot"] == 6 and summary["skipped_rounds"] == 0
    assert all(r["is_real_update"] and abs(r["loss"]) < 100 for r in summary["round_log"])
