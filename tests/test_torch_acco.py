"""The port's ACCO and DPU rounds against the JAX AccoTrainStep.

Both run one rank (the JAX side on a one-device CPU mesh) from the same
initial params over the same microbatch blocks (numpy, seeded): the seed
round and 6 rounds, for a tiny Llama (GQA) and a tiny GPT-Neo (one global
and one local layer, window 4; its zero biases and LayerNorms in the flat
layout). Compared after every round: the working
``flat_params``, the ZeRO-1 master params and Adam moments, the loss, the
LR and ``is_real_update``. Everything is float32.

Tolerance: rtol 2e-4 / atol 2e-6, the bar of tests/test_acco.py's
simulator trajectory check; the moments get the same bar. The loss is
compared at rtol 1e-5. The guard case is bit-exact: a skipped round must
leave params and optimizer state unchanged to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

ARCH = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=2, num_kv_heads=1, max_position_embeddings=16,
)
NEO_ARCH = dict(
    vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
    max_position_embeddings=16, window_size=4,
)
NEO_LAYERS = ("global", "local")
# family -> (JAX config, JAX model, port config, port model)
# a Llama inside the fused CE's envelope (hidden and vocab >= 128)
ARCH_128 = dict(ARCH, vocab_size=128, hidden_size=128)
FAMILIES = {
    "llama": lambda: (JaxLlamaConfig(**ARCH), JaxLlamaModel, LlamaConfig(**ARCH), LlamaModel),
    "llama_h128": lambda: (
        JaxLlamaConfig(**ARCH_128), JaxLlamaModel, LlamaConfig(**ARCH_128), LlamaModel,
    ),
    "gpt_neo": lambda: (
        JaxGPTNeoConfig(**NEO_ARCH, attention_layers=list(NEO_LAYERS)), JaxGPTNeoModel,
        GPTNeoConfig(**NEO_ARCH, attention_layers=NEO_LAYERS), GPTNeoModel,
    ),
}
N_ACC, BATCH, SEQ, ROUNDS = 2, 2, 16, 6
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
TOL = dict(rtol=2e-4, atol=2e-6)


def _blocks(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, ARCH["vocab_size"], (N_ACC, BATCH, SEQ)).astype(np.int32)
        out.append({
            "input_ids": ids,
            "attention_mask": np.ones_like(ids),
            "labels": ids,
            "valid": np.ones((N_ACC,), np.float32),
        })
    return out


def _jax_block(block):
    b = {k: jnp.asarray(v) for k, v in block.items()}
    b["valid"] = b["valid"][:, None]  # [n_acc, world_size]
    return b


def _setup(mode, family="llama", fused_loss=False):
    jcfg, jmodel_cls, cfg, model_cls = FAMILIES[family]()
    jmodel = jmodel_cls(jcfg, param_dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0))
    jstep = JaxAccoTrainStep(
        jmodel, make_mesh(devices=jax.devices()[:1]), jax_get_schedule(*SCHED),
        param_dtype=jnp.float32, mode=mode, fused_loss=fused_loss, **OPT,
    )
    jstate = jstep.init_state(params)
    model = model_cls(cfg, dtype=torch.float32, device="cpu")
    step = AccoTrainStep(model, get_schedule(*SCHED), mode=mode, fused_loss=fused_loss, **OPT)
    assert step.value_and_grad.fused_loss == (fused_loss or False)
    state = step.init_state(params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jstep, jstate, step, state


def _assert_states_close(jstate, state, what):
    pairs = {
        "flat_params": (jstate.flat_params, state.flat_params),
        "opt.params": (jstate.zero1.opt.params, state.zero1.opt.params),
        "opt.mu": (jstate.zero1.opt.mu, state.zero1.opt.mu),
        "opt.nu": (jstate.zero1.opt.nu, state.zero1.opt.nu),
    }
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(
            b.numpy(), np.asarray(a), err_msg=f"{what}: {name}", **TOL  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        )
    assert int(state.zero1.opt.count) == int(jstate.zero1.opt.count), what


@pytest.mark.parametrize(
    "family, mode, fused_loss",
    [
        pytest.param("llama", "acco", False, id="acco"),
        pytest.param("llama", "dpu", False, id="dpu"),
        pytest.param("gpt_neo", "acco", False, id="gpt_neo-acco"),
        pytest.param("gpt_neo", "dpu", False, id="gpt_neo-dpu"),
        # the fused CE: JAX's Pallas kernel in interpret mode, the port's plain version
        pytest.param("llama_h128", "acco", "pallas", id="acco-fused_loss_pallas"),
    ],
)
def test_rounds_match_jax(family, mode, fused_loss, monkeypatch):
    monkeypatch.setenv("ACCO_FUSED_CE_INTERPRET", "1")
    jstep, jstate, step, state = _setup(mode, family, fused_loss)
    # the fused case compiles JAX's interpreted kernel into each program:
    # one even and one odd round cover both of them
    rounds = 2 if fused_loss else ROUNDS
    blocks = _blocks(rounds + 1)
    jstate, jloss = jstep.seed_fn()(jstate, _jax_block(blocks[0]))
    state, loss = step.seed(state, block_from_numpy(blocks[0], "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(
        state.pending_grads.numpy(), np.asarray(jstate.pending_grads), **TOL
    )
    for r in range(rounds):
        parity = r % 2 == 0
        jstate, jm = jstep.round_fn(parity=parity)(jstate, _jax_block(blocks[r + 1]))
        state, m = step.round(state, block_from_numpy(blocks[r + 1], "cpu"), parity)
        what = f"{family} {mode} {fused_loss} round {r}"
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(float(m.lr), float(jm.lr), rtol=1e-6, err_msg=what)
        assert bool(m.is_real_update) == bool(jm.is_real_update), what
        assert bool(m.is_real_update) == (r % 2 == 1 if mode == "acco" else True), what
        _assert_states_close(jstate, state, what)
    assert int(state.zero1.opt.count) == (rounds // 2 if mode == "acco" else rounds)
    assert float(state.zero1.grads_committed) == float(jstate.zero1.grads_committed)


def test_poisoned_batch_is_a_bit_exact_skip():
    """A NaN microbatch weight in round 2 poisons the grads that round
    stages; round 3's update consumes them and the guard refuses it: the
    working params and the optimizer state stay bit-exact, the skip is
    counted, round 4 drops the poisoned carry-in, and the JAX step makes
    the same calls."""
    jstep, jstate, step, state = _setup("acco")
    blocks = _blocks(6, seed=3)
    blocks[3]["valid"] = np.array([np.nan, 1.0], np.float32)  # round 2's block
    jstate, _ = jstep.seed_fn()(jstate, _jax_block(blocks[0]))
    state, _ = step.seed(state, block_from_numpy(blocks[0], "cpu"))
    real = []
    for r in range(5):
        before = state
        parity = r % 2 == 0
        jstate, jm = jstep.round_fn(parity=parity)(jstate, _jax_block(blocks[r + 1]))
        state, m = step.round(state, block_from_numpy(blocks[r + 1], "cpu"), parity)
        real.append(bool(m.is_real_update))
        assert bool(m.skipped) == bool(jm.skipped) == (r == 3)
        assert bool(m.is_real_update) == bool(jm.is_real_update)
        if r == 3:
            assert torch.equal(state.flat_params, before.flat_params)
            for new, old in zip(state.zero1.opt, before.zero1.opt):
                assert torch.equal(new, old)
            assert float(state.zero1.grads_committed) == float(before.zero1.grads_committed)
        _assert_states_close(jstate, state, f"guard round {r}")
    assert real == [False, True, False, False, False]
    assert int(state.health.skipped_rounds) == int(jstate.health.skipped_rounds) == 1


@pytest.mark.parametrize("pad", [False, True])
def test_chunked_zero1_update_equals_one_chunk(pad, monkeypatch):
    """The ZeRO-1 step updates the shard chunk by chunk (memory at 1.5e9
    parameters); every element gets the same arithmetic as in one chunk,
    so params, moments and the bf16 flat are bit-equal, and the health
    verdict and gradient norm agree (the norm's sum is taken per chunk)."""
    from acco_tpu_torch.ops.adamw import init_adamw_state
    from acco_tpu_torch.parallel import zero1

    rng = np.random.default_rng(5)
    n = 1000
    geom = zero1.ShardGeometry(n - 3 if pad else n, 1)
    flat = torch.tensor(rng.standard_normal(n).astype(np.float32))
    opt = init_adamw_state(flat)
    opt = opt._replace(mu=opt.mu + 0.1, count=opt.count + 3)
    grads = torch.tensor(rng.standard_normal(n).astype(np.float32))
    args = (grads, opt, torch.tensor(2.0), torch.tensor(1e-3), geom, 0.1, 0.9, 0.95)
    whole = zero1.zero1_update_shard(*args, with_health=True)
    monkeypatch.setattr(zero1, "CHUNK", 96)
    chunked = zero1.zero1_update_shard(*args, with_health=True)
    torch.testing.assert_close(chunked[0], whole[0], rtol=0, atol=0)
    for got, want in zip(chunked[1], whole[1]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool(chunked[2].ok) and bool(whole[2].ok)
    torch.testing.assert_close(chunked[2].grad_norm, whole[2].grad_norm, rtol=1e-6, atol=0)
