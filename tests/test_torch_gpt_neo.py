"""The port's GPT-Neo against the JAX GPTNeoModel, and the weight carry-over.

Model: the JAX banded-kernel suite's GPT-Neo (tests/test_banded_attention.py:
vocab 128, hidden 128, ffn 256, 2 heads of 64, one global and one local
layer, window 64, ids [2, 128]), float32 on both sides. With
attention='fused' the JAX side runs its Pallas kernels in interpret mode
(ACCO_FUSED_ATTN_INTERPRET=1): the full kernel on the global layer and
the banded kernel on the local one; the port runs the plain versions of
K1 and K2. The weights are the JAX init carried across by
models/convert.py.

Tolerances: logits at 1e-4 (atol and rtol), the JAX suite's model-level
bar for its Llama kernel comparison; flat gradients at atol 2e-4 / rtol
2e-3, its bar for the GPT-Neo fused-vs-einsum gradients
(tests/test_banded_attention.py); the loss at rtol 1e-5. Both stacks sum
float32 products in their own order through LayerNorm, GELU and the CE.
The weight round trip is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.ops.losses import causal_lm_loss as jax_causal_lm_loss
from acco_tpu_torch.models import gpt_neo
from acco_tpu_torch.models.convert import params_from_jax, params_to_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel, param_layout
from acco_tpu_torch.parallel.common import make_flat_loss_fn
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(
    vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=2, max_position_embeddings=128, window_size=64,
    attention_layers=("global", "local"),
)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)


def _jax_model(attention, arch=ARCH):
    cfg = JaxGPTNeoConfig(**{**arch, "attention_layers": list(arch["attention_layers"])})
    return JaxGPTNeoModel(cfg, param_dtype=jnp.float32, attention=attention)


@pytest.fixture(scope="module")
def setup():
    params = _jax_model("xla").init(jax.random.PRNGKey(3))
    ids = np.random.default_rng(2).integers(0, ARCH["vocab_size"], (2, 128)).astype(np.int32)
    return jax.tree.map(np.asarray, params), ids


def _port_model(params, attention, cfg=GPTNeoConfig(**ARCH)):
    model = GPTNeoModel(cfg, dtype=torch.float32, attention=attention, device="cpu")
    flat = params_from_jax(params, cfg)
    model.load_flat(flat)
    return model, flat


@pytest.fixture
def calls(monkeypatch):
    """Counts of the model's attention calls, by kernel and window."""
    seen = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen.append((name, kwargs.get("window")))
            return fn(*args, **kwargs)

        monkeypatch.setattr(gpt_neo, name, wrapped)

    spy("fused_dot_product_attention", gpt_neo.fused_dot_product_attention)
    spy("banded_dot_product_attention", gpt_neo.banded_dot_product_attention)
    return seen


def test_flat_order_equals_ravel_pytree(setup):
    params, _ = setup
    cfg = GPTNeoConfig(**ARCH)
    flat_j, _ = ravel_pytree(params)
    flat_t = params_from_jax(params, cfg)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert [p for p, _, _ in param_layout(cfg)] == [
        "/".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
    ]
    back = params_to_jax(flat_t, cfg)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_init_fills_match_jax(setup):
    """Ones for the LayerNorm scales, zeros for every bias, draws with the
    init std elsewhere, leaf by leaf as the JAX init does; and the full
    GPT-Neo-125M architecture has the JAX model's parameter count."""
    params, _ = setup
    cfg = GPTNeoConfig(**ARCH)
    model = GPTNeoModel(cfg, dtype=torch.float32)
    flat = model.init_flat(torch.Generator().manual_seed(0))
    for path, shape, offset in param_layout(cfg):
        got = flat[offset : offset + int(np.prod(shape))].numpy()
        want = params["layers"][path[7:]] if path.startswith("layers/") else params[path]
        if np.all(want == want.flat[0]):
            np.testing.assert_array_equal(got, want.reshape(-1), err_msg=path)
        else:
            assert abs(got.std() - cfg.initializer_range) < 0.1 * cfg.initializer_range, path
    neo = GPTNeoConfig.from_json(os.path.join(REPO, "config", "model", "gpt-neo-125M.json"))
    assert GPTNeoModel(neo, device="meta").n_params == 124_412_160
    assert neo.layer_windows == [0, 256] * 6 and neo.ffn_dim == 3072


def _loss_and_grads_jax(model, params, ids, mask=None):
    def loss(p):
        logits = model.apply(p, jnp.asarray(ids), None if mask is None else jnp.asarray(mask))
        return jax_causal_lm_loss(logits, jnp.asarray(ids))

    # jitted: the interpreted Pallas kernels then run as compiled XLA, not
    # op by op from Python (the same function; half the time alone)
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), np.asarray(ravel_pytree(grads)[0])


def _loss_and_grads_port(model, flat, ids):
    ids_t = torch.tensor(ids, dtype=torch.long)
    loss, grads = make_flat_loss_fn(model, const_len=True)(
        flat, {"input_ids": ids_t, "attention_mask": torch.ones_like(ids_t), "labels": ids_t}
    )
    return float(loss), model.gather_grads(grads, torch.zeros(model.n_params)).numpy()


@pytest.mark.parametrize("attention", ["fused", "xla"])
def test_logits_and_gradients_match_jax(setup, calls, monkeypatch, attention):
    """'fused': the global layer through K1's plain version, the local one
    through K2's, as the JAX model sends them to its two kernels; 'xla':
    the plain path on both sides."""
    params, ids = setup
    monkeypatch.setenv("ACCO_FUSED_ATTN_INTERPRET", "1")
    model_j = _jax_model(attention)
    logits_j = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(ids)))
    loss_j, grads_j = _loss_and_grads_jax(model_j, params, ids)

    model_t, flat = _port_model(params, attention)
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long))
    expected = (
        [("fused_dot_product_attention", 0), ("banded_dot_product_attention", 64)]
        if attention == "fused" else []
    )
    assert calls == expected
    loss_t, grads_t = _loss_and_grads_port(model_t, flat, ids)
    assert calls == expected * 2
    np.testing.assert_allclose(logits_t.numpy(), logits_j, **LOGIT_TOL)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    np.testing.assert_allclose(grads_t, grads_j, **GRAD_TOL)


def test_padded_batch_takes_k1_with_each_window(setup, calls, monkeypatch):
    """A right-padded attention mask (const_len_batch=false): every layer
    runs K1 with its own window and the mask, on both sides; the logits of
    the real rows agree."""
    params, ids = setup
    monkeypatch.setenv("ACCO_FUSED_ATTN_INTERPRET", "1")
    mask = np.ones_like(ids)
    mask[0, 100:] = 0
    mask[1, 60:] = 0
    logits_j = np.asarray(_jax_model("fused").apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    model_t, _ = _port_model(params, "fused")
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long), torch.tensor(mask))
    assert calls == [("fused_dot_product_attention", 0), ("fused_dot_product_attention", 64)]
    real = mask.astype(bool)
    np.testing.assert_allclose(logits_t.numpy()[real], logits_j[real], **LOGIT_TOL)


def test_tiny_neo_auto_matches_jax():
    """config/model/tiny_neo.json (head_dim 16, window 16, four layers)
    with attention='auto': the plain path on both sides."""
    path = os.path.join(REPO, "config", "model", "tiny_neo.json")
    model_j = JaxGPTNeoModel(JaxGPTNeoConfig.from_json(path), param_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(5)))
    ids = np.random.default_rng(4).integers(0, 257, (2, 64)).astype(np.int32)
    logits_j = np.asarray(model_j.apply(params, jnp.asarray(ids)))
    model_t, _ = _port_model(params, "auto", GPTNeoConfig.from_json(path))
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(logits_t.numpy(), logits_j, **LOGIT_TOL)


def test_unported_options_raise():
    cfg = GPTNeoConfig(**ARCH)
    with pytest.raises(ValueError, match="flash"):
        GPTNeoModel(cfg, attention="flash")
    # context parallelism is ported (a sequence group); the ring needs one
    with pytest.raises(ValueError, match="requires a sequence group"):
        GPTNeoModel(cfg, attention="ring")
    # tensor parallelism is ported (a tensor group); with the ring (tp x sp,
    # item 9.4) the ring runs the shard's heads, and a pad below the vocab
    # is refused
    from acco_tpu_torch.models.layers import TensorGroup

    ring = GPTNeoModel(cfg, attention="ring", sequence_group=object(),
                       tensor_group=TensorGroup(None, 2, 0))
    assert ring.n_heads == cfg.num_heads // 2 and ring.sequence_group is not None
    with pytest.raises(ValueError, match="vocab_pad_to"):
        GPTNeoModel(cfg, vocab_pad_to=cfg.vocab_size - 1)
    assert GPTNeoModel(cfg, vocab_pad_to=256).wte.shape[0] == 256
