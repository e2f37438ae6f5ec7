"""The port's Llama against the JAX LlamaModel, and the weight carry-over.

Model: config/model/tiny128.json (head_dim 64, inside the fused kernel's
envelope), float32 on both sides, attention='fused': the JAX side runs
its Pallas kernel in interpret mode (ACCO_FUSED_ATTN_INTERPRET=1, as
tests/test_fused_attention.py does), the port its plain version. The
weights are the JAX init carried across by models/convert.py.

Tolerances: logits at 1e-4 and flat gradients at 1e-4 (atol and rtol) —
the JAX suite's own bar for the fused-vs-einsum model comparison
(tests/test_fused_attention.py), since both stacks sum float32 products
in their own order through two layers, RMSNorm and the CE. The weight
round trip is exact.
"""

import os

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.flatten_util import ravel_pytree

from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.losses import causal_lm_loss as jax_causal_lm_loss
from acco_tpu_torch.models.convert import params_from_jax, params_to_jax
from acco_tpu_torch.models.layers import lm_logits
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel, param_layout
from acco_tpu_torch.parallel.common import make_flat_loss_fn
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY128 = os.path.join(REPO, "config", "model", "tiny128.json")
LLAMA3_8B = os.path.join(REPO, "config", "model", "llama-3-8B.json")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = JaxLlamaConfig.from_json(TINY128)
    model = JaxLlamaModel(cfg, param_dtype=jnp.float32, attention="fused")
    params = model.init(jax.random.PRNGKey(1))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    return model, params, ids


def _port_model(jax_params, cfg):
    model = LlamaModel(cfg, dtype=torch.float32, attention="fused", device="cpu")
    flat = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg)
    model.load_flat(flat)
    return model, flat


def test_flat_order_equals_ravel_pytree(jax_setup):
    _, params, _ = jax_setup
    cfg = LlamaConfig.from_json(TINY128)
    flat_j, _ = ravel_pytree(params)
    flat_t = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    assert [p for p, _, _ in param_layout(cfg)] == [
        "/".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
    ]


def test_params_round_trip_exactly(jax_setup):
    _, params, _ = jax_setup
    cfg = LlamaConfig.from_json(TINY128)
    back = params_to_jax(params_from_jax(jax.tree.map(np.asarray, params), cfg), cfg)
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


def test_logits_match_jax(jax_setup, monkeypatch):
    model_j, params, ids = jax_setup
    monkeypatch.setenv("ACCO_FUSED_ATTN_INTERPRET", "1")
    logits_j = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(ids)))
    model_t, _ = _port_model(params, LlamaConfig.from_json(TINY128))
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(logits_t.numpy(), logits_j, **TOL)


def test_flat_gradients_match_jax(jax_setup, monkeypatch):
    model_j, params, ids = jax_setup
    monkeypatch.setenv("ACCO_FUSED_ATTN_INTERPRET", "1")

    def loss_j(p):
        return jax_causal_lm_loss(model_j.apply(p, jnp.asarray(ids)), jnp.asarray(ids))

    value_j, grads_j = jax.jit(jax.value_and_grad(loss_j))(params)
    flat_grad_j, _ = ravel_pytree(grads_j)

    cfg = LlamaConfig.from_json(TINY128)
    model_t, flat = _port_model(params, cfg)
    ids_t = torch.tensor(ids, dtype=torch.long)
    loss_t, grads_t = make_flat_loss_fn(model_t, const_len=True)(
        flat, {"input_ids": ids_t, "attention_mask": torch.ones_like(ids_t), "labels": ids_t}
    )
    flat_grad_t = model_t.gather_grads(grads_t, torch.zeros(model_t.n_params))
    np.testing.assert_allclose(float(loss_t), float(value_j), rtol=1e-5)
    np.testing.assert_allclose(flat_grad_t.numpy(), np.asarray(flat_grad_j), **TOL)


def test_lm_logits_float32_output_matches_jax_head():
    """The head product on bf16 operands: ``lm_logits`` gives the float32
    logits of JAX's ``einsum(..., preferred_element_type=jnp.float32)``
    (float32 sums of exact bf16 products, at rtol 1e-5), where the bf16
    product widened afterwards carries one bf16 rounding (2^-9 relative)
    and does not."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) * 0.2).astype(np.float32)
    want = np.asarray(jnp.einsum(
        "bld,dv->blv", jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ))
    ht, wt = (torch.tensor(x).to(torch.bfloat16) for x in (h, w))
    got = lm_logits(ht, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    widened = torch.matmul(ht, wt).float().numpy()
    assert not np.allclose(widened, want, rtol=1e-5, atol=1e-6)


def test_flash_route_matches_jax(jax_setup):
    """attention='flash': the port (K5's plain version) against JAX's
    ``LlamaModel(attention='flash')`` through the interpreted Pallas flash
    kernel, on the same params: logits, loss and flat gradients."""
    _, params, ids = jax_setup
    ids = ids[:1]  # one row: the interpreted kernel's time grows with each grid step
    cfg_j = JaxLlamaConfig.from_json(TINY128)
    model_j = JaxLlamaModel(cfg_j, param_dtype=jnp.float32, attention="flash")
    ids_j = jnp.asarray(ids)
    with pltpu.force_tpu_interpret_mode():
        # jitted: the interpreted kernel runs as compiled XLA, not op by
        # op from Python; the loss's gradient through the logits' VJP
        @jax.jit
        def logits_loss_grads(p):
            logits, vjp = jax.vjp(lambda q: model_j.apply(q, ids_j), p)
            value, dlogits = jax.value_and_grad(lambda lg: jax_causal_lm_loss(lg, ids_j))(logits)
            return logits, value, ravel_pytree(vjp(dlogits)[0])[0]

        logits_j, value_j, flat_grad_j = logits_loss_grads(params)
        logits_j, flat_grad_j = np.asarray(logits_j), np.asarray(flat_grad_j)

    cfg = LlamaConfig.from_json(TINY128)
    model_t, flat = _port_model(params, cfg)
    model_t.attention = "flash"
    ids_t = torch.tensor(ids, dtype=torch.long)
    with torch.no_grad():
        np.testing.assert_allclose(model_t.apply(ids_t).numpy(), logits_j, **TOL)
    loss_t, grads_t = make_flat_loss_fn(model_t, const_len=True)(
        flat, {"input_ids": ids_t, "attention_mask": torch.ones_like(ids_t), "labels": ids_t}
    )
    flat_grad_t = model_t.gather_grads(grads_t, torch.zeros(model_t.n_params))
    np.testing.assert_allclose(float(loss_t), float(value_j), rtol=1e-5)
    np.testing.assert_allclose(flat_grad_t.numpy(), flat_grad_j, **TOL)


def test_untied_gqa_weights_cross_exactly(tmp_path):
    """convert.py on a GQA config (4 heads, 2 KV heads) with an untied
    head: ravel_pytree order, an exact round trip, and equal logits."""
    raw = json.load(open(TINY128))
    raw.update(num_heads=4, num_kv_heads=2, tie_word_embeddings=False)
    path = tmp_path / "tiny128-gqa-untied.json"
    path.write_text(json.dumps(raw))
    cfg_j = JaxLlamaConfig.from_json(str(path))
    model_j = JaxLlamaModel(cfg_j, param_dtype=jnp.float32, attention="xla")
    params = model_j.init(jax.random.PRNGKey(3))
    assert "lm_head" in params
    cfg = LlamaConfig.from_json(str(path))
    tree = jax.tree.map(np.asarray, params)
    flat = params_from_jax(tree, cfg)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(params)[0]))
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(flat, cfg), tree)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    model_t = LlamaModel(cfg, dtype=torch.float32, attention="xla", device="cpu")
    model_t.load_flat(flat)
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long)).numpy()
    np.testing.assert_allclose(logits_t, np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(ids))),
                               **TOL)


def test_reads_llama3_8b_config():
    """The long-context path's architecture: the port reads every field of
    config/model/llama-3-8B.json as the JAX package does; cut to 2 layers
    it has 1,486,901,248 parameters (embedding and head 2 x 525,336,576)."""
    cfg, cfg_j = LlamaConfig.from_json(LLAMA3_8B), JaxLlamaConfig.from_json(LLAMA3_8B)
    for name in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                 "num_kv_heads", "max_position_embeddings", "rope_theta", "rms_norm_eps",
                 "tie_word_embeddings"):
        assert getattr(cfg, name) == getattr(cfg_j, name), name
    assert (cfg.rope_theta, cfg.tie_word_embeddings, cfg.vocab_size) == (500000.0, False, 128256)
    assert (cfg.num_kv_heads, cfg.head_dim, cfg.max_position_embeddings) == (8, 128, 8192)
    import dataclasses

    layout = param_layout(dataclasses.replace(cfg, num_layers=2))
    assert sum(int(np.prod(shape)) for _, shape, _ in layout) == 1_486_901_248
