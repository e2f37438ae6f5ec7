"""The port's fused lm-head + CE (plain version on the CPU) against the JAX
Pallas kernel run in interpret mode (``block_rows=16, block_vocab=128``).

The same numpy inputs, from a seed, go through both. Bars are the JAX
suite's own for its kernel against the materialized loss
(tests/test_fused_ce.py): the loss at rtol 1e-5, gradients of h and W at
atol 1e-6 / rtol 1e-4, the flat loss of a model at rtol 1e-5 and its flat
gradient at atol 2e-5 / rtol 1e-3; all float32, where only the order of
the float32 sums differs. bf16 inputs are held at rtol 1e-5 on the loss:
both sides sum exact products of the bf16 operands in float32.

The Hopper kernels themselves cannot run here (no card, no nvcc); they
are held against the same plain versions on the card by chip_smoke.py.
What this file checks about them is that a tensor off the CPU never
reaches the plain version.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from acco_tpu.ops import fused_ce as jax_fused_ce
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.ops import fused_ce as port
from acco_tpu_torch.ops import losses as port_losses
from acco_tpu_torch.ops.losses import IGNORE_INDEX
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

B, L, D, V = 2, 33, 128, 277  # deliberately unaligned rows and vocab
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, v=V, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, L, D)).astype(np.float32)
    w = (rng.standard_normal((D, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, (B, L)).astype(np.int32)
    if dtype != np.float32:  # round once, so both sides see the same values
        hidden = np.asarray(jnp.asarray(hidden, jnp.bfloat16).astype(jnp.float32))
        w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return hidden, w, labels


def _jax_loss(hidden, w, labels, dtype=jnp.float32, **kw):
    return jax_fused_ce.fused_ce_loss(
        jnp.asarray(hidden, dtype), jnp.asarray(w, dtype), jnp.asarray(labels),
        block_rows=16, block_vocab=128, interpret=True, **kw,
    )


def _port_loss(hidden, w, labels, dtype=torch.float32, **kw):
    return port.fused_ce_loss(
        torch.tensor(hidden).to(dtype), torch.tensor(w).to(dtype),
        torch.tensor(labels, dtype=torch.long), **kw,
    )


def _ignored(labels):
    labels = labels.copy()
    labels[:, 10:20] = IGNORE_INDEX
    labels[1, :] = IGNORE_INDEX
    return labels


@pytest.mark.parametrize(
    "case",
    [
        dict(id="plain", kw={}),
        dict(id="smoothing", kw=dict(label_smoothing=0.1)),
        dict(id="ignore_index", kw={}, ignore=True),
        dict(id="real_vocab", kw=dict(real_vocab=V - 21, label_smoothing=0.1), clip=V - 21),
        dict(id="no_shift_num_valid", kw=dict(shift=False, num_valid=123.0)),
    ],
    ids=lambda c: c["id"],
)
def test_value_matches_jax(case):
    hidden, w, labels = _inputs(0)
    if case.get("ignore"):
        labels = _ignored(labels)
    if case.get("clip"):
        labels = np.clip(labels, 0, case["clip"] - 1)
    want = float(_jax_loss(hidden, w, labels, **case["kw"]))
    got = float(_port_loss(hidden, w, labels, **case["kw"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("smoothing, real", [(0.0, None), (0.1, None), (0.0, V - 21)],
                         ids=["plain", "smoothing", "real_vocab"])
def test_gradients_match_jax(smoothing, real):
    hidden, w, labels = _inputs(4)
    labels[:, -5:] = IGNORE_INDEX
    if real:
        labels = np.clip(labels, 0, real - 1)
    kw = dict(label_smoothing=smoothing, real_vocab=real)
    gh_j, gw_j = jax.jit(jax.grad(
        lambda h, w_: _jax_loss(h, w_, labels, **kw), argnums=(0, 1)
    ))(jnp.asarray(hidden), jnp.asarray(w))
    h_t = torch.tensor(hidden, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    loss = port.fused_ce_loss(h_t, w_t, torch.tensor(labels, dtype=torch.long), **kw)
    gh_t, gw_t = torch.autograd.grad(loss, (h_t, w_t))
    np.testing.assert_allclose(gh_t.numpy(), np.asarray(gh_j), **GRAD_TOL)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), **GRAD_TOL)
    if real:  # padded columns receive no head gradient
        np.testing.assert_array_equal(gw_t.numpy()[:, real:], 0.0)


def test_bf16_inputs_match_jax():
    hidden, w, labels = _inputs(6, dtype="bf16")
    want = float(_jax_loss(hidden, w, labels, dtype=jnp.bfloat16))
    got = float(_port_loss(hidden, w, labels, dtype=torch.bfloat16))
    np.testing.assert_allclose(got, want, **LOSS_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_triple_and_its_vjp_match_jax(dtype):
    """The per-row (lse, true logit, sum of real logits) and its VJP for
    given cotangents, against JAX's ``_lm_head_ce`` on tile-aligned rows
    and vocab, with v_real below V, a target that never matches (-1) and
    one on a masked column. bf16: dlogits are rounded to bf16 before both
    products on both sides, and dH / dW are rounded to bf16 at the end, so
    the bar is two bf16 steps (2^-7 relative) of the larger gradients."""
    N, v, v_real = 64, 256, 240
    rng = np.random.default_rng(9)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, v)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, v_real, N).astype(np.int32)
    tgt[3], tgt[5] = -1, v_real + 3
    # cotangents at the scale a mean over the N rows gives them
    cot = [(rng.standard_normal(N) / N).astype(np.float32) for _ in range(3)]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    hj, wj = jnp.asarray(h, jdt), jnp.asarray(w, jdt)

    @jax.jit
    def run(a, b, cot):
        out, vjp = jax.vjp(
            lambda a, b: jax_fused_ce._lm_head_ce(a, b, jnp.asarray(tgt), v_real, 16, 128, True),
            a, b,
        )
        return out, vjp(cot)

    out_j, (dh_j, dw_j) = run(hj, wj, tuple(jnp.asarray(c) for c in cot))

    h_t = torch.tensor(np.asarray(hj.astype(jnp.float32))).to(tdt).requires_grad_(True)
    w_t = torch.tensor(np.asarray(wj.astype(jnp.float32)).T.copy()).to(tdt).requires_grad_(True)
    out_t = port.LmHeadCE.apply(h_t, w_t, torch.tensor(tgt), v_real)
    tl_t = out_t[1].detach()
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    assert float(tl_t[3]) == 0.0 and float(tl_t[5]) == np.float32(port.NEG)
    dh_t, dw_t = torch.autograd.grad(out_t, (h_t, w_t), [torch.tensor(c) for c in cot])
    for got, want in ((dh_t, dh_j), (dw_t.t(), dw_j)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **GRAD_TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


def _models(family):
    from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
    from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
    from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
    from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

    if family == "llama":  # tiny128
        path = os.path.join(REPO, "config", "model", "tiny128.json")
        jcfg, cfg = JaxLlamaConfig.from_json(path), LlamaConfig.from_json(path)
        jmodel, model_cls = JaxLlamaModel(jcfg, param_dtype=jnp.float32), LlamaModel
    else:  # a GPT-Neo of hidden 128: one global and one local layer
        arch = dict(vocab_size=257, hidden_size=128, num_layers=2, num_heads=2,
                    max_position_embeddings=64, window_size=16)
        jcfg = JaxGPTNeoConfig(**arch, attention_layers=["global", "local"])
        cfg = GPTNeoConfig(**arch, attention_layers=("global", "local"))
        jmodel, model_cls = JaxGPTNeoModel(jcfg, param_dtype=jnp.float32), GPTNeoModel
    params = jmodel.init(jax.random.PRNGKey(0))
    model = model_cls(cfg, dtype=torch.float32, device="cpu")
    flat_t = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    return jmodel, params, model, flat_t


@pytest.mark.parametrize("fused", ["pallas", "chunk"])
@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
def test_flat_loss_fn_matches_jax(family, fused, monkeypatch):
    """The train path's seam: the port's make_flat_loss_fn with
    ``fused_loss`` against the JAX one, loss and flat gradient."""
    from acco_tpu.parallel.common import make_flat_loss_fn as jax_make_flat_loss_fn
    from acco_tpu_torch.parallel.common import make_flat_loss_fn

    monkeypatch.setenv("ACCO_FUSED_CE_INTERPRET", "1")
    jmodel, params, model, flat_t = _models(family)
    flat_j, unravel = ravel_pytree(params)
    ids = np.random.default_rng(1).integers(0, 257, (2, 32)).astype(np.int32)
    batch_j = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.ones_like(ids),
               "labels": jnp.asarray(ids)}
    f_j = jax_make_flat_loss_fn(jmodel, unravel, flat_j.size, 0.05, fused_loss=fused)
    # jitted: the interpreted kernel runs as compiled XLA, not op by op
    l_j, g_j = jax.jit(jax.value_and_grad(f_j))(flat_j, batch_j)

    ids_t = torch.tensor(ids, dtype=torch.long)
    value_and_grad = make_flat_loss_fn(model, 0.05, fused_loss=fused)
    assert value_and_grad.fused_loss == fused
    l_t, grads = value_and_grad(
        flat_t, {"input_ids": ids_t, "attention_mask": torch.ones_like(ids_t), "labels": ids_t}
    )
    g_t = model.gather_grads(grads, torch.zeros(model.n_params))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-5, rtol=1e-3)


def _llama(hidden=128, vocab=257):
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

    return LlamaModel(
        LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=2 * hidden,
                    num_layers=1, num_heads=2, num_kv_heads=2, max_position_embeddings=32),
        dtype=torch.float32, device="cpu",
    )


def test_resolve_fused_loss_gate():
    """The downgrade chains of JAX's ``test_resolve_fused_loss_gate``."""
    resolve = port_losses.resolve_fused_loss
    small, ok = _llama(hidden=64), _llama()
    msgs = []
    assert resolve("pallas", ok, None) == "pallas"
    assert resolve("pallas", ok, 250) == "pallas"
    # outside the envelope: -> chunk; with Megatron padding -> off
    assert resolve("pallas", small, None, warn=msgs.append) == "chunk"
    assert resolve("pallas", small, 250, warn=msgs.append) is False
    assert len(msgs) == 2 and "envelope" in msgs[0] and "'chunk'" in msgs[0]
    # chunk predates real_vocab
    assert resolve("chunk", ok, 250) is False
    assert resolve(True, ok, None) == "chunk"
    assert resolve(False, ok, None) is False
    assert resolve("pallas", object(), None) is False
    # a sharded vocab (tensor parallelism): the envelope holds per shard,
    # and 'chunk', which has no sharded form, goes to the materialized CE
    msgs.clear()
    assert resolve("pallas", _llama(vocab=512), None, n_vocab_shards=2) == "pallas"
    assert resolve("pallas", _llama(vocab=250), None, warn=msgs.append, n_vocab_shards=2) is False
    assert resolve("chunk", ok, None, warn=msgs.append, n_vocab_shards=2) is False
    assert "vocab-parallel CE" in msgs[0] and "sharded form" in msgs[1]
    # context parallelism (JAX's seq_sharded chains): the kernel composes
    # with it; 'chunk' has no sequence-sharded form and goes to the
    # materialized CE, with a warning when asked for, silently when the
    # kernel's envelope sent it there (the envelope warning came first)
    msgs.clear()
    assert resolve("pallas", ok, None, seq_sharded=True) == "pallas"
    assert resolve("chunk", ok, None, warn=msgs.append, seq_sharded=True) is False
    assert resolve("pallas", small, None, warn=msgs.append, seq_sharded=True) is False
    assert len(msgs) == 2 and "context-parallel" in msgs[0]
    assert "envelope" in msgs[1] and "the materialized CE" in msgs[1]


class _OnCard:
    """A model's resolve surface with its parameters on the card (a
    ``torch.device('cuda')`` needs no card to exist)."""

    def __init__(self, model):
        self.config, self.hidden, self.lm_head = model.config, model.hidden, model.lm_head
        self.padded_vocab = getattr(model, "padded_vocab", None)

    def parameters(self):
        yield types.SimpleNamespace(device=torch.device("cuda", 0))


def test_resolve_fused_loss_auto_policy():
    """'auto' as JAX's policy decides on its accelerator: the kernel for
    V >= 100k and under context parallelism on the card, the materialized
    CE otherwise and on the CPU, never 'chunk', and silent."""
    resolve = port_losses.resolve_fused_loss
    msgs = []
    assert resolve("auto", _OnCard(_llama(vocab=50304)), None, msgs.append) is False
    assert resolve("auto", _OnCard(_llama(vocab=128256)), None, msgs.append) == "pallas"
    assert resolve("auto", _llama(vocab=128256), None, msgs.append) is False  # on the CPU
    # under context parallelism the kernel at any vocab on the card
    assert resolve("auto", _OnCard(_llama(vocab=50304)), None, msgs.append,
                   seq_sharded=True) == "pallas"
    assert resolve("auto", _llama(vocab=50304), None, msgs.append, seq_sharded=True) is False
    assert resolve("auto", _OnCard(_llama(hidden=96, vocab=128256)), None, msgs.append) is False
    assert resolve("auto", object(), None, msgs.append) is False
    assert msgs == []


def test_model_ce_chunk_rejects_unsupported_args():
    model = _llama(hidden=64)
    model.load_flat(torch.zeros(model.n_params))
    ids = torch.zeros((1, 8), dtype=torch.long)
    for bad in (dict(shift=False), dict(num_valid=1.0), dict(real_vocab=250)):
        with pytest.raises(ValueError, match="fused_loss='chunk'"):
            port_losses.model_ce(model, ids, None, ids, label_smoothing=0.0, fused="chunk", **bad)
    with pytest.raises(ValueError, match="vocab_group"):
        port_losses.model_ce(model, ids, None, ids, label_smoothing=0.0, fused="chunk",
                             vocab_group=object())


def test_envelope_and_vocab_splits():
    assert port.supports_fused_ce(8184, 768, 50257)
    assert not port.supports_fused_ce(8184, 100, 50257)  # unaligned hidden
    assert not port.supports_fused_ce(0, 768, 50257)
    for n_rows, vocab, n_sm in ((8192, 50257, 132), (1024, 128256, 132), (64, 277, 132), (1, 128, 8)):
        # the float32 kernels' tiles, and the bf16 kernels' rows and vocab columns
        for rows, cols in ((port.TILE, port.TILE), (port.GEMM_TILE, port.VOCAB_TILE)):
            splits, per = port.vocab_splits(n_rows, vocab, n_sm, rows, cols)
            tiles = -(-vocab // cols)
            assert (splits - 1) * per < tiles <= splits * per  # every split holds a tile


def test_off_cpu_tensor_launches_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the kernels: without a build
    the call raises, and the plain version is never called; so does the
    backward, whose first launch is ``ce_bwd_dp``."""

    def no_build():
        raise RuntimeError("no kernel build")

    def plain_called(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(port, "_library", no_build)
    for name in ("ce_fwd_reference", "ce_bwd_dp_reference", "lm_head_ce_backward_reference"):
        monkeypatch.setattr(port, name, plain_called)
    hidden = torch.empty(B, L, D, device="meta")
    w = torch.empty(D, V, device="meta")
    labels = torch.zeros(B, L, dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.fused_ce_loss(hidden, w, labels)

    # the backward of a forward that ran (here: stood in for) on the card
    def fwd_on_card(h, w_, tgt, v_real):
        return tuple(torch.zeros(h.shape[0], device=h.device) for _ in range(3))

    monkeypatch.setattr(port, "ce_fwd", fwd_on_card)
    hidden_bf16 = torch.empty(B, L, D, dtype=torch.bfloat16, device="meta", requires_grad=True)
    w_bf16 = torch.empty(D, V, dtype=torch.bfloat16, device="meta", requires_grad=True)
    loss = port.fused_ce_loss(hidden_bf16, w_bf16, labels)
    with pytest.raises(RuntimeError, match="no kernel build"):
        loss.backward()
    n = B * L
    rows = [torch.empty(n, device="meta") for _ in range(4)]
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.ce_bwd_dp(hidden_bf16.detach().reshape(n, D), w_bf16.detach().t(),
                       torch.zeros(n, dtype=torch.int32, device="meta"), V, *rows)


def test_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(port, "_library", lambda: None)
    h, w = torch.zeros(64, D), torch.zeros(V, D)
    tgt, row = torch.zeros(64, dtype=torch.int32), torch.zeros(64)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.ce_fwd(h, w, tgt, V)
    for fn in (port.ce_bwd_dh_f32, port.ce_bwd_dw_f32):
        with pytest.raises(ValueError, match="needs CUDA"):
            fn(h, w, tgt, V, row, row, row, row)
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    dp = torch.zeros(64, port.padded_vocab(V), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.ce_bwd_dp(hb, wb, tgt, V, row, row, row, row)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.ce_bwd_dh(dp, wb)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.ce_bwd_dw(dp, hb, V)
    # each takes only its own dtype and the dp buffer's padded width
    with pytest.raises(ValueError, match="bfloat16 only"):
        port.ce_bwd_dp(h, w, tgt, V, row, row, row, row)
    with pytest.raises(ValueError, match="float32 only"):
        port.ce_bwd_dh_f32(hb, wb, tgt, V, row, row, row, row)
    with pytest.raises(ValueError, match=r"dp must be bfloat16 \[N, 384\]"):
        port.ce_bwd_dh(dp[:, :V], wb)


# -- the backward's dp buffer, its plan and its chunks -----------------------


def test_dp_plan():
    """Vp, the chunk rows, the float32 dW decision; one chunk at both
    cells' heads (Llama-125M: 8192 rows x V 50257; Llama-3-8B at L 8192:
    8192 rows x V 128256) under the default 2 GiB cap."""
    for n_rows, vocab, vp in ((8192, 50257, 50304), (8192, 128256, 128256)):
        plan = port.dp_plan(n_rows, vocab)
        assert plan.vp == vp == port.padded_vocab(vocab)
        assert (plan.chunk_rows, plan.n_chunks, plan.dw_f32) == (n_rows, 1, False)
        assert 2 * plan.chunk_rows * plan.vp <= port.DP_CAP_BYTES
    assert port.padded_vocab(128) == 128 and port.padded_vocab(129) == 256
    # past the cap: chunks of a multiple of 128 rows, the last ragged
    plan = port.dp_plan(20000, 128256)
    assert plan.chunk_rows == 8320 and 2 * 8320 * 128256 <= port.DP_CAP_BYTES
    assert (plan.n_chunks, plan.dw_f32) == (3, True)
    assert list(plan.chunks(20000)) == [(0, 8320), (8320, 16640), (16640, 20000)]
    # a cap below one tile of rows keeps the rows it can, a multiple of 4
    plan = port.dp_plan(66, 277, cap_bytes=2 * 384 * 24)
    assert (plan.vp, plan.chunk_rows, plan.n_chunks) == (384, 24, 3)
    assert list(plan.chunks(66))[-1] == (48, 66)
    assert port.dp_plan(66, 277, cap_bytes=2 * 384 * 27).chunk_rows == 24
    assert [port.dw_mode(i, 1) for i in range(1)] == [0]
    assert [port.dw_mode(i, 4) for i in range(4)] == [1, 2, 2, 3]


def test_dp_reference_pads_and_masks():
    """``ce_bwd_dp_reference``: the activation dtype, [N, Vp]; zero in the
    pad columns [V, Vp) and, with every target below v_real, in the
    masked columns [v_real, V); equal to the rounded dlogits elsewhere."""
    N, v, v_real = 48, 277, 250
    rng = np.random.default_rng(12)
    h = torch.tensor(rng.standard_normal((N, D)), dtype=torch.bfloat16)
    w = torch.tensor(rng.standard_normal((v, D)) * 0.1, dtype=torch.bfloat16)
    tgt = torch.tensor(rng.integers(0, v_real, N), dtype=torch.int32)
    lse = port.ce_fwd_reference(h, w, tgt, v_real)[0]
    cot = [torch.tensor(rng.standard_normal(N) / N, dtype=torch.float32) for _ in range(3)]
    dp = port.ce_bwd_dp_reference(h, w, tgt, v_real, lse, *cot)
    assert dp.dtype == torch.bfloat16 and dp.shape == (N, port.padded_vocab(v)) == (N, 384)
    assert bool((dp[:, v_real:] == 0).all())
    want = port.dlogits_f32(h, w, tgt, v_real, lse, *cot)
    assert torch.equal(dp[:, :v], want.to(torch.bfloat16))
    assert bool((dp[:, :v_real] != 0).any())


def _chunked_grads(B_, L_, cap_bytes):
    """The port's gradients of the mean loss at (B_, L_) rows, float32, with
    the dp buffer capped at ``cap_bytes``, and JAX's, interpreted."""
    rng = np.random.default_rng(B_ * 100 + L_)
    hidden = rng.standard_normal((B_, L_, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B_, L_)).astype(np.int32)
    labels[0, 3:7] = IGNORE_INDEX
    kw = dict(label_smoothing=0.1)
    l_j, (gh_j, gw_j) = jax.jit(jax.value_and_grad(
        lambda h, w_: _jax_loss(h, w_, labels, **kw), argnums=(0, 1)
    ))(jnp.asarray(hidden), jnp.asarray(w))
    h_t = torch.tensor(hidden, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    loss = port.fused_ce_loss(h_t, w_t, torch.tensor(labels, dtype=torch.long),
                              dp_cap_bytes=cap_bytes, **kw)
    gh_t, gw_t = torch.autograd.grad(loss, (h_t, w_t))
    return (float(loss.detach()), gh_t.numpy(), gw_t.numpy()), (float(l_j), np.asarray(gh_j),
                                                      np.asarray(gw_j))


@pytest.mark.parametrize(
    "form, B_, L_",
    [  # shapes no other case traces: JAX reads its cap when it traces the backward
        pytest.param("fused", 2, 41, id="jax-fused-form"),
        pytest.param("split", 3, 25, id="jax-split-form"),
    ],
)
def test_chunked_backward_matches_jax(form, B_, L_, monkeypatch):
    """The chunked plain backward (3 chunks of 32 rows, the last ragged;
    dW summed in float32 across them) against both of JAX's backward forms:
    its fused kernel at the default cap and its split dH / dW kernels when
    ``ACCO_FUSED_CE_PARTIAL_CAP`` is 1 byte."""
    if form == "split":
        monkeypatch.setenv("ACCO_FUSED_CE_PARTIAL_CAP", "1")
    cap = 2 * port.padded_vocab(V) * 32
    plan = port.dp_plan(B_ * L_, V, cap)
    assert plan.n_chunks == 3 and plan.dw_f32 and (B_ * L_) % plan.chunk_rows
    (l_t, gh_t, gw_t), (l_j, gh_j, gw_j) = _chunked_grads(B_, L_, cap)
    np.testing.assert_allclose(l_t, l_j, **LOSS_TOL)
    np.testing.assert_allclose(gh_t, gh_j, **GRAD_TOL)
    np.testing.assert_allclose(gw_t, gw_j, **GRAD_TOL)
