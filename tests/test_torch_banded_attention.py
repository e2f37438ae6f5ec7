"""The port's banded attention (K2; plain version on the CPU) against the
JAX Pallas kernel run in interpret mode, forward and gradients.

Inputs come from a numpy seed and go through both frameworks as float32.
Tolerances are the JAX suite's own for its banded kernel against the
einsum oracle (tests/test_banded_attention.py): 2e-5 on the output and
5e-4 on the gradients, for float32 sums taken in another order; bf16 at
3e-2, as there.

The Hopper kernels cannot run here (no card, no nvcc); chip_smoke.py
holds them against the same plain versions on the card. What this file
checks about them is that a tensor off the CPU never reaches the plain
version: the wrapper launches the kernel or raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.ops import banded_attention as jax_banded
from acco_tpu_torch.models import gpt_neo as port_gpt_neo
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.ops import banded_attention as port
from acco_tpu_torch.ops import fused_attention as port_fused
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

B, H, D = 1, 2, 64
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(seed, L, dtype=np.float32, head_dim=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, head_dim)).astype(dtype) for _ in range(4)]


def _check_against_jax(L, window, scale, head_dim):
    q, k, v, cot = _inputs(L + window, L, head_dim=head_dim)

    def jax_fn(q, k, v):
        return jax_banded.banded_dot_product_attention(
            q, k, v, window=window, scale=scale, interpret=True
        )

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(jax_fn, q, k, v)
        return out, vjp(cot)

    out_j, grads_j = run(q, k, v, jnp.asarray(cot))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = port.banded_dot_product_attention(tq, tk, tv, window=window, scale=scale)
    out_t.backward(torch.tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    for name, gj, t in zip("qkv", grads_j, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), err_msg=f"d{name}", **GRAD_TOL)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


@pytest.mark.parametrize(
    "L, window, scale",
    [(256, 128, 0.125), (256, 200, 1.0), (384, 129, 0.125), (512, 257, 1.0)],
)
def test_plain_matches_jax_kernel(L, window, scale):
    """nprev = 1, 2, a non-block window, the W % 128 == 1 widths; unscaled
    (GPT-Neo) and scaled scores."""
    _check_against_jax(L, window, scale, 64)


@pytest.mark.parametrize("L, window, scale", [(256, 128, 1.0), (384, 129, 128 ** -0.5)])
def test_plain_matches_jax_kernel_head_dim_128(L, window, scale):
    """head_dim 128 (GPT-Neo-1.3B's and 2.7B's), which the kernels now take:
    the same forward and gradients as JAX's banded kernel."""
    _check_against_jax(L, window, scale, 128)


def test_explicit_backward_matches_autograd():
    """The plain per-kernel backward (delta, dQ, dK/dV from the saved
    LSE) that chip_smoke holds the kernels against equals autograd of the
    plain forward, and the plain LSE is the row's log-sum-exp."""
    L, window, scale = 384, 129, 1.0
    q, k, v, cot = _inputs(5, L)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = port.banded_reference(tq, tk, tv, window, scale)
    out.backward(torch.tensor(cot))
    args = [torch.tensor(x) for x in (q, k, v)]
    dout = torch.tensor(cot)
    delta = port_fused.delta_reference(out.detach(), dout)
    bwd = (*args, dout, lse.detach(), delta, window, scale)
    dq = port.banded_bwd_dq_reference(*bwd)
    dk, dv = port.banded_bwd_dkdv_reference(*bwd)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **GRAD_TOL)  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    _, lse_k1 = port_fused.attention_reference(*args, None, window, scale)
    np.testing.assert_allclose(lse.detach().numpy(), lse_k1.numpy(), **FWD_TOL)


def test_bf16_inputs():
    q, k, v, _ = _inputs(4, 256)
    got = port.banded_dot_product_attention(
        *(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)), window=128
    )
    want = jax_banded.banded_dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=128, interpret=True
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=3e-2, rtol=3e-2
    )


def test_envelope_matches_jax():
    """JAX's gate and band count on a grid of (L, W), head_dim 64 and 128
    (the head dims the Hopper kernels take); at wider multiples of 64, which
    no GPT-Neo preset has, the port builds no kernel."""
    for window in (1, 2, 128, 129, 256, 257, 640, 896, 897, 1000):
        assert port._nprev(window) == jax_banded._nprev(window)
    for L in (64, 128, 256, 1000, 1024, 2048, 8192, 8320):
        for window in (0, 1, 64, 128, 129, 255, 256, 897, 1000, 1024):
            for head_dim in (64, 128):
                assert port.supports_banded_attention(L, head_dim, window) == (
                    jax_banded.supports_banded_attention(L, head_dim, window)
                ), (L, head_dim, window)
    assert port.supports_banded_attention(1024, 128, 256)
    for head_dim in (192, 256):
        assert jax_banded.supports_banded_attention(1024, head_dim, 256)
        assert not port.supports_banded_attention(1024, head_dim, 256)


@pytest.mark.parametrize("L", [64, 128, 384, 1024, 8192, 8320])
@pytest.mark.parametrize("head_dim", [32, 64, 96, 128])
def test_envelope_grid_matches_jax(L, head_dim):
    """supports_banded_attention against JAX's on a grid of (L, D, W): the
    head dims of the model presets (64, 128) and some that neither takes
    (32, 96), windows from none to past L and past the band's cap."""
    for window in (0, 1, 127, 128, 129, 256, 640, 896, 897, 1000, 1024, 8192):
        assert port.supports_banded_attention(L, head_dim, window) == (
            jax_banded.supports_banded_attention(L, head_dim, window)
        ), (L, head_dim, window)


# GPT-Neo at head_dim 128 (2 heads of 128), one global and one local layer
NEO_D128 = dict(
    vocab_size=128, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=2,
    max_position_embeddings=256, window_size=64, attention_layers=("global", "local"),
)


def test_gpt_neo_head_dim_128_local_layers_take_k2(monkeypatch):
    """A tiny GPT-Neo at head_dim 128 with attention='fused': the port sends
    its local layer to banded_dot_product_attention (K2) and its global one
    to K1, as the JAX model sends its local layers to its banded kernel
    (in interpret mode here); the logits agree (the JAX suite's model-level
    1e-4)."""
    monkeypatch.setenv("ACCO_FUSED_ATTN_INTERPRET", "1")
    jax_calls, port_calls = [], []
    jax_fn = jax_banded.banded_dot_product_attention

    def jax_spy(*args, **kwargs):
        jax_calls.append(kwargs.get("window"))
        return jax_fn(*args, **kwargs)

    monkeypatch.setattr(jax_banded, "banded_dot_product_attention", jax_spy)
    for name in ("fused_dot_product_attention", "banded_dot_product_attention"):
        fn = getattr(port_gpt_neo, name)

        def spy(*args, _name=name, _fn=fn, **kwargs):
            port_calls.append((_name, kwargs.get("window")))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(port_gpt_neo, name, spy)

    cfg_j = JaxGPTNeoConfig(**{**NEO_D128, "attention_layers": list(NEO_D128["attention_layers"])})
    model_j = JaxGPTNeoModel(cfg_j, param_dtype=jnp.float32, attention="fused")
    params = jax.tree.map(np.asarray, model_j.init(jax.random.PRNGKey(7)))
    ids = np.random.default_rng(8).integers(0, NEO_D128["vocab_size"], (2, 256)).astype(np.int32)
    logits_j = np.asarray(model_j.apply(params, jnp.asarray(ids)))

    cfg = port_gpt_neo.GPTNeoConfig(**NEO_D128)
    assert cfg.head_dim == 128
    model_t = port_gpt_neo.GPTNeoModel(cfg, dtype=torch.float32, attention="fused", device="cpu")
    model_t.load_flat(params_from_jax(params, cfg))
    with torch.no_grad():
        logits_t = model_t.apply(torch.tensor(ids, dtype=torch.long))
    assert jax_calls and set(jax_calls) == {NEO_D128["window_size"]}
    assert port_calls == [("fused_dot_product_attention", 0),
                          ("banded_dot_product_attention", NEO_D128["window_size"])]
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=1e-4, rtol=1e-4)


def test_mha_only_and_envelope_errors():
    q = torch.zeros(1, 4, 256, 64)
    kv = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="MHA-only"):
        port.banded_dot_product_attention(q, kv, kv, window=128)
    with pytest.raises(ValueError, match="envelope"):
        port.banded_dot_product_attention(q, q, q, window=256)  # W >= L


def test_off_cpu_tensor_launches_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with no kernel
    build the call raises, and the plain version is never called."""

    def no_build():
        raise RuntimeError("no kernel build")

    def plain_called(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(port, "_library", no_build)
    monkeypatch.setattr(port, "banded_reference", plain_called)
    q = torch.empty(B, H, 256, D, device="meta")
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.banded_dot_product_attention(q, q, q, window=128)


def test_wrapper_refuses_cpu_tensors(monkeypatch):
    """The kernel wrappers take CUDA tensors only, checked before launch."""
    monkeypatch.setattr(port, "_library", lambda: None)
    q = torch.zeros(B, H, 256, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.banded_fwd(q, q, q, 128, 1.0)
