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

from acco_tpu.ops import banded_attention as jax_banded
from acco_tpu_torch.ops import banded_attention as port
from acco_tpu_torch.ops import fused_attention as port_fused

B, H, D = 1, 2, 64
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _inputs(seed, L, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize(
    "L, window, scale",
    [(256, 128, 0.125), (256, 200, 1.0), (384, 129, 0.125), (512, 257, 1.0)],
)
def test_plain_matches_jax_kernel(L, window, scale):
    """nprev = 1, 2, a non-block window, the W % 128 == 1 widths; unscaled
    (GPT-Neo) and scaled scores."""
    q, k, v, cot = _inputs(L + window, L)

    def jax_fn(q, k, v):
        return jax_banded.banded_dot_product_attention(
            q, k, v, window=window, scale=scale, interpret=True
        )

    out_j, vjp = jax.vjp(jax_fn, q, k, v)
    grads_j = vjp(jnp.asarray(cot))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = port.banded_dot_product_attention(tq, tk, tv, window=window, scale=scale)
    out_t.backward(torch.tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    for name, gj, t in zip("qkv", grads_j, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), err_msg=f"d{name}", **GRAD_TOL)


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
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **GRAD_TOL)
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
    """JAX's gate and band count on a grid of (L, W), head_dim 64 (the one
    head dim the Hopper kernels take)."""
    for window in (1, 2, 128, 129, 256, 257, 640, 896, 897, 1000):
        assert port._nprev(window) == jax_banded._nprev(window)
    for L in (64, 128, 256, 1000, 1024, 2048, 8192, 8320):
        for window in (0, 1, 64, 128, 129, 255, 256, 897, 1000, 1024):
            assert port.supports_banded_attention(L, 64, window) == (
                jax_banded.supports_banded_attention(L, 64, window)
            ), (L, window)
    assert jax_banded.supports_banded_attention(1024, 128, 256)
    assert not port.supports_banded_attention(1024, 128, 256)  # head_dim 64 only


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
