"""The port's fused attention (plain version on the CPU) against the JAX
Pallas kernel run in interpret mode, forward and gradients, at head_dim
64 and 128.

Inputs come from a numpy seed and go through both frameworks as float32.
Tolerances are the JAX suite's own for this kernel against its einsum
reference (tests/test_fused_attention.py): 2e-5 on the output and 5e-5
on gradients, for float32 sums taken in another order. Rows with no
allowed key (left padding) are compared too: both normalise them over
all L keys.

The Hopper kernel itself cannot run here (no card, no nvcc); it is held
against the same plain version on the card by chip_smoke.py. What this
file can check about it is that a tensor off the CPU never reaches the
plain version: the wrapper launches the kernel or raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.ops.attention import resolve_attention_impl as jax_resolve
from acco_tpu.ops.fused_attention import fused_dot_product_attention as jax_fused
from acco_tpu_torch.ops import attention as port_attention
from acco_tpu_torch.ops import fused_attention as port
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

B, H, L, D = 2, 4, 128, 64
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, hkv=H, pad=False, D=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, hkv, L, D)).astype(np.float32)
    cot = rng.standard_normal((B, H, L, D)).astype(np.float32)
    pad_mask = None
    if pad:
        pad_mask = np.ones((B, L), np.int32)
        pad_mask[0, :8] = 0  # left padding: rows 0-7 of batch 0 see no key
        pad_mask[1, 3 * L // 4 :] = 0  # right padding
    return q, k, v, cot, pad_mask


CASES = {
    "causal": dict(window=0, scale=None, hkv=H, pad=False),
    "window32": dict(window=32, scale=None, hkv=H, pad=False),
    "pad_mask": dict(window=0, scale=None, hkv=H, pad=True),
    "gqa": dict(window=0, scale=None, hkv=2, pad=False),
    "scale1": dict(window=0, scale=1.0, hkv=H, pad=False),
    # head_dim 128 (Llama-3-8B's), which the Hopper kernel takes too
    "d128_causal": dict(window=0, scale=None, hkv=H, pad=False, D=128),
    "d128_gqa_pad": dict(window=0, scale=None, hkv=2, pad=True, D=128),
    "d128_window32": dict(window=32, scale=None, hkv=H, pad=False, D=128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel(case):
    c = CASES[case]
    q, k, v, cot, pad = _inputs(
        sorted(CASES).index(case), hkv=c["hkv"], pad=c["pad"], D=c.get("D", D)
    )

    def jax_fn(q, k, v):
        return jax_fused(
            q, k, v,
            pad_mask=None if pad is None else jnp.asarray(pad),
            window=c["window"], scale=c["scale"], interpret=True,
        )

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(jax_fn, q, k, v)
        return out, vjp(cot)

    out_j, grads_j = run(q, k, v, jnp.asarray(cot))

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = port.fused_dot_product_attention(
        tq, tk, tv, None if pad is None else torch.tensor(pad),
        window=c["window"], scale=c["scale"],
    )
    out_t.backward(torch.tensor(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    for name, gj, t in zip("qkv", grads_j, (tq, tk, tv)):
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(gj), err_msg=f"d{name}", **GRAD_TOL  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        )


def test_explicit_backward_matches_autograd():
    """The plain per-kernel backward (delta, dK/dV, dQ from the saved
    LSE) that chip_smoke holds the kernels against equals autograd of the
    plain forward: float32, same 5e-5 bar."""
    q, k, v, cot, _ = _inputs(11, hkv=2)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    scale, window = D**-0.5, 32
    out, lse = port.attention_reference(tq, tk, tv, None, window, scale)
    out.backward(torch.tensor(cot))
    args = [torch.tensor(x) for x in (q, k, v)]
    dout = torch.tensor(cot)
    delta = port.delta_reference(out.detach(), dout)
    dk, dv = port.attn_bwd_dkdv_reference(*args, None, dout, lse.detach(), delta, window, scale)
    dq = port.attn_bwd_dq_reference(*args, None, dout, lse.detach(), delta, window, scale)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **GRAD_TOL)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


@pytest.mark.parametrize("head_dim", [64, 128])
def test_off_cpu_tensor_launches_kernel_or_raises(monkeypatch, head_dim):
    """A tensor that is not on the CPU goes to the kernel: with no kernel
    build the call raises, and the plain version is never called."""

    def no_build():
        raise RuntimeError("no kernel build")

    def plain_called(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(port, "_library", no_build)
    monkeypatch.setattr(port, "attention_reference", plain_called)
    q = torch.empty(B, H, L, head_dim, device="meta")
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.fused_dot_product_attention(q, q, q)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_wrapper_refuses_cpu_tensors(monkeypatch, head_dim):
    """The kernel wrappers take CUDA tensors only, checked before launch."""
    monkeypatch.setattr(port, "_library", lambda: None)
    q = torch.zeros(B, H, L, head_dim, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.attn_fwd(q, q, q, None, 0, head_dim**-0.5)


def test_envelope_and_impl_resolution():
    assert port.supports_fused_attention(1024, 64)
    assert port.supports_fused_attention(1024, 128)  # Llama-3-8B's head_dim
    assert port.supports_fused_attention(4096, 64)  # no L cap: nothing [L, L] resident
    assert not port.supports_fused_attention(1000, 64)
    assert not port.supports_fused_attention(1024, 96)
    resolve = port_attention.resolve_attention_impl
    assert resolve("auto", 1024, 64, "cuda") == "fused"
    assert resolve("auto", 1024, 128, "cuda") == "fused"
    assert resolve("auto", 1024, 64, "cpu") == "xla"
    assert resolve("fused", 128, 64, "cpu") == "fused"
    # 'flash' is K5 now (tests/test_torch_flash_attention.py), no longer refused
    assert resolve("flash", 1024, 64, "cuda") == "flash"


@pytest.mark.parametrize("seq_len, head_dim", [(128, 64), (512, 128), (1024, 64), (1024, 128)])
def test_auto_resolves_as_jax_does_up_to_l1024(seq_len, head_dim):
    """'auto' on the card picks what the JAX resolver picks on the TPU at L
    <= 1024: the fused kernel, at head_dim 64 and 128."""
    want = jax_resolve("auto", seq_len, platform="tpu", head_dim=head_dim)
    assert want == "fused"
    assert port_attention.resolve_attention_impl("auto", seq_len, head_dim, "cuda") == want
