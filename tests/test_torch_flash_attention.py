"""The port's flash attention (K5's plain version on the CPU) against JAX's
flash path: the plain reference of JAX's bundled flash kernel
(``mha_reference_no_custom_vjp``, differentiated by ``jax.vjp``; the
custom backward of ``mha_reference`` takes only sm_scale 1.0), and once
the JAX package's own ``flash_dot_product_attention`` through the Pallas
kernel in interpret mode. Forward and gradients, float32.

Tolerance: 1e-5 absolute (and relative) on O, dQ, dK and dV, for float32
sums taken in another order (the largest difference seen is ~1.5e-6 at
|values| up to ~4).

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
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash_kernel

from acco_tpu.ops.attention import flash_dot_product_attention as jax_flash
from acco_tpu.ops.attention import repeat_kv as jax_repeat_kv
from acco_tpu_torch.ops import attention as port_attention
from acco_tpu_torch.ops import flash_attention as port
from acco_tpu_torch.ops import fused_attention as k1
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, H, Hkv, L, D, pad):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, D)).astype(np.float32)
    cot = rng.standard_normal((B, H, L, D)).astype(np.float32)
    pad_mask = None
    if pad:
        pad_mask = np.ones((B, L), np.int32)
        pad_mask[0, L - L // 5 :] = 0  # right padding
        pad_mask[-1, L // 3 : L // 3 + 24] = 0  # a run of pads in the middle
        pad_mask[-1, L - 16 :] = 0
    return q, k, v, cot, pad_mask


def _port_fwd_bwd(q, k, v, cot, pad):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = port.flash_dot_product_attention(
        tq, tk, tv, None if pad is None else torch.tensor(pad)
    )
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _assert_match(out_t, grads_t, out_j, grads_j):
    np.testing.assert_allclose(out_t, np.asarray(out_j), err_msg="o", **TOL)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(gt, np.asarray(gj), err_msg=f"d{name}", **TOL)


CASES = {  # B, H, Hkv, L, D, pad (tail and middle)
    "d64": (2, 4, 4, 256, 64, False),
    "d64_gqa_pad": (2, 4, 2, 256, 64, True),
    "d128": (2, 4, 4, 256, 128, False),
    "d128_gqa": (2, 4, 2, 256, 128, False),
    "d128_gqa_pad": (2, 4, 2, 256, 128, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_flash_reference(case):
    B, H, Hkv, L, D, pad = CASES[case]
    q, k, v, cot, pad_mask = _inputs(sorted(CASES).index(case), B, H, Hkv, L, D, pad)

    def jax_fn(q, k, v):
        # acco_tpu's flash path with the kernel's plain reference in its place
        k, v = jax_repeat_kv(q, k, v)
        seg = None
        if pad_mask is not None:
            ids = jnp.asarray(pad_mask)
            seg = jax_flash_kernel.SegmentIds(q=ids, kv=ids)
        return jax_flash_kernel.mha_reference_no_custom_vjp(
            q, k, v, segment_ids=seg, causal=True, sm_scale=D**-0.5
        )

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(jax_fn, q, k, v)
        return out, vjp(cot)

    _assert_match(*_port_fwd_bwd(q, k, v, cot, pad_mask), *run(q, k, v, jnp.asarray(cot)))


def test_plain_matches_jax_package_flash_kernel_interpreted():
    """The JAX package's ``flash_dot_product_attention`` through the real
    Pallas flash kernel (interpret mode), GQA and pads."""
    q, k, v, cot, pad = _inputs(7, 1, 2, 1, 256, 64, True)
    with pltpu.force_tpu_interpret_mode():
        @jax.jit
        def run(q, k, v, cot):
            out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, jnp.asarray(pad)), q, k, v)
            return out, vjp(cot)

        out_j, grads_j = run(q, k, v, jnp.asarray(cot))
        grads_j = [np.asarray(g) for g in grads_j]
        out_j = np.asarray(out_j)
    _assert_match(*_port_fwd_bwd(q, k, v, cot, pad), out_j, grads_j)


def test_flash_mask_is_not_k1_mask():
    """K1 (and the einsum path) mask pad keys for every query; flash lets a
    pad query attend to the pad keys at or before it. Real rows agree, pad
    rows do not: the two masks must not be unified."""
    q, k, v, _, pad = _inputs(3, 2, 4, 2, 128, 64, True)
    tq, tk, tv, tpad = (torch.tensor(x) for x in (q, k, v, pad))
    flash = port.flash_reference(tq, tk, tv, tpad)[0].numpy()
    fused = k1.attention_reference(tq, tk, tv, tpad)[0].numpy()
    real = pad.astype(bool)[:, None, :, None]
    np.testing.assert_allclose(np.where(real, flash, 0), np.where(real, fused, 0), **TOL)
    pad_rows = np.abs(flash - fused).max(-1)[np.broadcast_to(~real[..., 0], flash.shape[:-1])]
    assert pad_rows.size and (pad_rows > 1e-2).all()
    allowed = port.segment_mask(128, tpad).numpy()
    assert allowed[1, 0, 127, 127] and not allowed[1, 0, 127, 0]  # pad query, real key


def test_explicit_backward_matches_autograd():
    """The plain per-kernel backward (delta, dK/dV, dQ from the saved LSE)
    that chip_smoke holds the kernels against equals autograd of the plain
    forward: float32, GQA, pads, D 128."""
    q, k, v, cot, pad = _inputs(11, 2, 4, 2, 128, 128, True)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    seg = torch.tensor(pad)
    scale = 128**-0.5
    out, lse = port.flash_reference(tq, tk, tv, seg, scale)
    out.backward(torch.tensor(cot))
    args = [torch.tensor(x) for x in (q, k, v)]
    dout = torch.tensor(cot)
    delta = k1.delta_reference(out.detach(), dout)
    dk, dv = port.flash_bwd_dkdv_reference(*args, seg, dout, lse.detach(), delta, scale)
    dq = port.flash_bwd_dq_reference(*args, seg, dout, lse.detach(), delta, scale)
    for got, t in zip((dq, dk, dv), (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), **TOL)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


@pytest.mark.parametrize(
    "impl, L, D, device, want",
    [
        ("auto", 2048, 64, "cuda", "flash"),
        ("auto", 2048, 128, "cuda", "flash"),
        ("auto", 8192, 64, "cuda", "flash"),
        ("auto", 8192, 128, "cuda", "flash"),
        ("auto", 2112, 64, "cuda", "fused"),  # past 2048, not a multiple of 512
        ("auto", 1024, 64, "cuda", "fused"),
        ("auto", 1024, 128, "cuda", "fused"),  # K1 takes head_dim 128
        ("auto", 8192, 128, "cpu", "xla"),
        ("auto", 2048, 64, "cpu", "xla"),
        ("flash", 128, 64, "cpu", "flash"),
        (True, 1024, 64, "cuda", "flash"),
    ],
)
def test_impl_resolution(impl, L, D, device, want):
    assert port_attention.resolve_attention_impl(impl, L, D, device) == want


def test_envelope():
    assert port.supports_flash_attention(128, 64)
    assert port.supports_flash_attention(8192, 128)
    assert port.supports_flash_attention(1088, 128)  # any multiple of 64, no L cap
    assert not port.supports_flash_attention(64, 64)
    assert not port.supports_flash_attention(1000, 128)
    assert not port.supports_flash_attention(1024, 96)


def test_off_cpu_tensor_launches_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with no kernel
    build the call raises, and the plain version is never called."""

    def no_build():
        raise RuntimeError("no kernel build")

    def plain_called(*a, **k):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(port, "_library", no_build)
    monkeypatch.setattr(port, "flash_reference", plain_called)
    q = torch.empty(1, 4, 256, 128, device="meta")
    kv = torch.empty(1, 2, 256, 128, device="meta")
    with pytest.raises(RuntimeError, match="no kernel build"):
        port.flash_dot_product_attention(q, kv, kv)


def test_wrapper_refuses_cpu_tensors(monkeypatch):
    """The kernel wrappers take CUDA tensors only, checked before launch."""
    monkeypatch.setattr(port, "_library", lambda: None)
    q = torch.zeros(1, 2, 256, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA"):
        port.flash_fwd(q, q, q, None, 128**-0.5)
    with pytest.raises(ValueError, match="envelope"):
        port.flash_fwd(q[..., :96].contiguous(), q[..., :96].contiguous(),
                       q[..., :96].contiguous(), None, 1.0)
