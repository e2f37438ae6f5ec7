"""Causal flash attention with segment ids: the Hopper kernel (K5), its
plain version, its autograd.

Counterpart of ``acco_tpu/ops/attention.py``'s
``flash_dot_product_attention``, which repeats K/V to q's head count and
calls JAX's bundled Pallas TPU flash kernel
(``jax.experimental.pallas.ops.tpu.flash_attention``) with
``segment_ids=SegmentIds(pad, pad)``, ``causal=True`` and
``sm_scale=D**-0.5``. ``csrc/flash_attention.cu`` is its Hopper kernel: a
tiled online-softmax forward and a three-kernel backward (the TPU
kernel's forward, dK/dV and dQ calls, with delta = rowsum(dO * O) as a
pre-pass whose plain version is K1's ``delta_reference``), for head_dim
64 and 128 and any L that is a multiple of 64 (at least 128), in
bfloat16 (tensor cores) or float32 (CUDA cores).

The mask is the flash kernel's: causal AND ``seg[i] == seg[j]``, with
``seg = pad_mask.astype(int32)``. It is not K1's (``ops/fused_attention``
and the einsum path mask pad *keys* for every query): here a pad query
attends to the pad keys at or before it. The two agree on every real
row and differ on pad rows. No row is ever fully masked (the diagonal
shares its segment), so the mask value only has to be large: the plain
version uses JAX's ``-0.7 * float32.max``, the kernel -1e9.

Numerics, as in the JAX kernel: float32 scores scaled after the product;
P (the unnormalised exp(s - max)) cast to v's dtype before the PV
product, the row sum kept in float32; the backward recomputes P from the
saved float32 LSE and rounds dS = P * (dP - delta) * scale to the
activation dtype before its products. dK/dV belong to the repeated heads
and are summed over each KV head's q heads, which is what autograd
through JAX's ``repeat_kv`` gives.

The kernel's forward is launched through a dispatcher op,
``acco_tpu_torch::flash_fwd`` (:func:`flash_fwd_op`), so that the
``remat='dots'`` policy (``models/layers.wrap_remat``) saves its O and
LSE instead of launching it again in the backward's recompute.

Each wrapper checks device, dtype (bfloat16 or float32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch returned a CUDA error, and adds one
to its count in :data:`LAUNCHES`. :func:`flash_dot_product_attention`
takes the plain path only for tensors on the CPU; a tensor anywhere else
goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from acco_tpu_torch.ops import fused_attention as fa
from acco_tpu_torch.ops.attention import repeat_kv

KERNEL_HEAD_DIMS = (64, 128)  # the head dims csrc/flash_attention.cu is built for
KERNEL_TILE = 64  # L must be a multiple of the kernels' 64-row tiles
MIN_SEQ = 128  # the TPU kernel's smallest block
# JAX's flash kernel's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_flash_attention(seq_len: int, head_dim: int) -> bool:
    """Shapes the Hopper kernel takes: head_dim 64 or 128, L a multiple of
    64 and at least 128. There is no upper bound on L."""
    return (
        head_dim in KERNEL_HEAD_DIMS and seq_len >= MIN_SEQ and seq_len % KERNEL_TILE == 0
    )


# argtypes of the C launchers: (dtype, pointers..., sizes..., scale, stream)
_SIGNATURES = {
    "acco_flash_fwd": [_I] + [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P],
    "acco_flash_bwd_delta": [_I, _P, _P, _P, ctypes.c_long, _I, _P],
    "acco_flash_bwd_dkdv": [_I] + [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P],
    "acco_flash_bwd_dq": [_I] + [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P],
}


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("flash_attention", _SIGNATURES)


def _check_qkv(name, q, k, v, seg):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,H,L,D], k/v [B,Hkv,L,D]; got {q.shape} {k.shape} {v.shape}")
    B, H, L, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (L, D) or H % k.shape[1]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if B * H > 65535:  # the kernels put b*h on the grid's y dimension
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit 65535")
    if not supports_flash_attention(L, D):
        raise ValueError(
            f"{name}: L={L} D={D} outside the kernel's envelope (D in "
            f"{KERNEL_HEAD_DIMS}, L >= {MIN_SEQ} and a multiple of {KERNEL_TILE})"
        )
    if seg is not None and (seg.shape != (B, L) or seg.dtype != torch.int32):
        raise ValueError(f"{name}: segment ids must be int32 [B, L], got {seg.dtype} {tuple(seg.shape)}")
    fa._check_cuda(name, q.dtype, q=q, k=k, v=v, seg=seg)


def _check_bwd(name, q, k, v, seg, dout, lse, delta):
    _check_qkv(name, q, k, v, seg)
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 {tuple(q.shape[:-1])}")
    fa._check_cuda(name, q.dtype, dout=dout, lse=lse, delta=delta)


# -- the four kernel wrappers -----------------------------------------------


def flash_fwd(q, k, v, seg, scale: float):
    """Kernel forward: (O like q, lse [B, H, L] float32)."""
    lib = _library()
    _check_qkv("flash_fwd", q, k, v, seg)
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    err = lib.acco_flash_fwd(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(seg),
        fa._ptr(o), fa._ptr(lse), B, H, k.shape[1], L, D, float(scale), fa._stream(),
    )
    fa._raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_delta(o, dout):
    """Kernel delta = rowsum(dO * O): [B, H, L] float32."""
    lib = _library()
    if o.shape != dout.shape or o.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd_delta: o {tuple(o.shape)} / dout {tuple(dout.shape)}")
    fa._check_cuda("flash_bwd_delta", o.dtype, o=o, dout=dout)
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=o.device)
    err = lib.acco_flash_bwd_delta(
        fa._DTYPE_CODES[o.dtype], fa._ptr(o), fa._ptr(dout), fa._ptr(delta),
        delta.numel(), o.shape[-1], fa._stream(),
    )
    fa._raise_on(err, "flash_bwd_delta")
    LAUNCHES["flash_bwd_delta"] += 1
    return delta


def flash_bwd_dkdv(q, k, v, seg, dout, lse, delta, scale: float):
    """Kernel dK, dV (summed over each KV head's q heads), like k and v."""
    lib = _library()
    _check_bwd("flash_bwd_dkdv", q, k, v, seg, dout, lse, delta)
    B, H, L, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.acco_flash_bwd_dkdv(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(seg),
        fa._ptr(dout), fa._ptr(lse), fa._ptr(delta), fa._ptr(dk), fa._ptr(dv),
        B, H, k.shape[1], L, D, float(scale), fa._stream(),
    )
    fa._raise_on(err, "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, seg, dout, lse, delta, scale: float):
    """Kernel dQ, like q."""
    lib = _library()
    _check_bwd("flash_bwd_dq", q, k, v, seg, dout, lse, delta)
    B, H, L, D = q.shape
    dq = torch.empty_like(q)
    err = lib.acco_flash_bwd_dq(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(seg),
        fa._ptr(dout), fa._ptr(lse), fa._ptr(delta), fa._ptr(dq),
        B, H, k.shape[1], L, D, float(scale), fa._stream(),
    )
    fa._raise_on(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


# -- plain versions -----------------------------------------------------------


def segment_mask(seq_len: int, seg: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Bool [B or 1, 1, L, L]: causal AND seg[i] == seg[j] (the flash
    kernel's mask; ``seg`` None: causal alone)."""
    if seg is not None:
        device = seg.device
    i = torch.arange(seq_len, device=device)
    allowed = (i[None, :] <= i[:, None])[None, None]
    if seg is not None:
        allowed = allowed & (seg[:, :, None] == seg[:, None, :])[:, None]
    return allowed


def _masked_scores(q, k, seg, scale):
    """float32 [B, H, L, L] scale * Q K^T, masked entries at MASK_VALUE
    (K already repeated to q's heads)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    allowed = segment_mask(q.shape[2], seg, q.device)
    return torch.where(allowed, s, torch.full_like(s, MASK_VALUE))


def flash_reference(q, k, v, seg=None, scale=None):
    """Plain forward: (O like q, lse [B, H, L] float32). The flash
    kernel's arithmetic: float32 scores, the unnormalised P = exp(s - max)
    cast to v's dtype before a float32-accumulated PV, divided by the
    float32 row sum. Differentiable through autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kr, vr = repeat_kv(q, k, v)
    s = _masked_scores(q, kr, seg, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), vr.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_probs(q, k, v, seg, dout, lse, delta, scale):
    """float32 (P, dS) with K/V repeated to q's heads, as the JAX flash
    backward forms them: P from the saved LSE, dS = P * (dP - delta) *
    scale, each rounded to the activation dtype before its products."""
    kr, vr = repeat_kv(q, k, v)
    p = torch.exp(_masked_scores(q, kr, seg, scale) - lse[..., None])
    dp = torch.matmul(dout.float(), vr.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p.to(q.dtype).float(), ds, kr


def flash_bwd_dkdv_reference(q, k, v, seg, dout, lse, delta, scale: float):
    """Plain dK, dV (like k and v), summed over each KV head's q heads."""
    p, ds, _ = _bwd_probs(q, k, v, seg, dout, lse, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    n_kv = k.shape[1]
    return fa._sum_heads(dk, n_kv).to(k.dtype), fa._sum_heads(dv, n_kv).to(v.dtype)


def flash_bwd_dq_reference(q, k, v, seg, dout, lse, delta, scale: float):
    """Plain dQ, like q."""
    _, ds, kr = _bwd_probs(q, k, v, seg, dout, lse, delta, scale)
    return torch.matmul(ds, kr.float()).to(q.dtype)


# -- autograd and the public function ---------------------------------------


def _flash_fwd_any(q, k, v, seg, scale):
    """(O, lse): the plain version on the CPU, else the kernel (which
    launches or raises)."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, seg, scale)
    return flash_fwd(q, k, v, seg, scale)


# the forward as a dispatcher op that a remat policy can save; it has no
# shape-only version: a meta tensor also reaches the kernel wrapper
flash_fwd_op = torch.library.custom_op(
    "acco_tpu_torch::flash_fwd", _flash_fwd_any, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? seg, float scale) -> (Tensor, Tensor)")
flash_fwd_op.register_fake(_flash_fwd_any)


class FlashAttention(torch.autograd.Function):
    """The kernel forward with the three-kernel backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale: float):
        o, lse = flash_fwd_op(q, k, v, seg, scale)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_bwd_delta(o, dout)
        dk, dv = flash_bwd_dkdv(q, k, v, seg, dout, lse, delta, ctx.scale)
        dq = flash_bwd_dq(q, k, v, seg, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, Hkv, L, D]
    v: torch.Tensor,  # [B, Hkv, L, D]
    pad_mask: Optional[torch.Tensor] = None,  # [B, L] 1 = real token
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention with the pad mask as segment ids, with the JAX
    ``flash_dot_product_attention``'s signature. The tensors' device
    decides the path: CPU tensors take the plain version (its gradient
    through autograd); any other device goes to the Hopper kernel, which
    raises if it cannot build or launch."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seg = None if pad_mask is None else pad_mask.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return flash_reference(q, k, v, seg, scale)[0]
    return FlashAttention.apply(q, k, v, seg, float(scale))
