"""Fused causal attention: the Hopper kernel, its plain version, its autograd.

Replaces ``acco_tpu/ops/fused_attention.py`` (``_attn_fwd`` and
``_attn_bwd``, the two Pallas TPU kernels behind
``fused_dot_product_attention``). The TPU kernels hold one head's whole
[L, L] float32 score tile in VMEM; an H100 block has 227 KB of shared
memory, so ``csrc/fused_attention.cu`` is a tiled online-softmax kernel
with the same contract instead, for head_dim 64 and 128. What bounds it
on the H100: at the flagship shape (B 8, H 12, L 1024, D 64, bf16) an
ideal forward is memory-bound (~51 MB, ~15 us) and an ideal backward
compute-bound (~32 GFLOP, ~33 us). The design keeps every [L, L]
intermediate out of device memory: blocks walk KV tiles (or q steps)
only inside the causal/window band, with running max, sum and output
rows in registers. bfloat16 inputs run on the wgmma + TMA mainloop of
``csrc/hopper_attention.cuh`` (shared with K5, with K1's mask as its
policy); float32 inputs run FMAs on the CUDA cores. Four kernels:

- ``attn_fwd``: O and the float32 log-sum-exp, one block per q tile;
- ``attn_bwd_delta``: delta = rowsum(dO * O);
- ``attn_bwd_dkdv``: dK, dV summed over the ``n_rep`` q heads of each KV
  head, one block per KV tile (no atomics: deterministic);
- ``attn_bwd_dq``: dQ, one block per q tile.

A row whose keys are all padding (left padding) is normalised over all L
keys, as the TPU kernel's whole-row softmax does: the kernel gives it the
mean of V and lse -1e9, and its backward P = 1 on every key.

The forward reaches its kernel (or, on the CPU, its plain version)
through a dispatcher op, ``acco_tpu_torch::attn_fwd`` (:func:`attn_fwd_op`):
a ctypes launch inside an autograd Function is invisible to a selective
checkpoint policy, which sees only dispatcher ops, so under
``remat='dots'`` the backward's recompute would launch the forward
kernel again. As an op its O and LSE are saved instead, as JAX names
them ``attn_out`` and ``attn_lse`` (acco_tpu/ops/fused_attention.py:216-223).

Each wrapper checks device, dtype (bfloat16 or float32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch returned a CUDA error, and adds one
to its count in :data:`LAUNCHES`. The plain versions
(``attention_reference``, ``delta_reference``,
``attn_bwd_dkdv_reference``, ``attn_bwd_dq_reference``) compute the
same function in PyTorch; :func:`fused_dot_product_attention` takes the
plain path only for tensors on the CPU. A tensor anywhere else goes to
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acco_tpu_torch.ops.attention import NEG_INF, allowed_mask, repeat_kv

KERNEL_HEAD_DIMS = (64, 128)  # the head dims csrc/fused_attention.cu is built for
KERNEL_TILE = 64  # L must be a multiple of 64 (the kernels' 64-row steps)

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {"attn_fwd": 0, "attn_bwd_delta": 0, "attn_bwd_dkdv": 0, "attn_bwd_dq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_attention(seq_len: int, head_dim: int) -> bool:
    """Shapes the Hopper kernel takes: head_dim 64 or 128 and L a multiple
    of 64. Unlike the TPU kernel there is no upper bound on L: no [L, L]
    tile is ever resident."""
    return head_dim in KERNEL_HEAD_DIMS and seq_len >= KERNEL_TILE and (
        seq_len % KERNEL_TILE == 0
    )


# argtypes of the C launchers: (dtype, pointers..., sizes..., scale, stream)
_SIGNATURES = {
    "acco_attn_fwd": [_I] + [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P],
    "acco_attn_bwd_delta": [_I, _P, _P, _P, ctypes.c_long, _I, _P],
    "acco_attn_bwd_dkdv": [_I] + [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P],
    "acco_attn_bwd_dq": [_I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P],
}


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("fused_attention", _SIGNATURES)


def _check_cuda(name: str, dtype: torch.dtype, **tensors) -> None:
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:  # the kernels copy tiles 16 bytes at a time
            raise ValueError(f"{name}: {arg} must start on a 16-byte boundary")
    for arg in ("q", "k", "v", "o", "dout"):
        t = tensors.get(arg)
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} (the kernel takes bfloat16 or float32)")


def _check_qkv(name, q, k, v, pad_mask):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: q [B,H,L,D], k/v [B,Hkv,L,D]; got {q.shape} {k.shape} {v.shape}")
    B, H, L, D = q.shape
    if k.shape[0] != B or k.shape[2:] != (L, D) or H % k.shape[1]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if B * H > 65535:  # the kernels put b*h on the grid's y dimension
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit 65535")
    if not supports_fused_attention(L, D):
        raise ValueError(
            f"{name}: L={L} D={D} outside the kernel's envelope "
            f"(D in {KERNEL_HEAD_DIMS}, L a multiple of {KERNEL_TILE})"
        )
    if pad_mask is not None and (
        pad_mask.shape != (B, L) or pad_mask.dtype != torch.int32
    ):
        raise ValueError(f"{name}: pad_mask must be int32 [B, L], got {pad_mask.dtype} {tuple(pad_mask.shape)}")
    _check_cuda(name, q.dtype, q=q, k=k, v=v, pad_mask=pad_mask)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# -- the four kernel wrappers -----------------------------------------------


def attn_fwd(q, k, v, pad_mask, window: int, scale: float):
    """Kernel forward: (O like q, lse [B, H, L] float32)."""
    lib = _library()
    _check_qkv("attn_fwd", q, k, v, pad_mask)
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    err = lib.acco_attn_fwd(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(pad_mask),
        _ptr(o), _ptr(lse), B, H, k.shape[1], L, D, int(window), float(scale),
        _stream(),
    )
    _raise_on(err, "attn_fwd")
    LAUNCHES["attn_fwd"] += 1
    return o, lse


def attn_bwd_delta(o, dout):
    """Kernel delta = rowsum(dO * O): [B, H, L] float32."""
    lib = _library()
    if o.shape != dout.shape or o.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attn_bwd_delta: o {tuple(o.shape)} / dout {tuple(dout.shape)}")
    _check_cuda("attn_bwd_delta", o.dtype, o=o, dout=dout)
    delta = torch.empty(o.shape[:-1], dtype=torch.float32, device=o.device)
    err = lib.acco_attn_bwd_delta(
        _DTYPE_CODES[o.dtype], _ptr(o), _ptr(dout), _ptr(delta),
        delta.numel(), o.shape[-1], _stream(),
    )
    _raise_on(err, "attn_bwd_delta")
    LAUNCHES["attn_bwd_delta"] += 1
    return delta


def _check_bwd(name, q, k, v, pad_mask, dout, lse, delta):
    _check_qkv(name, q, k, v, pad_mask)
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 {tuple(q.shape[:-1])}")
    _check_cuda(name, q.dtype, dout=dout, lse=lse, delta=delta)


def attn_bwd_dkdv(q, k, v, pad_mask, dout, lse, delta, window: int, scale: float):
    """Kernel dK, dV (GQA-summed), like k and v."""
    lib = _library()
    _check_bwd("attn_bwd_dkdv", q, k, v, pad_mask, dout, lse, delta)
    B, H, L, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.acco_attn_bwd_dkdv(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(pad_mask),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv),
        B, H, k.shape[1], L, D, int(window), float(scale), _stream(),
    )
    _raise_on(err, "attn_bwd_dkdv")
    LAUNCHES["attn_bwd_dkdv"] += 1
    return dk, dv


def attn_bwd_dq(q, k, v, pad_mask, dout, lse, delta, window: int, scale: float):
    """Kernel dQ, like q."""
    lib = _library()
    _check_bwd("attn_bwd_dq", q, k, v, pad_mask, dout, lse, delta)
    B, H, L, D = q.shape
    dq = torch.empty_like(q)
    err = lib.acco_attn_bwd_dq(
        _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(pad_mask),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dq),
        B, H, k.shape[1], L, D, int(window), float(scale), _stream(),
    )
    _raise_on(err, "attn_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    return dq


# -- plain versions -----------------------------------------------------------


def _masked_scores(q, k, pad_mask, window, scale):
    """float32 [B, H, L, L] scale * Q K^T with masked entries at -1e9."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    allowed = allowed_mask(q.shape[2], int(window), pad_mask, q.device)
    return torch.where(allowed, s, torch.full_like(s, NEG_INF))


def attention_reference(q, k, v, pad_mask=None, window: int = 0, scale=None):
    """Plain forward: (O like q, lse [B, H, L] float32). The JAX kernel's
    arithmetic: float32 scores, -1e9 masking, whole-row softmax in
    float32, probabilities cast to the activation dtype before PV.
    Differentiable through autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = repeat_kv(q, k, v)
    s = _masked_scores(q, k, pad_mask, window, scale)
    # normalise as exp(s - max) / sum, as the JAX kernel does: exp(s - lse)
    # would lose a fully masked row's log(L) against the -1e9 fill
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v), torch.logsumexp(s, dim=-1)


def delta_reference(o, dout):
    """Plain delta = rowsum(dO * O) in float32."""
    return (dout.float() * o.float()).sum(-1)


def _bwd_probs(q, k, v, pad_mask, dout, lse, delta, window, scale):
    """float32 (P, dS) with K/V repeated to q's heads, as the JAX
    ``_bwd_kernel`` forms them: P from the saved LSE, dS = P * (dP - delta),
    each cast to the activation dtype before its products."""
    kr, vr = repeat_kv(q, k, v)
    p = torch.exp(_masked_scores(q, kr, pad_mask, window, scale) - lse[..., None])
    dp = torch.matmul(dout.float(), vr.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return p.to(q.dtype).float(), ds, kr


def _sum_heads(x, n_kv):
    """[B, H, L, D] -> [B, n_kv, L, D], summing each KV head's q heads."""
    B, H, L, D = x.shape
    return x.view(B, n_kv, H // n_kv, L, D).sum(2)


def attn_bwd_dkdv_reference(q, k, v, pad_mask, dout, lse, delta, window: int, scale: float):
    """Plain dK, dV (like k and v), summed over each KV head's q heads."""
    p, ds, _ = _bwd_probs(q, k, v, pad_mask, dout, lse, delta, window, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    n_kv = k.shape[1]
    return _sum_heads(dk, n_kv).to(k.dtype), _sum_heads(dv, n_kv).to(v.dtype)


def attn_bwd_dq_reference(q, k, v, pad_mask, dout, lse, delta, window: int, scale: float):
    """Plain dQ, like q."""
    _, ds, kr = _bwd_probs(q, k, v, pad_mask, dout, lse, delta, window, scale)
    return (torch.matmul(ds, kr.float()) * scale).to(q.dtype)


# -- autograd and the public function ---------------------------------------


def _attn_fwd_any(q, k, v, pad_mask, window, scale):
    """(O, lse): the plain version on the CPU, else the kernel (which
    launches or raises)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, pad_mask, window, scale)
    return attn_fwd(q, k, v, pad_mask, window, scale)


# the forward as a dispatcher op that a remat policy can save; it has no
# shape-only version: a meta tensor also reaches the kernel wrapper
attn_fwd_op = torch.library.custom_op(
    "acco_tpu_torch::attn_fwd", _attn_fwd_any, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor? pad_mask, int window, float scale)"
           " -> (Tensor, Tensor)")
attn_fwd_op.register_fake(_attn_fwd_any)


class FusedAttention(torch.autograd.Function):
    """The kernel forward with the three-kernel backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, window: int, scale: float):
        o, lse = attn_fwd_op(q, k, v, pad_mask, window, scale)
        ctx.save_for_backward(q, k, v, pad_mask, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attn_bwd_delta(o, dout)
        dk, dv = attn_bwd_dkdv(
            q, k, v, pad_mask, dout, lse, delta, ctx.window, ctx.scale
        )
        dq = attn_bwd_dq(q, k, v, pad_mask, dout, lse, delta, ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None


class PlainFusedAttention(torch.autograd.Function):
    """The plain forward with the plain versions of the three backward
    kernels as its gradient: the kernel path's arithmetic on the CPU. It
    differs from autograd of the plain forward only on a row with no
    allowed key, where JAX's kernel backward (and the Hopper kernel) take
    P = exp(s - lse) = 1 on every key."""

    @staticmethod
    def forward(ctx, q, k, v, pad_mask, window: int, scale: float):
        o, lse = attn_fwd_op(q, k, v, pad_mask, window, scale)
        ctx.save_for_backward(q, k, v, pad_mask, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad_mask, o, lse = ctx.saved_tensors
        delta = delta_reference(o, dout)
        args = (q, k, v, pad_mask, dout, lse, delta, ctx.window, ctx.scale)
        dk, dv = attn_bwd_dkdv_reference(*args)
        return attn_bwd_dq_reference(*args), dk, dv, None, None, None


def fused_dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, Hkv, L, D]
    v: torch.Tensor,  # [B, Hkv, L, D]
    pad_mask: Optional[torch.Tensor] = None,  # [B, L] 1 = real token
    window: int = 0,  # 0 = global
    scale: Optional[float] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Causal (+window +padding) attention, with the JAX
    ``fused_dot_product_attention``'s signature. The tensors' device
    decides the path: CPU tensors take the plain versions (forward and
    the three backward kernels'); any other device goes to the Hopper
    kernel, which raises if it cannot build or launch. There is no
    interpreter, so ``interpret=True`` raises."""
    if interpret:
        raise ValueError(
            "interpret=True: the Hopper kernel has no interpreter; CPU "
            "tensors already run the plain version"
        )
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    window = int(window)
    if pad_mask is not None:
        pad_mask = pad_mask.to(torch.int32).contiguous()
    if q.device.type == "cpu":
        return PlainFusedAttention.apply(q, k, v, pad_mask, window, float(scale))
    return FusedAttention.apply(q, k, v, pad_mask, window, float(scale))
