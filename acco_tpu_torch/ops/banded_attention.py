"""Banded sliding-window attention (K2): the Hopper kernels, their plain
versions, their autograd.

Replaces ``acco_tpu/ops/banded_attention.py`` (``_fwd_kernel``,
``_dq_kernel`` and ``_dkv_kernel``, the three Pallas TPU kernels behind
``banded_dot_product_attention``), which GPT-Neo's local layers run.
Causal attention inside a static window ``W > 0``, computing only the key
band, MHA only, no pad mask. ``csrc/banded_attention.cu`` says what bounds
it on the H100 and how its design answers that: the bf16 kernels are the
wgmma + TMA attention mainloop of ``csrc/hopper_attention.cuh`` (K1's and
K5's) with a band mask policy. Three kernels:

- ``banded_fwd``: O (like q) and the float32 log-sum-exp (the JAX kernel
  takes the band's row max first and rounds the normalised P before PV;
  the bf16 kernel rounds P against its running max, which chip_smoke.py
  holds to the plain version's bars);
- ``banded_bwd_dq``: dQ, one block per 128-row q tile over its key band;
- ``banded_bwd_dkdv``: dK, dV, one block per 128-key tile over the q steps
  that can see it (no atomics: deterministic).

delta = rowsum(dO * O) is K1's hand-written ``attn_bwd_delta``
(``ops/fused_attention.py``), so a backward launches it too.

Envelope: JAX's (``supports_banded_attention``: 0 < W < L,
128 <= L <= 8192, L % 128 == 0, head_dim % 64 == 0, at most 8 blocks of
128 keys in the band) at the head dims the kernels are built for, 64 and
128 (JAX's GPT-Neo presets: 125M's 64, 1.3B's and 2.7B's 128).

Each wrapper checks device, dtype (bfloat16 or float32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch returned a CUDA error, and adds one
to its count in :data:`LAUNCHES`. :func:`banded_dot_product_attention`
takes the plain path only for tensors on the CPU; a tensor anywhere else
goes to the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acco_tpu_torch.ops import fused_attention as fa
from acco_tpu_torch.ops.attention import NEG_INF, allowed_mask

QB = 128  # the JAX kernel's q-row block: the unit of its key band
MAX_BAND_BLOCKS = 8  # the JAX envelope's cap on nprev + 1
KERNEL_HEAD_DIMS = (64, 128)  # the head dims csrc/banded_attention.cu is built for

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {"banded_fwd": 0, "banded_bwd_dq": 0, "banded_bwd_dkdv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of the C launchers: (dtype, pointers..., B, H, L, D, window, scale, stream)
_SIGNATURES = {
    "acco_banded_fwd": [_I] + [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "acco_banded_bwd_dq": [_I] + [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P],
    "acco_banded_bwd_dkdv": [_I] + [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nprev(window: int) -> int:
    """KV blocks of 128 before the diagonal block that a q block can
    reach: ceil((W - 1) / 128), as the JAX kernel counts them."""
    return -(-(window - 1) // QB)


def supports_banded_attention(seq_len: int, head_dim: int, window: int) -> bool:
    """JAX's envelope, at the head dims the Hopper kernels are built for
    (each a multiple of 64, as JAX requires)."""
    return (
        0 < window < seq_len
        and 128 <= seq_len <= 8192
        and seq_len % QB == 0
        and head_dim in KERNEL_HEAD_DIMS
        and _nprev(window) + 1 <= MAX_BAND_BLOCKS
    )


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("banded_attention", _SIGNATURES)


def _check(name, q, k, v, window, **more) -> None:
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must be [B,H,L,D] of one shape; got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, H, L, D = q.shape
    if B * H > 65535:  # the kernels put b*h on the grid's y dimension
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit 65535")
    if not supports_banded_attention(L, D, window):
        raise ValueError(f"{name}: L={L} D={D} window={window} outside the "
                         "kernel's envelope (supports_banded_attention)")
    fa._check_cuda(name, q.dtype, q=q, k=k, v=v, **more)


def _check_bwd(name, q, k, v, dout, lse, delta, window) -> None:
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:-1] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 {tuple(q.shape[:-1])}")
    _check(name, q, k, v, window, dout=dout, lse=lse, delta=delta)


# -- the three kernel wrappers ----------------------------------------------


def banded_fwd(q, k, v, window: int, scale: float):
    """Kernel forward: (O like q, lse [B, H, L] float32)."""
    lib = _library()
    _check("banded_fwd", q, k, v, window)
    B, H, L, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    err = lib.acco_banded_fwd(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(o),
        fa._ptr(lse), B, H, L, D, int(window), float(scale), fa._stream(),
    )
    fa._raise_on(err, "banded_fwd")
    LAUNCHES["banded_fwd"] += 1
    return o, lse


def banded_bwd_dq(q, k, v, dout, lse, delta, window: int, scale: float):
    """Kernel dQ, like q."""
    lib = _library()
    _check_bwd("banded_bwd_dq", q, k, v, dout, lse, delta, window)
    B, H, L, D = q.shape
    dq = torch.empty_like(q)
    err = lib.acco_banded_bwd_dq(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(dout),
        fa._ptr(lse), fa._ptr(delta), fa._ptr(dq), B, H, L, D, int(window),
        float(scale), fa._stream(),
    )
    fa._raise_on(err, "banded_bwd_dq")
    LAUNCHES["banded_bwd_dq"] += 1
    return dq


def banded_bwd_dkdv(q, k, v, dout, lse, delta, window: int, scale: float):
    """Kernel dK, dV, like k and v."""
    lib = _library()
    _check_bwd("banded_bwd_dkdv", q, k, v, dout, lse, delta, window)
    B, H, L, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.acco_banded_bwd_dkdv(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(dout),
        fa._ptr(lse), fa._ptr(delta), fa._ptr(dk), fa._ptr(dv), B, H, L, D,
        int(window), float(scale), fa._stream(),
    )
    fa._raise_on(err, "banded_bwd_dkdv")
    LAUNCHES["banded_bwd_dkdv"] += 1
    return dk, dv


# -- plain versions -----------------------------------------------------------


def banded_reference(q, k, v, window: int, scale: float):
    """Plain forward: (O like q, lse [B, H, L] float32), with the JAX
    kernel's arithmetic: float32 scores, -1e9 outside the band, the row
    max, exp and sum over the whole band, the normalised P cast to the
    activation dtype before PV, lse = max + log(sum). Differentiable
    through autograd."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(allowed_mask(q.shape[2], int(window), None, q.device), s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul((e / l).to(q.dtype), v)
    return o, (m + torch.log(l))[..., 0]


def banded_bwd_dq_reference(q, k, v, dout, lse, delta, window: int, scale: float):
    """Plain dQ: dS = P (dP - delta) cast to the activation dtype before
    dS K, then scaled, as ``_dq_kernel`` does (K1's plain dQ without a
    pad mask)."""
    return fa.attn_bwd_dq_reference(q, k, v, None, dout, lse, delta, window, scale)


def banded_bwd_dkdv_reference(q, k, v, dout, lse, delta, window: int, scale: float):
    """Plain dK, dV: P and dS cast before their products, dK scaled after
    the sum, as ``_dkv_kernel`` does (K1's plain dK/dV without a pad
    mask)."""
    return fa.attn_bwd_dkdv_reference(q, k, v, None, dout, lse, delta, window, scale)


# -- autograd and the public function ---------------------------------------


def _banded_fwd_any(q, k, v, window, scale):
    """(O, lse): the plain version on the CPU, else the kernel (which
    launches or raises)."""
    if q.device.type == "cpu":
        return banded_reference(q, k, v, window, scale)
    return banded_fwd(q, k, v, window, scale)


# the forward as a dispatcher op that the 'dots' remat policy saves (JAX
# names the banded kernel's outputs as the full kernel's); no shape-only
# version: a meta tensor also reaches the kernel wrapper
banded_fwd_op = torch.library.custom_op(
    "acco_tpu_torch::banded_fwd", _banded_fwd_any, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int window, float scale) -> (Tensor, Tensor)")
banded_fwd_op.register_fake(_banded_fwd_any)


class BandedAttention(torch.autograd.Function):
    """The kernel forward with delta + dQ + dK/dV kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, scale: float):
        o, lse = banded_fwd_op(q, k, v, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = fa.attn_bwd_delta(o, dout)
        dq = banded_bwd_dq(q, k, v, dout, lse, delta, ctx.window, ctx.scale)
        dk, dv = banded_bwd_dkdv(q, k, v, dout, lse, delta, ctx.window, ctx.scale)
        return dq, dk, dv, None, None


def banded_dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,  # [B, H, L, D]: MHA only
    v: torch.Tensor,
    window: int,  # a Python int > 0
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal sliding-window attention over the key band only, with the
    JAX ``banded_dot_product_attention``'s signature and checks. CPU
    tensors take the plain version (its gradient through autograd); any
    other device goes to the Hopper kernels, which raise if they cannot
    build or launch."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"banded attention is MHA-only: q heads {q.shape[1]} != kv heads {k.shape[1]}"
        )
    if not isinstance(window, int) or not supports_banded_attention(
        q.shape[2], q.shape[3], window
    ):
        raise ValueError(
            f"shape L={q.shape[2]} D={q.shape[3]} window={window!r} outside the "
            "banded kernel envelope (supports_banded_attention)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return banded_reference(q, k, v, window, scale)[0]
    return BandedAttention.apply(q, k, v, window, float(scale))
