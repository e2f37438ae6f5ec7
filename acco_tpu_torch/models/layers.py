"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``acco_tpu/models/layers.py``: norm statistics in float32,
GPT-Neo's ``gelu_new``, the half-rotation (HF/NeoX) RoPE, head split/merge
in the JAX package's [B, H, L, D] layout, and the tied head's float32
logits (:func:`lm_logits`) that both model families share.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def normal_init(
    shape: tuple, stddev: float, dtype, generator: torch.Generator, device=None
) -> torch.Tensor:
    return (
        torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        * stddev
    ).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """Mean and variance in float32; the normalised value is cast to the
    activation dtype before ``* scale + bias`` in that dtype, as the JAX
    ``layer_norm`` does (``F.layer_norm`` would apply the affine in
    float32 before rounding)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-Neo's 'gelu_new' (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] -> float32, summed in float32 with no rounding of
    the product to the operands' dtype. On the card, a bf16 GEMM with
    float32 output (cuBLAS, through ``torch.mm``'s ``out_dtype``);
    elsewhere the widened operands' float32 product, which is the same
    function (a bf16 x bf16 product is exact in float32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _LmLogits(torch.autograd.Function):
    """float32 logits h @ w; the backward rounds the float32 cotangent to
    the activation dtype and runs the two GEMMs in it."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32_out(h.reshape(-1, h.shape[-1]), w).view(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype).reshape(-1, g.shape[-1])
        dh = (g @ w.t()).view(h.shape)
        dw = h.reshape(-1, h.shape[-1]).t() @ g
        return dh, dw


def lm_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., D] x [D, V] -> [..., V] float32 logits accumulated from the
    activation-dtype operands with no rounding to that dtype, as JAX's
    ``einsum(..., preferred_element_type=jnp.float32)`` head does. The
    gradients come back in the activation dtype."""
    return _LmLogits.apply(h, w)


def rope_angles(
    seq_len: int, head_dim: int, theta: float, device=None, offset: int = 0,
    positions: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary position-embedding cos/sin tables, float32 [L, D/2].
    ``offset`` shifts the positions (a contiguous sequence shard starts at
    rank * chunk length); ``positions`` gives each token's absolute
    position instead (a zig-zag shard's tokens are not contiguous)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    if positions is None:
        positions = offset + torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = positions.to(device=device, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation RoPE on [B, H, L, D]."""
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, L, H*D] -> [B, H, L, D]"""
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]"""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)
