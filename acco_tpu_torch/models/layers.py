"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``acco_tpu/models/layers.py``: norm statistics in float32,
the half-rotation (HF/NeoX) RoPE, head split/merge in the JAX package's
[B, H, L, D] layout.
"""

from __future__ import annotations

import torch


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


def rope_angles(
    seq_len: int, head_dim: int, theta: float, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary position-embedding cos/sin tables, float32 [L, D/2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = positions[:, None] * inv_freq[None, :]
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
