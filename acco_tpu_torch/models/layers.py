"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``acco_tpu/models/layers.py``: norm statistics in float32,
GPT-Neo's ``gelu_new``, the half-rotation (HF/NeoX) RoPE, head split/merge
in the JAX package's [B, H, L, D] layout, the tied head's float32
logits (:func:`lm_logits`) that both model families share, and the
layers' rematerialisation (:func:`wrap_remat`).
"""

from __future__ import annotations

import functools

import torch
from torch.nn import functional as F


def _remat_saved_ops(remat) -> list:
    """The dispatcher ops whose outputs a selective remat mode keeps: the
    matmuls with no batch dims (JAX's ``dots_with_no_batch_dims_saveable``:
    ``aten.mm``/``addmm``; the attention scores' batched products are
    recomputed) and the attention kernels' forward ops (O and LSE, JAX's
    ``attn_out``/``attn_lse``); with 'dots+probs' also the plain path's
    activation-dtype probabilities (``attn_probs``)."""
    # importing the ops modules registers their ops
    from acco_tpu_torch.ops import attention, banded_attention, flash_attention  # noqa: F401
    from acco_tpu_torch.ops import fused_attention  # noqa: F401

    ours = torch.ops.acco_tpu_torch
    ops = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           ours.attn_fwd.default, ours.flash_fwd.default, ours.banded_fwd.default]
    if remat == "dots+probs":
        ops.append(ours.attn_probs.default)
    return ops


def wrap_remat(block, remat):
    """``block`` under the configured rematerialisation, as JAX's
    ``wrap_remat`` (acco_tpu/models/layers.py:29-82):

    - ``False``: ``block`` itself, every activation stored;
    - ``True``: ``torch.utils.checkpoint`` of the whole block, which the
      backward reruns, attention kernels included (``jax.checkpoint``);
    - ``'dots'``: a selective checkpoint that keeps the outputs of the
      matmuls with no batch dims and the attention kernels' O and LSE
      and recomputes the rest (norms, RoPE, activations, the plain
      path's scores and softmax): the forward kernels of K1, K2 and K5
      are not launched again;
    - ``'dots+probs'``: ``'dots'`` plus the plain path's probabilities.

    Spellings go through ``ops.attention.normalize_remat``. Outside
    autograd (eval, ``no_grad``) the block runs as it is."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    from acco_tpu_torch.ops.attention import normalize_remat

    remat = normalize_remat(remat)
    if remat is False:
        return block
    kw = {}
    if remat != True:  # noqa: E712 — 'dots' and 'dots+probs' (strings)
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _remat_saved_ops(remat))

    def run(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False, **kw)

    return run


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
