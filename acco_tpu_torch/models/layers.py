"""Shared transformer building blocks, as plain functions on tensors.

Counterpart of ``acco_tpu/models/layers.py``: norm statistics in float32,
GPT-Neo's ``gelu_new``, the half-rotation (HF/NeoX) RoPE, head split/merge
in the JAX package's [B, H, L, D] layout, the tied head's float32
logits (:func:`lm_logits`) that both model families share, the layers'
rematerialisation (:func:`wrap_remat`), and tensor parallelism's pieces:
the :class:`TensorGroup`, its all-reduce (:func:`tp_all_reduce`) and the
vocab-parallel embedding (:func:`vocab_parallel_embed`).
"""

from __future__ import annotations

import dataclasses
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
        # no random draws in a layer (no dropout): the recompute needs no
        # RNG state, whose fetch a captured round (compile/graphs.py) refuses
        return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return run


@dataclasses.dataclass(frozen=True)
class TensorGroup:
    """The process group a model's layers are tensor-parallel over, with
    this rank's place in it (the JAX ``tensor_axis``)."""

    group: object  # a torch.distributed ProcessGroup
    size: int
    rank: int

    @classmethod
    def of(cls, group=None) -> "TensorGroup":
        import torch.distributed as dist

        group = group if group is not None else dist.group.WORLD
        return cls(group, dist.get_world_size(group), dist.get_rank(group))


class _TpSum(torch.autograd.Function):
    """Sum over the tensor group, whose backward is the same sum: the
    transpose JAX gives ``lax.psum`` under ``shard_map(check_vma=False)``,
    so that the port's gradients carry JAX's factor tp
    (``parallel/tp.py``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def tp_all_reduce(x: torch.Tensor, tg: "TensorGroup | None") -> torch.Tensor:
    """``lax.psum(x, tensor_axis)``: the sum over ``tg``'s ranks (its
    gradient is summed the same way); ``x`` itself without a group."""
    return x if tg is None else _TpSum.apply(x, tg.group)


def tp_max(x: torch.Tensor, tg: "TensorGroup | None") -> torch.Tensor:
    """Elementwise max over ``tg``'s ranks of a value with no gradient
    (the stabilising max of the vocab-parallel log-sum-exp; JAX gathers
    the maxes, since ``pmax`` has no autodiff rule, and the max of the
    gathered values is the same number)."""
    x = x.detach().clone()
    if tg is not None:
        import torch.distributed as dist

        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tg.group)
    return x


def vocab_parallel_embed(wte: torch.Tensor, input_ids: torch.Tensor,
                         tg: TensorGroup) -> torch.Tensor:
    """Token embedding with the vocab dim sharded over ``tg`` (Megatron's
    vocab-parallel embedding, JAX ``models/layers.py:150-169``): each
    shard looks up its in-range ids (the others at row 0, zeroed) and one
    all-reduce assembles the [B, L, D] embedding."""
    v_local = wte.shape[0]
    loc = input_ids - tg.rank * v_local
    ok = (loc >= 0) & (loc < v_local)
    rows = F.embedding(torch.where(ok, loc, torch.zeros_like(loc)), wte)
    return tp_all_reduce(torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                      device=rows.device)), tg)


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


def apply_rope_at(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-rotation RoPE on [R, H, 1, D] with per-ROW angle tables [R, D/2]
    (``rope_angles`` at each slot's position): the decode step's variant of
    :func:`apply_rope`, each request slot at its own depth."""
    return apply_rope(x, cos[:, None, None, :], sin[:, None, None, :])


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, L, H*D] -> [B, H, L, D]"""
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, -1).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]"""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)
