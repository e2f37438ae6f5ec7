"""Ring attention: causal attention over a sequence-sharded process group.

Counterpart of ``acco_tpu/ops/ring_attention.py``. Each rank of the
sequence group holds one chunk of the sequence; K/V chunks rotate around
the ring (rank r sends to r + 1 and receives from r - 1) while each rank
accumulates its queries' attention with the online-softmax merge
(:func:`_merge`). Three layouts:

- :func:`ring_attention`: contiguous chunks, rank i holds tokens
  [i Lc, (i + 1) Lc);
- :func:`zigzag_ring_attention`: rank i holds half-chunks i and
  2 ws - 1 - i (:func:`zigzag_positions`), which balances the causal work;
- :func:`windowed_ring_attention`: exact causal + sliding-window masking
  from absolute token positions (GPT-Neo), for either layout.

Each block is the ring block kernel (K4, ``ops/block_attention.py``:
block_impl 'fused') or its jnp-form counterpart in float32 ('xla');
'auto' is 'fused' on CUDA and 'xla' on the CPU, as the JAX resolver picks
the Pallas block on the TPU only. The rank is a Python int here, so the
block choices JAX makes with ``lax.switch``/``cond``/``where`` (full,
diagonal or skipped block; a fully masked windowed hop; zig-zag's wrapped
hops) are plain ``if``s. The K/V rotation still runs on every hop on every
rank: the ring stays uniform.

The exchange (:class:`_RingShift`) is one ``torch.autograd.Function`` per
hop that moves K and V together, stacked into one tensor, with
``dist.batch_isend_irecv`` on the sequence group; its backward makes the
reverse exchange, which is what JAX's transposed ``ppermute`` gives. One
exchange per hop keeps the backward ring one chain whose order the
autograd engine cannot vary from rank to rank. A sequence group of one
rank runs no hop, as JAX's scan runs none on a size-1 axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

_NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SequenceGroup:
    """The process group the sequence is sharded over, with this rank's
    place in it (the JAX ``sequence_axis``)."""

    group: object  # a torch.distributed ProcessGroup
    size: int
    rank: int

    @classmethod
    def of(cls, group=None) -> "SequenceGroup":
        import torch.distributed as dist

        group = group if group is not None else dist.group.WORLD
        return cls(group, dist.get_world_size(group), dist.get_rank(group))


def _resolve_block_impl(impl: str, device) -> str:
    """'auto' -> 'fused' (K4) on CUDA, 'xla' elsewhere; 'xla'/'fused' force."""
    if impl == "auto":
        return "fused" if torch.device(device).type == "cuda" else "xla"
    if impl not in ("xla", "fused"):
        raise ValueError(f"ring block impl must be auto/xla/fused, got {impl!r}")
    return impl


class _RingShift(torch.autograd.Function):
    """(k, v) -> the previous rank's (k, v), in one exchange; the backward
    sends the gradients the other way round."""

    @staticmethod
    def _shift(x: torch.Tensor, sg: SequenceGroup, step: int) -> torch.Tensor:
        import torch.distributed as dist

        send_to = dist.get_global_rank(sg.group, (sg.rank + step) % sg.size)
        recv_from = dist.get_global_rank(sg.group, (sg.rank - step) % sg.size)
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, send_to, sg.group),
               dist.P2POp(dist.irecv, out, recv_from, sg.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    @staticmethod
    def forward(ctx, k, v, sg):
        ctx.sg = sg
        kv = _RingShift._shift(torch.stack([k, v]).contiguous(), sg, 1)
        return kv[0], kv[1]

    @staticmethod
    def backward(ctx, dk, dv):
        g = _RingShift._shift(torch.stack([dk, dv]).contiguous(), ctx.sg, -1)
        return g[0], g[1], None


def _exchange(k, v, sg: SequenceGroup):
    return _RingShift.apply(k, v, sg)


class _Keep(torch.autograd.Function):
    """``o`` unchanged, with (k, v) as inputs whose gradient is zero: a hop
    whose block is skipped on this rank still takes part in the backward
    ring, whose exchanges every rank must run (JAX's transposed ppermute
    runs everywhere and sends zeros)."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.kv = (k.shape, k.dtype, v.shape, v.dtype, k.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        ks, kd, vs, vd, dev = ctx.kv
        return do, torch.zeros(ks, dtype=kd, device=dev), torch.zeros(vs, dtype=vd, device=dev)


def _skip(o, k_c, v_c, sg: SequenceGroup):
    """The accumulator past a skipped block (see :class:`_Keep`)."""
    return _Keep.apply(o, k_c, v_c) if sg.size > 1 else o


def _merge(o, m, l, o_blk, m_blk, l_blk):
    """Online-softmax merge of an unnormalised block partial into the
    running (o, m, l). ``torch.maximum`` splits its gradient in half on a
    tie, as ``jnp.maximum`` does."""
    m_new = torch.maximum(m, m_blk)
    corr = torch.exp(m - m_new)
    corr_blk = torch.exp(m_blk - m_new)
    return (
        o * corr[..., None] + o_blk * corr_blk[..., None],
        m_new,
        l * corr + l_blk * corr_blk,
    )


def _expand(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x.repeat_interleave(n_rep, dim=1) if n_rep > 1 else x


def _init_acc(B, H, L, D, device):
    return (
        torch.zeros((B, H, L, D), dtype=torch.float32, device=device),
        torch.full((B, H, L), _NEG_INF, dtype=torch.float32, device=device),
        torch.zeros((B, H, L), dtype=torch.float32, device=device),
    )


def _normalise(o, l, dtype):
    return (o / l.clamp(min=1e-30)[..., None]).to(dtype)


def ring_attention(
    q: torch.Tensor,  # [B, H, Lc, D]: this rank's query chunk
    k: torch.Tensor,  # [B, Hkv, Lc, D]
    v: torch.Tensor,  # [B, Hkv, Lc, D]
    sg: SequenceGroup,
    scale: Optional[float] = None,
    block_impl: str = "auto",
) -> torch.Tensor:
    """Causal attention where rank i holds tokens [i Lc, (i + 1) Lc).
    Returns this rank's output chunk [B, H, Lc, D] in q's dtype. No pad
    mask: the path serves const-len packed sequences."""
    from acco_tpu_torch.ops.block_attention import block_attention_partial

    ws, my_idx = sg.size, sg.rank
    n_rep = q.shape[1] // k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    block_impl = _resolve_block_impl(block_impl, q.device)
    B, H, Lc, D = q.shape
    qf = q.float() if block_impl == "xla" else q
    i_loc = torch.arange(Lc, device=q.device)
    diag_bias = torch.where(
        i_loc[None, :] <= i_loc[:, None],
        torch.zeros((), device=q.device), torch.full((), _NEG_INF, device=q.device),
    )

    def block_update(o, m, l, k_c, v_c, kv_idx):
        if block_impl == "fused":
            # past chunk = full block, self = causal triangle, future = skipped
            if kv_idx > my_idx:
                return _skip(o, k_c, v_c, sg), m, l
            return _merge(o, m, l, *block_attention_partial(
                q, k_c, v_c, diag=kv_idx == my_idx, scale=scale))
        scores = torch.matmul(qf, _expand(k_c, n_rep).float().transpose(-1, -2)) * scale
        if kv_idx == my_idx:
            scores = scores + diag_bias
        elif kv_idx > my_idx:
            scores = scores + _NEG_INF
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        o_new = o * corr[..., None] + torch.matmul(p, _expand(v_c, n_rep).float())
        return o_new, m_new, l_new

    o, m, l = _init_acc(B, H, Lc, D, q.device)
    k_c, v_c = k, v
    for s in range(ws):
        if s:
            k_c, v_c = _exchange(k_c, v_c, sg)
        o, m, l = block_update(o, m, l, k_c, v_c, (my_idx - s) % ws)
    return _normalise(o, l, q.dtype)


def windowed_ring_attention(
    q: torch.Tensor,  # [B, H, Lc, D]
    k: torch.Tensor,  # [B, Hkv, Lc, D]
    v: torch.Tensor,  # [B, Hkv, Lc, D]
    sg: SequenceGroup,
    window: int,  # 0 = global causal, w = sliding window
    q_positions: torch.Tensor,  # [Lc] absolute positions of this rank's tokens (CPU)
    kv_positions_fn: Callable[[int], torch.Tensor],  # rank -> [Lc] positions (CPU)
    scale: Optional[float] = None,
    block_impl: str = "auto",
) -> torch.Tensor:
    """Ring attention with exact causal + sliding-window masking from
    absolute positions (HF semantics: i attends j iff j <= i and, with a
    window, j > i - window). The positions are host tensors, pure
    functions of the layout, so whether a hop is fully masked (and skips
    its block) is decided on the host; the K/V rotation still runs."""
    from acco_tpu_torch.ops.block_attention import block_attention_partial

    ws, my_idx = sg.size, sg.rank
    n_rep = q.shape[1] // k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    block_impl = _resolve_block_impl(block_impl, q.device)
    B, H, Lc, D = q.shape
    qf = q.float() if block_impl == "xla" else q
    qi = q_positions.long()

    def live(kj):
        """Does any query see any of these keys? (host work over the
        positions, O(Lc log Lc): the count of keys in (qi - window, qi])"""
        kj = kj.long().sort().values
        hi = torch.searchsorted(kj, qi, right=True)
        lo = torch.searchsorted(kj, qi - window, right=True) if window else 0
        return bool(((hi - lo) > 0).any())

    def block_update(o, m, l, k_c, v_c, src):
        kj = kv_positions_fn(src)
        if not live(kj):
            return _skip(o, k_c, v_c, sg), m, l
        if block_impl == "fused":
            return _merge(o, m, l, *block_attention_partial(
                qf, k_c, v_c, scale=scale, q_positions=q_positions, kv_positions=kj,
                window=window))
        kj = kj.long().to(q.device)[None, :]
        qd = qi.to(q.device)[:, None]
        mask = (kj <= qd) & ((window == 0) | (kj > qd - window))
        scores = torch.matmul(qf, _expand(k_c, n_rep).float().transpose(-1, -2)) * scale
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        o_new = o * corr[..., None] + torch.matmul(p, _expand(v_c, n_rep).float())
        return o_new, m_new, l_new

    o, m, l = _init_acc(B, H, Lc, D, q.device)
    k_c, v_c = k, v
    for s in range(ws):
        if s:
            k_c, v_c = _exchange(k_c, v_c, sg)
        o, m, l = block_update(o, m, l, k_c, v_c, (my_idx - s) % ws)
    return _normalise(o, l, q.dtype)


def zigzag_positions(global_len: int, ws: int, shard_index: int, device=None) -> torch.Tensor:
    """Absolute positions [global_len / ws] (int64) of shard
    ``shard_index``'s tokens under the zig-zag layout: half-chunks i and
    2 ws - 1 - i of 2 ws. Made on ``device`` (the host by default)."""
    lh = global_len // (2 * ws)
    early = shard_index * lh + torch.arange(lh, device=device)
    late = (2 * ws - 1 - shard_index) * lh + torch.arange(lh, device=device)
    return torch.cat([early, late])


def zigzag_permutation(global_len: int, ws: int):
    """numpy ``(perm, inverse_perm)`` with ``x_zigzag = x[..., perm]``: the
    global sequence reordered so that contiguous sharding over ws ranks
    lands half-chunks (i, 2 ws - 1 - i) on rank i."""
    if global_len % (2 * ws):
        raise ValueError(
            f"zig-zag layout needs global_len divisible by 2*ws "
            f"({2 * ws}); got {global_len} — a shorter permutation would "
            f"silently truncate every sequence"
        )
    lh = global_len // (2 * ws)
    order = []
    for i in range(ws):
        order.extend(range(i * lh, (i + 1) * lh))
        order.extend(range((2 * ws - 1 - i) * lh, (2 * ws - i) * lh))
    perm = np.asarray(order, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def zigzag_ring_attention(
    q: torch.Tensor,  # [B, H, Lc, D]: [early half; late half]
    k: torch.Tensor,  # [B, Hkv, Lc, D]
    v: torch.Tensor,  # [B, Hkv, Lc, D]
    sg: SequenceGroup,
    scale: Optional[float] = None,
    block_impl: str = "auto",
) -> torch.Tensor:
    """Causal ring attention over the zig-zag layout. Rank i's chunk is
    half-chunks (i, 2 ws - 1 - i); every hop computes two unmasked
    half-blocks:

    - self hop (s = 0):   qa x ea (diag), qb x lb (diag), qb x ea (full)
    - no-wrap hop (j < i): qa x ea (full), qb x ea (full)
    - wrapped hop (j > i): qb x ea (full), qb x la (full)
    """
    from acco_tpu_torch.ops.block_attention import block_attention_partial

    ws, my_idx = sg.size, sg.rank
    n_rep = q.shape[1] // k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    block_impl = _resolve_block_impl(block_impl, q.device)
    B, H, Lc, D = q.shape
    lh = Lc // 2
    qf = q.float() if block_impl == "xla" else q
    qa, qb = qf[:, :, :lh], qf[:, :, lh:]
    i_loc = torch.arange(lh, device=q.device)
    diag_bias = torch.where(
        i_loc[None, :] <= i_loc[:, None],
        torch.zeros((), device=q.device), torch.full((), _NEG_INF, device=q.device),
    )

    def attend(q_half, k_half, v_half, diag: bool):
        if block_impl == "fused":
            return block_attention_partial(q_half, k_half, v_half, diag=diag, scale=scale)
        scores = torch.matmul(q_half, _expand(k_half, n_rep).float().transpose(-1, -2)) * scale
        if diag:
            scores = scores + diag_bias
        m_blk = scores.amax(-1)
        p = torch.exp(scores - m_blk[..., None])
        return torch.matmul(p, _expand(v_half, n_rep).float()), m_blk, p.sum(-1)

    def halves(x):
        return x[:, :, :lh], x[:, :, lh:]

    (ka, kb), (va, vb) = halves(k), halves(v)
    a = _merge(*_init_acc(B, H, lh, D, q.device), *attend(qa, ka, va, True))
    b = _merge(*_init_acc(B, H, lh, D, q.device), *attend(qb, kb, vb, True))
    b = _merge(*b, *attend(qb, ka, va, False))
    k_c, v_c = k, v
    for s in range(1, ws):
        k_c, v_c = _exchange(k_c, v_c, sg)
        (ea_k, la_k), (ea_v, la_v) = halves(k_c), halves(v_c)
        if (my_idx - s) % ws > my_idx:  # wrapped: both blocks into b
            b = _merge(*b, *attend(qb, ea_k, ea_v, False))
            b = _merge(*b, *attend(qb, la_k, la_v, False))
        else:
            a = _merge(*a, *attend(qa, ea_k, ea_v, False))
            b = _merge(*b, *attend(qb, ea_k, ea_v, False))
    o = torch.cat([_normalise(a[0], a[2], torch.float32), _normalise(b[0], b[2], torch.float32)],
                  dim=2)
    return o.to(q.dtype)
