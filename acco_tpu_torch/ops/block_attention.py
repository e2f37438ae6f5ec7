"""One ring hop's attention block: the Hopper kernel (K4), its plain
version, its autograd.

Replaces ``acco_tpu/ops/block_attention.py`` (``_blk_fwd`` and
``_blk_bwd``, the two Pallas TPU kernels behind
``block_attention_partial``), which the ring attention of context
parallelism (``ops/ring_attention.py``) calls once per (q chunk, kv
chunk) block. The function, for q [B, H, Lq, D] and k/v [B, Hkv, Lk, D]
(GQA through head ``h // n_rep``; K and V are never repeated):

    s = scale * Q K^T, masked entries set to -1e9 (a select, not an add)
    m = rowmax(s),  l = rowsum(exp(s - m)),  o = exp(s - m) V

all three float32 and ``o`` unnormalised: the operands of the ring's
online-softmax merge. Three masks: none (a past chunk), ``diag`` (j <= i,
the self hop) and positional (``kv_pos[j] <= q_pos[i]`` and, when
``window`` != 0, ``kv_pos[j] > q_pos[i] - window``: GPT-Neo's windowed
ring). A positional row can be fully masked; it then has m = -1e9,
p = 1 on every key, l = Lk, o = sum of V, and no gradient into q or k,
as in JAX; the merge weighs such a partial by exp(-1e9 - m) = 0.

The backward is the JAX custom VJP's, with cotangents on all three
outputs (do, dm, dl): dp = bf16(do) V^T + dl; w = eq / cnt with
eq = (s == m), the cotangent on m split evenly over tied maxima;
ds = p dp - w sum(p dp) + dm w, zero where masked, rounded to q's dtype;
dq = ds K * scale, dk = ds^T Q * scale, dv = p^T do.

``csrc/block_attention.cu`` computes this in four kernels, the bf16
forward, dK/dV and dQ on the wgmma + TMA attention mainloop of
``csrc/hopper_attention.cuh`` (one instance a mask):

- ``blk_fwd``: one block per 128-row q tile, an online-max pass over the
  KV tiles (the diag mask skips the tiles above the diagonal, the
  positional mask those whose spans of positions cannot meet the rows');
  it returns the final m and o, l rescaled to it, and counts ``cnt =
  #(s == m)`` on the way (exact: the running count restarts whenever the
  running max rises);
- ``blk_bwd_rowc``: per row c = (dm - sum(p dp)) / max(cnt, 1), with
  sum(p dp) = rowsum(bf16(do) * o) + dl * l (the delta trick: o = sum p
  V), so that ds = p dp + eq * c;
- ``blk_bwd_dkdv``: one block per 128-key tile, summing its n_rep q heads
  itself (no atomics, deterministic);
- ``blk_bwd_dq``: one block per 128-row q tile.

Positional masks walk only the tiles whose spans of positions (each
64-position tile's min and max, :func:`positions_with_spans`, appended to
the positions the kernels read) can meet, and mask only the tiles whose
spans do not cover every pair. The bf16 forward takes the max and the
ties on the raw products Q K^T and emits m = scale * max, which is the
backward's s = scale * (its own products, in the same order) at the
maximum, so ``eq`` matches the forward's ``cnt`` bit for bit. Lq and Lk
are multiples of 64: a half tile of 128 reads zeros past the end, and
its rows are never stored.
Numerics against JAX's kernel: P is rounded to bf16 against the running
max rather than the final one before the PV product (as K5 does), and dV
is the product of bf16 P and bf16 do with float32 accumulation where JAX
multiplies float32 p and do. float32 inputs run on the CUDA cores with
no rounding.

Each wrapper checks device, dtype (bfloat16 or float32), shape and
contiguity, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch returned a CUDA error, and adds one
to its count in :data:`LAUNCHES` (the forward under ``blk_fwd_diag``,
``blk_fwd_full`` or ``blk_fwd_pos`` by its mask, the three backward
kernels once per backward). :func:`block_attention_partial` takes the
plain path only for tensors on the CPU; a tensor anywhere else goes to
the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from acco_tpu_torch.ops import fused_attention as fa
from acco_tpu_torch.ops.attention import NEG_INF, repeat_kv

KERNEL_HEAD_DIMS = (64, 128)  # the head dims csrc/block_attention.cu is built for
KERNEL_TILE = 64  # Lq and Lk must be multiples of 64 (half of the kernels' 128-row tiles)
SPAN_TILE = 64  # positions a span covers: every tile of the kernels is a whole number of them
MODES = {"full": 0, "diag": 1, "pos": 2}

# Launches per kernel since the last reset_launch_counts().
LAUNCHES = {
    "blk_fwd_full": 0, "blk_fwd_diag": 0, "blk_fwd_pos": 0,
    "blk_bwd_rowc": 0, "blk_bwd_dkdv": 0, "blk_bwd_dq": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_block_attention(q_len: int, kv_len: int, head_dim: int) -> bool:
    """Shapes the Hopper kernel takes: head_dim 64 or 128, Lq and Lk
    multiples of 64. No upper bound (the TPU kernel's Lc <= 2048 is its
    VMEM tile's)."""
    return (
        head_dim in KERNEL_HEAD_DIMS
        and q_len >= KERNEL_TILE and q_len % KERNEL_TILE == 0
        and kv_len >= KERNEL_TILE and kv_len % KERNEL_TILE == 0
    )


# argtypes of the C launchers: (dtype, pointers..., sizes..., mode, window, scale, stream)
_SIGNATURES = {
    "acco_blk_fwd": [_I] + [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
    "acco_blk_bwd_rowc": [_I] + [_P] * 7 + [ctypes.c_long, _I, _P],
    "acco_blk_bwd_dkdv": [_I] + [_P] * 11 + [_I] * 8 + [ctypes.c_float, _P],
    "acco_blk_bwd_dq": [_I] + [_P] * 10 + [_I] * 8 + [ctypes.c_float, _P],
}


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("block_attention", _SIGNATURES)


def positions_with_spans(pos: torch.Tensor) -> torch.Tensor:
    """int32 [L + 2 L / 64] on ``pos``'s device: the positions [L] (L a
    multiple of 64), then the (min, max) of each 64-position tile, which
    the kernels read to skip the tiles whose pairs no position allows."""
    pos = pos.reshape(-1).to(torch.int32).contiguous()
    tiles = pos.view(-1, SPAN_TILE)
    return torch.cat((pos, torch.stack((tiles.amin(1), tiles.amax(1)), 1).reshape(-1)))


def _spanned(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """Positions as the kernels read them: ``t`` [n] gets its spans (on its
    device); one that has them ([n + 2 n / 64]) passes."""
    if t is None or t.numel() == n + 2 * (n // SPAN_TILE):
        return t
    return positions_with_spans(t)


def _mode(diag: bool, q_pos) -> int:
    return MODES["pos"] if q_pos is not None else MODES["diag" if diag else "full"]


def _check_qkv(name, q, k, v, mode, q_pos, kv_pos):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,H,Lq,D], k/v [B,Hkv,Lk,D]; got {q.shape} {k.shape} {v.shape}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if B * H > 65535:  # the kernels put b*h on the grid's y dimension
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid limit 65535")
    if not supports_block_attention(Lq, Lk, D):
        raise ValueError(
            f"{name}: Lq={Lq} Lk={Lk} D={D} outside the kernel's envelope (D in "
            f"{KERNEL_HEAD_DIMS}, Lq and Lk multiples of {KERNEL_TILE})"
        )
    if mode == MODES["diag"] and Lq != Lk:
        raise ValueError(f"{name}: the diag mask needs Lq == Lk, got {Lq} and {Lk}")
    if mode == MODES["pos"]:
        for arg, t, n in (("q_pos", q_pos, Lq), ("kv_pos", kv_pos, Lk)):
            if t is None or t.dim() != 1 or t.numel() not in (n, n + 2 * (n // SPAN_TILE)) or (
                t.dtype != torch.int32
            ):
                raise ValueError(f"{name}: {arg} must be int32 [{n}] (or with its spans)")
    fa._check_cuda(name, q.dtype, q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
    return _spanned(q_pos, Lq), _spanned(kv_pos, Lk)


def _check_rows(name, B, H, Lq, **rows):
    for arg, t in rows.items():
        if t.shape != (B, H, Lq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 {(B, H, Lq)}")
    fa._check_cuda(name, torch.float32, **rows)


# -- the four kernel wrappers -----------------------------------------------


def blk_fwd(q, k, v, mode: int, q_pos, kv_pos, window: int, scale: float):
    """Kernel forward: (o [B, H, Lq, D], m, l, cnt [B, H, Lq]), float32."""
    lib = _library()
    q_pos, kv_pos = _check_qkv("blk_fwd", q, k, v, mode, q_pos, kv_pos)
    B, H, Lq, D = q.shape
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m, l, cnt = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) for _ in range(3))
    err = lib.acco_blk_fwd(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(q_pos),
        fa._ptr(kv_pos), fa._ptr(o), fa._ptr(m), fa._ptr(l), fa._ptr(cnt),
        B, H, k.shape[1], Lq, k.shape[2], D, mode, int(window), float(scale), fa._stream(),
    )
    fa._raise_on(err, "blk_fwd")
    LAUNCHES["blk_fwd_" + {v_: k_ for k_, v_ in MODES.items()}[mode]] += 1
    return o, m, l, cnt


def blk_bwd_rowc(o, dout, dm, dl, l, cnt):
    """Kernel c = (dm - rowsum(dout * o) - dl * l) / max(cnt, 1): float32
    [B, H, Lq] (``o`` float32 [B, H, Lq, D], ``dout`` like it in the
    activation dtype)."""
    lib = _library()
    if o.shape != dout.shape or o.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"blk_bwd_rowc: o {tuple(o.shape)} / dout {tuple(dout.shape)}")
    B, H, Lq, D = o.shape
    fa._check_cuda("blk_bwd_rowc", dout.dtype, dout=dout)
    _check_rows("blk_bwd_rowc", B, H, Lq, dm=dm, dl=dl, l=l, cnt=cnt)
    if o.dtype != torch.float32:
        raise ValueError("blk_bwd_rowc: o must be float32")
    c = torch.empty((B, H, Lq), dtype=torch.float32, device=o.device)
    err = lib.acco_blk_bwd_rowc(
        fa._DTYPE_CODES[dout.dtype], fa._ptr(o), fa._ptr(dout), fa._ptr(dm), fa._ptr(dl),
        fa._ptr(l), fa._ptr(cnt), fa._ptr(c), c.numel(), D, fa._stream(),
    )
    fa._raise_on(err, "blk_bwd_rowc")
    LAUNCHES["blk_bwd_rowc"] += 1
    return c


def _bwd_args(name, q, k, v, mode, q_pos, kv_pos, dout, m, dl, c):
    """The positions with their spans, after the checks."""
    q_pos, kv_pos = _check_qkv(name, q, k, v, mode, q_pos, kv_pos)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout must be {q.dtype} {tuple(q.shape)}")
    B, H, Lq, _ = q.shape
    fa._check_cuda(name, q.dtype, dout=dout)
    _check_rows(name, B, H, Lq, m=m, dl=dl, c=c)
    return q_pos, kv_pos


def blk_bwd_dkdv(q, k, v, mode: int, q_pos, kv_pos, window: int, scale: float, dout, m, dl, c):
    """Kernel dK, dV like k and v (summed over each KV head's q heads).
    ``dout`` is the cotangent on o in q's dtype."""
    lib = _library()
    q_pos, kv_pos = _bwd_args("blk_bwd_dkdv", q, k, v, mode, q_pos, kv_pos, dout, m, dl, c)
    B, H, Lq, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = lib.acco_blk_bwd_dkdv(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(q_pos),
        fa._ptr(kv_pos), fa._ptr(dout), fa._ptr(m), fa._ptr(dl), fa._ptr(c), fa._ptr(dk),
        fa._ptr(dv), B, H, k.shape[1], Lq, k.shape[2], D, mode, int(window), float(scale),
        fa._stream(),
    )
    fa._raise_on(err, "blk_bwd_dkdv")
    LAUNCHES["blk_bwd_dkdv"] += 1
    return dk, dv


def blk_bwd_dq(q, k, v, mode: int, q_pos, kv_pos, window: int, scale: float, dout, m, dl, c):
    """Kernel dQ like q."""
    lib = _library()
    q_pos, kv_pos = _bwd_args("blk_bwd_dq", q, k, v, mode, q_pos, kv_pos, dout, m, dl, c)
    B, H, Lq, D = q.shape
    dq = torch.empty_like(q)
    err = lib.acco_blk_bwd_dq(
        fa._DTYPE_CODES[q.dtype], fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(q_pos),
        fa._ptr(kv_pos), fa._ptr(dout), fa._ptr(m), fa._ptr(dl), fa._ptr(c), fa._ptr(dq),
        B, H, k.shape[1], Lq, k.shape[2], D, mode, int(window), float(scale), fa._stream(),
    )
    fa._raise_on(err, "blk_bwd_dq")
    LAUNCHES["blk_bwd_dq"] += 1
    return dq


# -- plain versions -----------------------------------------------------------


def block_mask(
    q_len: int, kv_len: int, diag: bool, q_pos=None, kv_pos=None, window: int = 0, device=None
) -> Optional[torch.Tensor]:
    """Bool [Lq, Lk] of allowed (query, key) pairs, or None (no mask)."""
    if q_pos is not None:
        qi, kj = q_pos.long()[:, None], kv_pos.long()[None, :]
        allowed = kj <= qi
        if window:
            allowed = allowed & (kj > qi - window)
        return allowed
    if diag:
        i = torch.arange(q_len, device=device)
        return i[None, :kv_len] <= i[:, None]
    return None


def _masked_scores(q, k, allowed, scale):
    """float32 [B, H, Lq, Lk] scale * Q K^T with masked entries at -1e9
    (K already repeated to q's heads)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if allowed is None:
        return s
    return torch.where(allowed, s, torch.full_like(s, NEG_INF))


def block_fwd_reference(q, k, v, diag=False, q_pos=None, kv_pos=None, window=0, scale=None):
    """Plain forward: (o, m, l, cnt), float32, with the JAX kernel's
    arithmetic: float32 scores, p = exp(s - m) cast to v's dtype before a
    float32-accumulated PV, the row sum of the float32 p. ``cnt`` counts
    the entries equal to the row max (the backward's tie split)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kr, vr = repeat_kv(q, k, v)
    allowed = block_mask(q.shape[2], k.shape[2], diag, q_pos, kv_pos, window, q.device)
    s = _masked_scores(q, kr, allowed, scale)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.matmul(p.to(v.dtype).float(), vr.float())
    cnt = (s == m[..., None]).float().sum(-1)
    return o, m, p.sum(-1), cnt


def _block_bwd_terms(q, k, v, m, dout, dm, dl, diag, q_pos, kv_pos, window, scale):
    """float32 (p, ds) with K/V repeated to q's heads, term by term as the
    JAX ``_bwd_kernel``: dp = dout(in v's dtype) V^T + dl, w = eq / cnt,
    ds = p dp - w sum(p dp) + dm w, zero where masked, rounded to q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kr, vr = repeat_kv(q, k, v)
    allowed = block_mask(q.shape[2], k.shape[2], diag, q_pos, kv_pos, window, q.device)
    s = _masked_scores(q, kr, allowed, scale)
    m = m[..., None]
    p = torch.exp(s - m)
    dp = torch.matmul(dout.to(v.dtype).float(), vr.float().transpose(-1, -2)) + dl[..., None]
    eq = (s == m).float()
    w = eq / eq.sum(-1, keepdim=True).clamp(min=1.0)
    common = (p * dp).sum(-1, keepdim=True)
    ds = p * dp - w * common + dm[..., None] * w
    if allowed is not None:
        ds = torch.where(allowed, ds, torch.zeros_like(ds))
    return p, ds.to(q.dtype).float(), kr, scale


def _dq_of(ds, kr, q, scale):
    return (torch.matmul(ds, kr.float()) * scale).to(q.dtype)


def _dkdv_of(p, ds, q, k, v, dout, scale):
    """ds^T Q * scale and p^T dout (float32 p and dout, as in JAX), each
    summed over the q heads of its KV head."""
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    n_kv = k.shape[1]
    return fa._sum_heads(dk, n_kv).to(k.dtype), fa._sum_heads(dv, n_kv).to(v.dtype)


def block_bwd_dq_reference(q, k, v, m, dout, dm, dl, diag=False, q_pos=None, kv_pos=None,
                           window=0, scale=None):
    """Plain dq like q."""
    _, ds, kr, scale = _block_bwd_terms(q, k, v, m, dout, dm, dl, diag, q_pos, kv_pos, window,
                                        scale)
    return _dq_of(ds, kr, q, scale)


def block_bwd_dkdv_reference(q, k, v, m, dout, dm, dl, diag=False, q_pos=None, kv_pos=None,
                             window=0, scale=None):
    """Plain dk, dv like k, v."""
    p, ds, _, scale = _block_bwd_terms(q, k, v, m, dout, dm, dl, diag, q_pos, kv_pos, window,
                                       scale)
    return _dkdv_of(p, ds, q, k, v, dout, scale)


def block_bwd_reference(q, k, v, m, dout, dm, dl, diag=False, q_pos=None, kv_pos=None,
                        window=0, scale=None):
    """Plain VJP, term by term as the JAX ``_bwd_kernel``: (dq, dk, dv)
    like q, k, v, from the saved row max ``m`` and the float32 cotangents
    ``dout`` [B, H, Lq, D], ``dm``, ``dl`` [B, H, Lq]."""
    p, ds, kr, scale = _block_bwd_terms(q, k, v, m, dout, dm, dl, diag, q_pos, kv_pos, window,
                                        scale)
    return (_dq_of(ds, kr, q, scale), *_dkdv_of(p, ds, q, k, v, dout, scale))


def block_rowc_reference(o, dout, dm, dl, l, cnt):
    """Plain c = (dm - rowsum(dout * o) - dl * l) / max(cnt, 1), float32
    [B, H, Lq]: the backward's row coefficient, ds = p dp + eq c (sum(p
    dp) taken as rowsum(dout * o) + dl * l, since o = sum p V; ``dout`` in
    the activation dtype, as dp = dout V^T takes it)."""
    common = (o.float() * dout.float()).sum(-1) + dl * l
    return (dm - common) / cnt.clamp(min=1.0)


# -- autograd and the public function ---------------------------------------


class _Block(torch.autograd.Function):
    """(o, m, l) of one block with the JAX VJP: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, diag: bool, window: int, scale: float):
        ctx.cfg = (diag, window, scale)
        if q.device.type == "cpu":
            o, m, l, _ = block_fwd_reference(q, k, v, diag, q_pos, kv_pos, window, scale)
            ctx.save_for_backward(q, k, v, q_pos, kv_pos, m)
        else:
            o, m, l, cnt = blk_fwd(q, k, v, _mode(diag, q_pos), q_pos, kv_pos, window, scale)
            ctx.save_for_backward(q, k, v, q_pos, kv_pos, m, o, l, cnt)
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        diag, window, scale = ctx.cfg
        q, k, v, q_pos, kv_pos, m, *fwd = ctx.saved_tensors
        do, dm, dl = do.float().contiguous(), dm.float().contiguous(), dl.float().contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = block_bwd_reference(
                q, k, v, m, do, dm, dl, diag, q_pos, kv_pos, window, scale
            )
        else:
            o, l, cnt = fwd
            mode = _mode(diag, q_pos)
            # dp = do V^T takes do in v's dtype, as the JAX kernel
            do_t = do.to(q.dtype).contiguous()
            c = blk_bwd_rowc(o, do_t, dm, dl, l, cnt)
            args = (q, k, v, mode, q_pos, kv_pos, window, scale, do_t, m, dl, c)
            dk, dv = blk_bwd_dkdv(*args)
            dq = blk_bwd_dq(*args)
        return dq, dk, dv, None, None, None, None, None


def block_attention_partial(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, Hkv, Lk, D]
    v: torch.Tensor,  # [B, Hkv, Lk, D]
    diag: bool = False,
    scale: Optional[float] = None,
    q_positions: Optional[torch.Tensor] = None,  # [Lq] absolute positions
    kv_positions: Optional[torch.Tensor] = None,  # [Lk]
    window: int = 0,  # 0 = global causal
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's unnormalised partial ``(o, m, l)``, float32, with the
    JAX ``block_attention_partial``'s signature and VJP. The tensors'
    device decides the path: CPU tensors take the plain version; any other
    device goes to the Hopper kernel, which raises if it cannot build or
    launch."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions go together")
    if q_positions is not None and diag:
        raise ValueError("diag and positional masking are exclusive")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q_positions is not None:
        # host positions go over without a sync: the ring's layouts are host
        # tensors; for the kernels with their spans, computed where they lie
        spans = q.device.type != "cpu" and supports_block_attention(
            q.shape[2], k.shape[2], q.shape[3])
        q_positions, kv_positions = (
            (positions_with_spans(t) if spans else t.to(torch.int32)).to(q.device,
                                                                          non_blocking=True)
            for t in (q_positions, kv_positions)
        )
    if q.device.type != "cpu":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _Block.apply(
        q, k, v, q_positions, kv_positions, bool(diag), int(window or 0), float(scale)
    )
