"""Fused lm-head + cross-entropy: the Hopper kernel (K3), its plain version, its autograd.

Replaces ``acco_tpu/ops/fused_ce.py``: ``_lm_head_ce_fwd`` and the three
Pallas calls of ``_lm_head_ce_bwd`` (its fused form and its split dH / dW
form). The loss never writes the [N, V] float32 logits to device memory:
the forward keeps a running (max, sumexp, true logit, sum of real logits)
per row over vocab tiles. The backward computes the logits once more and
writes dlogits, rounded to the activation dtype as the JAX ``_dp_tile``
rounds them, into a [Nc, Vp] buffer (Vp = V rounded up to 128) that the
dH and dW products then read: the buffer holds the values JAX's kernel
multiplies, but JAX keeps them in VMEM and the port moves them through
device memory, 2 Nc Vp bytes at a time. The rows are taken in chunks of
Nc so that the buffer stays under ``DP_CAP_BYTES`` (2 GiB: one chunk at
the Llama-125M head, 0.77 GiB at N 8192 x V 50257, and at Llama-3-8B's,
1.96 GiB at N 8192 x V 128256), which :func:`dp_plan` decides; with
several chunks dW sums in a float32 [V, D] buffer in chunk order and is
rounded once. JAX's fused backward, its [T, N, D] float32 dH partials and
the cap that switches it to the split form (``ACCO_FUSED_CE_PARTIAL_CAP``)
exist for the TPU's VMEM pipeline and have no counterpart here.
``csrc/fused_ce.cu`` says what bounds the kernels and how they are built
on ``csrc/hopper_gemm.cuh``.

The head reaches the kernels as the row-major [V, D] matrix it is stored
as (the tied embedding table), and dW comes back in that layout: the
[D, V] view the models hand over is transposed back, not copied.

Kernel wrappers, bfloat16 (the training path): :func:`ce_fwd`,
:func:`ce_bwd_dp`, :func:`ce_bwd_dh` (from dp) and :func:`ce_bwd_dw`
(from dp); float32 (CUDA cores, recomputing dp): :func:`ce_fwd`,
:func:`ce_bwd_dh_f32` and :func:`ce_bwd_dw_f32`, which count as
``ce_bwd_dh`` and ``ce_bwd_dw``. Each checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty`` unless given them,
launches on the current stream, raises if the launch returned a CUDA
error, and adds one to its count in :data:`LAUNCHES`. Their plain
versions (:func:`ce_fwd_reference`, :func:`ce_bwd_dp_reference`,
:func:`ce_bwd_dh_reference`, :func:`ce_bwd_dw_reference`, and the whole
chunked backward :func:`lm_head_ce_backward_reference`) materialize the
logits in PyTorch. :func:`fused_ce_loss` takes the plain versions only
for tensors on the CPU; a tensor anywhere else goes to the kernels or
raises. :func:`vocab_parallel_fused_ce_loss` (JAX: ``fused_ce.py:503``)
runs the same kernels per vocab shard under tensor parallelism, with a
cross-shard LSE combine.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from acco_tpu_torch.ops.losses import IGNORE_INDEX

NEG = -1e30  # the JAX kernel's column mask (``_NEG``)
TILE = 64  # rows (hidden or vocab) per tile of the float32 kernels
GEMM_TILE = 128  # hidden rows per tile of the bf16 kernels (csrc/hopper_gemm.cuh)
VOCAB_TILE = 256  # vocab columns per tile of the bf16 forward and dp
DP_CAP_BYTES = 2 << 30  # the most the backward's bf16 dp buffer may take

# Launches per kernel wrapper since the last reset_launch_counts();
# ``ce_fwd`` is one C call that launches the split pass and its merge.
# ``vp_ce`` counts the vocab-parallel wrapper's calls on the card, each
# of which launches ``ce_fwd`` on its shard.
LAUNCHES = {"ce_fwd": 0, "ce_bwd_dp": 0, "ce_bwd_dh": 0, "ce_bwd_dw": 0, "vp_ce": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int

# argtypes of the C launchers: (pointers..., sizes..., stream)
_SIGNATURES = {
    "acco_ce_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    "acco_ce_bwd_dp": [_P] * 8 + [_I] * 7 + [_P],
    "acco_ce_bwd_dh": [_P] * 3 + [_I] * 4 + [_P],
    "acco_ce_bwd_dw": [_P] * 4 + [_I] * 5 + [_P],
    "acco_ce_bwd_dh_f32": [_P] * 8 + [_I] * 4 + [_P],
    "acco_ce_bwd_dw_f32": [_P] * 8 + [_I] * 4 + [_P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_ce(n_rows: int, hidden: int, vocab: int) -> bool:
    """The JAX kernel's envelope: at least one row, a hidden dim that is a
    multiple of 128, at least 128 vocab columns. The Hopper kernels check
    their own bounds, so no row or vocab count needs padding."""
    return n_rows >= 1 and hidden % 128 == 0 and vocab >= 128


def padded_vocab(vocab: int) -> int:
    """Vp: the dp buffer's row length, V rounded up to a tile of 128 (TMA
    needs rows of a multiple of 16 bytes, and V = 50257 is odd)."""
    return -(-vocab // GEMM_TILE) * GEMM_TILE


@dataclass(frozen=True)
class DpPlan:
    """How the backward takes the rows: chunks of ``chunk_rows`` (the last
    one ragged), a bf16 dp buffer [chunk_rows, vp], and whether dW sums in
    a float32 [V, D] buffer (more than one chunk)."""

    vp: int
    chunk_rows: int
    n_chunks: int
    dw_f32: bool

    def chunks(self, n_rows: int):
        for r0 in range(0, n_rows, self.chunk_rows):
            yield r0, min(n_rows, r0 + self.chunk_rows)


def dp_plan(n_rows: int, vocab: int, cap_bytes: int = DP_CAP_BYTES) -> DpPlan:
    """Chunks of the most rows whose bf16 dp fits ``cap_bytes`` (a
    multiple of 128 rows where that is at least one tile, else of 4, so
    that every chunk's float32 rows start on a 16-byte boundary), taken
    from the first row; the last chunk holds what is left."""
    vp = padded_vocab(vocab)
    rows = max(1, cap_bytes // (2 * vp))
    if rows >= GEMM_TILE:
        rows -= rows % GEMM_TILE
    elif rows >= 4:
        rows -= rows % 4
    chunk = min(n_rows, rows)
    n_chunks = -(-n_rows // chunk)
    return DpPlan(vp=vp, chunk_rows=chunk, n_chunks=n_chunks, dw_f32=n_chunks > 1)


def dw_mode(chunk: int, n_chunks: int) -> int:
    """What ``ce_bwd_dw`` does with chunk ``chunk``'s product: 0 write dW
    (one chunk), 1 write the float32 sum, 2 add to it, 3 add and write dW."""
    if n_chunks == 1:
        return 0
    return 1 if chunk == 0 else 3 if chunk == n_chunks - 1 else 2


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("fused_ce", _SIGNATURES)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on_card(name: str, *tensors) -> None:
    """Every tensor on CUDA, contiguous, and starting on a 16-byte
    boundary (TMA's and the float32 kernels' copies)."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: a tensor is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every input must start on a 16-byte boundary")


def _check(name: str, h, w, tgt, v_real: int, rows=()) -> None:
    """h [N, D] and w [V, D] of one dtype, tgt int32 [N], float32 [N] rows."""
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: h [N, D], w [V, D]; got {tuple(h.shape)} {tuple(w.shape)}")
    N, D = h.shape
    V = w.shape[0]
    if h.dtype != w.dtype or h.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: h {h.dtype}, w {w.dtype} (one of bfloat16, float32)")
    if N < 1 or D % 128 or not 0 <= v_real <= V:
        raise ValueError(f"{name}: N={N} D={D} V={V} v_real={v_real} outside the kernel's "
                         "envelope (N >= 1, D a multiple of 128, 0 <= v_real <= V)")
    if tgt.shape != (N,) or tgt.dtype != torch.int32:
        raise ValueError(f"{name}: tgt must be int32 [{N}], got {tgt.dtype} {tuple(tgt.shape)}")
    for i, r in enumerate(rows):
        if r.shape != (N,) or r.dtype != torch.float32:
            raise ValueError(f"{name}: row input {i} must be float32 [{N}]")
    _on_card(name, h, w, tgt, *rows)


def _check_dp(name: str, dp, other, vocab: int) -> None:
    """dp bf16 [N, Vp] with Vp = padded_vocab(vocab), other bf16 [*, D]."""
    if dp.dim() != 2 or dp.dtype != torch.bfloat16 or dp.shape[1] != padded_vocab(vocab):
        raise ValueError(f"{name}: dp must be bfloat16 [N, {padded_vocab(vocab)}], got "
                         f"{dp.dtype} {tuple(dp.shape)}")
    if other.dim() != 2 or other.dtype != torch.bfloat16 or other.shape[1] % 128:
        raise ValueError(f"{name}: the other operand must be bfloat16 [*, D], D a multiple of "
                         f"128; got {other.dtype} {tuple(other.shape)}")
    if dp.shape[0] < 1:
        raise ValueError(f"{name}: no rows")


def _check_out(name: str, out, shape, dtype) -> None:
    if out.shape != shape or out.dtype != dtype:
        raise ValueError(f"{name}: out must be {dtype} {tuple(shape)}, got {out.dtype} "
                         f"{tuple(out.shape)}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def vocab_splits(n_rows: int, vocab: int, n_sm: int, row_tile: int = TILE,
                 vocab_tile: int = TILE) -> tuple[int, int]:
    """(splits, tiles per split) of a pass over the vocab in tiles of
    ``vocab_tile``, one block per (row tile, split), no split empty: the
    fewest splits whose waves of ``n_sm`` blocks, each as long as its
    tiles per split, take the least time."""
    row_tiles = math.ceil(n_rows / row_tile)
    vocab_tiles = math.ceil(vocab / vocab_tile)
    best = None
    for want in range(1, min(vocab_tiles, 64) + 1):
        per = math.ceil(vocab_tiles / want)
        splits = math.ceil(vocab_tiles / per)
        cost = math.ceil(row_tiles * splits / n_sm) * per
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- the kernel wrappers ------------------------------------------------------


def ce_fwd(h, w, tgt, v_real: int):
    """Kernel forward: per-row (lse, true logit, sum of real logits), each
    float32 [N]."""
    lib = _library()
    _check("ce_fwd", h, w, tgt, v_real)
    N, D = h.shape
    V = w.shape[0]
    tiles = (GEMM_TILE, VOCAB_TILE) if h.dtype == torch.bfloat16 else (TILE, TILE)
    splits, per = vocab_splits(N, V, _n_sm(h.device), *tiles)
    part = torch.empty((4, splits, N), dtype=torch.float32, device=h.device)
    lse, tl, sl = (torch.empty(N, dtype=torch.float32, device=h.device) for _ in range(3))
    err = lib.acco_ce_fwd(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(tgt), _ptr(part), _ptr(lse), _ptr(tl),
        _ptr(sl), N, D, V, int(v_real), splits, per, _stream(),
    )
    _raise_on(err, "ce_fwd")
    LAUNCHES["ce_fwd"] += 1
    return lse, tl, sl


def ce_bwd_dp(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl, out=None):
    """Kernel dlogits, bf16 [N, Vp]: ``ce_bwd_dp_reference``'s values,
    the columns >= V zero."""
    lib = _library()
    if h.dtype != torch.bfloat16:
        raise ValueError(f"ce_bwd_dp: bfloat16 only, got {h.dtype}")
    _check("ce_bwd_dp", h, w, tgt, v_real, (lse, d_lse, d_tl, d_sl))
    N, D = h.shape
    V = w.shape[0]
    vp = padded_vocab(V)
    if out is None:
        out = torch.empty((N, vp), dtype=h.dtype, device=h.device)
    _check_out("ce_bwd_dp", out, (N, vp), h.dtype)
    _on_card("ce_bwd_dp", out)
    splits, per = vocab_splits(N, vp, _n_sm(h.device), GEMM_TILE, VOCAB_TILE)
    err = lib.acco_ce_bwd_dp(
        _ptr(h), _ptr(w), _ptr(tgt), _ptr(lse), _ptr(d_lse), _ptr(d_tl), _ptr(d_sl), _ptr(out),
        N, D, V, vp, int(v_real), splits, per, _stream(),
    )
    _raise_on(err, "ce_bwd_dp")
    LAUNCHES["ce_bwd_dp"] += 1
    return out


def ce_bwd_dh(dp, w, out=None):
    """Kernel dH = dp[:, :V] w, bf16 [N, D]."""
    lib = _library()
    _check_dp("ce_bwd_dh", dp, w, w.shape[0])
    N, vp = dp.shape
    V, D = w.shape
    if out is None:
        out = torch.empty((N, D), dtype=w.dtype, device=w.device)
    _check_out("ce_bwd_dh", out, (N, D), w.dtype)
    _on_card("ce_bwd_dh", dp, w, out)
    err = lib.acco_ce_bwd_dh(_ptr(dp), _ptr(w), _ptr(out), N, D, V, vp, _stream())
    _raise_on(err, "ce_bwd_dh")
    LAUNCHES["ce_bwd_dh"] += 1
    return out


def ce_bwd_dw(dp, h, vocab: int, out=None, acc=None, mode: int = 0):
    """Kernel dW = dp[:, :vocab]^T h, bf16 [vocab, D], by ``mode``
    (:func:`dw_mode`) with ``acc`` the float32 [vocab, D] sum of the
    chunks; returns ``out`` (modes 1 and 2 leave it unwritten)."""
    lib = _library()
    _check_dp("ce_bwd_dw", dp, h, vocab)
    N, vp = dp.shape
    D = h.shape[1]
    if h.shape[0] != N:
        raise ValueError(f"ce_bwd_dw: dp has {N} rows, h {h.shape[0]}")
    if out is None:
        out = torch.empty((vocab, D), dtype=h.dtype, device=h.device)
    _check_out("ce_bwd_dw", out, (vocab, D), h.dtype)
    if mode not in (0, 1, 2, 3) or (mode and acc is None):
        raise ValueError(f"ce_bwd_dw: mode {mode} (0-3; 1-3 need the float32 sum buffer)")
    if acc is not None:
        _check_out("ce_bwd_dw", acc, (vocab, D), torch.float32)
    _on_card("ce_bwd_dw", dp, h, out, acc)
    err = lib.acco_ce_bwd_dw(_ptr(dp), _ptr(h), _ptr(out), _ptr(acc), N, D, vocab, vp, mode,
                             _stream())
    _raise_on(err, "ce_bwd_dw")
    LAUNCHES["ce_bwd_dw"] += 1
    return out


def _bwd_f32(name: str, fn: str, out: torch.Tensor, h, w, tgt, v_real, lse, d_lse, d_tl, d_sl):
    lib = _library()
    if h.dtype != torch.float32:
        raise ValueError(f"{name}: float32 only, got {h.dtype}")
    _check(name, h, w, tgt, v_real, (lse, d_lse, d_tl, d_sl))
    err = getattr(lib, fn)(
        _ptr(h), _ptr(w), _ptr(tgt), _ptr(lse), _ptr(d_lse), _ptr(d_tl), _ptr(d_sl), _ptr(out),
        h.shape[0], h.shape[1], w.shape[0], int(v_real), _stream(),
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def ce_bwd_dh_f32(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Kernel dH [N, D], float32 (CUDA cores, dp recomputed)."""
    return _bwd_f32("ce_bwd_dh", "acco_ce_bwd_dh_f32", torch.empty_like(h),
                    h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)


def ce_bwd_dw_f32(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Kernel dW [V, D], float32 (CUDA cores, dp recomputed)."""
    return _bwd_f32("ce_bwd_dw", "acco_ce_bwd_dw_f32", torch.empty_like(w),
                    h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)


def _backward_kernels(h, w, tgt, v_real: int, lse, cot, cap_bytes: int, need_h: bool,
                      need_w: bool):
    """dH and dW through the kernels: float32 through the recomputing
    kernels, bf16 chunk by chunk through dp, dH and dW."""
    if h.dtype == torch.float32:
        args = (h, w, tgt, v_real, lse, *cot)
        return (ce_bwd_dh_f32(*args) if need_h else None,
                ce_bwd_dw_f32(*args) if need_w else None)
    N = h.shape[0]
    V, D = w.shape
    plan = dp_plan(N, V, cap_bytes)
    dp = torch.empty((plan.chunk_rows, plan.vp), dtype=h.dtype, device=h.device)
    dh = torch.empty_like(h) if need_h else None
    dw = torch.empty_like(w) if need_w else None
    acc = torch.empty((V, D), dtype=torch.float32, device=h.device) if need_w and plan.dw_f32 \
        else None
    for i, (r0, r1) in enumerate(plan.chunks(N)):
        buf = dp[: r1 - r0]
        ce_bwd_dp(h[r0:r1], w, tgt[r0:r1], v_real, lse[r0:r1], *(c[r0:r1] for c in cot),
                  out=buf)
        if need_h:
            ce_bwd_dh(buf, w, out=dh[r0:r1])
        if need_w:
            ce_bwd_dw(buf, h[r0:r1], V, out=dw, acc=acc, mode=dw_mode(i, plan.n_chunks))
    return dh, dw


# -- plain versions -----------------------------------------------------------


def _logits(h, w, v_real: int):
    """float32 [N, V] logits (float32 sums of exact products), the column
    indices and the real-column mask."""
    logits = torch.matmul(h.float(), w.float().t())
    col = torch.arange(w.shape[0], device=h.device)
    return logits, col, col < v_real


def _target_cols(tgt, vocab: int):
    """(rows, columns) of the targets inside [0, vocab): the onehot's ones."""
    hit = (tgt >= 0) & (tgt < vocab)
    return torch.arange(tgt.shape[0], device=tgt.device)[hit], tgt[hit].long()


def ce_fwd_reference(h, w, tgt, v_real: int):
    """Plain forward: (lse, true logit, sum of real logits), float32 [N]."""
    logits, col, valid = _logits(h, w, v_real)
    sl = torch.where(valid, logits, torch.zeros_like(logits)).sum(-1)
    logits[:, v_real:] = NEG  # the masked logits, in place
    tl = torch.zeros_like(sl)
    rows, cols = _target_cols(tgt, w.shape[0])
    tl[rows] = logits[rows, cols]
    return torch.logsumexp(logits, dim=-1), tl, sl


def dlogits_f32(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """d_lse * softmax + d_tl * onehot + d_sl * valid, float32 [N, V],
    summed in that order, built in place in the logits' buffer."""
    x, _, _ = _logits(h, w, v_real)
    x[:, v_real:] = NEG
    x.sub_(lse[:, None]).exp_().mul_(d_lse[:, None])
    rows, cols = _target_cols(tgt, w.shape[0])
    x[rows, cols] += d_tl[rows]
    x[:, :v_real] += d_sl[:, None]
    return x


def dlogits_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """:func:`dlogits_f32` rounded to the activation dtype, as the JAX
    ``_dp_tile``."""
    return dlogits_f32(h, w, tgt, v_real, lse, d_lse, d_tl, d_sl).to(h.dtype)


def ce_bwd_dp_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Plain ``ce_bwd_dp``: :func:`dlogits_reference` padded with zero
    columns to [N, Vp]."""
    dp = dlogits_reference(h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)
    return F.pad(dp, (0, padded_vocab(w.shape[0]) - w.shape[0]))


def ce_bwd_dh_reference(dp, w):
    """Plain dH from dp [N, Vp]: float32 sums of the exact products,
    rounded once to w's dtype."""
    return torch.matmul(dp[:, : w.shape[0]].float(), w.float()).to(w.dtype)


def ce_bwd_dw_reference(dp, h, vocab: int):
    """Plain dW [vocab, D] from dp [N, Vp], like ``ce_bwd_dh_reference``."""
    return torch.matmul(dp[:, :vocab].float().t(), h.float()).to(h.dtype)


def lm_head_ce_backward_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl,
                                  cap_bytes: int = DP_CAP_BYTES, need_h: bool = True,
                                  need_w: bool = True):
    """Plain backward, chunked as the kernels chunk it (:func:`dp_plan`):
    per chunk of rows its dp, its rows of dH, and its float32 share of dW,
    summed in chunk order and rounded once."""
    N = h.shape[0]
    V = w.shape[0]
    plan = dp_plan(N, V, cap_bytes)
    dh = torch.empty_like(h) if need_h else None
    acc = None
    for r0, r1 in plan.chunks(N):
        dp = ce_bwd_dp_reference(h[r0:r1], w, tgt[r0:r1], v_real, lse[r0:r1], d_lse[r0:r1],
                                 d_tl[r0:r1], d_sl[r0:r1])
        if need_h:
            dh[r0:r1] = ce_bwd_dh_reference(dp, w)
        if need_w:
            part = torch.matmul(dp[:, :V].float().t(), h[r0:r1].float())
            acc = part if acc is None else acc.add_(part)
    return dh, (acc.to(w.dtype) if need_w else None)


# -- autograd and the public function ---------------------------------------


class LmHeadCE(torch.autograd.Function):
    """(lse, true logit, sum of real logits) per row of h w^T, with the
    backward kernels as its gradient (their dp buffer held under
    ``dp_cap_bytes``). CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, h, w, tgt, v_real: int, dp_cap_bytes: int = DP_CAP_BYTES):
        fwd = ce_fwd_reference if h.device.type == "cpu" else ce_fwd
        lse, tl, sl = fwd(h, w, tgt, v_real)
        ctx.save_for_backward(h, w, tgt, lse)
        ctx.v_real, ctx.cap = v_real, dp_cap_bytes
        return lse, tl, sl

    @staticmethod
    def backward(ctx, d_lse, d_tl, d_sl):
        h, w, tgt, lse = ctx.saved_tensors
        cot = [
            torch.zeros_like(lse) if c is None else c.float().contiguous()
            for c in (d_lse, d_tl, d_sl)
        ]
        need_h, need_w = ctx.needs_input_grad[:2]
        if h.device.type == "cpu":
            dh, dw = lm_head_ce_backward_reference(h, w, tgt, ctx.v_real, lse, *cot,
                                                   cap_bytes=ctx.cap, need_h=need_h,
                                                   need_w=need_w)
        else:
            dh, dw = _backward_kernels(h, w, tgt, ctx.v_real, lse, cot, ctx.cap, need_h, need_w)
        return dh, dw, None, None, None


def fused_ce_loss(
    hidden: torch.Tensor,  # [B, L, D] activation dtype
    lm_head: torch.Tensor,  # [D, V] (the tied wte transposed: a view)
    labels: torch.Tensor,  # [B, L] int, IGNORE_INDEX = masked
    label_smoothing: float = 0.0,
    shift: bool = True,
    num_valid=None,
    real_vocab: Optional[int] = None,
    interpret: Optional[bool] = None,
    dp_cap_bytes: int = DP_CAP_BYTES,
) -> torch.Tensor:
    """``causal_lm_loss(hidden @ lm_head, labels)`` with no [B, L, V]
    logits, with the JAX ``fused_ce_loss``'s contract and outer
    arithmetic. With ``shift`` every row of ``hidden`` goes in (no copy of
    ``hidden[:, :-1]``) and each sequence's last target is IGNORE_INDEX,
    so that row's cotangents, dlogits and dH are exactly 0. There is no
    interpreter, so ``interpret=True`` raises. ``dp_cap_bytes`` caps the
    backward's bf16 dlogits buffer (:func:`dp_plan`)."""
    if interpret:
        raise ValueError(
            "interpret=True: the Hopper kernel has no interpreter; CPU "
            "tensors already run the plain version"
        )
    B, L, D = hidden.shape
    V = lm_head.shape[1]
    if not supports_fused_ce(B * (L - 1 if shift else L), D, V):
        raise ValueError(f"shape N={B * L} D={D} V={V} outside the fused CE envelope")
    if shift:
        labels = torch.cat(
            [labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1
        )
    targets = labels.reshape(-1)
    h2 = hidden.reshape(B * L, D)
    w = lm_head.t()  # [V, D]: the tied table itself
    if h2.device.type != "cpu":
        h2, w = h2.contiguous(), w.contiguous()  # copies only an untied [D, V] head
    v_real = V if real_vocab is None else int(real_vocab)
    mask = (targets != IGNORE_INDEX).float()
    safe = torch.where(targets == IGNORE_INDEX, torch.zeros_like(targets), targets)
    lse, tl, sl = LmHeadCE.apply(h2, w, safe.to(torch.int32).contiguous(), v_real,
                                  dp_cap_bytes)
    per_tok = lse - tl
    if label_smoothing:
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * (lse - sl / v_real)
    denom = mask.sum() if num_valid is None else torch.as_tensor(
        num_valid, dtype=torch.float32, device=mask.device
    )
    return (per_tok * mask).sum() / denom.clamp(min=1.0)


def shard_targets(targets: torch.Tensor, v0: int, v_local: int) -> torch.Tensor:
    """A vocab shard's int32 targets: the global ids in ``[v0, v0 +
    v_local)`` made local, every other id and the ignored rows the -1
    sentinel, which the kernel never matches."""
    t_loc = targets - v0
    sentinel = (targets == IGNORE_INDEX) | (t_loc < 0) | (t_loc >= v_local)
    return torch.where(sentinel, torch.full_like(t_loc, -1), t_loc).to(torch.int32).contiguous()


def shard_v_real(real_vocab: int, v0: int, v_local: int) -> int:
    """A vocab shard's real columns: ``clip(real_vocab - v0, 0, v_local)``."""
    return min(max(int(real_vocab) - v0, 0), v_local)


def vp_shard_ce(h2, w_local, targets, rank: int, size: int, real_vocab: Optional[int] = None,
                dp_cap_bytes: int = DP_CAP_BYTES, ce=None) -> tuple:
    """One vocab shard's part of the wrapper: rank ``rank`` of ``size``
    holds rows ``[v0, v0 + V/tp)`` of the head (``w_local``, [V/tp, D]);
    its K3 runs with the clipped ``v_real`` (:func:`shard_v_real`) on its
    localised targets (:func:`shard_targets`). Returns the shard's (lse,
    true logit, sum of real logits) and the vocab size the smoothing
    averages over. ``ce(h, w, tgt, v_real)`` replaces :class:`LmHeadCE`
    (the chip check's plain version emulated alike)."""
    v_local = w_local.shape[0]
    v0 = rank * v_local
    vocab_total = v_local * size
    if real_vocab is not None and real_vocab < vocab_total:
        v_real, vocab_total = shard_v_real(real_vocab, v0, v_local), int(real_vocab)
    else:
        v_real = v_local
    tgt = shard_targets(targets, v0, v_local)
    if ce is None:
        lse_l, tl_l, sl_l = LmHeadCE.apply(h2, w_local, tgt, v_real, dp_cap_bytes)
    else:
        lse_l, tl_l, sl_l = ce(h2, w_local, tgt, v_real)
    return lse_l, tl_l, sl_l, vocab_total


def vp_combine(lse_l, tl_l, sl_l, label_smoothing: float, vocab_total: int, reduce_max,
               reduce_sum):
    """The vocab-parallel wrapper's cross-shard combine: ``(lse,
    per-token loss)`` from the shards' (lse, true logit, sum of real
    logits). ``reduce_max`` takes the shards' max of a value with no
    gradient; ``reduce_sum`` sums a stack ``[k, ...]`` of per-shard rows
    over the shards (the group's all-reduce; over a leading shard axis
    when the shards are emulated in one process)."""
    gmax = reduce_max(lse_l.detach())
    parts = [torch.exp(lse_l - gmax), tl_l]
    if label_smoothing:
        parts.append(sl_l)
    summed = reduce_sum(torch.stack(parts))
    lse = torch.log(summed[0]) + gmax
    per_tok = lse - summed[1]
    if label_smoothing:
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * (
            lse - summed[2] / vocab_total)
    return lse, per_tok


def vocab_parallel_fused_ce_loss(
    hidden: torch.Tensor,  # [B, L, D] activation dtype (the same on every tp rank)
    lm_head_local: torch.Tensor,  # [D, V/tp] this shard's vocab slice
    labels: torch.Tensor,  # [B, L] int GLOBAL ids, IGNORE_INDEX = masked
    vocab_group,  # models.layers.TensorGroup the vocab dim is sharded over
    label_smoothing: float = 0.0,
    shift: bool = True,
    num_valid=None,
    real_vocab: Optional[int] = None,
    dp_cap_bytes: int = DP_CAP_BYTES,
) -> torch.Tensor:
    """:func:`fused_ce_loss` over a vocab-sharded head (JAX
    ``ops/fused_ce.py:503-575``): the tensor-parallel loss without the
    local [B, L, V/tp] float32 logits. Each rank runs K3 (:class:`LmHeadCE`:
    ``ce_fwd`` and the backward kernels on a CUDA tensor, the plain
    versions on a CPU one) on its own [V/tp, D] slice, with

    - ``v_real = clip(real_vocab - v0, 0, V/tp)``, a host int fixed per
      rank, so the Megatron padding on the last shard never enters the
      LSE or the logit sum;
    - the targets outside ``[v0, v0 + V/tp)`` and the ignored rows as the
      -1 sentinel, which the kernel never matches (``csrc/fused_ce.cu``).

    The combine is O(N) PyTorch over the group: the ranks' max of the
    local LSEs (no gradient), then ``sum exp(lse_l - gmax)``, the true
    logit and the logit sums in one all-reduce
    (``models.layers.tp_all_reduce``), ``lse = log(sum) + gmax``, and the
    smoothing over ``real_vocab``. Autograd hands each rank's kernels
    ``d_lse * exp(lse_l - lse)``, and the all-reduce's backward sums the
    cotangents over the group, as JAX's ``psum`` transpose. Each rank's
    dH covers its own vocab slice; the sum over the slices happens where
    the hidden state's gradient meets the layers' all-reduces (JAX's
    convention, ``parallel/tp.py``). Every rank returns the same loss."""
    from acco_tpu_torch.models.layers import tp_all_reduce, tp_max

    B, L, D = hidden.shape
    v_local = lm_head_local.shape[1]
    if not supports_fused_ce(B * (L - 1 if shift else L), D, v_local):
        raise ValueError(f"shape N={B * L} D={D} V/tp={v_local} outside the fused CE envelope")
    if shift:
        labels = torch.cat(
            [labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1
        )
    targets = labels.reshape(-1)
    h2 = hidden.reshape(B * L, D)
    w = lm_head_local.t()  # [V/tp, D]
    if h2.device.type != "cpu":
        h2, w = h2.contiguous(), w.contiguous()
    mask = (targets != IGNORE_INDEX).float()
    if h2.device.type == "cuda":
        LAUNCHES["vp_ce"] += 1
    lse_l, tl_l, sl_l, vocab_total = vp_shard_ce(h2, w, targets, vocab_group.rank,
                                                 vocab_group.size, real_vocab, dp_cap_bytes)
    _, per_tok = vp_combine(lse_l, tl_l, sl_l, label_smoothing, vocab_total,
                            lambda x: tp_max(x, vocab_group),
                            lambda x: tp_all_reduce(x, vocab_group))
    denom = mask.sum() if num_valid is None else torch.as_tensor(
        num_valid, dtype=torch.float32, device=mask.device
    )
    return (per_tok * mask).sum() / denom.clamp(min=1.0)
