"""Fused lm-head + cross-entropy: the Hopper kernel (K3), its plain version, its autograd.

Replaces ``acco_tpu/ops/fused_ce.py``: ``_lm_head_ce_fwd`` and the three
Pallas calls of ``_lm_head_ce_bwd`` (its fused form and its split dH / dW
form). The loss never writes the [N, V] logits to device memory: the
forward keeps a running (max, sumexp, true logit, sum of real logits)
per row over vocab tiles, and the backward recomputes each logits tile
and contracts its dlogits twice. On Hopper one deterministic dH kernel
and one deterministic dW kernel serve every shape: the JAX package's
fused backward, its [T, N, D] float32 dH partials and the cap that
switches to the split form (``ACCO_FUSED_CE_PARTIAL_CAP``) exist for the
TPU's VMEM pipeline and have no counterpart here. ``csrc/fused_ce.cu``
says what bounds the kernels and how their accumulators fit a block.

The head reaches the kernels as the row-major [V, D] matrix it is stored
as (the tied embedding table), and dW comes back in that layout: the
[D, V] view the models hand over is transposed back, not copied.

Three kernel wrappers (:func:`ce_fwd`, :func:`ce_bwd_dh`,
:func:`ce_bwd_dw`) check device, dtype (bfloat16 or float32), shape and
contiguity, allocate their outputs with ``torch.empty``, launch on the
current stream, raise if the launch returned a CUDA error, and add one to
their count in :data:`LAUNCHES`. Their plain versions
(:func:`ce_fwd_reference`, :func:`ce_bwd_dh_reference`,
:func:`ce_bwd_dw_reference`) materialize the logits in PyTorch and round
dlogits to the activation dtype before both products, as the JAX
``_dp_tile`` does. :func:`fused_ce_loss` takes the plain versions only
for tensors on the CPU; a tensor anywhere else goes to the kernels or
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from acco_tpu_torch.ops.losses import IGNORE_INDEX

NEG = -1e30  # the JAX kernel's column mask (``_NEG``)
TILE = 64  # rows (hidden or vocab) per kernel tile

# Launches per kernel wrapper since the last reset_launch_counts();
# ``ce_fwd`` is one C call that launches the split pass and its merge.
LAUNCHES = {"ce_fwd": 0, "ce_bwd_dh": 0, "ce_bwd_dw": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int

# argtypes of the C launchers: (dtype, pointers..., sizes..., stream)
_SIGNATURES = {
    "acco_ce_fwd": [_I] + [_P] * 7 + [_I] * 6 + [_P],
    "acco_ce_bwd_dh": [_I] + [_P] * 8 + [_I] * 4 + [_P],
    "acco_ce_bwd_dw": [_I] + [_P] * 8 + [_I] * 4 + [_P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supports_fused_ce(n_rows: int, hidden: int, vocab: int) -> bool:
    """The JAX kernel's envelope: at least one row, a hidden dim that is a
    multiple of 128, at least 128 vocab columns. The Hopper kernels check
    their own bounds, so no row or vocab count needs padding."""
    return n_rows >= 1 and hidden % 128 == 0 and vocab >= 128


def _library() -> ctypes.CDLL:
    from acco_tpu_torch.utils import cuda_build

    return cuda_build.load("fused_ce", _SIGNATURES)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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
    for t in (h, w, tgt, *rows):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: a tensor is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every input must be contiguous")
        if t.data_ptr() % 16:  # the kernels copy rows 16 bytes at a time
            raise ValueError(f"{name}: every input must start on a 16-byte boundary")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def vocab_splits(n_rows: int, vocab: int, n_sm: int) -> tuple[int, int]:
    """(splits, tiles per split) of the forward: enough (row tile, vocab
    split) blocks for about four on each SM, no split empty."""
    row_tiles = math.ceil(n_rows / TILE)
    vocab_tiles = math.ceil(vocab / TILE)
    want = max(1, min(vocab_tiles, math.ceil(4 * n_sm / row_tiles)))
    per = math.ceil(vocab_tiles / want)
    return math.ceil(vocab_tiles / per), per


# -- the three kernel wrappers ----------------------------------------------


def ce_fwd(h, w, tgt, v_real: int):
    """Kernel forward: per-row (lse, true logit, sum of real logits), each
    float32 [N]."""
    lib = _library()
    _check("ce_fwd", h, w, tgt, v_real)
    N, D = h.shape
    V = w.shape[0]
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits, per = vocab_splits(N, V, n_sm)
    part = torch.empty((4, splits, N), dtype=torch.float32, device=h.device)
    lse, tl, sl = (torch.empty(N, dtype=torch.float32, device=h.device) for _ in range(3))
    err = lib.acco_ce_fwd(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(tgt), _ptr(part), _ptr(lse), _ptr(tl),
        _ptr(sl), N, D, V, int(v_real), splits, per, _stream(),
    )
    _raise_on(err, "ce_fwd")
    LAUNCHES["ce_fwd"] += 1
    return lse, tl, sl


def _bwd(name: str, fn: str, out: torch.Tensor, h, w, tgt, v_real, lse, d_lse, d_tl, d_sl):
    lib = _library()
    _check(name, h, w, tgt, v_real, (lse, d_lse, d_tl, d_sl))
    err = getattr(lib, fn)(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(tgt), _ptr(lse), _ptr(d_lse),
        _ptr(d_tl), _ptr(d_sl), _ptr(out), h.shape[0], h.shape[1], w.shape[0], int(v_real),
        _stream(),
    )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def ce_bwd_dh(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Kernel dH [N, D], like h."""
    return _bwd("ce_bwd_dh", "acco_ce_bwd_dh", torch.empty_like(h),
                h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)


def ce_bwd_dw(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Kernel dW [V, D], like w."""
    return _bwd("ce_bwd_dw", "acco_ce_bwd_dw", torch.empty_like(w),
                h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)


# -- plain versions -----------------------------------------------------------


def _logits(h, w, v_real: int):
    """float32 [N, V] logits (float32 sums of exact products), the column
    indices and the real-column mask."""
    logits = torch.matmul(h.float(), w.float().t())
    col = torch.arange(w.shape[0], device=h.device)
    return logits, col, col < v_real


def ce_fwd_reference(h, w, tgt, v_real: int):
    """Plain forward: (lse, true logit, sum of real logits), float32 [N]."""
    logits, col, valid = _logits(h, w, v_real)
    masked = torch.where(valid, logits, torch.full_like(logits, NEG))
    zero = torch.zeros_like(logits)
    tl = torch.where(col == tgt[:, None].long(), masked, zero).sum(-1)
    sl = torch.where(valid, logits, zero).sum(-1)
    return torch.logsumexp(masked, dim=-1), tl, sl


def dlogits_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """d_lse * softmax + d_tl * onehot + d_sl * valid, rounded to the
    activation dtype, as the JAX ``_dp_tile``."""
    logits, col, valid = _logits(h, w, v_real)
    p = torch.exp(torch.where(valid, logits, torch.full_like(logits, NEG)) - lse[:, None])
    onehot = (col == tgt[:, None].long()).float()
    dp = d_lse[:, None] * p + d_tl[:, None] * onehot + d_sl[:, None] * valid.float()
    return dp.to(h.dtype)


def ce_bwd_dh_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Plain dH, like h."""
    dp = dlogits_reference(h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)
    return torch.matmul(dp.float(), w.float()).to(h.dtype)


def ce_bwd_dw_reference(h, w, tgt, v_real: int, lse, d_lse, d_tl, d_sl):
    """Plain dW, like w."""
    dp = dlogits_reference(h, w, tgt, v_real, lse, d_lse, d_tl, d_sl)
    return torch.matmul(dp.float().t(), h.float()).to(w.dtype)


# -- autograd and the public function ---------------------------------------


class LmHeadCE(torch.autograd.Function):
    """(lse, true logit, sum of real logits) per row of h w^T, with the dH
    and dW kernels as its gradient. CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, h, w, tgt, v_real: int):
        fwd = ce_fwd_reference if h.device.type == "cpu" else ce_fwd
        lse, tl, sl = fwd(h, w, tgt, v_real)
        ctx.save_for_backward(h, w, tgt, lse)
        ctx.v_real = v_real
        return lse, tl, sl

    @staticmethod
    def backward(ctx, d_lse, d_tl, d_sl):
        h, w, tgt, lse = ctx.saved_tensors
        cot = [
            torch.zeros_like(lse) if c is None else c.float().contiguous()
            for c in (d_lse, d_tl, d_sl)
        ]
        cpu = h.device.type == "cpu"
        args = (h, w, tgt, ctx.v_real, lse, *cot)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (ce_bwd_dh_reference if cpu else ce_bwd_dh)(*args)
        if ctx.needs_input_grad[1]:
            dw = (ce_bwd_dw_reference if cpu else ce_bwd_dw)(*args)
        return dh, dw, None, None


def fused_ce_loss(
    hidden: torch.Tensor,  # [B, L, D] activation dtype
    lm_head: torch.Tensor,  # [D, V] (the tied wte transposed: a view)
    labels: torch.Tensor,  # [B, L] int, IGNORE_INDEX = masked
    label_smoothing: float = 0.0,
    shift: bool = True,
    num_valid=None,
    real_vocab: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """``causal_lm_loss(hidden @ lm_head, labels)`` with no [B, L, V]
    logits, with the JAX ``fused_ce_loss``'s contract and outer
    arithmetic. With ``shift`` every row of ``hidden`` goes in (no copy of
    ``hidden[:, :-1]``) and each sequence's last target is IGNORE_INDEX,
    so that row's cotangents, dlogits and dH are exactly 0. There is no
    interpreter, so ``interpret=True`` raises."""
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
    lse, tl, sl = LmHeadCE.apply(h2, w, safe.to(torch.int32).contiguous(), v_real)
    per_tok = lse - tl
    if label_smoothing:
        per_tok = (1.0 - label_smoothing) * per_tok + label_smoothing * (lse - sl / v_real)
    denom = mask.sum() if num_valid is None else torch.as_tensor(
        num_valid, dtype=torch.float32, device=mask.device
    )
    return (per_tok * mask).sum() / denom.clamp(min=1.0)
