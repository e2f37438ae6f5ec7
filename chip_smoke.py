#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acco_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name, the device count, nvidia-smi's name and
   power limit;
2. build: compiles csrc/fused_attention.cu (K1), banded_attention.cu
   (K2), fused_ce.cu (K3, with hopper_gemm.cuh), flash_attention.cu (K5) and
   block_attention.cu (K4) for sm_90a from the checkout (into build/),
   one nvcc each, started together, and prints ptxas's report;
3. parity: each kernel against its plain PyTorch version on the same
   inputs on the card, bf16 unless named. K1 at the Llama flagship shape
   (B 8, H = Hkv 12, L 1024, D 64, window 0, no pad), at a small GQA
   shape with window 256 and a key pad mask, and at GPT-Neo's global
   shape (scale 1.0); K2 at GPT-Neo's local shape (W 256, scale 1.0), a
   small odd window (W 129) and the widest band of its envelope (W 897);
   K3 (the fused lm-head + CE: forward, dp, dH, dW, the four on the
   wgmma/TMA mainloop of hopper_gemm.cuh; dp held exactly, up to one bf16
   step at a rounding edge; dp, dH and dW run twice must give the same
   bits) at Llama-125M's head (8184 rows, D 768, V 50257), a small
   unaligned shape (64 rows, D 128, V 277, real vocab 256, ignored rows,
   smoothing 0.1) and Llama-3-8B's head (1024 rows, D 4096, V 128256),
   the two heads also with the softmax term alone in dlogits, and its
   backward in 3 chunks of rows (dW summed in float32) at the
   Llama-125M head against the one-chunk dH and the plain chunked dW;
   the head's
   float32 logits against the
   widened product; K5 (causal flash attention with segment ids) at the
   Llama flagship shape, a small GQA shape with pads in the middle and at
   the tail (D 128; also in float32) and Llama-3-8B's long-context shape
   (B 1, H 32, Hkv 8, L 8192, D 128); K4 (the ring's block: forward, row
   pre-pass, dK/dV, dQ, with random cotangents on o, m and l) at (a) the
   Llama-350M preset's block at sp 16 (B 1, H 16, L 1024, D 64), (b)
   Llama-3-8B at the ring path's half-chunk (H 32, Hkv 8, L 4096, D 128),
   both full and diagonal, (c) GPT-Neo-125M's positional block at a
   zig-zag hop at sp 2 (windows 0 and 256, rows fully masked), (d) small
   float32 cases with ties planted at the row max, and a small bf16 GQA
   case; then K3's (one fault in each of its four passes), K5's and
   K4's bars against planted faults, each in a patched copy of the
   kernel's source, which they must fail;
4. timing: CUDA events over many launches after a warm-up, for each
   kernel, its plain version and, where one PyTorch call computes the
   same function, that call (F.scaled_dot_product_attention); K2 also
   beside K1 at the same window; K3 at the main path's head (8192 rows,
   D 768, V 50257) and at the long-context paths' head (8192 rows, D
   4096, V 128256; before the paths, its 4.2 GB of float32 logits freed
   after) beside the port's materialized head and CE, which no single
   PyTorch call replaces; K5 at the flagship shape beside K1 and at the
   long-context shape; K4 at (a), (b) and (c), beside SDPA on the same
   attended pairs (the same work, not the same function: SDPA returns
   the normalised output and no row max or sum);
5. main paths: ``python -m acco_tpu_torch train=acco model=llama-125M
   data=synthetic``, ``... model=gptneo ...`` and ``... model=llama-125M
   ... train.fused_loss=pallas`` in-process at full width (12 layers,
   d 768, seq 1024, batch 8, n_acc 1), and ``... model=llama-125M
   model.config_path=<tmp>/llama-3-8B-depth2.json train.max_length=8192
   train.batch_size=1`` (Llama-3-8B at full width cut to 2 layers,
   'auto' attention resolving to K5 and 'auto' fused loss to K3), with
   no process group; then the ring paths, the last two paths' models on
   the ring of context parallelism through a one-rank NCCL sequence
   group handed to ``build_trainer`` (zig-zag: two diagonal half-blocks
   and one full a layer for Llama; the windowed ring's positional block
   a layer for GPT-Neo; the loss through K3, as 'auto' resolves under
   CP): the seed round and 6 rounds each, with the kernels' launch counts
   and the calls of the materialized head set to 0 just before each run
   and read just after, the ring paths' round-0 losses against their
   base paths' on the same weights and batch, and one GPT-Neo forward and
   backward through the windowed ring against the non-CP path (K1 + K2);
6. agreement: the entry point on a small float32 input through the
   kernels and through the plain attention gives the same losses and
   gradients (tiny128, then gpt-neo-125M at L 512), and so do
   ``train.fused_loss=pallas`` (K3) against the materialized CE,
   ``train.use_pallas_attention=true`` (K5) and the one-rank ring (K4)
   against the plain attention (tiny128);
7. profile: each path again under torch.profiler, for the device time
   per kernel, K1's to K5's device time per microbatch and the device's
   idle share.

The last lines are the kernels JSON line, nvidia-smi's line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(B=8, H=12, Hkv=12, L=1024, D=64, window=0, pad=False)
SMALL = dict(B=2, H=4, Hkv=2, L=512, D=64, window=256, pad=True)
# GPT-Neo scores are unscaled (scale 1.0): q and k are drawn with std
# D^-1/4 so that the scores still have unit variance
NEO_QK_STD = 64 ** -0.25
NEO_GLOBAL = dict(B=8, H=12, Hkv=12, L=1024, D=64, window=0, pad=False,
                  scale=1.0, qk_std=NEO_QK_STD)
# K2 (MHA, no pad): GPT-Neo-125M's local layer, an odd window, the widest
# band of the envelope (nprev(897) + 1 = 8 blocks of 128 keys)
NEO_LOCAL = dict(B=8, H=12, L=1024, D=64, window=256)
BANDED_SHAPES = (
    ("gpt-neo local", NEO_LOCAL),
    ("odd window", dict(B=2, H=4, L=512, D=64, window=129)),
    ("widest band", dict(B=2, H=4, L=1024, D=64, window=897)),
)
# main paths at full width: Llama-125M (config/model/llama-125M.json),
# GPT-Neo-125M (config/model/gpt-neo-125M.json, 6 global + 6 local layers)
# and Llama-125M with the fused lm-head + CE (train.fused_loss=pallas)
MAIN_ROUNDS = 6  # after the seed round
LAYERS, D_MODEL, SEQ, BATCH = 12, 768, 1024, 8
NEO_WINDOW = 256
VOCAB = 50257

# K3 shapes: rows N of hidden states, hidden D, vocab V, real vocab, label
# smoothing, the share of ignored rows, and (seq) every seq-th row ignored,
# as the main path ignores the last row of each sequence. With
# softmax_only the cotangents are a random signed d_lse per row and no
# d_tl or d_sl: dlogits is then the softmax term alone, which under the
# mean loss's cotangents is too small a part of dH to show a fault in it;
# and, d_lse differing from row to row, a block that reads another row
# tile's stats gets another result.
CE_LLAMA = dict(N=BATCH * (SEQ - 1), D=D_MODEL, V=VOCAB, v_real=VOCAB, smoothing=0.0, ignore=0.0)
CE_LLAMA3 = dict(N=1024, D=4096, V=128256, v_real=128256, smoothing=0.0, ignore=0.0)
CE_SHAPES = (
    ("llama-125M head", CE_LLAMA),
    ("llama-125M head, softmax term alone", {**CE_LLAMA, "softmax_only": True}),
    ("small unaligned", dict(N=2 * 32, D=128, V=277, v_real=256, smoothing=0.1, ignore=0.25)),
    ("llama-3-8B head", CE_LLAMA3),
    ("llama-3-8B head, softmax term alone", {**CE_LLAMA3, "softmax_only": True}),
)
CE_MAIN = dict(N=BATCH * SEQ, D=D_MODEL, V=VOCAB, v_real=VOCAB, smoothing=0.0, ignore=0.0,
               seq=SEQ)
# the long-context cells' head: Llama-3-8B's (D 4096, V 128256) at batch 1 x
# L 8192; its float32 logits are 4.2 GB, so it is timed before the paths
CE_LONG = dict(N=8192, D=4096, V=128256, v_real=128256, smoothing=0.0, ignore=0.0, seq=8192)

# K5 shapes: the Llama-125M flagship (D 64, beside K1), a small GQA shape
# with pads in the middle and at the tail (D 128), and the long-context
# main path's layer (Llama-3-8B: H 32, Hkv 8, D 128, L 8192, batch 1)
FLASH_FLAGSHIP = dict(B=8, H=12, Hkv=12, L=1024, D=64)
FLASH_SMALL = dict(B=2, H=4, Hkv=2, L=512, D=128, pad="middle+tail")
FLASH_LLAMA3 = dict(B=1, H=32, Hkv=8, L=8192, D=128)
FLASH_SHAPES = (
    ("llama-125M flagship", FLASH_FLAGSHIP),
    ("small gqa, pads in the middle and at the tail", FLASH_SMALL),
    ("small gqa, pads, float32", {**FLASH_SMALL, "dtype": "float32"}),
    ("llama-3-8B, L 8192", FLASH_LLAMA3),
)
# K4 (the ring's block) shapes: (a) the Llama-350M preset's per-device
# block, a zig-zag half-chunk of Lc 2048 at sp 16; (b) Llama-3-8B at the
# card's ring path's half-chunk (L 8192 at sp 1); (c) GPT-Neo-125M's
# positional block at the positions of a zig-zag hop at sp 2, L 2048
# (rank 1's queries against rank 0's keys: with window 256 the queries at
# 768..1535 have no key left, and their rows are fully masked); (d) small,
# float32, with ties planted at each row's max. Each shape lists its
# variants: 'full', 'diag', or (query positions, key positions, window).
BLOCK_350M = dict(B=1, H=16, Hkv=16, L=1024, D=64)
BLOCK_LLAMA3 = dict(B=1, H=32, Hkv=8, L=4096, D=128)
BLOCK_NEO = dict(B=8, H=12, Hkv=12, L=1024, D=64, scale=1.0, qk_std=NEO_QK_STD)
BLOCK_TIES = dict(B=2, H=4, Hkv=2, L=128, D=64, dtype="float32", ties=True)
BLOCK_SMALL = dict(B=2, H=4, Hkv=2, L=128, D=64)
# (query rank, key rank, global length, ranks, window) of a zig-zag hop
ZZ_NEO = {f"hop sp2 w{w}": (1, 0, 2048, 2, w) for w in (0, NEO_WINDOW)}
ZZ_SMALL = {"hop w0": (1, 0, 256, 2, 0), "hop w48": (1, 0, 256, 2, 48),
            "self w48": (0, 0, 256, 2, 48)}
BLOCK_SHAPES = (
    ("(a) llama-350M preset's block at sp 16", BLOCK_350M, ("full", "diag")),
    ("(b) llama-3-8B, the card ring path's half-chunk", BLOCK_LLAMA3, ("full", "diag")),
    ("(c) gpt-neo-125M, a zig-zag hop at sp 2, L 2048", BLOCK_NEO, tuple(ZZ_NEO)),
    ("(d) small, planted ties, float32", BLOCK_TIES, ("full", "diag", *ZZ_SMALL)),
    ("(d) small, planted ties, float32, D 128", {**BLOCK_TIES, "D": 128},
     ("full", "diag", *ZZ_SMALL)),
    ("small gqa, bf16", BLOCK_SMALL, ("full", "diag", *ZZ_SMALL)),
)
# the long-context main path: config/model/llama-3-8B.json at full width
# (d 4096, 32 heads, 8 KV heads, vocab 128256, untied head) cut to 2
# layers, written at run time into a temporary directory
LLAMA3_JSON = os.path.join(REPO, "config", "model", "llama-3-8B.json")
LLAMA3_LAYERS, LLAMA3_SEQ = 2, 8192


@functools.cache
def llama3_config() -> str:
    """The depth-cut Llama-3-8B architecture file, written once per run
    into a temporary directory that is removed at exit."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    with open(LLAMA3_JSON) as f:
        raw = json.load(f)
    raw["num_layers"] = LLAMA3_LAYERS
    path = os.path.join(tmp, f"llama-3-8B-depth{LLAMA3_LAYERS}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def main_args(path: str) -> list[str]:
    spec = MAIN_PATHS[path]
    extra = [f"model.config_path={llama3_config()}"] if spec.get("llama3") else []
    return [
        "train=acco", f"model={spec['model']}", *extra, "data=synthetic",
        f"train.batch_size={spec['batch']}", f"train.max_length={spec['seq']}",
        "train.n_grad_accumulation=1", f"train.nb_steps_tot={MAIN_ROUNDS}", *spec["extra"],
    ]

# Tolerances on the card, bf16 (kernel vs its plain version, same inputs):
# outputs are rounded to bf16 (relative step 2^-8) and summed in another
# order; the plain forward also rounds P to bf16 before PV where the
# online-softmax kernel keeps it in f32. Each check is
# |kernel - plain| <= atol + rtol * |plain|.
TOL = {
    "o": (1e-2, 2e-2),
    # K2 rounds the normalised P, as its plain version does: O differs only
    # where another summation order flips a bf16 rounding of P or of O
    # (one bf16 step of O, 2^-7 relative)
    "o_band": (4e-3, 8e-3),
    # float32 sums of exact bf16 products in another order; a logit rounded
    # to bf16 would be off by up to 2^-9 of itself (1e-3 at |logit| 0.5)
    "logits": (1e-5, 1e-5),
    "lse": (1e-3, 1e-4),  # float32 in both; only the summation order differs
    "delta": (1e-3, 1e-4),  # float32 dot products of identical bf16 inputs
    "dq": (1e-2, 2e-2),
    "dk": (1e-2, 2e-2),
    "dv": (1e-2, 2e-2),
    # K3's per-row float32 lse and true logit: exact bf16 products summed
    # in another order (the sum of the real logits: check_mass)
    # K4's row statistics: float32 on both sides; m and l differ only by
    # the summation order of s, c = (dm - rowsum(dO o) - dl l) / cnt only
    # by that of its dot product
    "blk_m": (1e-3, 1e-4),
    "blk_l": (1e-3, 1e-4),
    "blk_c": (1e-3, 1e-4),
    "ce_lse": (1e-4, 1e-5),
    "ce_tl": (1e-4, 1e-5),
}
# K5 in float32 against its plain version in float32: no rounding to bf16
# on either side, only the summation order differs (the end-to-end
# float32 agreement's 1e-4 bar)
F32_TOL = (1e-4, 1e-4)
# K3's dH and dW, elementwise: |err| <= r * |plain| + t * term, where term
# bounds each product summed into the element (``ce_grad_terms``).
# Both sides round dlogits to bf16 before their products and the result
# to bf16 at the end. The final rounding can differ by one bf16 step of
# the element (2^-7 of it): r = 2^-6. A float32 dlogit on a rounding edge
# can round the other way on the other side and move its product by one
# bf16 step of itself (at most 2^-7 of it), which shows in full where the
# sum cancels: t = 2^-6 allows two such steps. The bar stays far
# below the typical element, so that a dlogit term dropped or misweighted
# fails (phase 3's planted faults).
ELEMENT_TOL = {"ce_dh": (2 ** -6, 2 ** -6), "ce_dw": (2 ** -6, 2 ** -6)}
# K3's dp buffer against the plain version's bf16 dlogits: equal, except
# where the two float32 values lie on either side of a bf16 rounding edge.
# The kernel's float32 dlogit differs from the plain one only by the
# summation order of its logit and by expf's last bits (about 2^-20 of
# itself); an element may round the other way, by one bf16 step, only
# where the plain float32 value lies within DP_EDGE_RTOL of itself from
# the midpoint of the two bf16 values. The pad columns [V, Vp) are 0.
DP_EDGE_RTOL = 2 ** -12
# K3's sum of the real logits adds V float32 terms, each itself a sum of D
# products taken in another order: |err| <= 2^-22 * sum over the row of
# |logit| (4 float32 steps of the row's absolute mass)
MASS_RTOL = 2 ** -22


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(name: str, got, want, tol=None) -> float:
    import torch

    atol, rtol = tol or TOL[name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {atol:g} + {rtol:g}*|ref|)")
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside tolerance "
            f"(max abs err {max_err:.3e})"
        )
    return max_err


def check_mass(name: str, got, want, mass) -> float:
    """|got - want| <= MASS_RTOL * mass, elementwise."""
    import torch

    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {MASS_RTOL:g}*sum|logit|, "
        f"max {float((err / mass).max()):.3e} of the mass)")
    if not bool(torch.isfinite(got).all()) or bool((err > MASS_RTOL * mass).any()):
        raise AssertionError(f"{name}: elements outside tolerance (max abs err {max_err:.3e})")
    return max_err


def check_elementwise(name: str, got, want, term) -> float:
    """|got - want| <= r * |want| + t * term, elementwise."""
    import torch

    r, t = ELEMENT_TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = r * want.abs() + t * term
    used = float((err / tol.clamp(min=torch.finfo(torch.float32).tiny)).max())
    max_err = float(err.max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {r:g}*|ref| + {t:g}*term; median |ref| "
        f"{float(want.abs().median()):.3e}, median term {float(term.median()):.3e}; "
        f"worst err/tol {used:.3f})")
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: elements outside tolerance (max abs err {max_err:.3e}, "
                             f"worst err/tol {used:.3f})")
    return max_err


def check_dp(name: str, got, want, exact, vocab: int) -> float:
    """bf16 dp [N, Vp] against the plain bf16 dp: equal but one bf16 step
    at a rounding edge of the plain float32 value ``exact`` [N, V]
    (DP_EDGE_RTOL); 0 in the pad columns."""
    import torch

    if got.shape != want.shape or got.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, want bf16 "
                             f"{tuple(want.shape)}")
    if bool((got[:, vocab:] != 0).any()):
        raise AssertionError(f"{name}: nonzero pad columns")
    got, want = got[:, :vocab], want[:, :vocab]
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: kernel output has non-finite values")
    differ = got != want
    n_diff = int(differ.sum())
    max_err = float((got.float() - want.float()).abs().max())
    if n_diff:
        g, w_, x = got[differ], want[differ], exact[differ]
        steps = (g.view(torch.int16).int() - w_.view(torch.int16).int()).abs()
        same_sign = torch.signbit(g) == torch.signbit(w_)
        mid = (g.float() + w_.float()) / 2
        edge = (x - mid).abs() <= DP_EDGE_RTOL * x.abs()
        bad = ~(same_sign & (steps == 1) & edge)
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {n_diff} differing elements are not one bf16 step "
                f"apart at a rounding edge (max abs err {max_err:.3e})")
    log(f"  {name:5s} max_abs_err {max_err:.3e}  ({n_diff} of {got.numel()} elements one bf16 "
        f"step off, each at a rounding edge within {DP_EDGE_RTOL:g} of itself; pad columns 0)")
    return max_err


def ce_grad_terms(h, w, args) -> tuple:
    """For each element of dH [N, D] and of dW [V, D], a bound on the
    largest |product| in its sum, from the plain version's bf16 dlogits:
    the product of the largest |dlogit| over the contraction, exactly, and
    the second largest |dlogit| times the largest |operand| in the
    element's column for every other product."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    def bound(dp, other):  # dp [rows, K] (|dlogits|), other [K, D]
        top = dp.topk(2, dim=1)
        other = other.float().abs()
        return torch.maximum(top.values[:, :1] * other[top.indices[:, 0]],
                             top.values[:, 1:] * other.amax(0))

    dp = fc.dlogits_reference(*args).float().abs_()
    return bound(dp, w), bound(dp.t(), h)


# Faults planted in the kernels (the source file, the text to replace,
# its replacement, and the kernel whose check must fail it): K3's four bf16
# passes against their bars at the softmax-alone Llama-125M head
# (CE_SHAPES[1]); K5 against its bars at the small GQA shape with pads
# (FLASH_SMALL), where segment ids, the causal diagonal and the online
# rescale all matter
PLANTED_FAULTS = {
    "K3: the forward skips the running sum's rescale": (
        "fused_ce.cu", "l[hh] *= expf(m[hh] - m_new);", "l[hh] *= 1.f;", "K3"),
    "K3: lse + 0.1 in the dp epilogue": (
        "fused_ce.cu", "- lse_r[hh])", "- lse_r[hh] - 0.1f)", "K3"),
    "K3: the softmax term dropped from dp": (
        "fused_ce.cu", "return dl_r[hh] * expf(", "return 0.f * dl_r[hh] * expf(", "K3"),
    "K3: dH's K loop skips its last Vp tile": (
        "fused_ce.cu", "const int k_steps_dh = Vp / hopper::kBK;",
        "const int k_steps_dh = Vp / hopper::kBK - 1;", "K3"),
    "K3: dW's B operand (h) read one 64-row chunk late": (
        "fused_ce.cu", "hopper::make_map(&mb, h, N, D, true)",
        "hopper::make_map(&mb, static_cast<const bf16*>(h) + 64 * (size_t)D, N - 64, D, true)",
        "K3"),
    "K3: dW's middle chunk overwrites the float32 sum": (
        "fused_ce.cu", "if (mode >= 2) {", "if (mode >= 3) {", "K3 chunks"),
    "K5: dK/dV ignores the segment ids": (
        "flash_attention.cu", "(!seg_b || sg[ii] == skey[h])", "(true)", "K5"),
    "K5: dK/dV drops the causal diagonal": (
        "flash_attention.cu", "key_lo + h * 8 <= qq + ii", "key_lo + h * 8 < qq + ii", "K5"),
    "K4: the tie term dropped": (
        "block_attention.cu", "+ (eq ? c : 0.f)", "+ 0.f * (eq ? c : 0.f)", "K4"),
    "K4: dl ignored": ("block_attention.cu", "p * (dp_dot + dl)", "p * (dp_dot + 0.f * dl)", "K4"),
    "K4: the window edge off by one": (
        "block_attention.cu", "kp > qp - window", "kp >= qp - window", "K4"),
    "K5: the forward skips the output's rescale": (
        "flash_attention.cu", "oacc[j][e] *= corr[e / 2];", "oacc[j][e] *= 1.f;", "K5"),
}
FAULT_CHECKS = {
    "K3": lambda: ce_parity(CE_SHAPES[1][1], 7),
    "K3 chunks": lambda: ce_chunked_parity(CE_LLAMA, 11),
    "K5": lambda: flash_parity(FLASH_SMALL, 21),
    "K4": lambda: (block_parity(BLOCK_TIES, 31, ("full", "diag", *ZZ_SMALL)),
                   block_parity(BLOCK_SMALL, 32, ("full", *ZZ_SMALL))),
}
# run in the copy: exits 0 if the check failed the fault, 3 if it passed it
_FAULT_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
try:
    cs.FAULT_CHECKS[sys.argv[2]]()
except AssertionError as exc:
    print("caught:", exc)
    sys.exit(0)
sys.exit(3)
"""


# checks of planted faults running at once: each of K3's holds a few
# float32 [8184, 50257] tensors (1.6 GB each) of its plain version
FAULT_PROCS = 6


def planted_faults() -> None:
    """Each fault of PLANTED_FAULTS in its own copy of the package and its
    own process, FAULT_PROCS at a time: the patched kernel builds in the
    copy and its check must fail it."""
    procs = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for i, (fault, (source, old, new, kernel)) in enumerate(PLANTED_FAULTS.items()):
                while sum(p.poll() is None for p in procs.values()) >= FAULT_PROCS:
                    time.sleep(0.5)
                root = os.path.join(tmp, str(i))
                shutil.copytree(os.path.join(REPO, "acco_tpu_torch"),
                                os.path.join(root, "acco_tpu_torch"),
                                ignore=shutil.ignore_patterns("__pycache__"))
                shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
                path = os.path.join(root, "acco_tpu_torch", "csrc", source)
                with open(path) as f:
                    src = f.read()
                if src.count(old) != 1:
                    raise AssertionError(f"planted fault {fault!r}: its patch no longer applies")
                with open(path, "w") as f:
                    f.write(src.replace(old, new))
                with open(os.path.join(root, "check.log"), "w") as out:  # no pipe to fill
                    procs[fault] = subprocess.Popen(
                        [sys.executable, "-c", _FAULT_CHILD, root, kernel],
                        stdout=out, stderr=subprocess.STDOUT, text=True,
                    )
            for i, (fault, proc) in enumerate(procs.items()):
                proc.wait(timeout=600)
                with open(os.path.join(tmp, str(i), "check.log")) as f:
                    out = f.read()
                caught = [line for line in out.splitlines() if line.startswith("caught:")]
                if proc.returncode == 3:
                    raise AssertionError(f"planted fault {fault!r} passed its check:\n{out[-2000:]}")
                if proc.returncode != 0 or not caught:
                    raise AssertionError(f"planted fault {fault!r}: the check exited "
                                         f"{proc.returncode}:\n{out[-2000:]}")
                log(f"  {fault}: {caught[0]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def make_inputs(shape: dict, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, L, D = (shape[k] for k in ("B", "H", "L", "D"))
    Hkv = shape.get("Hkv", H)
    qk_std = shape.get("qk_std", 1.0)

    dtype = getattr(torch, shape.get("dtype", "bfloat16"))

    def randn(*s, std=1.0):
        return (torch.randn(*s, generator=g, device="cuda") * std).to(dtype)

    q, k = randn(B, H, L, D, std=qk_std), randn(B, Hkv, L, D, std=qk_std)
    v, dout = randn(B, Hkv, L, D), randn(B, H, L, D)
    pad = None
    if shape.get("pad"):
        # right padding, as the loader pads: no query row is left without
        # an allowed key, so every row is compared
        pad = torch.ones(B, L, dtype=torch.int32, device="cuda")
        pad[-1, L - L // 5:] = 0
        if shape["pad"] == "middle+tail":  # K5's segment ids: pad rows are compared too
            pad[0, L - L // 5:] = 0
            pad[-1, L // 3:L // 3 + 40] = 0
    return q, k, v, dout, pad


def parity(shape: dict, seed: int) -> dict:
    """Every kernel against its plain version; returns max errors."""
    import torch

    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, pad = make_inputs(shape, seed)
    window, scale = shape["window"], shape.get("scale", shape["D"] ** -0.5)
    errs = {}
    o, lse = fa.attn_fwd(q, k, v, pad, window, scale)
    o_ref, lse_ref = fa.attention_reference(q, k, v, pad, window, scale)
    torch.cuda.synchronize()
    errs["attn_fwd"] = max(check("o", o, o_ref), check("lse", lse, lse_ref))
    # The backward kernels get the same inputs as their plain versions: the
    # kernel forward's O and LSE, the kernel delta.
    delta = fa.attn_bwd_delta(o, dout)
    torch.cuda.synchronize()
    errs["attn_bwd_delta"] = check("delta", delta, fa.delta_reference(o, dout))
    dk, dv = fa.attn_bwd_dkdv(q, k, v, pad, dout, lse, delta, window, scale)
    dk_ref, dv_ref = fa.attn_bwd_dkdv_reference(
        q, k, v, pad, dout, lse, delta, window, scale
    )
    torch.cuda.synchronize()
    errs["attn_bwd_dkdv"] = max(check("dk", dk, dk_ref), check("dv", dv, dv_ref))
    dq = fa.attn_bwd_dq(q, k, v, pad, dout, lse, delta, window, scale)
    dq_ref = fa.attn_bwd_dq_reference(q, k, v, pad, dout, lse, delta, window, scale)
    torch.cuda.synchronize()
    errs["attn_bwd_dq"] = check("dq", dq, dq_ref)
    return errs


def banded_parity(shape: dict, seed: int) -> dict:
    """Every K2 kernel against its plain version at scale 1.0 (GPT-Neo's
    unscaled scores); returns max errors."""
    import torch

    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, _ = make_inputs({**shape, "qk_std": NEO_QK_STD}, seed)
    window, scale = shape["window"], 1.0
    errs = {}
    o, lse = bd.banded_fwd(q, k, v, window, scale)
    o_ref, lse_ref = bd.banded_reference(q, k, v, window, scale)
    torch.cuda.synchronize()
    errs["banded_fwd"] = max(check("o_band", o, o_ref), check("lse", lse, lse_ref))
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, dout, lse, delta, window, scale)
    dq = bd.banded_bwd_dq(*args)
    torch.cuda.synchronize()
    errs["banded_bwd_dq"] = check("dq", dq, bd.banded_bwd_dq_reference(*args))
    dk, dv = bd.banded_bwd_dkdv(*args)
    dk_ref, dv_ref = bd.banded_bwd_dkdv_reference(*args)
    torch.cuda.synchronize()
    errs["banded_bwd_dkdv"] = max(check("dk", dk, dk_ref), check("dv", dv, dv_ref))
    return errs


def head_parity() -> None:
    """The head's float32 logits (``lm_logits``: a bf16 GEMM with float32
    output) against the float32 product of the widened bf16 operands, at
    the main paths' shape: no rounding of the logits to bf16."""
    import torch

    from acco_tpu_torch.models.layers import lm_logits

    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn(BATCH, SEQ, D_MODEL, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(50257, D_MODEL, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = False
    got = lm_logits(h, w.t())
    want = torch.matmul(h.float(), w.float().t())
    log(f"  torch.mm out_dtype: {hasattr(torch.ops.aten.mm, 'dtype')}; logits {got.dtype}")
    check("logits", got, want)
    if got.dtype != torch.float32:
        raise AssertionError(f"lm_logits returned {got.dtype}")


def time_ms(fn, iters: int = 20, warmup: int = 3, windows: int = 5) -> float:
    """ms per call: the median over ``windows`` windows of the mean of
    ``iters`` calls between two CUDA events, after warm-up. One window of
    a 0.1 ms kernel lasts 2 ms, and a single slow window read up to 2x a
    kernel's time in the main path's profile."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(windows):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def device_ms(fn, iters: int = 10, attempts: int = 3) -> float:
    """Mean device ms per call: the CUDA kernels' own time under
    torch.profiler, for calls whose host cost (autograd) can exceed their
    device time and so would leak into an event-timed loop. A session
    whose trace holds no device activity (it happened once on the card,
    for a call that other sessions of the same run had traced) is
    profiled again, up to ``attempts`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in rows)
        if total > 0:
            return total / 1e3 / iters
        log(f"  the profiler recorded no device time (attempt {attempt} of {attempts})")
    raise AssertionError("the profiler recorded no device time")


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timing(shape: dict) -> tuple[dict, dict]:
    """Per-kernel ms, plain ms, library ms and bound at ``shape``, and
    the same for the three backward kernels together."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, pad = make_inputs(shape, 7)
    window, scale = shape["window"], shape["D"] ** -0.5
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    o, lse = fa.attn_fwd(q, k, v, pad, window, scale)
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, pad, dout, lse, delta, window, scale)

    # Work this run's inputs need: causal pairs (window 0, no pad here).
    pairs = B * H * L * (L + 1) / 2
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    kv = B * Hkv * L * D * 2
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "attn_fwd": (act + 2 * kv + act + row, 4 * D * pairs),
        "attn_bwd_delta": (2 * act + row, 2 * B * H * L * D),
        "attn_bwd_dkdv": (2 * act + 2 * kv + 2 * row + 2 * kv, 8 * D * pairs),
        "attn_bwd_dq": (2 * act + 2 * kv + 2 * row + act, 6 * D * pairs),
    }
    runs = {
        "attn_fwd": (
            lambda: fa.attn_fwd(q, k, v, pad, window, scale),
            lambda: fa.attention_reference(q, k, v, pad, window, scale),
        ),
        "attn_bwd_delta": (
            lambda: fa.attn_bwd_delta(o, dout),
            lambda: fa.delta_reference(o, dout),
        ),
        "attn_bwd_dkdv": (
            lambda: fa.attn_bwd_dkdv(*args),
            lambda: fa.attn_bwd_dkdv_reference(*args),
        ),
        "attn_bwd_dq": (
            lambda: fa.attn_bwd_dq(*args),
            lambda: fa.attn_bwd_dq_reference(*args),
        ),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    # Library yardstick, timed here and never called by the port:
    # F.scaled_dot_product_attention(is_causal=True) forward, and its
    # backward (one autograd call, device time: its host cost is larger
    # than its kernels') for the three backward kernels together.
    out["attn_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = device_ms(
        lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True)
    )
    bwd = ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")
    backward = {
        "ms": sum(out[n]["ms"] for n in bwd),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(
            3 * act + 2 * kv + row + act + 2 * kv, 10 * D * pairs
        )[0],
    }
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain "
        f"{backward['plain_ms']:.4f} ms  SDPA backward {sdpa_bwd_ms:.4f} ms  "
        f"bound {backward['bound_ms']:.4f} ms")
    return out, backward


def band_pairs(B: int, H: int, L: int, window: int) -> int:
    """(query, key) pairs a causal window attends: sum of min(i + 1, W)."""
    return B * H * sum(min(i + 1, window or L) for i in range(L))


def banded_timing(shape: dict) -> tuple[dict, dict]:
    """Each K2 kernel's ms, plain ms and bound at ``shape`` (scale 1.0),
    beside two yardsticks on the same inputs: the library call
    (F.scaled_dot_product_attention with a bool band mask; its backward
    as device time, as above) and the port's K1 at the same window; and
    the same for the backward (delta + dQ + dK/dV) together."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, _ = make_inputs({**shape, "qk_std": NEO_QK_STD}, 8)
    window, scale = shape["window"], 1.0
    B, H, L, D = (shape[x] for x in ("B", "H", "L", "D"))
    o, lse = bd.banded_fwd(q, k, v, window, scale)
    delta = fa.attn_bwd_delta(o, dout)
    args = (q, k, v, dout, lse, delta, window, scale)
    k1_args = (q, k, v, None, dout, lse, delta, window, scale)

    # Work this run's inputs need: the band's pairs, not L(L+1)/2.
    pairs = band_pairs(B, H, L, window)
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "banded_fwd": (4 * act + row, 4 * D * pairs),
        "banded_bwd_dq": (5 * act + 2 * row, 6 * D * pairs),
        "banded_bwd_dkdv": (6 * act + 2 * row, 8 * D * pairs),
    }
    runs = {
        "banded_fwd": (
            lambda: bd.banded_fwd(q, k, v, window, scale),
            lambda: bd.banded_reference(q, k, v, window, scale),
            lambda: fa.attn_fwd(q, k, v, None, window, scale),
        ),
        "banded_bwd_dq": (
            lambda: bd.banded_bwd_dq(*args),
            lambda: bd.banded_bwd_dq_reference(*args),
            lambda: fa.attn_bwd_dq(*k1_args),
        ),
        "banded_bwd_dkdv": (
            lambda: bd.banded_bwd_dkdv(*args),
            lambda: bd.banded_bwd_dkdv_reference(*args),
            lambda: fa.attn_bwd_dkdv(*k1_args),
        ),
    }
    out = {}
    for name, (kernel, plain, k1) in runs.items():
        ms, k1_ms, plain_ms = time_ms(kernel), time_ms(k1), time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "k1_ms": k1_ms}
    i = torch.arange(L, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    out["banded_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, scale=scale)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    y = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=band, scale=scale)
    sdpa_bwd_ms = device_ms(
        lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True)
    )
    delta_ms = time_ms(lambda: fa.attn_bwd_delta(o, dout))
    bwd = ("banded_bwd_dq", "banded_bwd_dkdv")
    backward = {
        "ms": delta_ms + sum(out[n]["ms"] for n in bwd),
        "k1_ms": delta_ms + sum(out[n]["k1_ms"] for n in bwd),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(8 * act + row, 10 * D * pairs)[0],
    }
    log(f"  band pairs {pairs}")
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  K1 at window {window} {r['k1_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  K1 {backward['k1_ms']:.4f} ms  "
        f"plain {backward['plain_ms']:.4f} ms  SDPA backward {sdpa_bwd_ms:.4f} ms  "
        f"bound {backward['bound_ms']:.4f} ms")
    return out, backward


def flash_plain(name: str, q, k, v, seg, *bwd, scale: float):
    """K5's plain version of kernel ``name``; at L >= 4096 one KV head
    (with its n_rep q heads) at a time, since heads are independent and
    the whole [B, H, L, L] float32 scores would take tens of GB."""
    import torch

    from acco_tpu_torch.ops import flash_attention as fl

    fn = {"flash_fwd": fl.flash_reference, "flash_bwd_dkdv": fl.flash_bwd_dkdv_reference,
          "flash_bwd_dq": fl.flash_bwd_dq_reference}[name]
    Hkv = k.shape[1]
    n_rep = q.shape[1] // Hkv
    if q.shape[2] < 4096:
        return fn(q, k, v, seg, *bwd, scale)
    outs = []
    for h in range(Hkv):
        qh, kvh = slice(h * n_rep, (h + 1) * n_rep), slice(h, h + 1)
        outs.append(fn(q[:, qh], k[:, kvh], v[:, kvh], seg, *(t[:, qh] for t in bwd), scale))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return torch.cat(outs, dim=1)


def flash_parity(shape: dict, seed: int) -> dict:
    """Every K5 kernel against its plain version; returns max errors. The
    backward kernels and their plain versions get the kernel forward's O
    and LSE and the kernel delta."""
    import torch

    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, seg = make_inputs(shape, seed)
    scale = shape["D"] ** -0.5
    f32 = q.dtype == torch.float32

    def tol(name):
        return F32_TOL if f32 else TOL[name]

    errs = {}
    o, lse = fl.flash_fwd(q, k, v, seg, scale)
    o_ref, lse_ref = flash_plain("flash_fwd", q, k, v, seg, scale=scale)
    torch.cuda.synchronize()
    errs["flash_fwd"] = max(check("o", o, o_ref, tol("o")), check("lse", lse, lse_ref, tol("lse")))
    del o_ref, lse_ref
    delta = fl.flash_bwd_delta(o, dout)
    torch.cuda.synchronize()
    errs["flash_bwd_delta"] = check("delta", delta, fa.delta_reference(o, dout), tol("delta"))
    bwd = (dout, lse, delta)
    dk, dv = fl.flash_bwd_dkdv(q, k, v, seg, *bwd, scale)
    dk_ref, dv_ref = flash_plain("flash_bwd_dkdv", q, k, v, seg, *bwd, scale=scale)
    torch.cuda.synchronize()
    errs["flash_bwd_dkdv"] = max(check("dk", dk, dk_ref, tol("dk")),
                                 check("dv", dv, dv_ref, tol("dv")))
    dq = fl.flash_bwd_dq(q, k, v, seg, *bwd, scale)
    dq_ref = flash_plain("flash_bwd_dq", q, k, v, seg, *bwd, scale=scale)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = check("dq", dq, dq_ref, tol("dq"))
    del q, k, v, dout, o, dk, dv, dq, dk_ref, dv_ref, dq_ref
    torch.cuda.empty_cache()
    return errs


def flash_timing(shape: dict) -> tuple[dict, dict]:
    """Each K5 kernel's ms, plain ms, library ms and bound at ``shape``
    (causal, no segment ids: the main path's case), and the same for the
    backward (delta + dK/dV + dQ) together. Library: SDPA on K/V repeated
    to q's heads beforehand (``is_causal=True``), its backward as one
    autograd call's device time, as for K1."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, seg = make_inputs(shape, 9)
    scale = shape["D"] ** -0.5
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    o, lse = fl.flash_fwd(q, k, v, seg, scale)
    delta = fl.flash_bwd_delta(o, dout)
    bwd = (dout, lse, delta)
    big = L >= 4096  # the plain version then runs one KV head at a time

    pairs = B * H * L * (L + 1) / 2  # causal pairs, no segment ids
    act = B * H * L * D * 2  # one bf16 [B, H, L, D] tensor
    kv = B * Hkv * L * D * 2
    row = B * H * L * 4  # one float32 [B, H, L] tensor
    work = {
        "flash_fwd": (act + 2 * kv + act + row, 4 * D * pairs),
        "flash_bwd_delta": (2 * act + row, 2 * B * H * L * D),
        "flash_bwd_dkdv": (2 * act + 2 * kv + 2 * row + 2 * kv, 8 * D * pairs),
        "flash_bwd_dq": (2 * act + 2 * kv + 2 * row + act, 6 * D * pairs),
    }
    runs = {
        "flash_fwd": (lambda: fl.flash_fwd(q, k, v, seg, scale),
                      lambda: flash_plain("flash_fwd", q, k, v, seg, scale=scale)),
        "flash_bwd_delta": (lambda: fl.flash_bwd_delta(o, dout),
                            lambda: fa.delta_reference(o, dout)),
        "flash_bwd_dkdv": (lambda: fl.flash_bwd_dkdv(q, k, v, seg, *bwd, scale),
                           lambda: flash_plain("flash_bwd_dkdv", q, k, v, seg, *bwd,
                                               scale=scale)),
        "flash_bwd_dq": (lambda: fl.flash_bwd_dq(q, k, v, seg, *bwd, scale),
                         lambda: flash_plain("flash_bwd_dq", q, k, v, seg, *bwd, scale=scale)),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, iters=5 if big else 20)
        plain_ms = time_ms(plain, iters=1, warmup=1, windows=3) if big else time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
        torch.cuda.empty_cache()
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    out["flash_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
    )
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kr, vr))
    y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = device_ms(lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True))
    del qg, kg, vg, y, kr, vr
    bwd_names = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
    backward = {
        "ms": sum(out[n]["ms"] for n in bwd_names),
        "plain_ms": sum(out[n]["plain_ms"] for n in bwd_names),
        "library_ms": sdpa_bwd_ms,
        "bound_ms": bound_ms(3 * act + 2 * kv + row + act + 2 * kv, 10 * D * pairs)[0],
    }
    log(f"  attended pairs {pairs:.6g}")
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"library {r['library_ms']} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain {backward['plain_ms']:.4f} ms"
        f"  SDPA backward {sdpa_bwd_ms:.4f} ms  bound {backward['bound_ms']:.4f} ms")
    log(f"  forward + backward  kernel {out['flash_fwd']['ms'] + backward['ms']:.4f} ms  SDPA "
        f"{out['flash_fwd']['library_ms'] + sdpa_bwd_ms:.4f} ms")
    del q, k, v, dout, o, lse, delta
    torch.cuda.empty_cache()
    return out, backward


def block_variant(shape: dict, variant: str):
    """(diag, query positions, key positions, window) of a K4 variant."""
    import torch

    from acco_tpu_torch.ops.ring_attention import zigzag_positions

    if variant in ("full", "diag"):
        return variant == "diag", None, None, 0
    q_rank, kv_rank, length, ranks, window = {**ZZ_NEO, **ZZ_SMALL}[variant]
    if length // ranks != shape["L"]:
        raise ValueError(f"{variant}: a chunk of {length // ranks}, shape has L {shape['L']}")
    pos = [zigzag_positions(length, ranks, r).to(torch.int32).cuda() for r in (q_rank, kv_rank)]
    return False, pos[0], pos[1], window


def make_block_inputs(shape: dict, seed: int):
    """q, k, v in the shape's dtype and random float32 cotangents g [B, H,
    L, D], r_m, r_l [B, H, L] (std 1) for K4's three outputs, which
    ``block_cotangents`` scales. With ``ties``, three keys of every KV head
    are one vector u and every query leans on u, so each row that sees
    them has its max three times."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    dtype = getattr(torch, shape.get("dtype", "bfloat16"))
    std = shape.get("qk_std", 1.0)

    def randn(*size, s=1.0):
        return torch.randn(*size, generator=g, device="cuda") * s

    q, k, v = randn(B, H, L, D, s=std), randn(B, Hkv, L, D, s=std), randn(B, Hkv, L, D)
    if shape.get("ties"):
        u = randn(D, s=std)
        q = q + u
        k[:, :, [3, 4, 5]] = 2 * u
    cot = (randn(B, H, L, D), randn(B, H, L), randn(B, H, L))
    return (q.to(dtype), k.to(dtype), v.to(dtype)), cot


def block_cotangents(cot, l):
    """(dO, dm, dl) at the scale the ring's merge gives them: the partial
    o is unnormalised (|o| grows with the row sum l), and the merge's
    cotangents on o and l carry a 1 / l, on m none: dO = g / l, dl = r_l /
    l, dm = r_m, random so that the tie term (dm - sum p dp) / cnt carries
    weight."""
    g, r_m, r_l = cot
    inv = 1.0 / l
    return (g * inv[..., None]).contiguous(), r_m.contiguous(), (r_l * inv).contiguous()


def block_plain(fn, q, k, v, *rows, **kw):
    """K4's plain version ``fn`` (forward or backward); at L >= 4096 one KV
    head (with its n_rep q heads) at a time, as flash_plain does."""
    import torch

    if q.shape[2] < 4096:
        return fn(q, k, v, *rows, **kw)
    n_rep = q.shape[1] // k.shape[1]
    outs = []
    for h in range(k.shape[1]):
        qh, kvh = slice(h * n_rep, (h + 1) * n_rep), slice(h, h + 1)
        outs.append(fn(q[:, qh], k[:, kvh], v[:, kvh], *(t[:, qh] for t in rows), **kw))
        torch.cuda.empty_cache()
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=1)
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def block_grad_terms(q, k, v, m, do, dm, dl, **kw):
    """For each element of K4's dQ, dK and dV, a bound on the largest
    product in its sum, from the plain version's dS and P: dq[i, d] sums
    scale ds[i, j] k[j, d] over keys, bounded by scale max_j |ds[i, j]|
    max_j |k[j, d]|; dk[j, d] and dv[j, d] likewise over the rows (and the
    q heads) of the KV head."""
    from acco_tpu_torch.ops import block_attention as bl

    def terms(q, k, v, m, do, dm, dl, **kw):
        p, ds, kr, scale = bl._block_bwd_terms(q, k, v, m, do, dm, dl, kw["diag"], kw["q_pos"],
                                               kw["kv_pos"], kw["window"], kw["scale"])
        B, H = q.shape[:2]
        Hkv = k.shape[1]

        def per_kv(x):  # [B, H, n] -> [B, Hkv, n], the max over each KV head's q heads
            return x.view(B, Hkv, H // Hkv, -1).amax(2)

        a = ds.abs()
        t_dq = scale * a.amax(-1, keepdim=True) * kr.float().abs().amax(2, keepdim=True)
        t_dk = scale * per_kv(a.amax(2))[..., None] * per_kv(q.float().abs().amax(2))[:, :, None]
        t_dv = per_kv(p.amax(2))[..., None] * per_kv(do.abs().amax(2))[:, :, None]
        return t_dq, t_dk, t_dv

    return block_plain(terms, q, k, v, m, do, dm, dl, **kw)


def check_term(name: str, got, want, term) -> float:
    """|got - want| <= atol + rtol |want| + 2^-6 term, elementwise (TOL's
    bar plus two bf16 steps of the element's largest product)."""
    import torch

    atol, rtol = TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = atol + rtol * want.abs() + 2 ** -6 * term
    max_err = float(err.max())
    used = float((err / tol).max())
    log(f"  {name:5s} max_abs_err {max_err:.3e}  (tol {atol:g} + {rtol:g}*|ref| + 2^-6*term; "
        f"median term {float(term.median()):.3e}; worst err/tol {used:.3f})")
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{name}: {int((err > tol).sum())} elements outside tolerance "
                             f"(max abs err {max_err:.3e}, worst err/tol {used:.3f})")
    return max_err


def block_parity(shape: dict, seed: int, variants) -> dict:
    """Every K4 kernel against its plain version, per variant; returns max
    errors. The row-statistics kernel and its plain version take the same
    inputs (the kernel forward's o, l, cnt); the dK/dV and dQ kernels and
    the plain backward each take their own forward's m, since eq = (s ==
    m) needs the s that its own products give."""
    import torch

    from acco_tpu_torch.ops import block_attention as bl

    (q, k, v), cot = make_block_inputs(shape, seed)
    scale = shape.get("scale", shape["D"] ** -0.5)
    f32 = q.dtype == torch.float32

    def tol(name):
        return F32_TOL if f32 else TOL[name]

    errs = {}
    for variant in variants:
        diag, qp, kp, window = block_variant(shape, variant)
        mode = bl._mode(diag, qp)
        fwd_name = "blk_fwd_" + ("pos" if qp is not None else variant)
        kw = dict(diag=diag, q_pos=qp, kv_pos=kp, window=window, scale=scale)
        log(f"  {variant}")
        o, m, l, cnt = bl.blk_fwd(q, k, v, mode, qp, kp, window, scale)
        o_r, m_r, l_r, cnt_r = block_plain(bl.block_fwd_reference, q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(cnt, cnt_r):
            raise AssertionError(f"cnt: {int((cnt != cnt_r).sum())} rows count other ties")
        # o is unnormalised: compared as o / l_ref, the normalised output's scale
        inv = 1.0 / l_r[..., None]
        e = max(check("o", o * inv, o_r * inv, tol("o")), check("blk_m", m, m_r, tol("blk_m")),
                check("blk_l", l, l_r, tol("blk_l")))
        do, dm, dl = block_cotangents(cot, l_r)
        errs[fwd_name] = max(errs.get(fwd_name, 0.0), e)
        log(f"  rows fully masked: {int((m == -1e9).sum())}; rows with tied maxima: "
            f"{int((cnt > 1).sum())}")
        del o_r, l_r, cnt_r
        do_t = do.to(q.dtype).contiguous()  # as the autograd backward passes it
        c = bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt)
        torch.cuda.synchronize()
        e = check("blk_c", c, bl.block_rowc_reference(o, do_t, dm, dl, l, cnt), tol("blk_c"))
        errs["blk_bwd_rowc"] = max(errs.get("blk_bwd_rowc", 0.0), e)
        args = (q, k, v, mode, qp, kp, window, scale, do_t, m, dl, c)
        dk, dv = bl.blk_bwd_dkdv(*args)
        dq = bl.blk_bwd_dq(*args)
        grads = block_plain(bl.block_bwd_reference, q, k, v, m_r, do, dm, dl, **kw)
        torch.cuda.synchronize()
        if f32:  # no rounding on either side: the float32 bar alone
            e = {n: check(n, g, r, F32_TOL) for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                                                 grads)}
        else:  # a random dm makes single products of dS large: their bf16 steps count
            terms = block_grad_terms(q, k, v, m_r, do, dm, dl, **kw)
            e = {n: check_term(n, g, r, t) for n, g, r, t in zip(("dq", "dk", "dv"),
                                                                  (dq, dk, dv), grads, terms)}
            del terms
        errs["blk_bwd_dkdv"] = max(errs.get("blk_bwd_dkdv", 0.0), e["dk"], e["dv"])
        errs["blk_bwd_dq"] = max(errs.get("blk_bwd_dq", 0.0), e["dq"])
        del o, dq, dk, dv, grads, do, dm, dl
        torch.cuda.empty_cache()
    return errs


def block_timing(shape: dict, variants, seed: int) -> dict:
    """Each K4 kernel's ms, plain ms and bound at ``shape``, per variant,
    beside SDPA on the same attended pairs (no mask for 'full',
    ``is_causal`` for 'diag', the bool mask for a positional variant): a
    reference time for the same work, not the same function (SDPA returns
    the normalised output and no m or l); its backward as one autograd
    call's device time. Keys '<kernel>/<variant>'."""
    import torch
    import torch.nn.functional as F

    from acco_tpu_torch.ops import block_attention as bl

    (q, k, v), cot = make_block_inputs(shape, seed)
    scale = shape.get("scale", shape["D"] ** -0.5)
    B, H, Hkv, L, D = (shape[x] for x in ("B", "H", "Hkv", "L", "D"))
    big = L >= 4096  # the plain version then runs one KV head at a time
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    out = {}
    for variant in variants:
        diag, qp, kp, window = block_variant(shape, variant)
        mode = bl._mode(diag, qp)
        kw = dict(diag=diag, q_pos=qp, kv_pos=kp, window=window, scale=scale)
        mask = bl.block_mask(L, L, diag, qp, kp, window, q.device)
        pairs = B * H * (L * L if mask is None else int(mask.sum()))
        o, m, l, cnt = bl.blk_fwd(q, k, v, mode, qp, kp, window, scale)
        do, dm, dl = block_cotangents(cot, l)
        do_t = do.to(q.dtype).contiguous()
        c = bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt)
        args = (q, k, v, mode, qp, kp, window, scale, do_t, m, dl, c)
        bwd = (q, k, v, m, do, dm, dl)
        act = B * H * L * D * q.element_size()  # q, dO or dQ
        kv = B * Hkv * L * D * k.element_size()
        o_bytes = B * H * L * D * 4  # the float32 partial o
        row = B * H * L * 4  # a float32 [B, H, L]
        work = {  # bytes (inputs read once, outputs written once), operations
            "blk_fwd": (act + 2 * kv + o_bytes + 3 * row, 4 * D * pairs),
            "blk_bwd_rowc": (o_bytes + act + 4 * row + row, 2 * B * H * L * D),
            "blk_bwd_dkdv": (2 * act + 2 * kv + 3 * row + 2 * kv, 8 * D * pairs),
            "blk_bwd_dq": (2 * act + 2 * kv + 3 * row + act, 6 * D * pairs),
        }
        runs = {
            "blk_fwd": (lambda: bl.blk_fwd(q, k, v, mode, qp, kp, window, scale),
                        lambda: block_plain(bl.block_fwd_reference, q, k, v, **kw)),
            "blk_bwd_rowc": (lambda: bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt),
                             lambda: bl.block_rowc_reference(o, do_t, dm, dl, l, cnt)),
            "blk_bwd_dkdv": (lambda: bl.blk_bwd_dkdv(*args),
                             lambda: block_plain(bl.block_bwd_dkdv_reference, *bwd, **kw)),
            "blk_bwd_dq": (lambda: bl.blk_bwd_dq(*args),
                           lambda: block_plain(bl.block_bwd_dq_reference, *bwd, **kw)),
        }
        sdpa_kw = {"full": {}, "diag": {"is_causal": True}}.get(variant, {"attn_mask": mask})
        for name, (kernel, plain) in runs.items():
            ms = time_ms(kernel, iters=5 if big else 20)
            plain_ms = (time_ms(plain, iters=1, warmup=1, windows=3) if big
                        else time_ms(plain, iters=5))
            b_ms, b_by = bound_ms(*work[name])
            out[f"{name}/{variant}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                        "bound_by": b_by, "library_ms": None}
            torch.cuda.empty_cache()
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr, scale=scale,
                                                                  **sdpa_kw))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kr, vr))
        y = F.scaled_dot_product_attention(qg, kg, vg, scale=scale, **sdpa_kw)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(y, (qg, kg, vg), do_t,
                                                         retain_graph=True))
        out[f"blk_fwd/{variant}"]["sdpa_ms"] = sdpa_fwd
        for name in ("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"):
            out[f"{name}/{variant}"]["sdpa_bwd_ms"] = sdpa_bwd
        del qg, kg, vg, y, o, m, l, cnt, c, do, do_t
        torch.cuda.empty_cache()
        log(f"  {variant}: attended pairs {pairs:.6g}")
        for name in runs:
            r = out[f"{name}/{variant}"]
            log(f"  {name:13s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        bwd_ms = sum(out[f"{n}/{variant}"]["ms"] for n in ("blk_bwd_rowc", "blk_bwd_dkdv",
                                                           "blk_bwd_dq"))
        log(f"  SDPA on the same pairs: forward {sdpa_fwd:.4f} ms, backward {sdpa_bwd:.4f} ms; "
            f"K4 forward {out[f'blk_fwd/{variant}']['ms']:.4f}, backward {bwd_ms:.4f} ms")
    del q, k, v, kr, vr
    torch.cuda.empty_cache()
    return out


def make_ce_inputs(shape: dict, seed: int):
    """K3's inputs on the card, bf16: hidden rows (std 1), the head as the
    [V, D] table (std 0.02, the models' init), int32 targets below v_real
    (0 on ignored rows, as fused_ce_loss maps them), and the cotangents
    of the mean loss that fused_ce_loss's outer arithmetic gives them
    (with ``softmax_only``: d_lse random per row, d_tl = d_sl = 0)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    N, D, V, v_real = (shape[k] for k in ("N", "D", "V", "v_real"))
    h = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(V, D, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    tgt = torch.randint(0, v_real, (N,), generator=g, device="cuda")
    mask = (torch.rand(N, generator=g, device="cuda") >= shape["ignore"]).float()
    if shape.get("seq"):
        mask[shape["seq"] - 1::shape["seq"]] = 0.0
    tgt = torch.where(mask > 0, tgt, torch.zeros_like(tgt)).to(torch.int32)
    ls, denom = shape["smoothing"], mask.sum().clamp(min=1.0)
    cot = (mask / denom, -(1.0 - ls) * mask / denom, -ls * mask / (denom * v_real))
    if shape.get("softmax_only"):
        d_lse = torch.randn(N, generator=g, device="cuda") * mask / denom
        cot = (d_lse, torch.zeros_like(d_lse), torch.zeros_like(d_lse))
    return h, w, tgt, v_real, mask, tuple(c.contiguous() for c in cot)


def ce_parity(shape: dict, seed: int) -> dict:
    """K3's four kernels against their plain versions; returns max errors.
    dp and its plain version get the kernel's lse; dH and dW take the
    kernel's dp and are held against the plain products of the plain dp.
    A second run of dp, dH and dW must give the same bits."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    h, w, tgt, v_real, _, cot = make_ce_inputs(shape, seed)
    V = w.shape[0]
    errs = {}
    lse, tl, sl = fc.ce_fwd(h, w, tgt, v_real)
    ref = fc.ce_fwd_reference(h, w, tgt, v_real)
    torch.cuda.synchronize()
    logits = fc._logits(h, w, v_real)[0]
    mass = logits.abs_()[:, :v_real].sum(-1)
    del logits
    errs["ce_fwd"] = max(check("ce_lse", lse, ref[0]), check("ce_tl", tl, ref[1]),
                         check_mass("ce_sl", sl, ref[2], mass))
    args = (h, w, tgt, v_real, lse, *cot)
    term_dh, term_dw = ce_grad_terms(h, w, args)
    dp = fc.ce_bwd_dp(*args)
    torch.cuda.synchronize()
    dp_ref = fc.ce_bwd_dp_reference(*args)
    errs["ce_bwd_dp"] = check_dp("ce_dp", dp, dp_ref, fc.dlogits_f32(*args), V)
    dh = fc.ce_bwd_dh(dp, w)
    torch.cuda.synchronize()
    errs["ce_bwd_dh"] = check_elementwise("ce_dh", dh, fc.ce_bwd_dh_reference(dp_ref, w), term_dh)
    dw = fc.ce_bwd_dw(dp, h, V)
    torch.cuda.synchronize()
    errs["ce_bwd_dw"] = check_elementwise("ce_dw", dw, fc.ce_bwd_dw_reference(dp_ref, h, V),
                                          term_dw)
    dp2 = fc.ce_bwd_dp(*args)
    same = (torch.equal(dp2, dp), torch.equal(fc.ce_bwd_dh(dp2, w), dh),
            torch.equal(fc.ce_bwd_dw(dp2, h, V), dw))
    log(f"  a second run of dp, dH, dW bit-identical: {same}")
    if not all(same):
        raise AssertionError(f"K3's backward is not deterministic: {same}")
    del h, w, ref, dp, dp2, dp_ref, dh, dw, term_dh, term_dw
    torch.cuda.empty_cache()
    return errs


def ce_chunked_parity(shape: dict, seed: int, n_chunks: int = 3) -> dict:
    """K3's bf16 backward through ``LmHeadCE`` with a dp cap that cuts the
    rows into ``n_chunks`` chunks of a multiple of 128 rows, the last
    ragged (dW summed in the float32 buffer: modes 1, 2, 3): dH bit-equal
    to the one-chunk run's (each row's dp and products do not depend on
    the chunk), dW against the plain chunked backward at the same cap."""
    import torch

    from acco_tpu_torch.ops import fused_ce as fc

    h, w, tgt, v_real, _, cot = make_ce_inputs(shape, seed)
    N, V = h.shape[0], w.shape[0]
    rows = -(-N // n_chunks)
    cap = 2 * fc.padded_vocab(V) * -(-rows // 128) * 128
    plan = fc.dp_plan(N, V, cap)
    if plan.n_chunks != n_chunks or not plan.dw_f32 or N % plan.chunk_rows == 0:
        raise AssertionError(f"cap {cap} gives {plan}, not {n_chunks} chunks, the last ragged")

    def grads(cap_bytes):
        hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
        out = fc.LmHeadCE.apply(hg, wg, tgt, v_real, cap_bytes)
        return torch.autograd.grad(out, (hg, wg), cot), out[0].detach()

    (dh1, _), lse = grads(fc.DP_CAP_BYTES)
    reset_launch_counts()
    dh, dw = grads(cap)[0]
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if k.startswith("ce_")}
    log(f"  {plan}; launches {launches}")
    if launches != {"ce_fwd": 1, **dict.fromkeys(("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw"),
                                                   n_chunks)}:
        raise AssertionError(f"the chunked backward launched {launches}")
    if not torch.equal(dh, dh1):
        raise AssertionError("the chunked dH differs from the one-chunk dH")
    log("  dH bit-equal to the one-chunk run's")
    args = (h, w, tgt, v_real, lse, *cot)
    _, term_dw = ce_grad_terms(h, w, args)
    ref_dw = fc.lm_head_ce_backward_reference(*args, cap_bytes=cap, need_h=False)[1]
    err = check_elementwise("ce_dw", dw, ref_dw, term_dw)
    del h, w, dh, dh1, dw, ref_dw, term_dw
    torch.cuda.empty_cache()
    return {"ce_bwd_dw": err}


def ce_timing(shape: dict, batch: int, seq: int) -> tuple[dict, dict, dict]:
    """K3's kernels at a head of ``batch`` x ``seq`` rows (the last of each
    sequence ignored): kernel ms, plain ms and bound, with their errors
    against the plain versions at this shape; and the loss as a whole
    (``fused_ce_loss`` forward, forward + backward, peak memory) beside the
    port's materialized head and CE (``layers.lm_logits`` +
    ``causal_lm_loss``) on the same inputs."""
    import torch

    from acco_tpu_torch.models.layers import lm_logits
    from acco_tpu_torch.ops import fused_ce as fc
    from acco_tpu_torch.ops.losses import IGNORE_INDEX, causal_lm_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    h, w, tgt, v_real, mask, cot = make_ce_inputs(shape, 11)
    N, D, V = (shape[k] for k in ("N", "D", "V"))
    lse, tl, sl = fc.ce_fwd(h, w, tgt, v_real)
    args = (h, w, tgt, v_real, lse, *cot)
    term_dh, term_dw = ce_grad_terms(h, w, args)
    dp = fc.ce_bwd_dp(*args)
    dp_ref = fc.ce_bwd_dp_reference(*args)
    errs = {"ce_fwd": check("ce_lse", lse, fc.ce_fwd_reference(h, w, tgt, v_real)[0]),
            "ce_bwd_dp": check_dp("ce_dp", dp, dp_ref, fc.dlogits_f32(*args), V)}
    errs["ce_bwd_dh"] = check_elementwise("ce_dh", fc.ce_bwd_dh(dp, w),
                                          fc.ce_bwd_dh_reference(dp_ref, w), term_dh)
    errs["ce_bwd_dw"] = check_elementwise("ce_dw", fc.ce_bwd_dw(dp, h, V),
                                          fc.ce_bwd_dw_reference(dp_ref, h, V), term_dw)
    del term_dh, term_dw, dp_ref
    torch.cuda.empty_cache()
    vp = fc.padded_vocab(V)
    rows, hb, wb, dpb = N * 4, N * D * 2, V * D * 2, N * vp * 2  # float32 [N]; bf16 h, w, dp
    ops = 2 * N * D * V
    work = {  # bytes (inputs read once, outputs written once), operations
        "ce_fwd": (hb + wb + rows + 3 * rows, ops),
        "ce_bwd_dp": (hb + wb + rows + 4 * rows + dpb, ops),
        "ce_bwd_dh": (dpb + wb + hb, ops),
        "ce_bwd_dw": (dpb + hb + wb, ops),
    }
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    runs = {
        "ce_fwd": (lambda: fc.ce_fwd(h, w, tgt, v_real),
                   lambda: fc.ce_fwd_reference(h, w, tgt, v_real)),
        "ce_bwd_dp": (lambda: fc.ce_bwd_dp(*args, out=dp), lambda: fc.ce_bwd_dp_reference(*args)),
        "ce_bwd_dh": (lambda: fc.ce_bwd_dh(dp, w, out=dh), lambda: fc.ce_bwd_dh_reference(dp, w)),
        "ce_bwd_dw": (lambda: fc.ce_bwd_dw(dp, h, V, out=dw),
                      lambda: fc.ce_bwd_dw_reference(dp, h, V)),
    }
    out = {}
    for name, (kernel, plain) in runs.items():
        ms, plain_ms = time_ms(kernel, iters=10), time_ms(plain, iters=2, windows=3)
        b_ms, b_by = bound_ms(*work[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None}
        torch.cuda.empty_cache()
    del dp, dh, dw

    # the whole loss on [B, L, D] hidden states and B L labels whose
    # shift gives the targets above, through K3 and through the
    # materialized head
    h3 = h.view(batch, seq, D)
    labels = torch.full((batch, seq), IGNORE_INDEX, dtype=torch.long, device="cuda")
    labels[:, 1:] = torch.where(mask > 0, tgt.long(), IGNORE_INDEX).view(batch, seq)[:, :-1]
    hg, wg = h3.detach().requires_grad_(True), w.detach().requires_grad_(True)

    def fused(grad: bool):
        loss = fc.fused_ce_loss(hg, wg.t(), labels)
        return torch.autograd.grad(loss, (hg, wg)) if grad else loss

    def materialized(grad: bool):
        loss = causal_lm_loss(lm_logits(hg, wg.t()), labels)
        return torch.autograd.grad(loss, (hg, wg)) if grad else loss

    whole = {}
    for name, fn in (("fused", fused), ("materialized", materialized)):
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fn(False), iters=5, windows=3)
        step_ms = time_ms(lambda: fn(True), iters=5, windows=3)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        whole[name] = {"forward_ms": fwd_ms, "backward_ms": step_ms - fwd_ms,
                       "step_ms": step_ms, "peak_bytes": peak}
        torch.cuda.empty_cache()
    with torch.no_grad():
        loss_f, loss_m = float(fused(False)), float(materialized(False))
    log(f"  loss: K3 {loss_f:.6f}  materialized {loss_m:.6f}")
    if abs(loss_f - loss_m) > 1e-5 * abs(loss_m):
        raise AssertionError("K3's loss and the materialized loss disagree")
    out["ce_fwd"]["materialized_ms"] = whole["materialized"]["forward_ms"]
    for name in ("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw"):  # the materialized backward makes all
        out[name]["materialized_ms"] = whole["materialized"]["backward_ms"]
    bwd = ("ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw")
    backward = {
        "ms": sum(out[k]["ms"] for k in bwd),
        "plain_ms": sum(out[k]["plain_ms"] for k in bwd),
        "materialized_ms": whole["materialized"]["backward_ms"],
        "bound_ms": sum(out[k]["bound_ms"] for k in bwd),
    }
    for name, r in out.items():
        log(f"  {name:15s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"materialized {r['materialized_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; kernel / bound {r['ms'] / r['bound_ms']:.2f}, "
            f"{ops / r['ms'] / 1e9:.1f} TFLOP/s)")
    log(f"  backward total  kernel {backward['ms']:.4f} ms  plain {backward['plain_ms']:.4f} ms"
        f"  materialized {backward['materialized_ms']:.4f} ms  bound {backward['bound_ms']:.4f} ms")
    log(f"  K3 forward + backward {out['ce_fwd']['ms'] + backward['ms']:.4f} ms against the "
        f"materialized head and CE's {whole['materialized']['step_ms']:.4f} ms")
    for name, r in whole.items():
        log(f"  whole loss, {name:12s}: forward {r['forward_ms']:.4f} ms  backward "
            f"{r['backward_ms']:.4f} ms  step {r['step_ms']:.4f} ms  peak above inputs "
            f"{r['peak_bytes']} bytes ({r['peak_bytes'] / 2**30:.3f} GiB)")
    del h, w, hg, wg, h3
    torch.cuda.empty_cache()
    return out, {**backward, "whole": whole}, errs


def _launch_tables():
    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import block_attention as bl
    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa
    from acco_tpu_torch.ops import fused_ce as fc

    return fa, bd, fc, fl, bl


def reset_launch_counts() -> None:
    for module in _launch_tables():
        module.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for module in _launch_tables():
        out.update(module.LAUNCHES)
    return out


class HeadLogitsCalls:
    """Counts the models' calls of the materialized head
    (``layers.lm_logits``, as models/llama.py and models/gpt_neo.py import
    it) while the context is open: the fused-CE path must make none."""

    def __enter__(self):
        from acco_tpu_torch.models import gpt_neo, llama

        self.count, self.saved = 0, []
        for module in (llama, gpt_neo):
            original = module.lm_logits

            def counted(h, w, _original=original):
                self.count += 1
                return _original(h, w)

            self.saved.append((module, original))
            module.lm_logits = counted
        return self

    def __exit__(self, *exc):
        for module, original in self.saved:
            module.lm_logits = original


class BlockWindows:
    """Counts K4's positional forward launches by window while the
    context is open (the windowed ring's layers: 0 = global)."""

    def __enter__(self):
        from acco_tpu_torch.ops import block_attention as bl

        self.module, self.original, self.counts = bl, bl.blk_fwd, {}

        def counted(q, k, v, mode, q_pos, kv_pos, window, scale):
            if mode == bl.MODES["pos"]:
                self.counts[window] = self.counts.get(window, 0) + 1
            return self.original(q, k, v, mode, q_pos, kv_pos, window, scale)

        bl.blk_fwd = counted
        return self

    def __exit__(self, *exc):
        self.module.blk_fwd = self.original


# Each main path: its model and extra overrides, its shape (batch, seq,
# d_model), its layers' windows (0 = global), the parameters outside any
# matmul (an untied embedding table), the fused loss it must resolve to,
# the launches per microbatch of every kernel (K2 reuses K1's delta
# kernel) and the calls of the materialized head per microbatch.
_K1 = ("attn_fwd", "attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq")
_K2 = ("banded_fwd", "banded_bwd_dq", "banded_bwd_dkdv")
_K3 = ("ce_fwd", "ce_bwd_dp", "ce_bwd_dh", "ce_bwd_dw")
_K3_F32 = ("ce_fwd", "ce_bwd_dh", "ce_bwd_dw")  # float32: dp recomputed inside dH and dW
_K5 = ("flash_fwd", "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
_K4 = ("blk_fwd_diag", "blk_fwd_full", "blk_fwd_pos", "blk_bwd_rowc", "blk_bwd_dkdv",
       "blk_bwd_dq")
_125M = dict(batch=BATCH, seq=SEQ, d_model=D_MODEL, embed_params=0)
MAIN_PATHS = {
    "llama-125M": dict(
        model="llama-125M", extra=[], **_125M, windows=[0] * LAYERS, head_logits=1,
        fused_loss=False, attention="fused",
        per_microbatch={**dict.fromkeys(_K1, 12), **dict.fromkeys(_K2 + _K3 + _K5 + _K4, 0)},
    ),
    "gptneo": dict(
        model="gptneo", extra=[], **_125M, windows=[0, NEO_WINDOW] * (LAYERS // 2),
        head_logits=1, fused_loss=False, attention="fused",
        per_microbatch={"attn_fwd": 6, "attn_bwd_delta": 12, "attn_bwd_dkdv": 6,
                        "attn_bwd_dq": 6, **dict.fromkeys(_K2, 6),
                        **dict.fromkeys(_K3 + _K5 + _K4, 0)},
    ),
    "llama-125M-fusedce": dict(
        model="llama-125M", extra=["train.fused_loss=pallas"], **_125M, windows=[0] * LAYERS,
        head_logits=0, fused_loss="pallas", attention="fused",
        per_microbatch={**dict.fromkeys(_K1, 12), **dict.fromkeys(_K2 + _K5 + _K4, 0),
                        **dict.fromkeys(_K3, 1)},
    ),
    # Llama-3-8B at full width, 2 layers, L 8192: use_pallas_attention and
    # fused_loss stay 'auto' and must resolve to K5 and K3
    "llama3-8B-L8192": dict(
        model="llama-125M", llama3=True, extra=[], batch=1, seq=LLAMA3_SEQ, d_model=4096,
        embed_params=128256 * 4096, windows=[0] * LLAMA3_LAYERS, head_logits=0,
        fused_loss="pallas", attention="flash",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K4, 0), **dict.fromkeys(_K3, 1),
                        **dict.fromkeys(_K5, LLAMA3_LAYERS)},
    ),
}
# The ring paths (context parallelism through a one-rank NCCL sequence
# group: every layout runs its self blocks, no hop): the long-context
# Llama path's model and data through the zig-zag ring (per layer two
# diagonal half-blocks and one full, 4096 rows each; K3 for the loss, as
# fused_loss 'auto' resolves under CP), and GPT-Neo-125M through the
# windowed ring (one positional block per layer, window 0 or 256; K3 as
# well). GPT-Neo-125M's position table holds 1024 positions, so its ring
# runs at L 1024 as its main path does.
RING_PATHS = {
    "llama3-8B-L8192-ring": dict(
        base="llama3-8B-L8192", batch=1, seq=LLAMA3_SEQ, d_model=4096,
        embed_params=128256 * 4096, windows=[0] * LLAMA3_LAYERS, head_logits=0,
        fused_loss="pallas", attention="ring",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K5, 0), **dict.fromkeys(_K3, 1),
                        "blk_fwd_diag": 2 * LLAMA3_LAYERS, "blk_fwd_full": LLAMA3_LAYERS,
                        "blk_fwd_pos": 0,
                        **dict.fromkeys(("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
                                        3 * LLAMA3_LAYERS)},
    ),
    "gptneo-ring": dict(
        base="gptneo", **_125M, windows=[0, NEO_WINDOW] * (LAYERS // 2), head_logits=0,
        fused_loss="pallas", attention="ring",
        per_microbatch={**dict.fromkeys(_K1 + _K2 + _K5, 0), **dict.fromkeys(_K3, 1),
                        "blk_fwd_diag": 0, "blk_fwd_full": 0, "blk_fwd_pos": LAYERS,
                        **dict.fromkeys(("blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
                                        LAYERS)},
        pos_windows={0: LAYERS // 2, NEO_WINDOW: LAYERS // 2},
    ),
}
# the kernel each JSON entry reports launches for: its own slice's path
OWN_PATH = {**dict.fromkeys(_K1, "llama-125M"), **dict.fromkeys(_K2, "gptneo"),
            **dict.fromkeys(_K3, "llama-125M-fusedce"), **dict.fromkeys(_K5, "llama3-8B-L8192"),
            **dict.fromkeys(_K4, "llama3-8B-L8192-ring"), "blk_fwd_pos": "gptneo-ring"}
SOURCE = {**dict.fromkeys(_K1, "fused_attention.cu"), **dict.fromkeys(_K2, "banded_attention.cu"),
          **dict.fromkeys(_K3, "fused_ce.cu"), **dict.fromkeys(_K5, "flash_attention.cu"),
          **dict.fromkeys(_K4, "block_attention.cu")}


def ring_trainer(path: str, sg, extra=()):
    """The trainer of a ring path: its base path's configuration, the model
    on the ring, and ``sg`` (a one-rank sequence group) handed in."""
    from acco_tpu_torch.__main__ import build_trainer

    return build_trainer([*main_args(RING_PATHS[path]["base"]), *extra], sequence_group=sg)


def main_path(path: str, sg=None) -> tuple[dict, float, int, dict]:
    """The port's entry point, in-process, at the model's full width (a
    ring path: its trainer on the one-rank group ``sg``), with every
    launch count (and the materialized head's calls) set to 0 just before
    the run and read just after; returns the counts, the median round ms,
    the peak memory and the summary."""
    import torch

    from acco_tpu_torch.__main__ import main as entry

    spec = MAIN_PATHS.get(path) or RING_PATHS[path]
    model = path
    torch.cuda.reset_peak_memory_stats()
    with HeadLogitsCalls() as head, BlockWindows() as windows:
        reset_launch_counts()
        summary = entry(main_args(path)) if sg is None else ring_trainer(path, sg).train()
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rounds = summary["round_log"]
    if len(rounds) != MAIN_ROUNDS:
        raise AssertionError(f"expected {MAIN_ROUNDS} rounds, ran {len(rounds)}")
    losses = [summary["seed_loss"]] + [r["loss"] for r in rounds]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    real = [r["is_real_update"] for r in rounds]
    if real != [r % 2 == 1 for r in range(MAIN_ROUNDS)]:
        raise AssertionError(f"is_real_update does not alternate: {real}")
    microbatches = (MAIN_ROUNDS + 1) * 1  # seed + rounds, n_acc 1
    if summary["fused_loss"] != spec["fused_loss"]:
        raise AssertionError(f"{model}: fused_loss resolved to {summary['fused_loss']!r}")
    if summary["attention"] != spec["attention"]:
        raise AssertionError(f"{model}: attention resolved to {summary['attention']!r}")
    if head.count != spec["head_logits"] * microbatches:
        raise AssertionError(f"{model}: the materialized head ran {head.count} times, expected "
                             f"{spec['head_logits']} per microbatch x {microbatches}")
    want_windows = {w: n * microbatches for w, n in spec.get("pos_windows", {}).items()}
    if windows.counts != want_windows:
        raise AssertionError(f"{model}: K4's positional launches by window {windows.counts}, "
                             f"expected {want_windows}")
    for name, per_mb in spec["per_microbatch"].items():
        if launches[name] != per_mb * microbatches:
            raise AssertionError(
                f"{model}: {name} launched {launches[name]} times, expected {per_mb} "
                f"per microbatch x {microbatches} microbatches"
            )
    round_ms = [r["ms"] for r in rounds]
    med = statistics.median(round_ms)
    seq, d_model = spec["seq"], spec["d_model"]
    tokens = spec["batch"] * seq
    log(f"  attention {summary['attention']}  fused_loss {summary['fused_loss']}  "
        f"n_params {summary['n_params']}")
    log(f"  losses {['%.4f' % x for x in losses]}")
    log(f"  is_real_update {real}")
    log(f"  round ms {['%.1f' % x for x in round_ms]}  median {med:.2f}")
    tok_s = tokens / (med / 1e3)
    # model FLOPs per token: 6 N for the matmuls (the tied head counted
    # once; an untied embedding table, a lookup, not at all) plus, per
    # layer, 12 d times the mean keys a row attends (forward and backward
    # of QK^T and PV)
    n_matmul = summary["n_params"] - spec["embed_params"]
    mean_keys = [band_pairs(1, 1, seq, w) / seq for w in spec["windows"]]
    flops_per_token = 6 * n_matmul + sum(12 * d_model * m for m in mean_keys)
    log(f"  MFU formula: (6 x {n_matmul} + sum over layers of 12 x {d_model} x "
        f"mean keys {sorted(set(round(m, 3) for m in mean_keys))}) x tokens/s / "
        f"{PEAK_BF16_FLOPS:.3g}")
    log(f"  tokens/s {tok_s:.1f}  MFU {flops_per_token * tok_s / PEAK_BF16_FLOPS:.4f} "
        f"(vs {PEAK_BF16_FLOPS:.3g} FLOP/s bf16)")
    log(f"  max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"  launches {launches}  materialized head calls {head.count}"
        + (f"  K4 positional launches by window {windows.counts}" if windows.counts else ""))
    return launches, med, peak, summary


ATTENTION_RUNS = (
    ["train.use_pallas_attention=fused", "train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)
CE_RUNS = (
    ["train.use_pallas_attention=fused", "train.fused_loss=pallas"],
    ["train.use_pallas_attention=fused", "train.fused_loss=false"],
)
FLASH_RUNS = (
    ["train.use_pallas_attention=true", "train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)


RING_RUNS = (
    ["train.fused_loss=false"],
    ["train.use_pallas_attention=xla", "train.fused_loss=false"],
)


def small_input_agreement(args: list[str], kernels: tuple[str, ...], runs=ATTENTION_RUNS,
                          plain_silent: tuple[str, ...] | None = None, sg=None) -> None:
    """The entry point twice on a small float32 input (4 ACCO rounds),
    with the overrides of ``runs``: once through the kernels (on the ring,
    with ``sg`` handed in, when given) and once through their plain path.
    Every kernel in ``kernels`` launched in the first run; none of
    ``plain_silent`` (by default: no kernel at all) in the second; the
    losses and the last staged gradients agree."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for group, extra in zip((sg, None), runs):
        reset_launch_counts()
        trainer = build_trainer([
            *args, "train.nb_steps_tot=4", "train.use_mixed_precision=false", *extra,
        ], sequence_group=group)
        summary = trainer.train()
        out.append((summary, trainer.final_state, launch_counts()))
    (s_k, st_k, n_k), (s_p, st_p, n_p) = out
    silent = n_p.keys() if plain_silent is None else plain_silent
    if any(n_k[k] == 0 for k in kernels) or any(n_p[k] for k in silent):
        raise AssertionError(f"kernel launches: kernel run {n_k}, plain run {n_p}")
    losses_k = [s_k["seed_loss"]] + [r["loss"] for r in s_k["round_log"]]
    losses_p = [s_p["seed_loss"]] + [r["loss"] for r in s_p["round_log"]]
    g_k, g_p = st_k.pending_grads, st_p.pending_grads
    err = float((g_k - g_p).abs().max())
    # float32 on both sides; only the summation order differs
    tol = 1e-4 * float(g_p.abs().max())
    log(f"  launches (kernel run) { {k: n_k[k] for k in kernels} }")
    log(f"  losses kernel {['%.6f' % x for x in losses_k]}")
    log(f"  losses plain  {['%.6f' % x for x in losses_p]}")
    log(f"  staged grads max abs diff {err:.3e} (tol {tol:.3e} = 1e-4 * max|g|)")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(losses_k, losses_p)) or err > tol:
        raise AssertionError("kernel and plain training runs disagree")


@contextlib.contextmanager
def one_rank_group():
    """A one-rank NCCL process group on the card (any free local port),
    yielding its SequenceGroup (the port's context-parallel code with no
    hop) and destroyed on the way out."""
    import socket

    import torch
    import torch.distributed as dist

    from acco_tpu_torch.ops.ring_attention import SequenceGroup

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield SequenceGroup.of(dist.group.WORLD)
    finally:
        dist.destroy_process_group()


# the ring paths against the paths they share weights and data with:
# losses in bf16 within this share of the reference (both sides round
# the attention output to bf16; K4 merges float32 partials where K5 and
# K1/K2 normalise in-kernel), gradients within this relative L2 distance
RING_LOSS_RTOL = 1e-3
RING_GRAD_RTOL = 1e-2


def ring_loss_vs(summary: dict, reference: dict, what: str) -> float:
    """The round-0 loss of a ring path against its reference path's: same
    weights (the seed), same batch (the loader's seed), both before any
    update (round 0 computes at the initial weights)."""
    got, want = summary["round_log"][0]["loss"], reference["round_log"][0]["loss"]
    rel = abs(got - want) / abs(want)
    log(f"  round-0 loss: ring {got:.6f}  {what} {want:.6f}  relative difference {rel:.3e} "
        f"(bar {RING_LOSS_RTOL:g})")
    if rel > RING_LOSS_RTOL:
        raise AssertionError(f"the ring path's round-0 loss is off the {what} path's")
    return rel


def neo_ring_step_agreement(sg) -> None:
    """GPT-Neo-125M, one forward and backward on the same weights and
    batch: the windowed ring (K4, on the one-rank group) against the
    non-CP path (K1 on the global layers, K2 on the local ones), both
    with the loss through K3."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
    from acco_tpu_torch.parallel.common import block_from_numpy, prep_cp_leaves

    out = []
    for group in (sg, None):
        trainer = build_trainer([*main_args("gptneo"), "train.fused_loss=pallas"],
                                sequence_group=group)
        device = trainer.device
        flat = trainer.step.init_state(trainer.model.init_flat(
            torch.Generator(device=device).manual_seed(trainer.seed))).flat_params
        block = block_from_numpy(stack_microbatches(infinite_batches(trainer.loader), 1), device)
        block = prep_cp_leaves(block, group, trainer.model.zigzag)
        reset_launch_counts()
        loss, grads = trainer.step.value_and_grad(flat, {
            "input_ids": block.input_ids[0], "attention_mask": block.attention_mask[0],
            "labels": block.labels[0]})
        torch.cuda.synchronize()
        out.append((float(loss), torch.cat([g.float().reshape(-1) for g in grads]),
                    launch_counts()))
        del trainer, flat, grads
        torch.cuda.empty_cache()
    (loss_r, g_r, n_r), (loss_d, g_d, n_d) = out
    rel = abs(loss_r - loss_d) / abs(loss_d)
    g_rel = float((g_r - g_d).norm() / g_d.norm())
    log(f"  launches: ring { {k: n_r[k] for k in _K4 + _K1[:1] + _K2[:1]} }")
    log(f"  launches: non-CP { {k: n_d[k] for k in _K4 + _K1[:1] + _K2[:1]} }")
    log(f"  loss ring {loss_r:.6f}  non-CP {loss_d:.6f}  relative difference {rel:.3e} (bar "
        f"{RING_LOSS_RTOL:g}); gradients |ring - non-CP| / |non-CP| = {g_rel:.3e} (bar "
        f"{RING_GRAD_RTOL:g})")
    if (n_r["blk_fwd_pos"] != LAYERS or n_r["attn_fwd"] or n_d["blk_fwd_pos"]
            or not n_d["attn_fwd"] or not n_d["banded_fwd"]):
        raise AssertionError("the two GPT-Neo runs did not take the kernels they name")
    if rel > RING_LOSS_RTOL or g_rel > RING_GRAD_RTOL:
        raise AssertionError("GPT-Neo's windowed ring and its non-CP path disagree")


def profile_main_path(model: str, round_ms: float, top: int = 12, sg=None) -> None:
    """Where the device time of a main path goes: the same run again,
    under torch.profiler (after the measured run, so the profiler's own
    cost touches no reported time). Prints device ms per microbatch for
    the top kernels, and the device's idle share of a round: 1 - device
    ms per microbatch / the measured run's median round ms (n_acc 1). The
    profiled run's own wall time includes the profiler's host cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from acco_tpu_torch.__main__ import build_trainer

    trainer = build_trainer(main_args(model)) if sg is None else ring_trainer(model, sg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    microbatches = MAIN_ROUNDS + 1
    # device-side rows only: CPU op rows also carry their kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    per_mb = busy_ms / microbatches
    log(f"  {model}: device busy {per_mb:.2f} ms per microbatch (init + seed + "
        f"{MAIN_ROUNDS} rounds: {busy_ms:.1f} ms in {wall_ms:.1f} ms of profiled wall "
        f"time); idle share of a {round_ms:.2f} ms round {1 - per_mb / round_ms:.3f}")
    for family, tag in (("K1", r"\battn_"), ("K2", r"\bbanded_"), ("K3", r"\bce_(fwd|bwd)"),
                        ("K5", r"\bflash_"), ("K4", r"\bblk_")):
        rows = [e for e in kernels if re.search(tag, e.key)]
        ms = sum(e.self_device_time_total for e in rows) / 1e3 / microbatches
        log(f"  {family} kernels: {ms:.3f} ms/microbatch "
            f"({', '.join(sorted({kernel_label(e.key) for e in rows}))})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3 / microbatches:9.3f} ms/microbatch "
            f"x{e.count // microbatches:<4d} {kernel_label(e.key)}: {e.key[:90]}")


def kernel_label(key: str) -> str:
    """A kernel's short name in a profile: the epilogue of a Hopper GEMM
    (``hopper_gemm_kernel<..., ce_fwd_epilogue>``), else its own name."""
    m = re.search(r"\w+_epilogue", key) or re.search(r"\w+_kernel", key) or re.search(r"\w+", key)
    return m.group(0) if m else key


def build_all() -> None:
    """The four kernel libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from acco_tpu_torch.utils import cuda_build

    names = ("fused_attention", "banded_attention", "fused_ce", "flash_attention",
             "block_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        for future in [pool.submit(cuda_build.build, n) for n in names]:
            future.result()
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for name in names:
        info = cuda_build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.1f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("    " + line.strip())


# The TPU kernel each Hopper kernel replaces (file:line of its pallas_call).
REPLACES = {
    "attn_fwd": "acco_tpu/ops/fused_attention.py:197",
    "attn_bwd_delta": "acco_tpu/ops/fused_attention.py:243",
    "attn_bwd_dkdv": "acco_tpu/ops/fused_attention.py:243",
    "attn_bwd_dq": "acco_tpu/ops/fused_attention.py:243",
    "banded_fwd": "acco_tpu/ops/banded_attention.py:240",
    "banded_bwd_dq": "acco_tpu/ops/banded_attention.py:279",
    "banded_bwd_dkdv": "acco_tpu/ops/banded_attention.py:314",
    "ce_fwd": "acco_tpu/ops/fused_ce.py:267",
    # one dp, one dH and one dW kernel serve both backward forms of the TPU
    # kernel: the split dH / dW calls and the fused call (:324); dp is the
    # `_dp_tile` (:160) that each of those calls computes
    "ce_bwd_dp": "acco_tpu/ops/fused_ce.py:324, acco_tpu/ops/fused_ce.py:356, "
                 "acco_tpu/ops/fused_ce.py:375",
    "ce_bwd_dh": "acco_tpu/ops/fused_ce.py:356, acco_tpu/ops/fused_ce.py:324",
    "ce_bwd_dw": "acco_tpu/ops/fused_ce.py:375, acco_tpu/ops/fused_ce.py:324",
    # JAX's bundled TPU flash kernel (jax.experimental.pallas.ops.tpu.
    # flash_attention), reached through the JAX package's flash path: the
    # forward, dK/dV and dQ pallas_calls and the backward's plain-jnp delta
    **dict.fromkeys(_K5, "acco_tpu/ops/attention.py:193"),
    # the ring's block: forward and VJP pallas_calls
    **dict.fromkeys(_K4[:3], "acco_tpu/ops/block_attention.py:200"),
    **dict.fromkeys(_K4[3:], "acco_tpu/ops/block_attention.py:250"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import acco_tpu_torch  # noqa: F401  (the port, from this checkout)
    except ImportError as exc:
        print(f"chip_smoke: the port is not in this checkout ({exc})", file=sys.stderr)
        return 2

    log("== 1 device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name}  count {count}  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}")

    log("== 2 build")
    build_all()

    log("== 3 parity (bf16 unless named, kernel vs plain on the same inputs)")
    errs = {}
    k1_shapes = (("flagship", FLAGSHIP, 0), ("small gqa+window+pad", SMALL, 1),
                 ("gpt-neo global, scale 1.0", NEO_GLOBAL, 2))
    for label, shape, seed in k1_shapes:
        log(f" K1 {label}: {shape}")
        for kname, e in parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    for seed, (label, shape) in enumerate(BANDED_SHAPES, start=3):
        log(f" K2 {label}: {shape}")
        for kname, e in banded_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    for seed, (label, shape) in enumerate(CE_SHAPES, start=6):
        log(f" K3 {label}: {shape}")
        for kname, e in ce_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    log(f" K3's backward in 3 chunks of rows (dW summed in float32) at {CE_LLAMA}")
    for kname, e in ce_chunked_parity(CE_LLAMA, 11).items():
        errs[kname] = max(errs[kname], e)
    log(" head: float32 logits from bf16 operands")
    head_parity()
    for seed, (label, shape) in enumerate(FLASH_SHAPES, start=20):
        log(f" K5 {label}: {shape}")
        for kname, e in flash_parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    for seed, (label, shape, variants) in enumerate(BLOCK_SHAPES, start=40):
        log(f" K4 {label}: {shape}")
        for kname, e in block_parity(shape, seed, variants).items():
            errs[kname] = max(errs.get(kname, 0.0), e)
    log(" K3's bars (softmax-alone Llama-125M head; the chunked backward), K5's bars "
        "(small GQA shape with pads) and K4's (the small float32 case with ties and the "
        "small bf16 case) against planted faults")
    planted_faults()

    log("== 4 timing (CUDA events)")
    log(f" K1 at the Llama flagship shape {FLAGSHIP}")
    times, backward = timing(FLAGSHIP)
    log(f" K2 at the GPT-Neo local shape {NEO_LOCAL}, scale 1.0")
    banded_times, banded_backward = banded_timing(NEO_LOCAL)
    times.update(banded_times)
    log(f" K3 at the main path's head {CE_MAIN}")
    ce_times, ce_backward, ce_errs = ce_timing(CE_MAIN, BATCH, SEQ)
    log(f" K3 at the long-context paths' head {CE_LONG}")
    long_times, long_backward, long_errs = ce_timing(CE_LONG, 1, CE_LONG["seq"])
    for kname, r in ce_times.items():
        times[kname] = {**r, "long_head": long_times[kname]}
    for kname in ce_errs:
        errs[kname] = max(errs[kname], ce_errs[kname], long_errs[kname])
    log(f" K5 at the Llama flagship shape {FLASH_FLAGSHIP}, beside K1 (above)")
    flash_flagship, flash_flagship_bwd = flash_timing(FLASH_FLAGSHIP)
    for k5, k1 in zip(_K5, _K1):
        log(f"  {k5:15s} K5 {flash_flagship[k5]['ms']:.4f} ms  K1 {times[k1]['ms']:.4f} ms")
    log(f"  backward total  K5 {flash_flagship_bwd['ms']:.4f} ms  K1 {backward['ms']:.4f} ms")
    log(f" K5 at the long-context main path's shape {FLASH_LLAMA3}")
    flash_times, flash_backward = flash_timing(FLASH_LLAMA3)
    for kname, r in flash_times.items():
        times[kname] = {**r, "flagship": flash_flagship[kname]}
    # K4: the JSON entry of each kernel is its time at the Llama ring
    # path's shape (b) (the backward kernels: on the full block), or for
    # the positional forward at GPT-Neo's (c) with window 256; every
    # shape and variant measured stands beside it under "by_shape"
    block_times = {}
    for tag, shape, variants in (("a", BLOCK_350M, ("full", "diag")),
                                 ("b", BLOCK_LLAMA3, ("full", "diag")),
                                 ("c", BLOCK_NEO, (f"hop sp2 w{NEO_WINDOW}",))):
        log(f" K4 at ({tag}) {shape}")
        for key, r in block_timing(shape, variants, 50).items():
            block_times[f"{key} ({tag})"] = r
    pos = f"hop sp2 w{NEO_WINDOW}"
    for kname, key, variants in (
        ("blk_fwd_full", "blk_fwd/full (b)", ("full",)),
        ("blk_fwd_diag", "blk_fwd/diag (b)", ("diag",)),
        ("blk_fwd_pos", f"blk_fwd/{pos} (c)", (pos,)),
        ("blk_bwd_rowc", "blk_bwd_rowc/full (b)", ("full", "diag", pos)),
        ("blk_bwd_dkdv", "blk_bwd_dkdv/full (b)", ("full", "diag", pos)),
        ("blk_bwd_dq", "blk_bwd_dq/full (b)", ("full", "diag", pos)),
    ):
        family = key.split("/")[0]
        times[kname] = {**block_times[key], "by_shape": {
            k: {x: r[x] for x in ("ms", "plain_ms", "bound_ms", "sdpa_ms", "sdpa_bwd_ms") if x in r}
            for k, r in block_times.items()
            if k.split("/")[0] == family and k.split("/")[1].rsplit(" (", 1)[0] in variants}}

    launches, round_ms, peaks, summaries = {}, {}, {}, {}
    for step, path in enumerate(MAIN_PATHS, start=1):
        log(f"== 5.{step} main path {path}: {' '.join(main_args(path))}")
        launches[path], round_ms[path], peaks[path], summaries[path] = main_path(path)
    # the ring paths: context parallelism on a one-rank NCCL sequence
    # group, made only now (the paths above run with no process group)
    with one_rank_group() as sg:
        for step, path in enumerate(RING_PATHS, start=len(MAIN_PATHS) + 1):
            base = RING_PATHS[path]["base"]
            log(f"== 5.{step} ring path {path}: {' '.join(main_args(base))}, the model on the ring, "
                f"a one-rank NCCL sequence group handed in")
            launches[path], round_ms[path], peaks[path], summaries[path] = main_path(path, sg)
            ring_loss_vs(summaries[path], summaries[base], base)
        log(" gpt-neo-125M: one forward and backward, the windowed ring (K4) against the non-CP "
            "path (K1 + K2), K3 on both")
        neo_ring_step_agreement(sg)
        log(f"  peak memory by path: { {p: f'{b / 2**30:.2f} GiB' for p, b in peaks.items()} }")
        log("== 6 small input: the kernel path agrees with the plain path (float32)")
        log(" tiny128 (K1), L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            ("attn_fwd", "attn_bwd_dkdv", "attn_bwd_dq"),
        )
        log(" gpt-neo-125M (K1 and K2), L 512")
        small_input_agreement(
            ["train=acco", "model=gptneo", "data=synthetic", "train.max_length=512",
             "train.batch_size=2"],
            ("attn_fwd", "attn_bwd_dkdv", "attn_bwd_dq", "banded_fwd", "banded_bwd_dq",
             "banded_bwd_dkdv"),
        )
        log(" tiny128, fused_loss=pallas (K3) vs the materialized CE, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            _K3_F32, runs=CE_RUNS, plain_silent=_K3,
        )
        log(" gpt-neo-125M, fused_loss=pallas (K1, K2 and K3) vs the materialized CE, L 512")
        small_input_agreement(
            ["train=acco", "model=gptneo", "data=synthetic", "train.max_length=512",
             "train.batch_size=2"],
            ("attn_fwd", "banded_fwd", *_K3_F32), runs=CE_RUNS, plain_silent=_K3,
        )
        log(" tiny128, use_pallas_attention=true (K5) vs the plain attention, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            _K5, runs=FLASH_RUNS,
        )
        log(" tiny128 on the one-rank ring (K4) vs the plain attention, L 128")
        small_input_agreement(
            ["train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
             "train.batch_size=4"],
            ("blk_fwd_diag", "blk_fwd_full", "blk_bwd_rowc", "blk_bwd_dkdv", "blk_bwd_dq"),
            runs=RING_RUNS, sg=sg,
        )
        log("== 7 where the device time goes (profiled reruns of the main paths)")
        for model in MAIN_PATHS:
            profile_main_path(model, round_ms[model])
        for model in RING_PATHS:
            profile_main_path(model, round_ms[model], sg=sg)

        # launches: each kernel's count on its own slice's main path (K1: the
        # Llama path, K2: the GPT-Neo path, K3: the fused-CE path, K5: the
        # long-context path), and on every path. K5's times are at the
        # long-context path's shape, with the flagship shape's beside them.
        kernels = [
            {
                "name": kname,
                "route": "cuda",
                "source": "acco_tpu_torch/csrc/" + SOURCE[kname],
                "replaces": REPLACES[kname],
                "launches": launches[OWN_PATH[kname]][kname],
                "launches_by_path": {m: launches[m][kname] for m in launches},
                "max_abs_err": errs[kname],
                **times[kname],
            }
            for kname in times
        ]
        log(f"K1 backward total (delta + dK/dV + dQ): {json.dumps(backward)}")
        log(f"K2 backward total (delta + dQ + dK/dV): {json.dumps(banded_backward)}")
        log(f"K3 backward total (dp + dH + dW) and the whole loss, Llama-125M head: "
            f"{json.dumps(ce_backward)}; long-context head: {json.dumps(long_backward)}")
        log(f"K5 backward total (delta + dK/dV + dQ), L 8192: {json.dumps(flash_backward)}; "
            f"flagship: {json.dumps(flash_flagship_bwd)}")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": count}}), flush=True)
        return 0


if __name__ == "__main__":
    sys.exit(main())
