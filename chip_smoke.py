#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acco_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name, the device count, nvidia-smi's name and
   power limit;
2. build: compiles csrc/fused_attention.cu for sm_90a from the checkout
   (into build/) and prints nvcc/ptxas's report;
3. parity: each of the four attention kernels against its plain PyTorch
   version on the same inputs on the card, bf16, at the flagship shape
   (B 8, H = Hkv 12, L 1024, D 64, window 0, no pad) and at a small GQA
   shape with window 256 and a key pad mask;
4. timing: CUDA events over many launches after a warm-up, for each
   kernel, its plain version and, where one PyTorch call computes the
   same function, that call (F.scaled_dot_product_attention);
5. main path: ``python -m acco_tpu_torch train=acco model=llama-125M
   data=synthetic`` in-process at full width (12 layers, d 768, seq 1024,
   batch 8, n_acc 1): the seed round and 6 rounds, with the kernels'
   launch counts read from this run alone;
6. agreement: the entry point on a small float32 input through the
   kernels and through the plain attention gives the same losses and
   gradients;
7. profile: the main path again under torch.profiler, for the device
   time per kernel and the device's idle share.

The last lines are the kernels JSON line, nvidia-smi's line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(B=8, H=12, Hkv=12, L=1024, D=64, window=0, pad=False)
SMALL = dict(B=2, H=4, Hkv=2, L=512, D=64, window=256, pad=True)
# main path: Llama-125M (config/model/llama-125M.json) at full width
MAIN_ROUNDS = 6  # after the seed round
LAYERS, D_MODEL, SEQ, BATCH = 12, 768, 1024, 8
MAIN_ARGS = [
    "train=acco", "model=llama-125M", "data=synthetic",
    f"train.batch_size={BATCH}", f"train.max_length={SEQ}",
    "train.n_grad_accumulation=1", f"train.nb_steps_tot={MAIN_ROUNDS}",
]

# Tolerances on the card, bf16 (kernel vs its plain version, same inputs):
# outputs are rounded to bf16 (relative step 2^-8) and summed in another
# order; the plain forward also rounds P to bf16 before PV where the
# online-softmax kernel keeps it in f32. Each check is
# |kernel - plain| <= atol + rtol * |plain|.
TOL = {
    "o": (1e-2, 2e-2),
    "lse": (1e-3, 1e-4),  # float32 in both; only the summation order differs
    "delta": (1e-3, 1e-4),  # float32 dot products of identical bf16 inputs
    "dq": (1e-2, 2e-2),
    "dk": (1e-2, 2e-2),
    "dv": (1e-2, 2e-2),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check(name: str, got, want) -> float:
    import torch

    atol, rtol = TOL[name]
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


def make_inputs(shape: dict, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, Hkv, L, D = (shape[k] for k in ("B", "H", "Hkv", "L", "D"))

    def randn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = randn(B, H, L, D), randn(B, Hkv, L, D), randn(B, Hkv, L, D)
    dout = randn(B, H, L, D)
    pad = None
    if shape["pad"]:
        # right padding, as the loader pads: no query row is left without
        # an allowed key, so every row is compared
        pad = torch.ones(B, L, dtype=torch.int32, device="cuda")
        pad[-1, L - L // 5:] = 0
    return q, k, v, dout, pad


def parity(shape: dict, seed: int) -> dict:
    """Every kernel against its plain version; returns max errors."""
    import torch

    from acco_tpu_torch.ops import fused_attention as fa

    q, k, v, dout, pad = make_inputs(shape, seed)
    window, scale = shape["window"], shape["D"] ** -0.5
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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call: CUDA events around ``iters`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device ms per call: the CUDA kernels' own time under
    torch.profiler, for calls whose host cost (autograd) can exceed their
    device time and so would leak into an event-timed loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / 1e3 / iters


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


def main_path() -> tuple[dict, float]:
    """The port's entry point, in-process, at Llama-125M's full width;
    returns each kernel's launch count in this run and the median round
    ms."""
    import torch

    from acco_tpu_torch.__main__ import main as entry
    from acco_tpu_torch.ops import fused_attention as fa

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    summary = entry(MAIN_ARGS)
    launches = dict(fa.LAUNCHES)
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
    for name, n in launches.items():
        if n != LAYERS * microbatches:
            raise AssertionError(
                f"{name}: {n} launches, expected {LAYERS} per microbatch "
                f"x {microbatches} microbatches"
            )
    round_ms = [r["ms"] for r in rounds]
    med = statistics.median(round_ms)
    tokens = BATCH * SEQ
    log(f"  losses {['%.4f' % x for x in losses]}")
    log(f"  is_real_update {real}")
    log(f"  round ms {['%.1f' % x for x in round_ms]}  median {med:.2f}")
    tok_s = tokens / (med / 1e3)
    # model FLOPs per token: 6 N for the matmuls (the tied head counted
    # once) + 6 layers L D for causal attention, forward and backward
    flops_per_token = 6 * summary["n_params"] + 6 * LAYERS * SEQ * D_MODEL
    log(f"  tokens/s {tok_s:.1f}  MFU {flops_per_token * tok_s / PEAK_BF16_FLOPS:.4f} "
        f"(vs {PEAK_BF16_FLOPS:.3g} FLOP/s bf16)")
    log(f"  max_memory_allocated {peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"  launches {launches}")
    return launches, med


def small_input_agreement() -> None:
    """The entry point twice on a small input (tiny128, float32, 4 ACCO
    rounds), once through the kernels and once through the plain
    attention: the losses and the last staged gradients must agree."""
    import torch

    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for attention in ("fused", "xla"):
        fa.reset_launch_counts()
        trainer = build_trainer([
            "train=acco", "model=tiny128", "data=synthetic", "train.max_length=128",
            "train.batch_size=4", "train.nb_steps_tot=4",
            "train.use_mixed_precision=false", f"train.use_pallas_attention={attention}",
        ])
        summary = trainer.train()
        runs[attention] = (summary, trainer.final_state, dict(fa.LAUNCHES))
    (s_k, st_k, n_k), (s_p, st_p, n_p) = runs["fused"], runs["xla"]
    if n_k["attn_fwd"] == 0 or n_p["attn_fwd"] != 0:
        raise AssertionError(f"kernel launches: fused run {n_k}, plain run {n_p}")
    losses_k = [s_k["seed_loss"]] + [r["loss"] for r in s_k["round_log"]]
    losses_p = [s_p["seed_loss"]] + [r["loss"] for r in s_p["round_log"]]
    g_k, g_p = st_k.pending_grads, st_p.pending_grads
    err = float((g_k - g_p).abs().max())
    # float32 on both sides; only the summation order differs
    tol = 1e-4 * float(g_p.abs().max())
    log(f"  losses kernel {['%.6f' % x for x in losses_k]}")
    log(f"  losses plain  {['%.6f' % x for x in losses_p]}")
    log(f"  staged grads max abs diff {err:.3e} (tol {tol:.3e} = 1e-4 * max|g|)")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(losses_k, losses_p)) or err > tol:
        raise AssertionError("kernel and plain training runs disagree")


def profile_main_path(round_ms: float, top: int = 12) -> None:
    """Where the device time of the main path goes: the same run again,
    under torch.profiler (after the measured run, so the profiler's own
    cost touches no reported time). Prints device ms per microbatch for
    the top kernels, and the device's idle share of a round: 1 - device
    ms per microbatch / the measured run's median round ms (n_acc 1). The
    profiled run's own wall time includes the profiler's host cost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from acco_tpu_torch.__main__ import build_trainer

    trainer = build_trainer(MAIN_ARGS)
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
    log(f"  device busy {per_mb:.2f} ms per microbatch (init + seed + {MAIN_ROUNDS} rounds: "
        f"{busy_ms:.1f} ms in {wall_ms:.1f} ms of profiled wall time); idle share of a "
        f"{round_ms:.2f} ms round {1 - per_mb / round_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3 / microbatches:9.3f} ms/microbatch "
            f"x{e.count // microbatches:<4d} {e.key[:90]}")


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
    from acco_tpu_torch.utils import cuda_build

    log("== 1 device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"  {name}  count {count}  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}")

    log("== 2 build")
    t0 = time.perf_counter()
    cuda_build.build("fused_attention")
    info = cuda_build.BUILD_INFO["fused_attention"]
    log(f"  fused_attention built in {time.perf_counter() - t0:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    log("== 3 parity (bf16, kernel vs plain on the same inputs)")
    errs = {}
    for label, shape, seed in (("flagship", FLAGSHIP, 0), ("small gqa+window+pad", SMALL, 1)):
        log(f" {label}: {shape}")
        for kname, e in parity(shape, seed).items():
            errs[kname] = max(errs.get(kname, 0.0), e)

    log("== 4 timing (flagship shape, CUDA events)")
    times, backward = timing(FLAGSHIP)

    log("== 5 main path: train=acco model=llama-125M data=synthetic")
    launches, round_ms = main_path()
    log("== 6 small input: the kernel path agrees with the plain path (float32)")
    small_input_agreement()
    log("== 7 where the device time goes (profiled rerun of the main path)")
    profile_main_path(round_ms)

    sources = {
        "attn_fwd": "acco_tpu/ops/fused_attention.py:197",
        "attn_bwd_delta": "acco_tpu/ops/fused_attention.py:243",
        "attn_bwd_dkdv": "acco_tpu/ops/fused_attention.py:243",
        "attn_bwd_dq": "acco_tpu/ops/fused_attention.py:243",
    }
    kernels = [
        {
            "name": kname,
            "route": "cuda",
            "source": "acco_tpu_torch/csrc/fused_attention.cu",
            "replaces": sources[kname],
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            **times[kname],
        }
        for kname in times
    ]
    log(f"backward total (delta + dK/dV + dQ): {json.dumps(backward)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
