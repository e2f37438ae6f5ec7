#!/usr/bin/env python3
"""Times variants of the attention kernels K5, K1, K2 and K4 (bf16)
against each other, in turns, in one process on one NVIDIA card.

    python3 kernel_ab.py [--parent DIR]

Timings of one kernel move by up to a quarter between two runs on two
cards, so versions are compared only inside one run. Each variant is a
copy of ``acco_tpu_torch/csrc/`` (or of DIR, another tree's ``csrc/``,
such as the parent commit's unpacked with ``git archive`` into a
git-ignored directory) with text replacements, built with nvcc (the
flags of ``acco_tpu_torch/utils/cuda_build.py``) into
``build/kernel_ab/<variant>/`` and swapped in through the ops modules'
``_library``. Variants:

- ``tree``: the checkout's sources;
- ``parent``: DIR's sources (given ``--parent``);
- ``no_softmax``: the forward without its softmax (P = S), so that only
  its products and its pipeline remain (K5 and K1);
- ``no_exp``: dK/dV and dQ without the exponential of P = exp(s - lse)
  (K5 and K1).

The two ablations give wrong results: they are timings only. Each
variant's forward, dK/dV and dQ are timed with CUDA events (chip_smoke's
``time_ms``) at K5's long-context and flagship shapes, K1's flagship and
Llama-3-8B-width shapes, K2 at GPT-Neo-125M's local layer (D 64) and
GPT-Neo-2.7B's (D 128), and K4 at the ring cell's block (b) (full and
diagonal) and GPT-Neo's positional block (c) (window 256), in two rounds
in opposite orders. Prints one line a shape and, last, the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
HEADER = "hopper_attention.cuh"
VARIANTS = {
    "tree": [],
    "no_softmax": [
        (HEADER, "    softmax(k0, corr);\n    acc_to_frag",
         "    corr[0] = corr[1] = 1.f;\n    acc_to_frag"),
        (HEADER, "      softmax(k0, corr);\n", "      corr[0] = corr[1] = 1.f;\n"),
    ],
    "no_exp": [
        (HEADER, "exp2_approx((st[x] - ls[col]) * kLog2e)", "st[x]"),
        (HEADER, "exp2_approx((sc[x] - lse_r[hh]) * kLog2e)", "sc[x]"),
    ],
}
LIBRARIES = ("flash_attention", "fused_attention", "banded_attention", "block_attention")
ABLATED = ("flash_attention", "fused_attention")  # the libraries the ablations are built for


def build(variants: dict, parent: str | None) -> dict:
    """(variant, library) -> the loaded library, every nvcc started at once."""
    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import block_attention as bl
    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa
    from acco_tpu_torch.utils import cuda_build

    modules = {"flash_attention": fl, "fused_attention": fa, "banded_attention": bd,
               "block_attention": bl}
    root = os.path.join(REPO, "build", "kernel_ab")
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name, patches in variants.items():
        src = parent if name == "parent" else os.path.join(REPO, "acco_tpu_torch", "csrc")
        d = os.path.join(root, name)
        shutil.copytree(src, d)
        for file, old, new in patches:
            path = os.path.join(d, file)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: its patch of {file} no longer applies")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for lib in LIBRARIES if name in ("tree", "parent") else ABLATED:
            out = os.path.join(d, lib + ".so")
            cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", out,
                   os.path.join(d, lib + ".cu")]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        lib = ctypes.CDLL(out)
        for fn, argtypes in modules[key[1]]._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def kernel_runs(mod, shape: dict, variant=None) -> tuple:
    """The forward, dK/dV and dQ of ``mod`` (K5's, K1's, K2's or K4's ops
    module) at ``shape`` (K4: its ``variant``), as three calls; the
    backward's inputs from the forward."""
    import chip_smoke as cs
    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import block_attention as bl
    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    if mod is bl:
        (q, k, v), cot = cs.make_block_inputs(shape, 50)
        scale = shape.get("scale", shape["D"] ** -0.5)
        diag, qp, kp, window = cs.block_variant(shape, variant)
        mode = bl._mode(diag, qp)
        if qp is not None:  # with their spans, made once (a parent's kernel reads the first L)
            qp, kp = bl.positions_with_spans(qp), bl.positions_with_spans(kp)
        o, m, l, cnt = bl.blk_fwd(q, k, v, mode, qp, kp, window, scale)
        do, dm, dl = cs.block_cotangents(cot, l)
        do_t = do.to(q.dtype).contiguous()
        args = (q, k, v, mode, qp, kp, window, scale, do_t, m, dl,
                bl.blk_bwd_rowc(o, do_t, dm, dl, l, cnt))
        return (lambda: bl.blk_fwd(q, k, v, mode, qp, kp, window, scale),
                lambda: bl.blk_bwd_dkdv(*args),
                lambda: bl.blk_bwd_dq(*args))
    if mod is bd:
        q, k, v, dout, _ = cs.make_inputs({**shape, "qk_std": shape["D"] ** -0.25}, 8)
        window = shape["window"]
        o, lse = bd.banded_fwd(q, k, v, window, 1.0)
        bwd = (dout, lse, fa.attn_bwd_delta(o, dout), window, 1.0)
        return (lambda: bd.banded_fwd(q, k, v, window, 1.0),
                lambda: bd.banded_bwd_dkdv(q, k, v, *bwd),
                lambda: bd.banded_bwd_dq(q, k, v, *bwd))
    q, k, v, dout, pad = cs.make_inputs(shape, 9)
    scale = shape["D"] ** -0.5
    if mod is fl:
        o, lse = fl.flash_fwd(q, k, v, pad, scale)
        bwd = (dout, lse, fl.flash_bwd_delta(o, dout), scale)
        return (lambda: fl.flash_fwd(q, k, v, pad, scale),
                lambda: fl.flash_bwd_dkdv(q, k, v, pad, *bwd),
                lambda: fl.flash_bwd_dq(q, k, v, pad, *bwd))
    o, lse = mod.attn_fwd(q, k, v, pad, 0, scale)
    bwd = (dout, lse, mod.attn_bwd_delta(o, dout), 0, scale)
    return (lambda: mod.attn_fwd(q, k, v, pad, 0, scale),
            lambda: mod.attn_bwd_dkdv(q, k, v, pad, *bwd),
            lambda: mod.attn_bwd_dq(q, k, v, pad, *bwd))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="another tree's acco_tpu_torch/csrc/")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from acco_tpu_torch.ops import banded_attention as bd
    from acco_tpu_torch.ops import block_attention as bl
    from acco_tpu_torch.ops import flash_attention as fl
    from acco_tpu_torch.ops import fused_attention as fa

    variants = dict(VARIANTS)
    if args.parent:
        variants = {"parent": [], **variants}
    libs = build(variants, args.parent)
    pos = f"hop sp2 w{cs.NEO_WINDOW}"
    shapes = (("K5 L 8192", fl, cs.FLASH_LLAMA3, None),
              ("K5 flagship", fl, cs.FLASH_FLAGSHIP, None), ("K1 flagship", fa, cs.FLAGSHIP, None),
              ("K1 Llama-3-8B width", fa, cs.K1_LLAMA3, None),
              ("K2 GPT-Neo-125M local", bd, cs.NEO_LOCAL, None),
              ("K2 GPT-Neo-2.7B local, D 128", bd, cs.NEO_LARGE_LOCAL, None),
              ("K4 (b) full", bl, cs.BLOCK_LLAMA3, "full"),
              ("K4 (b) diag", bl, cs.BLOCK_LLAMA3, "diag"),
              ("K4 (c) " + pos, bl, cs.BLOCK_NEO, pos))
    names = {fl: "flash_attention", fa: "fused_attention", bd: "banded_attention",
             bl: "block_attention"}
    for label, mod, shape, variant in shapes:
        lib_name = names[mod]
        built = [name for name in variants if (name, lib_name) in libs]
        times = {}
        for order in (built, built[::-1]):
            for name in order:
                mod._library = lambda lib=libs[(name, lib_name)]: lib
                try:
                    ms = [round(cs.time_ms(fn, iters=10), 4)
                          for fn in kernel_runs(mod, shape, variant)]
                except RuntimeError as exc:  # a parent that does not take the shape
                    ms = str(exc)
                times.setdefault(name, []).append(ms)
        print(f"{label} {shape}: (forward, dK/dV, dQ) ms by variant, two rounds: {times}",
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
