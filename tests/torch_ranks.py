"""Run a script on several gloo ranks for the port's distributed tests.

Each rank is its own Python process (``python -c <script> <rank> <world
size> <store> <workdir>``) that imports torch and the port, never JAX. The
script initialises its process group through a ``file://`` store in the
test's temporary directory (no fixed port: the suite runs under
pytest-xdist), does its work, and writes its results into the work
directory. :func:`run_ranks` joins the processes under a timeout and
fails, with their output, if one hangs or exits non-zero.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
RANK, WS, STORE, WORKDIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK, world_size=WS)
"""


@pytest.fixture(autouse=True)
def torch_settings(monkeypatch):
    """One intra-op thread for the test (the suite runs several workers on
    a few cores), and every global torch setting a test may change (the
    thread count, the default dtype, the TF32 flags, the deterministic
    flag) and ``PYTORCH_CUDA_ALLOC_CONF``, which the entry point fills
    in, as they were after it. A test module takes it by importing it."""
    import torch

    saved = (torch.get_num_threads(), torch.get_default_dtype(),
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved[0])
    torch.set_default_dtype(saved[1])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[2:4]
    if torch.are_deterministic_algorithms_enabled() != saved[4]:  # its first call takes ~2 s
        torch.use_deterministic_algorithms(saved[4])


def run_ranks(script: str, ws: int, workdir, timeout: float = 120.0) -> None:
    """Run ``script`` (after :data:`PRELUDE`) on ``ws`` ranks; raise with
    the ranks' output if any fails or the group does not finish within
    ``timeout`` seconds."""
    workdir = str(workdir)
    store = os.path.join(workdir, "store")
    # the barrier: a rank that tears gloo down while another is still in a
    # collective of one of several groups can abort at exit
    code = (PRELUDE.format(repo=REPO) + script
            + "\ndist.barrier()\ndist.destroy_process_group()\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(ws), store, workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(ws)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {ws} ranks did not finish within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise AssertionError("\n".join(
            f"rank {r} exited {rc}:\n{out[-3000:]}" for r, rc, out in failed))


# Training on ranks: one rank of a {dp, sp} world runs the port's ACCO/DPU
# rounds or DDP steps on its slice of seeded global blocks and saves what
# it saw. ``spec.json``: family ('llama' | 'gpt_neo'), arch, dp, sp,
# zigzag, method ('acco' | 'dpu' | 'ddp'), sched, opt, rounds, batch (the
# rank's batch), lr_grad_accounting. ``flat.npy``: the initial [n_params]
# parameters. ``blocks.npz``: global blocks ``{i}/{input_ids, ...}`` of
# [n_acc, dp * batch, seq] and ``{i}/valid`` [n_acc, dp]. The rank takes
# its dp index's rows and valid column, then (sp > 1) its sequence chunk.
# Saves ``out{RANK}.npz``: per round the loss, LR, is_real_update, the
# count consumed, the working params and this rank's optimizer shard.
TRAIN_WORKER = """
import json
import numpy as np
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy, prep_cp_leaves
from acco_tpu_torch.parallel.ddp import DDPTrainStep
from acco_tpu_torch.parallel.mesh import RankGroups

spec = json.load(open(os.path.join(WORKDIR, "spec.json")))
groups, sg = RankGroups.build(spec["dp"], spec["sp"], RANK)
kw = dict(attention="ring", sequence_group=sg, zigzag=spec["zigzag"]) if sg else {}
if spec["family"] == "llama":
    model = LlamaModel(LlamaConfig(**spec["arch"]), dtype=torch.float32, **kw)
else:
    arch = dict(spec["arch"], attention_layers=tuple(spec["arch"]["attention_layers"]))
    model = GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, **kw)
common = dict(const_len_batch=True, sequence_group=sg, groups=groups,
              lr_grad_accounting=spec["lr_grad_accounting"], **spec["opt"])
if spec["method"] == "ddp":
    step = DDPTrainStep(model, get_schedule(*spec["sched"]), **common)
else:
    step = AccoTrainStep(model, get_schedule(*spec["sched"]), mode=spec["method"], **common)
state = step.init_state(torch.tensor(np.load(os.path.join(WORKDIR, "flat.npy"))))
data = np.load(os.path.join(WORKDIR, "blocks.npz"))
rows = slice(groups.dp_index * spec["batch"], (groups.dp_index + 1) * spec["batch"])

def block(i):
    raw = {k: data[f"{i}/{k}"][:, rows] for k in ("input_ids", "attention_mask", "labels")}
    raw["valid"] = data[f"{i}/valid"][:, groups.dp_index]
    return prep_cp_leaves(block_from_numpy(raw, "cpu"), sg, spec["zigzag"])

out = {k: [] for k in ("losses", "lrs", "real", "round_grads", "flats", "opt_params", "mu",
                       "nu", "sched", "committed")}

def record(state):
    out["flats"].append(state.flat_params.numpy().copy())
    for name in ("params", "mu", "nu"):
        out["opt_params" if name == "params" else name].append(
            getattr(state.zero1.opt, name).numpy().copy())
    out["sched"].append(int(state.zero1.sched_grads))
    out["committed"].append(float(state.zero1.grads_committed))

if spec["method"] == "ddp":
    record(state)
    for r in range(spec["rounds"]):
        state, m = step.step(state, block(r))
        out["losses"].append(float(m.loss))
        out["lrs"].append(float(m.lr))
        out["real"].append(not bool(m.skipped))
        out["round_grads"].append(float(m.grads_this_step))
        record(state)
else:
    state, loss = step.seed(state, block(0))
    out["losses"].append(float(loss))
    record(state)
    for r in range(spec["rounds"]):
        state, m = step.round(state, block(r + 1), parity=r % 2 == 0)
        out["losses"].append(float(m.loss))
        out["lrs"].append(float(m.lr))
        out["real"].append(bool(m.is_real_update))
        out["round_grads"].append(float(m.round_grads))
        record(state)
np.savez(os.path.join(WORKDIR, f"out{RANK}.npz"), **{k: np.array(v) for k, v in out.items()})
"""


def run_training(spec: dict, flat, blocks: list, workdir, timeout: float = 120.0) -> list:
    """:data:`TRAIN_WORKER` on ``spec['dp'] * spec['sp']`` ranks; returns
    each rank's saved arrays."""
    import json

    import numpy as np

    np.save(os.path.join(str(workdir), "flat.npy"), np.asarray(flat))
    np.savez(os.path.join(str(workdir), "blocks.npz"),
             **{f"{i}/{k}": v for i, b in enumerate(blocks) for k, v in b.items()})
    with open(os.path.join(str(workdir), "spec.json"), "w") as f:
        json.dump(spec, f)
    ws = spec["dp"] * spec["sp"]
    run_ranks(TRAIN_WORKER, ws, workdir, timeout=timeout)
    return [dict(np.load(os.path.join(str(workdir), f"out{r}.npz"))) for r in range(ws)]
