"""Run a script on several gloo ranks for the port's distributed tests.

Each rank is its own Python process that runs ``<script>`` with
``sys.argv`` ``[<rank>, <world size>, <store>, <workdir>]`` and imports
torch and the port, never JAX. The processes are forked from a
multiprocessing fork server that imported torch once (per test worker),
not started afresh: a fresh interpreter spends ~3.6 s importing torch,
and the distributed tests start ~70 ranks. The script initialises its
process group through a ``file://`` store in the test's temporary
directory (no fixed port: the suite runs under pytest-xdist), does its
work, and writes its results into the work directory. :func:`run_ranks`
joins the processes under a timeout and fails, with their output, if
one hangs or exits non-zero.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

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


_CONTEXT = None


def _fork_server():
    """The fork server's context (made once a process): its server imports
    torch, torch.distributed, torch._dynamo and numpy before it forks any
    rank."""
    global _CONTEXT
    if _CONTEXT is None:
        import multiprocessing

        ctx = multiprocessing.get_context("forkserver")
        # torch._dynamo: torch.utils.checkpoint imports it at its first call
        # (~5 s with sympy), which every pipeline rank would pay again
        ctx.set_forkserver_preload(["torch", "torch.distributed", "torch._dynamo", "numpy",
                                    "torch_ranks"])
        _CONTEXT = ctx
    return _CONTEXT


def _rank_main(code: str, argv: list, log: str, env: dict) -> None:
    """One rank, in a process forked from the server: the test's
    environment, ``sys.argv``, stdout and stderr into ``log``, then the
    script as ``__main__``; exits 1 with the traceback logged if it
    raises."""
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    sys.stdout = sys.stderr = os.fdopen(1, "w", buffering=1)
    os.environ.clear()
    os.environ.update(env)
    sys.argv = ["-c", *argv]
    status = 0
    try:
        exec(compile(code, "<rank script>", "exec"), {"__name__": "__main__"})
    except SystemExit as exc:
        status = exc.code if isinstance(exc.code, int) else 1
    except BaseException:  # noqa: BLE001 — reported through the log and the exit code
        traceback.print_exc()
        status = 1
    sys.stdout.flush()
    os._exit(status)


class Ranks:
    """``ws`` rank processes running a script; :meth:`join` waits for
    them (the timeout counts from their start) and raises with their
    output if any fails or hangs. Started first, they run while the test
    computes its reference in-process."""

    def __init__(self, script: str, ws: int, workdir, timeout: float = 120.0) -> None:
        workdir = str(workdir)
        store = os.path.join(workdir, "store")
        # the barrier: a rank that tears gloo down while another is still in
        # a collective of one of several groups can abort at exit
        code = (PRELUDE.format(repo=REPO) + script
                + "\ndist.barrier()\ndist.destroy_process_group()\n")
        env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        self.ws, self.timeout = ws, timeout
        self.logs = [os.path.join(workdir, f"rank{r}.log") for r in range(ws)]
        ctx = _fork_server()
        self.procs = [
            ctx.Process(target=_rank_main, name=f"rank{r}",
                        args=(code, [str(r), str(ws), store, workdir], self.logs[r], env))
            for r in range(ws)
        ]
        for p in self.procs:
            p.start()
        # after the starts: a worker's first start waits for the fork server's imports
        self.deadline = time.monotonic() + timeout

    def join(self) -> None:
        try:
            for p in self.procs:
                p.join(timeout=max(0.0, self.deadline - time.monotonic()))
            if any(p.exitcode is None for p in self.procs):
                raise AssertionError(f"the {self.ws} ranks did not finish within {self.timeout} s")
        finally:
            for p in self.procs:
                if p.exitcode is None:
                    p.kill()
                    p.join()
        failed = [(r, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode]
        if failed:
            raise AssertionError("\n".join(
                f"rank {r} exited {rc}:\n{_tail(self.logs[r])}" for r, rc in failed))


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "(no output)"


def run_ranks(script: str, ws: int, workdir, timeout: float = 120.0) -> None:
    """Run ``script`` (after :data:`PRELUDE`) on ``ws`` ranks; raise with
    the ranks' output if any fails or the group does not finish within
    ``timeout`` seconds."""
    Ranks(script, ws, workdir, timeout).join()


# Training on ranks: one rank of a {dp, sp} world runs the port's ACCO/DPU
# rounds or DDP steps on its slice of seeded global blocks and saves what
# it saw. ``spec.json``: family ('llama' | 'gpt_neo'), arch, dp, sp,
# zigzag, method ('acco' | 'dpu' | 'ddp'), sched, opt, rounds, batch (the
# rank's batch), lr_grad_accounting, and optionally tp (a {dp, tp} world,
# dp outer) or pp (a {dp, pp} world, dp outer) with vocab_pad_to,
# fused_loss, and mesh (the {axis: size} mesh in its key order, which
# replaces dp, sp, tp and pp's). ``flat.npy``: the initial [n_params]
# dense parameters (under tp or pp, or both, each rank keeps its model
# index's local vector).
# ``blocks.npz``: global blocks ``{i}/{input_ids, ...}`` of
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
mesh = spec.get("mesh") or {"dp": spec["dp"], "sp": spec["sp"], "tp": spec.get("tp", 1),
                            "pp": spec.get("pp", 1)}
groups, sg = RankGroups.build(mesh, RANK)
kw = dict(attention="ring", sequence_group=sg, zigzag=spec["zigzag"]) if sg else {}
tg, pg = groups.tensor_group(), groups.pipeline_group()
if tg is not None or pg is not None:
    kw.update(tensor_group=tg, pipeline_group=pg, vocab_pad_to=spec.get("vocab_pad_to"),
              model_group=groups.model_group() if tg is not None and pg is not None else None)
if spec["family"] == "llama":
    model = LlamaModel(LlamaConfig(**spec["arch"]), dtype=torch.float32, **kw)
else:
    arch = dict(spec["arch"], attention_layers=tuple(spec["arch"]["attention_layers"]))
    model = GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, **kw)
common = dict(const_len_batch=True, sequence_group=sg, groups=groups,
              lr_grad_accounting=spec["lr_grad_accounting"],
              fused_loss=spec.get("fused_loss", False), **spec["opt"])
if spec["method"] == "ddp":
    step = DDPTrainStep(model, get_schedule(*spec["sched"]), **common)
else:
    step = AccoTrainStep(model, get_schedule(*spec["sched"]), mode=spec["method"], **common)
flat0 = np.load(os.path.join(WORKDIR, "flat.npy"))
if groups.tensor is not None:
    from acco_tpu_torch.models.convert import params_to_jax
    dense = params_to_jax(torch.tensor(flat0), model.config, vocab=model.padded_vocab)
    flat0 = model.tp_layout.stack_flat(dense)[groups.model_index]
state = step.init_state(torch.tensor(flat0))
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


def start_training(spec: dict, flat, blocks: list, workdir, timeout: float = 120.0):
    """:data:`TRAIN_WORKER` started on the mesh's ranks (``spec['dp'] *
    spec['sp']`` x tp x pp); the returned function waits for them and
    returns each rank's saved arrays."""
    import json

    import numpy as np

    np.save(os.path.join(str(workdir), "flat.npy"), np.asarray(flat))
    np.savez(os.path.join(str(workdir), "blocks.npz"),
             **{f"{i}/{k}": v for i, b in enumerate(blocks) for k, v in b.items()})
    with open(os.path.join(str(workdir), "spec.json"), "w") as f:
        json.dump(spec, f)
    ws = 1
    for size in (spec.get("mesh") or {k: spec.get(k, 1) for k in ("dp", "sp", "tp", "pp")}).values():
        ws *= size
    ranks = Ranks(TRAIN_WORKER, ws, workdir, timeout=timeout)

    def join() -> list:
        ranks.join()
        return [dict(np.load(os.path.join(str(workdir), f"out{r}.npz"))) for r in range(ws)]

    return join


def run_training(spec: dict, flat, blocks: list, workdir, timeout: float = 120.0) -> list:
    """:data:`TRAIN_WORKER` on ``spec['dp'] * spec['sp']`` ranks; returns
    each rank's saved arrays."""
    return start_training(spec, flat, blocks, workdir, timeout)()


# The entry point's trainer (``python -m acco_tpu_torch``'s) on forked
# ranks, with the variables torchrun sets: ``argv.json`` holds the command
# line's arguments; rank 0 writes the summary to ``summary.json``.
CLI_WORKER = """
import json
os.environ.update(RANK=str(RANK), WORLD_SIZE=str(WS), LOCAL_RANK=str(RANK))
from acco_tpu_torch.__main__ import build_trainer
summary = build_trainer(json.load(open(os.path.join(WORKDIR, "argv.json")))).train()
if RANK == 0:
    json.dump(summary, open(os.path.join(WORKDIR, "summary.json"), "w"))
"""


def start_cli(argv: list, ws: int, workdir, timeout: float = 120.0):
    """:data:`CLI_WORKER` started on ``ws`` ranks (their default group the
    entry point's: it initialises none of its own) with the command line
    ``argv``; the returned function waits for them and returns rank 0's
    summary. A run resumed this way skips a second launcher's start."""
    import json

    with open(os.path.join(str(workdir), "argv.json"), "w") as f:
        json.dump([str(a) for a in argv], f)
    ranks = Ranks(CLI_WORKER, ws, workdir, timeout=timeout)

    def join() -> dict:
        ranks.join()
        with open(os.path.join(str(workdir), "summary.json")) as f:
            return json.load(f)

    return join

