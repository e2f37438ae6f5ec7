"""``python -m acco_tpu_torch.analysis``: the port's static gates.

Counterpart of ``tools/lint.py``. ``--ci`` runs, in order of cost:

1. **host-lint** over ``acco_tpu_torch/``, ``chip_smoke.py`` and the
   port's tests (``tests/test_torch_*.py``, ``tests/torch_ranks.py``);
2. **slow-markers** over the recorded durations of the port's tests
   (``--durations``, default ``outputs/test_durations.json``);
3. **metrics-gate** over ``acco_tpu_torch/`` and ``chip_smoke.py``;
4. the **program gates** over every program of the registry
   (``analysis/programs.py``), built on ``cuda:0`` (``--device cpu``: on
   the CPU): **rules**, **dtypes**, **census** (one round's collectives
   against the comm model: counted at the call sites on the CPU, read
   from the profiler's trace on the card) and **in-place** (the state
   stays in each program's static buffers over its dispatches), and on
   the card **overlap** (a profiled ACCO round's comm stream under its
   compute).

It exits nonzero if any gate fails. Without ``--device cpu`` the program
gates need a card and raise without one; the AST gates need no device.
``--memory --ranks N`` prints the memory sieve of every mesh of N ranks
(``analysis/memory.py``), ``--serve <serve config>`` a serving replica's.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class Gate:
    name: str
    ok: bool
    detail: list = field(default_factory=list)
    note: Optional[str] = None

    def lines(self) -> list:
        head = f"[{'ok ' if self.ok else 'FAIL'}] {self.name}" + (
            f" — {self.note}" if self.note else "")
        return [head] + [f"       {line}" for line in self.detail]


def lint_targets(repo: str = REPO) -> list:
    """What the AST gates walk: the package, ``chip_smoke.py`` and the
    port's tests."""
    return [os.path.join(repo, "acco_tpu_torch"), os.path.join(repo, "chip_smoke.py"),
            *sorted(glob.glob(os.path.join(repo, "tests", "test_torch_*.py"))),
            os.path.join(repo, "tests", "torch_ranks.py")]


def gate_host_lint(repo: str = REPO) -> Gate:
    from acco_tpu_torch.analysis.host_lint import lint_paths

    findings = lint_paths([p for p in lint_targets(repo) if os.path.exists(p)])
    return Gate("host-lint", not findings, [str(f) for f in findings],
                f"{len(findings)} findings" if findings else "clean")


def gate_slow_markers(path: str) -> Gate:
    from acco_tpu_torch.analysis.slow_markers import audit_recorded

    rep = audit_recorded(path)
    return Gate("slow-markers", rep.ok, rep.violations, rep.summary())


def gate_metrics(repo: str = REPO) -> Gate:
    from acco_tpu_torch.analysis.metrics_gate import check_paths

    rep = check_paths([os.path.join(repo, "acco_tpu_torch"), os.path.join(repo, "chip_smoke.py")])
    return Gate("metrics-gate", rep.ok, [str(f) for f in rep.findings], rep.summary())


def round_collectives(program) -> tuple:
    """``(collectives, how, result)`` of one round of ``program`` (its
    eager round, whose ``result`` names the leaves it wrote in place; an
    eval or serve program's dispatch): on the CPU counted at the call
    sites; on a card read from a ``torch.profiler`` trace of the round,
    which must show every call the recorder saw (else ValueError: the
    trace cannot be read)."""
    import torch

    from acco_tpu_torch.analysis.trace import (
        CollectiveRecorder,
        collectives_from_trace,
        dtype_bytes,
        nccl_kernels,
    )
    from acco_tpu_torch.telemetry.profile import load_events

    fn = program.eager_round or program.dispatch
    if program.device.type != "cuda":
        with CollectiveRecorder() as rec:
            result = fn()
        return rec.calls, "counted at the call sites", result
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with CollectiveRecorder() as rec, torch.profiler.profile(activities=acts) as prof:
        result = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = load_events(path)
    traced = collectives_from_trace(events)

    def key(c):
        return c.kind, c.elems, dtype_bytes(c.dtype), c.group_size

    if sorted(map(key, traced)) != sorted(map(key, rec.calls)):
        raise ValueError(f"{program.name}: the trace shows {[key(c) for c in traced]}, the call "
                         f"sites issued {[key(c) for c in rec.calls]}")
    return traced, f"from the trace, {nccl_kernels(events)} NCCL kernels seen", result


def program_gates(programs) -> list:
    """rules, dtypes, census and in-place over each program."""
    from acco_tpu_torch.analysis.census import check_census
    from acco_tpu_torch.analysis.donation import check_in_place
    from acco_tpu_torch.analysis.dtypes import check_dtype_policy
    from acco_tpu_torch.analysis.programs import TINY_SMALL_ELEMS
    from acco_tpu_torch.analysis.rules import check_rule_coverage

    gates = []
    for p in programs:
        rules = check_rule_coverage(p.state_tree, p.rule_table)
        dt = check_dtype_policy(p.state_tree, p.dtype_rules)
        eager = None
        try:
            calls, how, result = round_collectives(p)
            cen = check_census(calls, p.expect_comm_bytes, p.expect_comm_ops,
                               small_elems=TINY_SMALL_ELEMS)
            census_ok, census = cen.ok, f"{cen.summary()} ({how})"
            if p.eager_round is not None:
                eager = (f"eager round: {len(result['in_place'])} leaves in place, new: "
                         f"{', '.join(result['new']) or 'none'}")
        except ValueError as exc:
            census_ok, census = False, str(exc)
        n = 4 if p.name == "acco_rounds" else 2  # ACCO's cycle: 2 parities x 2 phases
        inp = check_in_place(p.name, p.dispatch, p.buffers, n=n, device=p.device)
        detail = [f"rules:    {rules.summary()}", f"dtypes:   {dt.summary()}",
                  f"census:   {census}", f"in-place: {inp.summary()}"]
        if eager is not None:  # reported, not gated: the eager path allocates by design
            detail.append(f"          {eager}")
        if not dt.ok:
            detail += [f"  {v.message}" for v in dt.violations]
        gates.append(Gate(f"program:{p.name}", rules.ok and dt.ok and census_ok and inp.ok,
                          detail))
    return gates


OVERLAP_MODEL = "llama-125M"  # config/model/<name>.yaml
OVERLAP_BLOCK = dict(batch=4, seq=512)


def overlap_gate(device, model_name: str = OVERLAP_MODEL) -> Gate:
    """The overlap verdict on four profiled ACCO rounds on the card, as the
    trainer runs them: over ``RoundPrograms`` (captured, with the branch
    probes ``profile_steps`` adds, so the reader names each replay's
    compute and comm branches), of ``model_name`` in bf16 with zero
    weights: a model whose compute is long enough to hide the comm
    branch (the tiny one's kernels are shorter than their launches)."""
    import torch

    from acco_tpu_torch.analysis.overlap import check_overlap
    from acco_tpu_torch.analysis.programs import _train_step, tiny_block
    from acco_tpu_torch.compile.graphs import RoundPrograms
    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.telemetry.profile import load_events

    cfg = load_yaml(os.path.join(REPO, "config", "model", model_name + ".yaml"))
    model = build_model(cfg, repo_root=REPO, dtype=torch.bfloat16, attention="xla",
                        device=device)
    step = _train_step("acco", model, None)
    state = step.init_state(torch.zeros(model.n_params, device=device))
    block = tiny_block(device, vocab=model.config.vocab_size, **OVERLAP_BLOCK)
    programs = RoundPrograms(step, state, tuple(tuple(t.shape) for t in block), capture=True,
                             probe=True)
    programs.prepare(True)
    parity = [True]

    def rounds(n: int) -> None:
        for _ in range(n):
            programs.run(block, parity[0])
            parity[0] = not parity[0]

    rounds(2)  # the first replays out of the trace
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        rounds(4)
        torch.cuda.synchronize()
    programs.release()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        rep = check_overlap(load_events(path))
    return Gate("overlap", rep.ok, rep.details, rep.summary())


@contextlib.contextmanager
def one_rank_group(backend: str):
    """A one-rank default process group (a ``FileStore`` in a temporary
    dir), destroyed after, unless the process has one: the train programs
    issue their reduce-scatter and all-gather on it."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield dist.group.WORLD
        return
    if backend == "nccl":
        import torch

        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def run_ci(device: str = "cuda", durations: Optional[str] = None, out=print,
           repo: str = REPO) -> int:
    """Every gate (the module's doc); the AST gates over ``repo``'s files."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the program gates run on cuda:0 and no card is present; pass "
                           "--device cpu to run them on the CPU")
    gates = [gate_host_lint(repo),
             gate_slow_markers(durations or os.path.join(repo, "outputs", "test_durations.json")),
             gate_metrics(repo)]
    from acco_tpu_torch.analysis.programs import build_all_tiny

    t0 = time.perf_counter()
    with one_rank_group("gloo" if device == "cpu" else "nccl") as group:
        programs = build_all_tiny(device, group)
        out(f"# built {len(programs)} programs on {device} in {time.perf_counter() - t0:.1f} s")
        gates += program_gates(programs)
    if device != "cpu":
        gates.append(overlap_gate(torch.device(device)))
    for g in gates:
        for line in g.lines():
            out(line)
    bad = [g for g in gates if not g.ok]
    out(f"\n{len(gates) - len(bad)}/{len(gates)} gates passed"
        + (f" — {len(bad)} FAILED" if bad else ""))
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m acco_tpu_torch.analysis",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ci", action="store_true", help="every gate; nonzero exit on a failure")
    ap.add_argument("--device", default="cuda", help="where the program gates run (cuda, cpu)")
    ap.add_argument("--durations", default=None,
                    help="the recorded test durations (default outputs/test_durations.json)")
    ap.add_argument("--repo", default=REPO, help="the checkout the AST gates walk")
    ap.add_argument("--memory", action="store_true", help="the memory sieve of --ranks ranks")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--mode", default="acco", choices=("acco", "dpu", "ddp"))
    ap.add_argument("--hbm-gb", type=float, default=80.0, help="memory per rank (H100: 80)")
    ap.add_argument("--serve", default=None, help="a serve config to price, e.g. "
                    "config/serve/llama3-8b.yaml")
    args = ap.parse_args(argv)
    if not (args.ci or args.memory or args.serve):
        ap.error("pick one: --ci, --memory or --serve")
    rc = 0
    if args.memory:
        from acco_tpu_torch.analysis.memory import sweep_report

        sweep_report(args.ranks, args.hbm_gb, args.mode)
    if args.serve:
        from acco_tpu_torch.analysis.memory import serve_report

        serve_report(args.serve, args.hbm_gb)
    if args.ci:
        rc = run_ci(args.device, args.durations, repo=args.repo)
    return rc


if __name__ == "__main__":
    sys.exit(main())
