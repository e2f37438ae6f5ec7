"""The port's static gates (``acco_tpu_torch/analysis/``), as
``tests/test_lint_gates.py`` proves the JAX package's: each analyzer
passes on the port's own sources and programs and fails on its seeded
violation.

- the program registry (``analysis/programs.py``: the ACCO rounds, DPU,
  DDP, the eval step, the serve prefill buckets and decode, on the CPU)
  clears the rules, dtypes and in-place gates;
- rules: an unmatched leaf, an ambiguous rule pair, a missing table fail;
- dtypes: a bf16 Adam moment and an uncovered leaf fail;
- host lint and the metrics gate: every seeded rule fires, the
  suppression markers and exemptions hold, the port's files are clean;
- slow markers: an unmarked slow port test fails, a missing file is a
  pass with a note, a JAX test is not the port's to mark;
- census and overlap: their verdicts on canned collectives and canned
  traces (the CPU has no streams), the trace reader on canned
  ``record_param_comms`` events, the call-site recorder on a one-rank
  gloo group;
- in-place: a dispatch that returns a new tensor fails;
- the entry point: ``python -m acco_tpu_torch.analysis --ci --device cpu``
  exits 0 on the tree and 1 on a copy with a seeded violation.
"""

import json
import os
import shutil
from collections import namedtuple

import pytest
import torch

from acco_tpu_torch.analysis.census import check_census, ring_comm_bytes
from acco_tpu_torch.analysis.donation import check_in_place, eager_in_place
from acco_tpu_torch.analysis.dtypes import check_dtype_policy, train_state_rules
from acco_tpu_torch.analysis.host_lint import lint_file, lint_paths
from acco_tpu_torch.analysis.overlap import check_overlap
from acco_tpu_torch.analysis.rules import check_rule_coverage
from acco_tpu_torch.analysis.slow_markers import audit_durations, audit_recorded, merge_records
from acco_tpu_torch.analysis.trace import Collective, collectives_from_trace
import torch_ranks
from torch_ranks import REPO

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


@pytest.fixture(scope="module")
def registry():
    """Every dispatched program, built once on the CPU (~0.5 s)."""
    from acco_tpu_torch.analysis.programs import build_all_tiny

    return build_all_tiny("cpu")


# -- the real programs pass ----------------------------------------------------------


def test_registry_covers_every_dispatched_program(registry):
    names = {p.name for p in registry}
    assert {"acco_rounds", "dpu_round", "ddp_step", "eval", "serve_decode"} <= names
    assert any(n.startswith("serve_prefill_") for n in names)


@pytest.mark.parametrize("gate", ["rules", "dtypes"])
def test_state_gates_pass_on_every_program(registry, gate):
    for p in registry:
        rep = (check_rule_coverage(p.state_tree, p.rule_table) if gate == "rules"
               else check_dtype_policy(p.state_tree, p.dtype_rules))
        assert rep.ok and rep.checked > 0, f"{p.name}: {rep.summary()}"


def test_in_place_gate_passes_on_every_program(registry):
    """The state stays in each program's static buffers: ACCO's whole
    cycle (both parities over both buffer sets), DPU, DDP (one set), the
    eval step (the flat buffers), the serve pools and parameters."""
    for p in registry:
        n = 4 if p.name == "acco_rounds" else 2
        rep = check_in_place(p.name, p.dispatch, p.buffers, n=n, device=p.device)
        assert rep.ok, rep.summary()
    acco = next(p for p in registry if p.name == "acco_rounds")
    assert len(acco.meta["programs"].programs) == 4  # the cycle's four programs


def test_in_place_fails_on_a_new_tensor(registry):
    """Seeded violation: a dispatch whose state holds a tensor outside the
    program's buffers (a round that allocated its output)."""
    p = next(p for p in registry if p.name == "ddp_step")

    def dispatch():
        state = p.dispatch()
        return state._replace(flat_params=state.flat_params.clone())

    rep = check_in_place(p.name, dispatch, p.buffers, n=2, device=p.device)
    assert not rep.ok and rep.moved == [f"flat_params (dispatch {k})" for k in range(3)]


def test_eager_round_reports_what_it_writes_in_place(registry):
    """On the CPU the eager DDP step (``in_place=True``) writes its state
    over itself; the eager ACCO round returns new tensors for the leaves
    it updates, and the report names them."""
    ddp = next(p for p in registry if p.name == "ddp_step").meta["programs"]
    from acco_tpu_torch.analysis.programs import tiny_block

    block = tiny_block("cpu")
    out = eager_in_place(ddp.step, ddp.state, block)
    assert "flat_params" in out["in_place"] and "zero1/opt/mu" in out["in_place"]
    acco = next(p for p in registry if p.name == "acco_rounds").meta["programs"]
    state = acco.template._replace(**{k: v.clone() for k, v in acco.state._asdict().items()
                                      if torch.is_tensor(v)})
    out = eager_in_place(acco.step, state, block, parity=False)
    assert "pending_grads" in out["new"]


# -- rules, dtypes ---------------------------------------------------------------------


def test_rules_gate_fails_on_unmatched_leaf():
    from acco_tpu_torch.sharding.tables import train_state_table

    rep = check_rule_coverage({"flat_params": 0, "mystery_buffer": 0},
                              train_state_table("ddp", ("dp",), None))
    assert not rep.ok and [v.kind for v in rep.violations] == ["unmatched"]
    assert "mystery_buffer" in rep.violations[0].message


def test_rules_gate_fails_on_ambiguous_rule_pair():
    from acco_tpu_torch.sharding.rules import P, Rule, RuleTable

    table = RuleTable("seeded-overlap", (Rule(r"^opt/", P()), Rule(r"mu$", P("dp"))))
    rep = check_rule_coverage({"opt": {"mu": 0, "nu": 0}}, table)
    assert {v.path: v.kind for v in rep.violations} == {"opt/mu": "ambiguous"}
    assert rep.checked == 2


def test_rules_gate_fails_on_missing_table():
    rep = check_rule_coverage({"flat_params": 0}, None)
    assert not rep.ok and "no sharding rule table" in rep.summary()


_Opt = namedtuple("_Opt", ["params", "mu", "nu", "count"])
_Zero1 = namedtuple("_Zero1", ["opt", "sched_grads", "grads_committed"])
_State = namedtuple("_State", ["flat_params", "pending_grads", "zero1", "round_idx"])


def _fake_state(mu_dtype=torch.float32, extra=None):
    def t(n, dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device="meta")

    state = _State(flat_params=t(8, torch.bfloat16), pending_grads=t(16),
                   zero1=_Zero1(opt=_Opt(t(8), t(8, mu_dtype), t(8), t((), torch.int32)),
                                sched_grads=t((), torch.int32), grads_committed=t(())),
                   round_idx=t((), torch.int32))
    return {"state": state, **extra} if extra else state


@pytest.mark.parametrize("case", ["bf16-moment", "uncovered", "conformant"])
def test_dtype_policy(case):
    """A bf16 Adam moment (trains worse without an error) and a leaf no
    rule covers (closed world) fail; the conformant tree passes."""
    rules = train_state_rules(torch.bfloat16)
    if case == "bf16-moment":
        rep = check_dtype_policy(_fake_state(mu_dtype=torch.bfloat16), rules)
        assert any("mu" in v.path and "bfloat16" in v.message for v in rep.violations)
    elif case == "uncovered":
        rep = check_dtype_policy(
            _fake_state(extra={"mystery": torch.zeros(4, dtype=torch.float64)}), rules)
        assert any(v.rule is None and "mystery" in v.path for v in rep.violations)
    else:
        rep = check_dtype_policy(_fake_state(), rules)
        assert rep.ok and rep.checked == 9
    assert rep.ok == (case == "conformant")


# -- host lint, metrics, slow markers ---------------------------------------------------

BAD_HOST = '''
import os
import threading
import torch


def loop(xs, stream):
    for x in xs:
        x.item()
        x.cpu()
        torch.cuda.synchronize()
    while xs:
        stream.synchronize()
        xs = xs[1:].tolist()


def start():
    threading.Thread(target=loop).start()
'''


def test_host_lint_fires_on_every_seeded_rule():
    findings = lint_file("bad_host.py", source=BAD_HOST)
    assert {f.rule for f in findings} == {"unused-import", "host-sync-in-loop",
                                          "thread-without-join"}
    syncs = [f.message.split(" ")[0] for f in findings if f.rule == "host-sync-in-loop"]
    assert syncs == [".item()", ".cpu()", ".synchronize()", ".synchronize()", ".tolist()"]


def test_host_lint_suppression_markers_and_exemptions():
    src = ("from __future__ import annotations\n"
           "import os\n"
           "import sys\n"
           "import threading\n"
           "__all__ = ['os']\n"
           "def f(xs):\n"
           "    for x in xs:\n"
           "        x.item()  # lint: host-sync-ok: the boundary read\n"
           "        x.numpy(1)\n"  # numpy with an argument: not a tensor's read-back
           "        def later():\n"
           "            return x.item()\n"  # defined in the loop, run elsewhere
           "    threading.Thread(target=f)  # lint: thread-ok\n")
    findings = lint_file("inline.py", source=src)
    assert [(f.rule, f.message) for f in findings] == [
        ("unused-import", "'sys' imported but never used")]


def test_repo_host_lint_is_clean():
    """The enforced baseline: the package, ``chip_smoke.py`` and the port's
    tests, as ``--ci`` walks them."""
    from acco_tpu_torch.analysis.__main__ import lint_targets

    findings = lint_paths(lint_targets())
    assert findings == [], "\n".join(map(str, findings))


def test_metrics_gate_fires_on_every_seeded_rule():
    from acco_tpu_torch.analysis.metrics_gate import check_file

    src = ("from acco_tpu_torch.telemetry import metrics\n"
           "def f(tracer, name):\n"
           "    metrics.emit('totally_made_up_metric', 1)\n"
           "    metrics.emit_many({'ckpt_saves_total': 1, 'another_bogus_name': 2})\n"
           "    metrics.emit(name, 1)  # dynamic: the run-time check's\n"
           "    with tracer.span('train/eval'):\n"
           "        tracer.complete_event('ckpt/snapshit', 1.0, cat='ckpt')\n"
           "    tracer.instant('not/a/span')\n"
           "    tracer.complete_event('tests/x.py::t', 1.0, cat='test')\n")
    rep = check_file("bad_metrics.py", source=src)
    assert sorted(f.rule for f in rep.findings) == ["undeclared-metric", "undeclared-metric",
                                                     "undeclared-span", "undeclared-span"]
    messages = " ".join(f.message for f in rep.findings)
    for name in ("totally_made_up_metric", "another_bogus_name", "ckpt/snapshit", "not/a/span"):
        assert name in messages
    assert rep.checked == 6  # the declared names were checked too, not flagged


def test_repo_metrics_gate_is_clean():
    from acco_tpu_torch.analysis.metrics_gate import check_paths

    rep = check_paths([os.path.join(REPO, "acco_tpu_torch"), os.path.join(REPO, "chip_smoke.py")])
    assert rep.ok, [str(f) for f in rep.findings]
    assert rep.checked > 40


def test_slow_marker_audit(tmp_path):
    """An unmarked port test over the threshold fails; a marked one and a
    JAX-package test (not the port's to mark) pass; a missing file is a
    pass with a note; recordings merge."""
    rep = audit_durations({
        "tests/test_torch_x.py::test_fast": {"duration": 0.2, "slow": False},
        "tests/test_torch_x.py::test_big": {"duration": 31.0, "slow": False},
        "tests/test_torch_x.py::test_marked": {"duration": 400.0, "slow": True},
        "tests/test_fused_ce.py::test_jax": {"duration": 300.0, "slow": False},
    }, prefix="tests/test_torch_")
    assert not rep.ok and rep.checked == 3 and len(rep.violations) == 1
    assert "test_big" in rep.violations[0]
    missing = audit_recorded(str(tmp_path / "nope.json"))
    assert missing.ok and missing.checked == 0 and missing.note
    path = str(tmp_path / "durations.json")
    merge_records(path, {"tests/test_torch_a.py::t1": {"duration": 30.0, "slow": False}})
    merge_records(path, {"tests/test_torch_a.py::t2": {"duration": 1.0, "slow": False}})
    rep = audit_recorded(path)
    assert rep.checked == 2 and len(rep.violations) == 1


# -- census, the trace reader, overlap ---------------------------------------------------

PP = 1 << 21  # a flat vector of 2M elements


def _round(ns=2, extra=()):
    """A round's collectives: the reduce-scatter of float32 gradients, the
    all-gather of bf16 params, the small sums, and ``extra``."""
    return [Collective("reduce-scatter", PP, "float32", ns),
            Collective("all-gather", PP, "bfloat16", ns),
            Collective("all-reduce", 2, "float32", ns), Collective("all-reduce", 1, "float32", ns),
            *extra]


def test_census_passes_on_the_round_and_fails_on_an_extra_all_reduce():
    model = ring_comm_bytes(PP, 2, 2)
    rep = check_census(_round(), model, (2, 2))
    assert rep.ok and rep.measured_bytes == model and rep.small_ops == 2
    extra = check_census(_round(extra=[Collective("all-reduce", PP, "float32", 2)]), model)
    assert not extra.ok and "outside model" in extra.summary()


def test_census_fails_on_op_count_small_cap_and_collective_free_path():
    assert not check_census(_round(), ring_comm_bytes(PP, 2, 2), (3, 4)).ok
    many = _round(extra=[Collective("all-reduce", 1, "float32", 2)] * 20)
    assert not check_census(many, ring_comm_bytes(PP, 2, 2)).ok
    assert not check_census(_round(), 0.0).ok  # a serve program must move nothing
    # at one rank the round's two collectives move nothing: 2 large ops, 0 bytes
    assert check_census(_round(ns=1), ring_comm_bytes(PP, 1, 2), (2, 2)).ok


def _comm(ts, dur, name, elems, dtype, corr, tid=1):
    """A ``record_param_comms`` host op and the launch inside it."""
    return [{"ph": "X", "cat": "cpu_op", "name": "record_param_comms", "ts": ts, "dur": dur,
             "pid": 1, "tid": tid,
             "args": {"Collective name": name, "In msg nelems": elems, "Out msg nelems":
                      elems // 2 if "scatter" in name else elems, "Group size": 2,
                      "dtype": dtype}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts + 1,
             "dur": 1, "pid": 1, "tid": tid, "args": {"correlation": corr}}]


def _kernel(ts, dur, stream, name="gemm", corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0,
            "tid": stream, "args": {"stream": stream, "correlation": corr}}


def _trace(nccl_stream):
    """Compute on stream 7 (the busiest), a reduce-scatter and an
    all-gather launched onto ``nccl_stream`` during it."""
    return [*_comm(0, 5, "_reduce_scatter_base", PP, "Float", 11),
            *_comm(50, 5, "_allgather_base", PP, "BFloat16", 12),
            _kernel(0, 300, 7), _kernel(10, 30, nccl_stream, "ncclDevKernel_ReduceScatter", 11),
            _kernel(60, 30, nccl_stream, "ncclDevKernel_AllGather", 12)]


def test_trace_reader_reads_record_param_comms():
    got = collectives_from_trace(_trace(20))
    assert [(c.kind, c.elems, c.group_size, c.stream) for c in got] == [
        ("reduce-scatter", PP, 2, 20), ("all-gather", PP, 2, 20)]
    assert check_census(got, ring_comm_bytes(PP, 2, 2), (2, 2)).ok


def test_overlap_verdicts_on_canned_traces():
    good = check_overlap(_trace(20))
    assert good.ok and good.windows == 2 and good.covered_windows == 2
    blocking = check_overlap(_trace(7))  # the collectives on the compute stream
    assert not blocking.ok and blocking.blocking_large == 2 and blocking.windows == 0
    exempt = check_overlap(_trace(7), small_elems=1 << 30)
    assert exempt.blocking_large == 0 and not exempt.ok  # still no comm window
    late = [*_trace(20)[:4], _kernel(0, 300, 7),
            _kernel(400, 30, 20, "ncclDevKernel_ReduceScatter", 11),
            _kernel(500, 30, 20, "ncclDevKernel_AllGather", 12)]
    rep = check_overlap(late)  # the comm side after the compute: no window covered
    assert not rep.ok and rep.windows == 2 and rep.covered_windows == 0


def test_recorder_counts_the_round_on_one_gloo_rank(tmp_path):
    """The census on gloo counts at the call sites: one ACCO round over a
    one-rank group issues its reduce-scatter (float32, the padded flat
    vector) and all-gather (bf16), and the small sums; the recorder
    unwinds on exit."""
    import torch.distributed as dist

    from acco_tpu_torch.analysis.__main__ import one_rank_group, round_collectives
    from acco_tpu_torch.analysis.programs import (
        TINY_SMALL_ELEMS,
        build_train_program,
        rank_groups,
    )

    before = dist.all_reduce
    with one_rank_group("gloo") as group:
        prog = build_train_program("acco", "cpu", rank_groups(group))
        calls, how, eager = round_collectives(prog)
    assert dist.all_reduce is before and how == "counted at the call sites"
    assert "pending_grads" in eager["new"]  # the eager round's report rides along
    big = [(c.kind, c.elems, c.dtype) for c in calls if c.elems > TINY_SMALL_ELEMS]
    pp = prog.meta["padded_size"]
    assert big == [("reduce-scatter", pp, "float32"), ("all-gather", pp, "bfloat16")]
    assert check_census(calls, prog.expect_comm_bytes, prog.expect_comm_ops,
                        small_elems=TINY_SMALL_ELEMS).ok


# -- the entry point ------------------------------------------------------------------------


def test_entry_point_passes_on_the_tree(tmp_path, capsys):
    """``python -m acco_tpu_torch.analysis --ci --device cpu`` on the tree:
    every gate passes (the slow-marker audit over an empty recording:
    the recorded durations are the machine's, and its seeded cases are
    above)."""
    from acco_tpu_torch.analysis.__main__ import main

    assert main(["--ci", "--device", "cpu", "--durations", str(tmp_path / "none.json")]) == 0
    out = capsys.readouterr().out
    assert "11/11 gates passed" in out and "program:serve_decode" in out


def test_entry_point_fails_on_a_seeded_violation(tmp_path, capsys):
    """A copy of the tree with an unused import in a port module and an
    unmarked slow port test recorded: ``--ci`` exits 1 and names both."""
    from acco_tpu_torch.analysis.__main__ import main

    copy = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "acco_tpu_torch"), copy / "acco_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), copy)
    with open(copy / "acco_tpu_torch" / "ops" / "adamw.py", "a") as f:
        f.write("\nimport shutil\n")
    (copy / "outputs").mkdir()
    (copy / "outputs" / "test_durations.json").write_text(json.dumps(
        {"tests/test_torch_x.py::test_big": {"duration": 99.0, "slow": False}}))
    assert main(["--ci", "--device", "cpu", "--repo", str(copy)]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] host-lint" in out and "'shutil' imported but never used" in out
    assert "[FAIL] slow-markers" in out and "9/11 gates passed" in out


def test_program_gates_need_a_card_without_device_cpu():
    from acco_tpu_torch.analysis.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the program gates run on it")
    with pytest.raises(RuntimeError, match="no card is present"):
        main(["--ci", "--durations", "/nonexistent"])


def test_round_watch_over_a_trainer_run(tmp_path):
    """``watch_round_programs`` (what ``chip_smoke.py`` wraps each captured
    cell in) sees every round of the entry point's trainer and finds its
    state in the buffer sets; a round whose state leaves them is named."""
    from acco_tpu_torch.__main__ import build_trainer
    from acco_tpu_torch.analysis.donation import watch_round_programs
    from acco_tpu_torch.compile import graphs

    argv = ["--device", "cpu", "train=acco", "model=tiny", "data=synthetic",
            "data.synthetic_num_docs=16", "train.max_length=32", "train.batch_size=2",
            "train.nb_steps_tot=4", "train.save=false", "train.eval=false",
            f"hydra.run.dir={tmp_path / 'run'}"]
    with watch_round_programs() as seen:
        summary = build_trainer(argv).train()
    assert summary["rounds_as"] == "buffer_sets" and seen["rounds"] == len(summary["round_log"])
    assert seen["rounds"] > 0 and seen["leaves"] == 13 * seen["rounds"] and not seen["moved"]
    original = graphs.RoundPrograms.state
    graphs.RoundPrograms.state = property(lambda self: graphs.unflatten(
        self.template, [t.clone() for t in self._leaves(self.phases)]))
    try:
        with watch_round_programs() as seen:
            build_trainer([*argv[:-1], f"hydra.run.dir={tmp_path / 'b'}"]).train()
    finally:
        graphs.RoundPrograms.state = original
    assert seen["moved"] and seen["moved"][0].startswith("round 1: ")
