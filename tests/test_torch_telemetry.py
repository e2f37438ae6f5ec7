"""The port's ``telemetry/`` against the JAX package's, and the profile
reader.

- The same emits into JAX's and the port's ``MetricsRegistry`` give equal
  ``scalar_row()`` and Prometheus text; an undeclared name raises in both.
- The same spans give traces that both ``validate_trace``s accept, with
  equal events apart from timestamps, durations and thread ids.
- ``StepAttribution`` given the same notes and boundaries gives an equal
  ``attribution_report`` with no estimate row.
- ``telemetry/profile.py``'s reader on a hand-written Chrome trace
  (compute, comm, NCCL and copy streams, the streams named by probes)
  gives the hand-computed overlap and keeps the copy stream out of the
  comm side; ``train.profile_steps=2`` on tiny128 writes a trace and says
  that the run was on the CPU.
- Importing the port's telemetry loads neither jax nor acco_tpu.
"""

import json
import os
import subprocess
import sys

import pytest

from acco_tpu.telemetry import attribution as jax_attribution
from acco_tpu.telemetry import metrics as jax_metrics
from acco_tpu.telemetry import trace as jax_trace
from acco_tpu_torch.telemetry import attribution, metrics, profile, trace
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EMITS = [("train_rounds_total", 1), ("train_rounds_total", 1), ("train_round_wall_ms", 12.5),
         ("train_round_wall_ms", 80.0), ("train_round_wall_ms", 3000.0), ("train_loss", 2.25),
         ("ckpt_snapshot_ms", 140.0), ("ckpt_commit_ms", 2770.0), ("health_spikes_total", 1),
         ("loader_block_wait_ms", 0.4), ("measured_overlap_pct", 5.4)]


def test_metrics_equal_jax():
    port, jax = metrics.MetricsRegistry(metrics.DECLARED), jax_metrics.MetricsRegistry(
        jax_metrics.DECLARED)
    assert port.declared_names() == jax.declared_names()
    for registry in (port, jax):
        for name, value in EMITS:
            registry.emit(name, value)
    assert port.scalar_row() == jax.scalar_row()
    assert port.to_prometheus_text() == jax.to_prometheus_text()
    assert port.value("train_round_wall_ms") == jax.value("train_round_wall_ms")
    with pytest.raises(metrics.UndeclaredMetricError, match="not declared"):
        port.emit("train_round_wal_ms", 1.0)


def _spans(module):
    tracer = module.Tracer(process_name="acco-acco")
    for r in range(3):
        with tracer.span("train/round", cat="train", round=r):
            with tracer.span("loader/next_block", cat="train"):
                pass
            tracer.complete_event("train/dispatch", 0.5, cat="train")
    tracer.instant("ckpt/snapshot", cat="ckpt")
    with pytest.raises(module.UndeclaredSpanError):
        tracer.span("train/rnd").__enter__()
    return tracer.to_dict({"id_run": "x"})


def test_trace_equal_jax():
    got, want = _spans(trace), _spans(jax_trace)
    assert trace.validate_trace(got) == [] and jax_trace.validate_trace(got) == []
    assert jax_trace.validate_trace(want) == [] and trace.validate_trace(want) == []

    def strip(t):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid", "pid")}
                for e in t["traceEvents"]]

    assert strip(got) == strip(want) and got["otherData"] == want["otherData"]
    bad = {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
                           {"ph": "X", "name": "b", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]}
    assert trace.validate_trace(bad) == jax_trace.validate_trace(bad) != []


def _attributed(module):
    attrib = module.StepAttribution()
    for loader, host, n, wall in ((0.5, 3.0, 2, 150.0), (0.0, 1.5, 3, 210.0), (9.0, 80.0, 1, 40.0)):
        attrib.note("loader", loader)
        attrib.note("host_stall", host)
        attrib.note("ckpt", 20.0 if n == 3 else 0.0)
        attrib.boundary(n, wall)
    return module.attribution_report(attrib.summary(), None)


def test_attribution_equal_jax():
    got = _attributed(attribution)
    assert got == _attributed(jax_attribution)
    assert got["clamped_ms"] > 0  # the third window's host buckets overran its wall
    assert attribution.load_estimate_row(1) is None  # no default estimates file
    assert attribution.split_device_residual(7.0, None) == {"compute_ms": 7.0,
                                                            "exposed_comm_ms": 0.0}


def _dev(cat, name, stream, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def _probe(role, ts, corr):
    return [{"ph": "X", "cat": "user_annotation", "name": profile.PROBE + role, "pid": 9,
             "tid": 1, "ts": ts, "dur": 10},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9, "tid": 1,
             "ts": ts + 2, "dur": 3, "args": {"correlation": corr}}]


def test_profile_reader_on_a_hand_written_trace():
    """Streams 7 (compute, probed), 13 (comm, probed), 21 (NCCL) and 30
    (the copy stream, probed; busier than the comm side): compute
    [0, 1000) and [1200, 2000); comm [900, 1300) and NCCL [1900, 2100);
    copies [100, 700) and [1950, 2050). The comm side's union is 600 us,
    300 us of it under compute: an overlap share of 50%, whatever the
    copies do."""
    events = (_probe("compute", 0, 1) + _probe("comm", 20, 2) + _probe("copy", 40, 3) + [
        _dev("kernel", "spin_kernel(long)", 7, 3, 0, 1),
        _dev("kernel", "spin_kernel(long)", 13, 23, 0, 2),
        _dev("kernel", "spin_kernel(long)", 30, 43, 0, 3),
        _dev("kernel", "gemm", 7, 0, 1000, 10), _dev("kernel", "attn", 7, 1200, 800, 11),
        _dev("kernel", "adamw", 13, 900, 400, 12),
        _dev("kernel", "ncclDevKernel_AllGather", 21, 1900, 200, 13),
        _dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 30, 100, 600, 14),
        _dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 30, 1950, 100, 15),
    ])
    assert profile.stream_roles(events) == {7: "compute", 13: "comm", 30: "copy"}
    got = profile.read_trace(events, wall_ms=4.2, rounds=2)
    assert got["compute_ms"] == pytest.approx(1.8 / 2)
    assert got["comm_ms"] == pytest.approx(0.6 / 2)
    assert got["comm_under_compute_ms"] == pytest.approx(0.3 / 2)
    assert got["measured_overlap_pct"] == pytest.approx(50.0)
    assert got["copy_ms"] == pytest.approx(0.7 / 2)
    assert got["union_ms"] == pytest.approx(2.1 / 2)
    assert got["idle_share"] == pytest.approx(1 - 2.1 / 4.2)
    # the runtime events lost: the probes' order names the streams
    no_runtime = [e for e in events if e["cat"] != "cuda_runtime"]
    assert profile.stream_roles(no_runtime) == {7: "compute", 13: "comm", 30: "copy"}
    # no probes at all: the busiest stream computes, a stream with kernels
    # is the comm side, a stream with copies only stays out of it
    bare = [e for e in events
            if e["cat"] not in ("user_annotation", "cuda_runtime") and e["dur"] > 0]
    got = profile.read_trace(bare)
    assert got["comm_ms"] == pytest.approx(0.6) and got["copy_ms"] == pytest.approx(0.7)
    assert profile.read_trace([e for e in events if e["cat"] == "user_annotation"]) == {
        "device": "cpu", "rounds": 1}


def test_profile_steps_on_cpu_writes_a_trace(tmp_path):
    from acco_tpu_torch.__main__ import main

    summary = main(["--device", "cpu", "train=acco", "model=tiny128", "data=synthetic",
                    "train.max_length=128", "train.batch_size=2", "train.nb_steps_tot=5",
                    "train.profile_steps=2", "+train.delta_step_for_log=1",
                    f"hydra.run.dir={tmp_path}"])
    prof = summary["profile"]
    assert prof["device"] == "cpu" and prof["rounds"] == 2
    assert os.path.dirname(prof["trace"]) == str(tmp_path / "profile")
    events = json.load(open(prof["trace"]))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert "measured_overlap_pct" not in prof and "idle_share" not in prof


def test_telemetry_imports_no_jax():
    code = ("import sys; import acco_tpu_torch.telemetry, acco_tpu_torch.telemetry.profile, "
            "acco_tpu_torch.resilience; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'acco_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
