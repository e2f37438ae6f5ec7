"""``train.profile_steps``: a few steady-state rounds under
``torch.profiler``, and the reader of their trace.

Counterpart of the JAX trainer's ``jax.profiler`` hook
(``acco_tpu/trainer.py``: ``profile_steps`` rounds traced after the
compile rounds, into ``<run_dir>/profile``). :class:`RoundProfiler`
skips the first rounds (2 for ACCO, whose even and odd rounds differ;
1 for DPU and DDP: the kernels build at their first use), then wraps
``steps`` rounds in ``torch.profiler.profile`` with the CPU and, on a
card, the CUDA activities, on rank 0 only, between two
``torch.cuda.synchronize()``; it writes the Chrome trace under
``<run_dir>/profile/`` and reads it back (:func:`read_trace`).

The reader sorts the device's activity (kernels, copies, memsets) by
CUDA stream, and names the streams by identity, not by load: at the
start of the window a tiny spin kernel is launched on each stream the
trainer owns — the current (compute) stream, ACCO's ``comm_stream``
(``parallel/acco.py``), the prefetch worker's copy stream
(``data/prefetch.py``) — one after the other, each inside a
``record_function`` range named after its role; the trace's runtime
launch inside that range carries the correlation id of the kernel, whose
event names the stream (and, failing that, the n-th range is the n-th
spin kernel). The compute side is the current stream; the comm side is
the comm stream, NCCL's streams (any stream that ran an ``nccl``
kernel) and any other stream that ran a kernel; the copy side, reported
on its own, is the copy stream and any other stream that only copied (a
checkpoint snapshot's, if one falls in the window). Per round of
the window: each side's busy ms, the comm side's ms under compute-stream
activity and its share (``measured_overlap_pct``), the union of every
stream's activity, and the device's idle share, 1 - union / the window's
wall time (the wall time includes the profiler's own host cost).

A captured round (``compile/graphs.py``) replays as one graph launch,
and its kernels report streams of the graph's own, which no eager probe
named (on an H100 with CUDA 12.8: mostly the comm branch on the
launching stream and the compute branch on a stream of each graph's
own, but not always). Under ``profile_steps`` the graph therefore
carries probes of its own: one spin kernel at the head of the compute
branch, two in a row at the head of the comm branch
(``compile.graphs.spin_probe``). A spin kernel that carries a
``cudaGraphLaunch``'s correlation is a graph's; on each stream it opens
a segment of its branch's side, which holds the stream's later events
up to the next graph probe (:func:`graph_sides`). These segments come
before the streams' names; ``streams_ms`` marks such a stream
``graph:<stream>``.

On the CPU there is no device activity: the summary says so
(``{"device": "cpu", ...}``) and invents no share.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

_module_log = logging.getLogger(__name__)

PROBE = "acco_stream_probe/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _measure(intervals: list) -> float:
    return sum(b - a for a, b in intervals)


def _intersect(x: list, y: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def probe_streams(streams: Dict[str, Any]) -> list:
    """Launch one tiny spin kernel (``torch.cuda._sleep``) on each CUDA
    stream of ``streams`` (role -> stream; None entries skipped), each
    inside a ``record_function`` range named ``acco_stream_probe/<role>``
    and finished before the next starts: :func:`stream_roles` finds each
    stream from the trace. Returns the probed roles."""
    import torch

    roles = []
    for role, stream in streams.items():
        if stream is None:
            continue
        with torch.profiler.record_function(PROBE + role), torch.cuda.stream(stream):
            torch.cuda._sleep(1000)
        stream.synchronize()
        roles.append(role)
    return roles


def _args(event: dict) -> dict:
    return event.get("args") or {}


def stream_roles(events: list) -> Dict[Any, str]:
    """CUDA stream id -> role, from the probes of :func:`probe_streams`.
    First by correlation: the runtime calls made inside a probe's range
    (same pid and tid) carry correlation ids, and the device event with
    that correlation names the stream. Then, for probes that found no
    stream so, by order: the probes ran one after the other, so the
    n-th probe range is the n-th spin kernel on the device."""
    ranges = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
         e["name"][len(PROBE):], e.get("pid"), e.get("tid"))
        for e in events
        if e.get("ph") == "X" and str(e.get("name", "")).startswith(PROBE)
        and e.get("cat") != "gpu_user_annotation")
    role_of_corr: Dict[Any, str] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        ts = float(e["ts"])
        for beg, end, role, pid, tid in ranges:
            if e.get("pid") == pid and e.get("tid") == tid and beg <= ts <= end:
                role_of_corr[_args(e).get("correlation")] = role
    roles: Dict[Any, str] = {}
    spins = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        stream = _args(e).get("stream", e.get("tid"))
        role = role_of_corr.get(_args(e).get("correlation"))
        if role is not None:
            roles[stream] = role
        if e.get("cat") == "kernel" and "spin_kernel" in str(e.get("name", "")):
            spins.append((float(e["ts"]), stream))
    spins.sort()
    if len(spins) == len(ranges):
        for (_, _, role, _, _), (_, stream) in zip(ranges, spins):
            if role not in roles.values():
                roles.setdefault(stream, role)
    return roles


def graph_sides(events: list) -> Dict[int, str]:
    """Index in ``events`` of each device event that a graph's probe
    names -> its side (see the module's doc): on each stream, in time
    order, a spin kernel of a graph launch (its correlation a
    ``cudaGraphLaunch``'s) alone opens a compute segment, two in a row a
    comm segment, and every later event of that stream belongs to the
    open segment. A replay's branch may run on any of the graph's
    streams, and one stream may carry both branches in turn."""
    graph_corr = {_args(e).get("correlation") for e in events
                  if e.get("cat") == "cuda_runtime" and "GraphLaunch" in str(e.get("name", ""))}
    on_stream: Dict[Any, list] = {}
    for i, e in enumerate(events):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            spin = ("spin_kernel" in str(e.get("name", ""))
                    and _args(e).get("correlation") in graph_corr)
            on_stream.setdefault(_args(e).get("stream", e.get("tid")), []).append(
                (float(e["ts"]), i, spin))
    sides: Dict[int, str] = {}
    for seq in on_stream.values():
        seq.sort()
        side, j = None, 0
        while j < len(seq):
            _, i, spin = seq[j]
            if spin:
                pair = j + 1 < len(seq) and seq[j + 1][2]
                side = "comm" if pair else "compute"
                if pair:
                    sides[i] = side
                    j += 1
                    i = seq[j][1]
            if side is not None:
                sides[i] = side
            j += 1
    return sides


def read_trace(events: list, wall_ms: Optional[float] = None, rounds: int = 1) -> dict:
    """The device's activity in a Chrome trace's ``events`` by side, per
    round (``rounds`` rounds in the window): ``compute_ms`` (the stream
    probed as 'compute'; the busiest stream when no probe is found),
    ``comm_ms`` (the stream probed as 'comm', every stream that ran an
    ``nccl`` kernel, and any unprobed stream that ran a kernel),
    ``comm_under_compute_ms`` and its share ``measured_overlap_pct``,
    ``copy_ms`` (the stream probed as 'copy' and unprobed streams with
    copies only: the prefetch copies, a snapshot's), ``union_ms`` (every
    stream), ``kernels``, ``kernel_launch_calls`` and ``graph_launches``
    a round and, given
    the window's ``wall_ms``, ``idle_share``. ``streams_ms``: each
    stream's busy ms a round with its role. A trace with no device
    activity gives ``{"device": "cpu"}``."""
    by_stream: Dict[Any, list] = {}
    nccl = set()
    device = []  # (index, stream, interval) of each device event
    for i, e in enumerate(events):
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        stream = _args(e).get("stream", e.get("tid"))
        beg = float(e["ts"])
        iv = (beg, beg + float(e.get("dur", 0)))
        by_stream.setdefault(stream, []).append(iv)
        device.append((i, stream, iv))
        if e.get("cat") == "kernel" and "nccl" in str(e.get("name", "")).lower():
            nccl.add(stream)
    if not by_stream:
        return {"device": "cpu", "rounds": rounds}
    merged = {k: _union(v) for k, v in by_stream.items()}
    busy = {k: _measure(v) / 1e3 for k, v in merged.items()}
    roles = stream_roles(events)
    graph = graph_sides(events)
    compute = [k for k, r in roles.items() if r == "compute" and k in merged]
    if not compute:
        compute = [max(busy, key=busy.get)]
    kernels = {_args(e).get("stream", e.get("tid")) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "spin_kernel" not in str(e.get("name", ""))}
    side = {}
    for k in merged:
        if k in compute:
            side[k] = "compute"
        elif roles.get(k) == "comm" or k in nccl:
            side[k] = "comm"
        elif k not in roles and k in kernels:
            side[k] = "comm"  # another stream that computes: the comm side
        else:
            side[k] = "copy"  # the copy stream(s): copies only
    replayed = {stream for i, stream, _ in device if i in graph}

    def union_of(which: str) -> list:
        # an event a graph's probe names takes its segment's side, any other
        # its stream's
        return _union([iv for i, k, iv in device if graph.get(i, side[k]) == which])

    comp, comm, copy = union_of("compute"), union_of("comm"), union_of("copy")
    everything = _union([iv for v in merged.values() for iv in v])
    n = max(1, int(rounds))
    # the host's launches: kernel launch calls and graph launches (a
    # captured round is one), and the kernels the device ran
    calls = [str(e.get("name", "")) for e in events
             if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
    n_kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    comm_ms = _measure(comm) / 1e3
    under_ms = _intersect(comm, comp) / 1e3
    union_ms = _measure(everything) / 1e3
    out = {
        "device": "cuda",
        "rounds": n,
        "compute_ms": _measure(comp) / 1e3 / n,
        "comm_ms": comm_ms / n,
        "comm_under_compute_ms": under_ms / n,
        "measured_overlap_pct": 100.0 * under_ms / comm_ms if comm_ms > 0 else None,
        "copy_ms": _measure(copy) / 1e3 / n,
        "union_ms": union_ms / n,
        "streams_ms": {f"{'graph' if k in replayed else side[k]}:{k}": busy[k] / n
                       for k in sorted(busy, key=lambda k: -busy[k])},
        "kernels": n_kernels / n,
        "kernel_launch_calls": sum("LaunchKernel" in c for c in calls) / n,
        "graph_launches": sum("GraphLaunch" in c for c in calls) / n,
    }
    if wall_ms is not None and wall_ms > 0:
        out["wall_ms"] = wall_ms / n
        out["idle_share"] = 1.0 - union_ms / wall_ms
    return out


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


class RoundProfiler:
    """``profile_steps`` rounds of the train loop under
    ``torch.profiler``. The trainer calls :meth:`before_round` (with
    ``streams()``, role -> stream for the probes) and :meth:`after_round`
    with its run-local round count and :meth:`finish` after the loop (a
    run that ends inside the window stops it there). Inactive (no calls
    do anything) when ``steps`` is 0 or on a rank other than 0. It keeps
    no reference to the trainer, so a finished trainer is freed at once."""

    def __init__(self, steps: int, skip: int, out_dir: str, device, *, rank: int = 0,
                 name: str = "rounds", log=None) -> None:
        self.steps = int(steps or 0)
        self.skip = int(skip)
        self.out_dir = out_dir
        self.device = device
        self.active = self.steps > 0 and rank == 0
        self.name = name
        self.log = log or _module_log
        self.summary: Optional[dict] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._t0 = 0.0
        self._rounds = 0

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def before_round(self, rounds_this_run: int, streams=None) -> None:
        if not self.active or self._prof is not None or rounds_this_run != self.skip:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)  # the rounds before are done
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._rounds = 0
        if self.cuda and streams is not None:
            probe_streams(streams())

    def after_round(self, rounds_this_run: int) -> None:
        if self._prof is None:
            return
        self._rounds += 1
        if self._rounds >= self.steps:
            self._stop()

    def finish(self) -> Optional[dict]:
        if self._prof is not None:
            self._stop()
        return self.summary

    def _stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        self.trace_path = os.path.join(self.out_dir, f"{self.name}.json")
        prof.export_chrome_trace(self.trace_path)
        self.active = False
        summary = read_trace(load_events(self.trace_path), wall_ms if self.cuda else None,
                             self._rounds)
        if not self.cuda:
            summary = {"device": "cpu", "rounds": self._rounds}
        summary["trace"] = self.trace_path
        self.summary = summary
        self.log.info("profiler trace of %d rounds -> %s: %s", self._rounds, self.trace_path,
                      {k: v for k, v in summary.items() if k != "streams_ms"})
