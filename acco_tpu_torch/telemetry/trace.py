"""Span/event tracer -> Chrome/Perfetto ``trace.json`` per run.

A copy of ``acco_tpu/telemetry/trace.py`` (the standard library only)
for the port. One artifact shows where a run's host time went: host
spans (the block wait, the dispatch, the logging boundary's read-back,
the checkpoint snapshot and commit) and the per-round windows, derived
from wall time between dispatches and fenced by the read-back the
trainer already makes at its logging boundary, land as complete events
(``ph: "X"``) on per-thread tracks, loadable by ``chrome://tracing`` /
https://ui.perfetto.dev.

Design constraints, all load-bearing:

* **zero device syncs** — every timestamp is ``time.perf_counter_ns()``
  on the host around work the train loop already does. The tracer never
  touches a tensor (it does not import torch), so
  ``telemetry.enabled=false`` vs ``true`` differ by list appends only.
* **closed-world span names** — like the metrics registry, a span name
  must be declared in :data:`SPAN_NAMES` or recording raises. The one
  open category is ``"test"`` (an unbounded namespace by construction).
* **thread identity** — events carry the recording thread's id plus a
  thread-name metadata event, so the checkpoint commit thread and the
  prefetch worker appear as their own tracks next to the train loop.
* **bounded memory** — at most ``max_events`` events are kept; overflow
  increments a drop counter reported in ``otherData`` instead of
  growing without bound on long runs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

# The closed world of span/event names, as the JAX package declares it.
# Categories group tracks in the viewer.
SPAN_NAMES = frozenset(
    {
        "loader/next_block",     # consumer blocked on the prefetch queue
        "train/dispatch",        # host time to enqueue one round program
        "train/round",           # wall between dispatches (device window)
        "train/log_boundary_sync",  # the existing read-back at the cadence
        "train/eval",            # evaluate() host+device wall
        "ckpt/snapshot",         # blocking device->host part of save()
        "ckpt/commit",           # background finalize (its own thread)
        "compile/warmup_join",   # join of the background AOT warmup
        "serve/prefill",         # one admitted request's prefill dispatch
        "serve/decode_step",     # one batched decode+sample step
        "serve/request",         # submit -> finish of one GenRequest
    }
)

# Categories whose event names are NOT closed-world (unbounded by
# construction — e.g. pytest nodeids).
FREE_CATEGORIES = frozenset({"test"})


class UndeclaredSpanError(KeyError):
    """A span name outside :data:`SPAN_NAMES` (closed world)."""


class Tracer:
    """Chrome-trace event recorder; a disabled tracer is a cheap no-op.

    All public methods are thread-safe; ``enabled=False`` short-circuits
    before taking the lock so instrumented code paths cost one attribute
    read when telemetry is off.
    """

    def __init__(
        self,
        enabled: bool = True,
        *,
        process_name: str = "acco",
        max_events: int = 200_000,
    ) -> None:
        self.enabled = bool(enabled)
        self.process_name = process_name
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._tids: Dict[int, int] = {}  # ident -> small stable tid
        self._t0_ns = time.perf_counter_ns()

    # -- time ----------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer construction (the trace clock)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    # -- recording -----------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
            self._events.append(
                {
                    "ph": "M", "name": "thread_name", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                }
            )
        return tid

    def _check_name(self, name: str, cat: str) -> None:
        if cat not in FREE_CATEGORIES and name not in SPAN_NAMES:
            raise UndeclaredSpanError(
                f"span name {name!r} is not declared in telemetry.trace."
                f"SPAN_NAMES (closed world — declare it there, like the "
                f"metrics registry)"
            )

    def _append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            event.setdefault("pid", self._pid)
            if "tid" not in event:
                event["tid"] = self._tid()
            self._events.append(event)

    @contextmanager
    def span(
        self, name: str, cat: str = "host", **args: Any
    ) -> Iterator[None]:
        """Record the enclosed block as one complete event."""
        if not self.enabled:
            yield
            return
        self._check_name(name, cat)
        ts = self.now_us()
        try:
            yield
        finally:
            self._append(
                {
                    "ph": "X", "name": name, "cat": cat,
                    "ts": round(ts, 1),
                    "dur": round(self.now_us() - ts, 1),
                    **({"args": args} if args else {}),
                }
            )

    def complete_event(
        self,
        name: str,
        dur_ms: float,
        *,
        cat: str = "host",
        ts_us: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record an externally-measured interval. Default timestamp
        places the event so it ENDS now — the natural call shape for
        ``t0 = ...; work(); tracer.complete_event(name, elapsed)``."""
        if not self.enabled:
            return
        self._check_name(name, cat)
        dur_us = max(0.0, float(dur_ms) * 1e3)
        if ts_us is None:
            ts_us = self.now_us() - dur_us
        self._append(
            {
                "ph": "X", "name": name, "cat": cat,
                "ts": round(max(0.0, ts_us), 1), "dur": round(dur_us, 1),
                **({"args": args} if args else {}),
            }
        )

    def instant(
        self, name: str, cat: str = "host", **args: Any
    ) -> None:
        if not self.enabled:
            return
        self._check_name(name, cat)
        self._append(
            {
                "ph": "i", "name": name, "cat": cat, "s": "t",
                "ts": round(self.now_us(), 1),
                **({"args": args} if args else {}),
            }
        )

    # -- export --------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_dict(
        self, other_data: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        other = {"process": self.process_name, "dropped_events": self.dropped}
        if other_data:
            other.update(other_data)
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write(
        self, path: str, other_data: Optional[Dict[str, Any]] = None
    ) -> str:
        """Atomic write of the Chrome-trace JSON; returns ``path``."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(other_data), f)
        os.replace(tmp, path)
        return path


def validate_trace(trace: Dict[str, Any]) -> List[str]:
    """Structural validity of a Chrome-trace dict: every complete event
    has nonnegative ts/dur, and per track (pid, tid) the complete events
    nest properly (an event may contain or follow its predecessor, never
    straddle its boundary) — the property the viewers rely on to build
    the flame stack. Returns human-readable problems (empty = valid)."""
    problems: List[str] = []
    # ts and dur are each rounded to 0.1 us, so edge-to-edge events can
    # overlap by up to ~0.2 us of pure rounding — treat that as adjacency.
    eps = 0.25
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    tracks: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        ts = ev.get("ts", 0)
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur", 0)
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev.get('name')}): negative dur {dur!r}"
                )
                continue
            key = (ev.get("pid"), ev.get("tid"))
            tracks.setdefault(key, []).append((ts, ts + dur, ev.get("name")))
    for key, spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for beg, end, name in spans:
            while stack and beg >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                problems.append(
                    f"track {key}: span {name!r} [{beg:.1f}, {end:.1f}] "
                    f"straddles enclosing {stack[-1][2]!r} "
                    f"(ends {stack[-1][1]:.1f})"
                )
            stack.append((beg, end, name))
    return problems


def test_duration_records(events: List[Dict[str, Any]]) -> Dict[str, dict]:
    """Project ``cat=="test"`` complete events back into the slow-marker
    audit's schema (nodeid -> {"duration": s, "slow": bool}), as the JAX
    package's function of the same name does."""
    records: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "test":
            continue
        args = ev.get("args") or {}
        records[ev["name"]] = {
            "duration": round(ev.get("dur", 0.0) / 1e6, 3),
            "slow": bool(args.get("slow", False)),
        }
    return records
