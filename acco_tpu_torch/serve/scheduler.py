"""Continuous batching: admit/evict per decode step against a page budget.

A copy of ``acco_tpu/serve/scheduler.py`` (framework-free) on the port's
``serve/kv_cache.PageAllocator`` and ``telemetry.metrics``: it drives
``serve/engine.ServeEngine`` (or ``StubEngine``) through the same host
surface, so the engine call logs equal JAX's for the same requests.

The loop shape (one :meth:`ContinuousBatchingScheduler.step` = one engine
decode dispatch, vLLM's iteration-level scheduling):

1. **admit** — up to ``prefills_per_step`` waiting requests whose prompt
   pages fit the free list take a free slot; their prefill runs now,
   interleaved between decode steps, and their first token is sampled
   from the prefill's last-position logits;
2. **grow** — every active request crossing a page boundary gets one new
   page; when the pool is dry, the most-recently-admitted active request
   (possibly the grower itself) is preempted: pages freed, re-queued at
   the FRONT of the waiting queue — LIFO victim choice keeps the oldest
   requests making progress, and the preempted request replays via one
   prefill of its prompt+generated prefix, so no sampled token is ever
   re-sampled;
3. **decode** — one batched step over all slots (inactive slots ride
   along pointed at the null page), then one batched sample with
   per-request temperature/top-k/PRNG state.

Host-side and single-threaded by design: every decision is a free-list
or queue operation between device dispatches, and server.ServingLoop
serializes step() calls.

Serving-resilience layer (the serve half of the trainer's robustness
story — see README "Serving under load"):

- **admission control** — :meth:`submit` sheds instead of queueing when
  the waiting queue is at ``max_waiting`` depth, when KV-pool occupancy
  crosses ``kv_watermark``, or when the scheduler is draining; a shed
  raises :class:`ShedError` (the HTTP layer maps it to 429/503 with
  ``Retry-After``) so overload degrades loudly instead of stacking
  unbounded work behind a dead deadline;
- **deadlines** — a request may carry ``deadline_ms``; every step
  sweeps waiting AND active requests and cancels expired ones (an
  expired waiter is never admitted, an expired active request stops
  consuming decode steps and frees its pages immediately);
- **cancellation** — :meth:`cancel` is the one path that detaches a
  request wherever it is in the lifecycle (waiting: dequeued; active:
  slot cleared, pages freed) and is what the HTTP handler's timeout,
  the deadline sweep, client_abandon chaos, and drain expiry all call —
  a 504'd client can no longer leave a zombie decoding to completion;
- **drain** — ``draining=True`` sheds all new work while in-flight
  requests run to completion (server.ServingLoop.drain owns the budget
  and the final cancellation of stragglers);
- **chaos** — an optional ``fault_injector``
  (resilience.faults.ServeFaultInjector) fires registered serve fault
  kinds at chosen step indices, before the step's admission phase.

Request lifecycle::

    new -> waiting -> active -> finished          (stop | length)
             |          |   \\-> failed           (engine error)
             |          \\-----> cancelled        (deadline | cancelled |
             |                                     abandoned | drain)
             \\----------------> cancelled | shed (never admitted)

A preempted active request goes back to waiting (LIFO victim, exact
replay) — preemption is invisible to the lifecycle's terminal states.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from acco_tpu_torch.serve.kv_cache import PageAllocator
from acco_tpu_torch.telemetry import metrics

_log = logging.getLogger(__name__)


class ShedError(Exception):
    """A submit refused by admission control (load shedding).

    ``kind`` is one of ``queue_full`` (waiting queue at max_waiting),
    ``kv_pressure`` (page-pool occupancy over the watermark), or
    ``draining`` (drain mode rejects all new work). ``retry_after_s``
    is the server's backoff hint (the HTTP layer renders it as a
    ``Retry-After`` header on the 429/503 response).
    """

    def __init__(self, kind: str, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.kind = kind
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass
class GenRequest:
    """One generation request and its full lifecycle state."""

    prompt: list  # token ids (may be left-truncated at submit)
    max_new_tokens: int = 16
    temperature: float = 0.0  # <= 0 -> greedy
    top_k: int = 0  # 0 -> full-vocab sampling
    seed: int = 0
    deadline_ms: Optional[float] = None  # client budget, submit-relative
    rid: int = -1  # assigned at submit
    # -- runtime state (scheduler-owned) --
    generated: list = dataclasses.field(default_factory=list)
    # new -> waiting -> active -> finished | failed | cancelled;
    # shed = refused at submit (see module docstring's state machine)
    status: str = "new"
    slot: Optional[int] = None
    pages: list = dataclasses.field(default_factory=list)
    seq_len: int = 0  # tokens committed to the KV cache
    # 'stop' | 'length' | 'deadline' | 'cancelled' | 'abandoned' | 'drain'
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    preemptions: int = 0
    admit_seq: int = -1  # admission order (eviction picks the newest)
    # telemetry (host wall clocks, perf_counter domain)
    submit_ts: float = 0.0  # set at submit; TTFT/latency anchor
    deadline_ts: Optional[float] = None  # perf_counter deadline, at submit
    ttft_ms: Optional[float] = None  # submit -> first sampled token
    key: Optional[np.ndarray] = None  # per-request PRNG state
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    def expired(self, now: Optional[float] = None) -> bool:
        return (
            self.deadline_ts is not None
            and (time.perf_counter() if now is None else now) >= self.deadline_ts
        )

    def cache_prefix(self) -> list:
        """The tokens a prefill must commit: everything except the last
        sampled token (which is the next decode step's input). Fresh
        requests have no generated tokens — the whole prompt."""
        if self.generated:
            return self.prompt + self.generated[:-1]
        return self.prompt


class ContinuousBatchingScheduler:
    def __init__(
        self,
        engine,
        *,
        prefills_per_step: int = 1,
        eos_token_id: Optional[int] = None,
        max_waiting: Optional[int] = None,
        kv_watermark: Optional[float] = None,
        retry_after_s: float = 1.0,
        fault_injector=None,
        log=None,
        tracer=None,
    ):
        self.engine = engine
        self.log = log or _log
        # Optional span tracer (telemetry/trace.py): prefill / decode /
        # whole-request events on the serving-loop thread. Latency
        # metrics (TTFT, decode step, request latency) always go to the
        # global registry — the /metrics endpoint renders them.
        self.tracer = tracer
        self.prefills_per_step = int(prefills_per_step)
        self.eos_token_id = (
            eos_token_id if eos_token_id is not None else engine.eos_token_id
        )
        self.allocator = PageAllocator(engine.num_pages)
        if self.allocator.available < engine.max_pages_per_seq:
            raise ValueError(
                f"page pool ({self.allocator.available} allocatable) cannot "
                f"hold even one max-length sequence "
                f"({engine.max_pages_per_seq} pages) — a request could "
                "never finish"
            )
        # -- admission control (None disables each guard) --
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        if self.max_waiting is not None and self.max_waiting < 1:
            raise ValueError(f"max_waiting must be >= 1, got {max_waiting}")
        self.kv_watermark = None if kv_watermark is None else float(kv_watermark)
        if self.kv_watermark is not None and not 0.0 < self.kv_watermark <= 1.0:
            raise ValueError(
                f"kv_watermark must be in (0, 1], got {kv_watermark}"
            )
        self.retry_after_s = float(retry_after_s)
        self.draining = False
        # Optional serve-side chaos (resilience.faults.ServeFaultInjector):
        # fired at the top of step(), before admission, on the loop thread.
        self.fault_injector = fault_injector
        self.waiting: deque = deque()
        self.slots: list = [None] * engine.max_slots
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        self._step_idx = 0  # 0-based count of step() calls (chaos anchor)
        self.completed = 0
        self.cancelled = 0
        self.shed = 0

    # -- intake -------------------------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        if not req.prompt:
            raise ValueError("empty prompt")
        req.rid = next(self._rid)
        req.submit_ts = time.perf_counter()
        if req.deadline_ms is not None:
            req.deadline_ts = req.submit_ts + float(req.deadline_ms) / 1e3
        metrics.emit("serve_requests_total", 1)
        # -- admission control: shed BEFORE any state is taken ----------
        if self.draining:
            self._shed(req, "draining", "server is draining")
        if (
            self.max_waiting is not None
            and len(self.waiting) >= self.max_waiting
        ):
            self._shed(
                req, "queue_full",
                f"waiting queue at max depth {self.max_waiting}",
            )
        if self.fault_injector is not None and not self.has_work:
            # a kv_exhaust hold with no request left to run would wait for
            # a step that never comes (every submit shed for KV pressure):
            # released here, where JAX's copy keeps it until the drain
            self.fault_injector.release_idle(self)
        if (
            self.kv_watermark is not None
            and self.kv_occupancy >= self.kv_watermark
        ):
            self._shed(
                req, "kv_pressure",
                f"KV pool occupancy {self.kv_occupancy:.2f} over "
                f"watermark {self.kv_watermark:.2f}",
            )
        # keep at least one position free for generation; the engine's
        # top bucket covers max_context so any kept tail prefills
        keep = min(len(req.prompt), self.engine.max_context - 1)
        if keep < len(req.prompt):
            req.prompt = list(req.prompt[-keep:])
        req.max_new_tokens = min(
            int(req.max_new_tokens),
            self.engine.max_context - len(req.prompt),
        )
        if req.max_new_tokens <= 0:
            req.status = "finished"
            req.finish_reason = "length"
            req.done.set()
            return req
        req.key = self.engine.make_key(req.seed)
        req.status = "waiting"
        self.waiting.append(req)
        return req

    def _shed(self, req: GenRequest, kind: str, why: str) -> None:
        req.status = "shed"
        req.finish_reason = "shed"
        req.error = why
        req.done.set()
        self.shed += 1
        metrics.emit("serve_shed_total", 1)
        raise ShedError(kind, why, retry_after_s=self.retry_after_s)

    @property
    def kv_occupancy(self) -> float:
        """Fraction of the allocatable page pool currently in use."""
        total = self.allocator.in_use + self.allocator.available
        return self.allocator.in_use / total if total else 1.0

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def drain_mode(self) -> None:
        """Reject all new submissions (drain); in-flight work continues.
        ServingLoop.drain() owns the budget and the final stop."""
        if not self.draining:
            self.draining = True
            self.log.info("scheduler draining: new submissions are shed")

    def stats(self) -> dict:
        snap = {
            "waiting": len(self.waiting),
            "active": sum(r is not None for r in self.slots),
            "slots_free": sum(r is None for r in self.slots),
            "pages_free": self.allocator.available,
            "pages_in_use": self.allocator.in_use,
            "kv_occupancy": round(self.kv_occupancy, 4),
            "completed": self.completed,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "draining": self.draining,
            **self.engine.counters,
        }
        # refresh the occupancy gauges at every stats() read — the
        # /metrics endpoint calls this right before rendering
        metrics.emit_many({
            "serve_waiting": snap["waiting"],
            "serve_active": snap["active"],
            "serve_slots_free": snap["slots_free"],
            "serve_pages_free": snap["pages_free"],
            "serve_pages_in_use": snap["pages_in_use"],
        })
        return snap

    # -- the step -----------------------------------------------------------

    def step(self) -> list:
        """One scheduling iteration; returns the requests that resolved
        (finished, or cancelled by the deadline sweep)."""
        step_idx = self._step_idx
        self._step_idx += 1
        if self.fault_injector is not None:
            # chaos fires before admission so a fault at step N shapes
            # the whole iteration (an engine_raise propagates to the
            # loop's fail_all path, exactly like a real engine error)
            self.fault_injector.before_step(self, step_idx)
        resolved = self._expire_deadlines()
        resolved.extend(self._admit())
        resolved.extend(self._decode())
        return resolved

    def _expire_deadlines(self) -> list:
        """Cancel every waiting/active request whose deadline passed:
        an expired waiter is never admitted (no prefill wasted), an
        expired active request frees its pages and stops consuming
        decode steps NOW, not when the client notices."""
        now = time.perf_counter()
        expired = [
            r for r in list(self.waiting) if r.expired(now)
        ] + [
            r for r in self.slots if r is not None and r.expired(now)
        ]
        for req in expired:
            self.cancel(req, reason="deadline")
        return expired

    def _admit(self) -> list:
        finished = []
        admitted = 0
        while self.waiting and admitted < self.prefills_per_step:
            free_slots = [i for i, r in enumerate(self.slots) if r is None]
            if not free_slots:
                break
            req = self.waiting[0]
            if req.expired():
                # expired between the sweep and here — still never admit
                self.cancel(req, reason="deadline")
                finished.append(req)
                continue
            prefix = req.cache_prefix()
            n_pages = max(1, math.ceil(len(prefix) / self.engine.page_size))
            pages = self.allocator.alloc(n_pages)
            if pages is None:
                break  # head-of-line: eviction only serves ACTIVE growth
            self.waiting.popleft()
            t_prefill = time.perf_counter()
            logits = self.engine.prefill(prefix, pages)
            prefill_ms = (time.perf_counter() - t_prefill) * 1e3
            metrics.emit("serve_prefill_ms", prefill_ms)
            if self.tracer is not None:
                self.tracer.complete_event(
                    "serve/prefill", prefill_ms, cat="serve",
                    args={"rid": req.rid, "tokens": len(prefix)},
                )
            req.slot = free_slots[0]
            req.pages = pages
            req.seq_len = len(prefix)
            req.status = "active"
            req.admit_seq = next(self._admit_seq)
            self.slots[req.slot] = req
            admitted += 1
            if not req.generated:
                # fresh request: its first token comes from the prefill
                toks, new_key = self.engine.sample(
                    logits[None, :],
                    req.key[None, :],
                    np.asarray([req.temperature], np.float32),
                    np.asarray([req.top_k], np.int32),
                )
                req.key = new_key[0]
                tok = int(toks[0])
                # TTFT: a FRESH request's first token is this prefill
                # sample (a preempted replay re-feeds, never re-samples,
                # so its TTFT stays the original one)
                if req.ttft_ms is None and req.submit_ts > 0:
                    req.ttft_ms = (time.perf_counter() - req.submit_ts) * 1e3
                    metrics.emit("serve_ttft_ms", req.ttft_ms)
                reason = self._finish_reason_for(req, tok)
                if reason != "stop":
                    req.generated.append(tok)
                if reason:
                    self._finish(req, reason)
                    finished.append(req)
            # resumed (preempted) requests replay their prefix only: the
            # last sampled token is already in req.generated and becomes
            # the next decode step's input — nothing is re-sampled
        return finished

    def _decode(self) -> list:
        self._grow()
        active = [
            (s, r) for s, r in enumerate(self.slots) if r is not None
        ]
        if not active:
            return []
        t_step = time.perf_counter()
        r_slots = self.engine.max_slots
        pmax = self.engine.max_pages_per_seq
        page_table = np.zeros((r_slots, pmax), np.int32)
        seq_lens = np.zeros((r_slots,), np.int32)
        tokens = np.zeros((r_slots,), np.int32)
        temps = np.zeros((r_slots,), np.float32)
        top_ks = np.zeros((r_slots,), np.int32)
        keys = np.zeros((r_slots, 2), np.uint32)
        for s, req in active:
            page_table[s, : len(req.pages)] = req.pages
            seq_lens[s] = req.seq_len
            tokens[s] = req.generated[-1]
            temps[s] = req.temperature
            top_ks[s] = req.top_k
            keys[s] = req.key
        logits = self.engine.decode(page_table, seq_lens, tokens)
        toks, new_keys = self.engine.sample(logits, keys, temps, top_ks)
        finished = []
        for s, req in active:
            req.seq_len += 1  # the fed token's K/V row is now committed
            req.key = new_keys[s]
            tok = int(toks[s])
            reason = self._finish_reason_for(req, tok)
            if reason != "stop":
                req.generated.append(tok)
            if reason:
                self._finish(req, reason)
                finished.append(req)
        step_ms = (time.perf_counter() - t_step) * 1e3
        metrics.emit("serve_decode_step_ms", step_ms)
        if self.tracer is not None:
            self.tracer.complete_event(
                "serve/decode_step", step_ms, cat="serve",
                args={"active": len(active)},
            )
        return finished

    def _grow(self) -> None:
        """Give every active request crossing a page boundary its next
        page, preempting the newest OTHER request when the pool is dry."""
        for req in sorted(
            (r for r in self.slots if r is not None),
            key=lambda r: r.admit_seq,
        ):
            if req.slot is None or self.slots[req.slot] is not req:
                continue  # already preempted this pass
            if req.seq_len < len(req.pages) * self.engine.page_size:
                continue
            while True:
                pages = self.allocator.alloc(1)
                if pages is not None:
                    req.pages.extend(pages)
                    break
                # victim = the newest-admitted active request, INCLUDING
                # the grower: a newer request never steals pages from an
                # older one (it yields itself instead), so the oldest
                # requests always make progress and starvation is
                # impossible; the ctor's capacity invariant guarantees a
                # lone request can always regrow to max length
                victim = max(
                    (r for r in self.slots if r is not None),
                    key=lambda r: r.admit_seq,
                )
                self._preempt(victim)
                if victim is req:
                    break  # req yielded; it replays via prefill later

    def _preempt(self, req: GenRequest) -> None:
        self.log.info(
            "preempting rid=%d (seq_len=%d, %d pages) — page pool dry",
            req.rid, req.seq_len, len(req.pages),
        )
        self.allocator.free(req.pages)
        req.pages = []
        self.slots[req.slot] = None
        req.slot = None
        req.seq_len = 0
        req.status = "waiting"
        req.preemptions += 1
        metrics.emit("serve_preemptions_total", 1)
        self.waiting.appendleft(req)

    def _finish_reason_for(self, req: GenRequest, tok: int) -> Optional[str]:
        if self.eos_token_id is not None and tok == self.eos_token_id:
            return "stop"  # EOS is consumed, not emitted
        if len(req.generated) + 1 >= req.max_new_tokens:
            return "length"  # this token (appended by the caller) is the last
        return None

    def _finish(self, req: GenRequest, reason: str) -> None:
        self.allocator.free(req.pages)
        req.pages = []
        if req.slot is not None:
            self.slots[req.slot] = None
        req.slot = None
        req.status = "finished"
        req.finish_reason = reason
        self.completed += 1
        metrics.emit("serve_completed_total", 1)
        metrics.emit("serve_tokens_total", len(req.generated))
        if req.submit_ts > 0:
            latency_ms = (time.perf_counter() - req.submit_ts) * 1e3
            metrics.emit("serve_request_latency_ms", latency_ms)
            if self.tracer is not None:
                self.tracer.complete_event(
                    "serve/request", latency_ms, cat="serve",
                    args={
                        "rid": req.rid,
                        "reason": reason,
                        "tokens": len(req.generated),
                        "preemptions": req.preemptions,
                    },
                )
        req.done.set()

    def cancel(self, req: GenRequest, reason: str = "cancelled") -> bool:
        """Detach ``req`` from the scheduler wherever it is and resolve
        it as ``cancelled`` (reason: 'cancelled' | 'deadline' |
        'abandoned' | 'drain'). Frees KV pages, clears the slot,
        removes it from the waiting queue. Returns False when the
        request already resolved (finished/failed/cancelled/shed) —
        cancellation races are first-resolution-wins.

        Must run on the thread that owns the scheduler (the serving
        loop's condition serializes ServingLoop.cancel with step()).
        """
        if req.done.is_set():
            return False
        if req.status == "waiting":
            try:
                self.waiting.remove(req)
            except ValueError:
                pass  # submitted but raced out of the queue
        if req.pages:
            self.allocator.free(req.pages)
            req.pages = []
        if req.slot is not None and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        req.slot = None
        req.status = "cancelled"
        req.finish_reason = reason
        self.cancelled += 1
        metrics.emit("serve_cancelled_total", 1)
        if reason == "deadline":
            metrics.emit("serve_deadline_expired_total", 1)
        self.log.info(
            "cancelled rid=%d (%s): %d tokens generated, pages freed",
            req.rid, reason, len(req.generated),
        )
        if self.tracer is not None and req.submit_ts > 0:
            self.tracer.complete_event(
                "serve/request",
                (time.perf_counter() - req.submit_ts) * 1e3,
                cat="serve",
                args={"rid": req.rid, "reason": reason,
                      "tokens": len(req.generated)},
            )
        req.done.set()
        return True

    def fail_all(self, error: str) -> list:
        """Abort every in-flight request (serving-loop fatal error)."""
        failed = []
        for req in list(self.waiting):
            req.status = "failed"
            req.error = error
            req.done.set()
            failed.append(req)
        self.waiting.clear()
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            self.allocator.free(req.pages)
            req.pages = []
            self.slots[s] = None
            req.status = "failed"
            req.error = error
            req.done.set()
            failed.append(req)
        if failed:
            metrics.emit("serve_failed_total", len(failed))
        return failed
