"""Stdlib HTTP front end + the background serving loop.

A copy of ``acco_tpu/serve/server.py`` with one difference: the loop
hands its lock over fairly. JAX's loop re-takes its condition right
after each ``scheduler.step()``, so a thread blocked in ``cancel``,
``drain``, ``submit``, ``stats`` or ``health`` can wait many steps. Here
each of those counts itself as a waiter before it blocks on the lock,
and the loop does not start its next step while a waiter is pending: a
caller gets the lock before the next step, after at most the one in
flight. Steps and scheduler mutations stay serialized. The routes and
their status codes are JAX's; a 200 from ``/generate`` also carries the
request's ``ttft_ms`` (the load harness reads it in ``--url`` mode).

No web framework (the container bakes nothing in): ``http.server``'s
ThreadingHTTPServer handles connections, each handler thread submits a
GenRequest and blocks on its ``done`` event, and ONE background
ServingLoop thread drives the scheduler — handler threads never touch
the engine, so the device programs stay single-dispatcher.

Endpoints::

    POST /generate  {"prompt": str | "tokens": [int], "max_new_tokens",
                     "temperature", "top_k", "seed", "deadline_ms"}
        -> 200 {"text", "tokens", "n_generated", "finish_reason",
                "preemptions", "rid"}
        -> 400 invalid inputs (reason in "error"); 429/503 shed by
           admission control (Retry-After header); 503 cancelled by
           drain/chaos; 504 handler timeout or deadline exceeded —
           in every non-200 case the request is CANCELLED in the
           scheduler (pages freed), never left decoding as a zombie
    GET  /healthz   -> {"ok", "state": ok|degraded|draining, "model",
                        scheduler stats...}; "degraded" reports
                        before-dead pressure (a new request would shed);
                        draining answers 503 so balancers rotate out
    GET  /metrics   -> Prometheus text exposition (0.0.4) of the global
                       telemetry registry: request/TTFT/decode-latency
                       histograms, occupancy gauges, counters
    POST /admin/drain {"budget_s": float?}
        -> run the graceful drain: shed new work, let in-flight requests
           finish within the budget, cancel stragglers, stop the loop;
           responds with the drain summary once the loop has exited
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from acco_tpu_torch.serve.scheduler import GenRequest, ShedError
from acco_tpu_torch.telemetry import REGISTRY, metrics

_log = logging.getLogger(__name__)


def encode_prompt(tokenizer, text: str) -> list:
    """Tokenize one prompt to a flat id list. HF tokenizers return flat
    ids for a single string; the byte-level fallback always batches —
    normalize both."""
    ids = tokenizer(text)["input_ids"]
    if ids and isinstance(ids[0], (list, tuple)):
        ids = ids[0]
    return [int(t) for t in ids]


class ServingLoop:
    """One thread calling scheduler.step() whenever there is work.

    submit() is the only cross-thread intake; a condition variable wakes
    the loop on new work and serializes scheduler access (cancel(),
    drain(), stats() and health() take the same lock, through
    :meth:`_locked`, so every scheduler mutation happens between steps).
    The loop yields to pending callers before each step (see the module
    docstring). A step that raises fails all in-flight requests (each
    handler gets the error) and keeps the loop alive for the next submit.
    """

    def __init__(self, scheduler, log=None):
        self.scheduler = scheduler
        self.log = log or _log
        self._cond = threading.Condition()
        # callers blocked on (or about to take) _cond; the loop waits for
        # none before it starts a step
        self._waiters = 0
        self._waiters_cond = threading.Condition(threading.Lock())
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="acco-serve-loop", daemon=True
        )

    def start(self) -> "ServingLoop":
        self._thread.start()
        return self

    def _acquire(self, timeout: float = -1) -> bool:
        """Take the loop's lock as a counted waiter: the loop starts no
        step while the count is nonzero."""
        with self._waiters_cond:
            self._waiters += 1
        try:
            return self._cond.acquire(timeout=timeout)
        finally:
            with self._waiters_cond:
                self._waiters -= 1
                if not self._waiters:
                    self._waiters_cond.notify_all()

    @contextlib.contextmanager
    def _locked(self):
        self._acquire()
        try:
            yield
        finally:
            self._cond.release()

    def submit(self, req: GenRequest) -> GenRequest:
        """Submit one request. Raises scheduler.ShedError when admission
        control refuses it (queue full / KV pressure / draining)."""
        with self._locked():
            self.scheduler.submit(req)
            self._cond.notify()
        return req

    def cancel(self, req: GenRequest, reason: str = "cancelled") -> bool:
        """Cancel a request in the scheduler (pages freed, slot cleared).
        Serialized with step() by the loop lock; returns False when the
        request already resolved."""
        with self._locked():
            return self.scheduler.cancel(req, reason=reason)

    def stats(self) -> dict:
        with self._locked():
            return self.scheduler.stats()

    def health(self) -> dict:
        """Scheduler stats plus a coarse state: ``draining`` when drain
        mode is on, ``degraded`` when a new request would currently be
        shed (queue at depth or pool over the watermark) — the
        degraded-before-dead signal for balancers and probes."""
        with self._locked():
            sched = self.scheduler
            stats = sched.stats()
            if sched.draining:
                state = "draining"
            elif (
                sched.max_waiting is not None
                and stats["waiting"] >= sched.max_waiting
            ) or (
                sched.kv_watermark is not None
                and sched.kv_occupancy >= sched.kv_watermark
            ):
                state = "degraded"
            else:
                state = "ok"
        stats["state"] = state
        stats["ok"] = state == "ok"
        return stats

    def drain(self, budget_s: float = 30.0) -> dict:
        """Graceful drain, mirroring the trainer's preemption contract:
        (1) shed all new work, (2) let in-flight requests finish within
        ``budget_s``, (3) cancel the stragglers (reason='drain', pages
        freed, handlers unblocked), (4) stop the loop thread. Idempotent;
        returns a summary dict."""
        t0 = time.perf_counter()
        with self._locked():
            already = self.scheduler.draining
            self.scheduler.drain_mode()
            self._cond.notify()
        if not already:
            metrics.emit("serve_drains_total", 1)
        deadline = t0 + float(budget_s)
        while time.perf_counter() < deadline:
            with self._locked():
                if not self.scheduler.has_work:
                    break
            time.sleep(0.02)
        cancelled = 0
        with self._locked():
            leftovers = [r for r in self.scheduler.waiting] + [
                r for r in self.scheduler.slots if r is not None
            ]
            for req in leftovers:
                cancelled += bool(self.scheduler.cancel(req, reason="drain"))
        drain_ms = (time.perf_counter() - t0) * 1e3
        metrics.emit("serve_drain_ms", drain_ms)
        self.stop()
        summary = {
            "drained": True,
            "in_budget": cancelled == 0,
            "cancelled": cancelled,
            "drain_ms": round(drain_ms, 3),
            "budget_s": float(budget_s),
        }
        self.log.info("drain complete: %s", summary)
        return summary

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the loop thread and JOIN it. A loop thread that does not
        exit within ``timeout`` is a leak the resilience contract says
        must be loud: log an error and raise RuntimeError instead of
        silently abandoning it. Idempotent once the thread has exited."""
        if self._thread.ident is None or not self._thread.is_alive():
            self._stop = True
            return  # never started, or already exited
        # A wedged step() holds the lock; bound the acquire so a stuck
        # loop cannot also wedge its own shutdown path.
        acquired = self._acquire(timeout=min(float(timeout), 5.0))
        try:
            self._stop = True
            if acquired:
                self._cond.notify_all()
        finally:
            if acquired:
                self._cond.release()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self.log.error(
                "serving loop thread failed to exit within %.1fs — the "
                "scheduler step is wedged (engine hang?); the thread is "
                "LEAKED and the process should be considered unhealthy",
                timeout,
            )
            raise RuntimeError(
                f"serving loop thread did not exit within {timeout}s"
            )

    def _run(self) -> None:
        while True:
            with self._waiters_cond:
                # the fair handoff: pending callers take the lock first
                while self._waiters and not self._stop:
                    self._waiters_cond.wait(timeout=0.5)
            with self._cond:
                while not self._stop and not self.scheduler.has_work:
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    return
                try:
                    finished = self.scheduler.step()
                except Exception as exc:  # fail loudly per-request,
                    # keep serving the next ones
                    self.log.exception("serving step failed")
                    self.scheduler.fail_all(f"{type(exc).__name__}: {exc}")
                    continue
            for req in finished:
                self.log.info(
                    "rid=%d done: %d tokens, finish=%s, preemptions=%d",
                    req.rid, len(req.generated), req.finish_reason,
                    req.preemptions,
                )


def validate_generate_body(body: dict, engine, defaults: dict):
    """Validate and normalize one /generate body against the engine's
    static limits. Returns ``(kwargs_for_GenRequest, None)`` on success
    or ``(None, reason)`` for a 400 — absurd inputs are refused HERE,
    before they take a queue slot or reach a compiled program."""
    try:
        max_new = int(body.get("max_new_tokens", defaults["max_new_tokens"]))
        temperature = float(body.get("temperature", defaults["temperature"]))
        top_k = int(body.get("top_k", defaults["top_k"]))
        seed = int(body.get("seed", 0))
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
    except (TypeError, ValueError) as exc:
        return None, f"non-numeric sampling parameter: {exc}"
    if max_new < 1:
        return None, f"max_new_tokens must be >= 1, got {max_new}"
    if max_new > engine.max_context:
        return None, (
            f"max_new_tokens {max_new} exceeds the engine's max_context "
            f"{engine.max_context}"
        )
    if not math.isfinite(temperature):
        return None, f"temperature must be finite, got {temperature}"
    if top_k < 0:
        return None, f"top_k must be >= 0, got {top_k}"
    if deadline_ms is not None and not (
        math.isfinite(deadline_ms) and deadline_ms > 0
    ):
        return None, f"deadline_ms must be a positive number, got {deadline_ms}"
    return {
        "max_new_tokens": max_new,
        "temperature": temperature,
        "top_k": top_k,
        "seed": seed,
        "deadline_ms": deadline_ms,
    }, None


def _make_handler(loop: ServingLoop, tokenizer, model_name: str,
                  defaults: dict, timeout_s: float,
                  drain_budget_s: float = 30.0):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            _log.debug("http: " + fmt, *args)

        def _json(self, code: int, payload: dict,
                  headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _text(self, code: int, body: str,
                  content_type: str = "text/plain; version=0.0.4") -> None:
            raw = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path == "/healthz":
                health = loop.health()
                code = 503 if health["state"] == "draining" else 200
                return self._json(code, {"model": model_name, **health})
            if self.path == "/metrics":
                # stats() refreshes the occupancy gauges under the loop
                # lock before the registry renders them
                loop.stats()
                return self._text(200, REGISTRY.to_prometheus_text())
            return self._json(404, {"error": "unknown path"})

        def _read_body(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}"), None
            except (ValueError, json.JSONDecodeError) as exc:
                return None, f"bad JSON: {exc}"

        def do_POST(self):
            if self.path == "/admin/drain":
                body, err = self._read_body()
                if err:
                    return self._json(400, {"error": err})
                budget = float(body.get("budget_s", drain_budget_s))
                return self._json(200, loop.drain(budget_s=budget))
            if self.path != "/generate":
                return self._json(404, {"error": "unknown path"})
            body, err = self._read_body()
            if err:
                return self._json(400, {"error": err})
            if "tokens" in body:
                try:
                    tokens = [int(t) for t in body["tokens"]]
                except (TypeError, ValueError):
                    return self._json(400, {"error": "non-integer tokens"})
            elif "prompt" in body:
                tokens = encode_prompt(tokenizer, body["prompt"])
            else:
                return self._json(400, {"error": "need 'prompt' or 'tokens'"})
            if not tokens:
                return self._json(400, {"error": "empty prompt"})
            engine = loop.scheduler.engine
            if len(tokens) > engine.max_prefill_len:
                return self._json(400, {"error": (
                    f"prompt of {len(tokens)} tokens exceeds the largest "
                    f"prefill bucket {engine.max_prefill_len}"
                )})
            kwargs, reason = validate_generate_body(body, engine, defaults)
            if kwargs is None:
                return self._json(400, {"error": reason})
            req = GenRequest(prompt=tokens, **kwargs)
            try:
                loop.submit(req)
            except ShedError as shed:
                code = 429 if shed.kind == "queue_full" else 503
                return self._json(
                    code,
                    {"error": str(shed), "kind": shed.kind},
                    headers={
                        "Retry-After":
                        str(max(1, int(math.ceil(shed.retry_after_s))))
                    },
                )
            # the handler's wait shrinks to the client deadline (plus
            # slack for the scheduler's own sweep to fire first — the
            # scheduler owns deadline cancellation, this is the backstop)
            wait_s = timeout_s
            if kwargs["deadline_ms"] is not None:
                wait_s = min(wait_s, kwargs["deadline_ms"] / 1e3 + 1.0)
            if not req.done.wait(timeout=wait_s):
                # zombie-request fix: a timed-out handler CANCELS the
                # request in the scheduler (pages freed, decode stopped)
                # instead of abandoning it to run to completion
                loop.cancel(req, reason="cancelled")
                return self._json(504, {
                    "error": "generation timed out", "rid": req.rid,
                })
            if req.status == "failed":
                return self._json(500, {"error": req.error})
            if req.status == "cancelled":
                if req.finish_reason == "deadline":
                    return self._json(504, {
                        "error": "deadline exceeded", "rid": req.rid,
                        "n_generated": len(req.generated),
                    })
                return self._json(503, {
                    "error": f"request cancelled ({req.finish_reason})",
                    "rid": req.rid,
                })
            self._json(200, {
                "text": tokenizer.decode(req.generated),
                "tokens": req.generated,
                "n_generated": len(req.generated),
                "finish_reason": req.finish_reason,
                "preemptions": req.preemptions,
                "rid": req.rid,
                "ttft_ms": req.ttft_ms,
            })

    return Handler


def serve_http(
    loop: ServingLoop,
    tokenizer,
    *,
    host: str = "127.0.0.1",
    port: int = 8700,
    model_name: str = "",
    defaults: dict | None = None,
    request_timeout_s: float = 300.0,
    drain_budget_s: float = 30.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; caller runs serve_forever()
    or drives it from a thread (tests)."""
    defaults = {
        "max_new_tokens": 32, "temperature": 0.0, "top_k": 0,
        **(defaults or {}),
    }
    handler = _make_handler(
        loop, tokenizer, model_name, defaults, request_timeout_s,
        drain_budget_s=drain_budget_s,
    )
    return ThreadingHTTPServer((host, port), handler)
