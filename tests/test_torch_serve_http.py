"""The port's HTTP front end and serving loop over ``StubEngine``: a few
of ``tests/test_serve_http.py``'s cases (generate, the 429 shed, the
drain endpoint, the zombie timeout) and the regression test of the loop's
fair handoff: with a 50 ms decode step, ``cancel()``, ``drain()``,
``submit()``, ``stats()`` and ``health()`` each get the loop's lock within
two steps (JAX's loop re-takes its lock after every step and can starve
them)."""

from __future__ import annotations

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch_ranks

from acco_tpu_torch.serve.engine import StubEngine
from acco_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, GenRequest
from acco_tpu_torch.serve.server import ServingLoop, encode_prompt, serve_http

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


class FakeTokenizer:
    eos_token_id = 0

    def __call__(self, text, **kw):
        return {"input_ids": [ord(c) % 32 for c in text]}

    def decode(self, ids):
        return "".join(chr(65 + (i % 26)) for i in ids)


def _post_raw(port, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


@contextlib.contextmanager
def _server(engine=None, request_timeout_s=30.0, **sched_kw):
    engine = engine or StubEngine(max_slots=2, num_pages=32)
    sched = ContinuousBatchingScheduler(engine, **sched_kw)
    loop = ServingLoop(sched).start()
    httpd = serve_http(loop, FakeTokenizer(), host="127.0.0.1", port=0,
                       request_timeout_s=request_timeout_s)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1], sched, loop
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        loop.stop()


def test_generate_healthz_and_metrics():
    with _server() as (port, sched, loop):
        status, out, _ = _post_raw(port, {"tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 200 and out["tokens"] == [4, 5, 6, 7]
        assert out["finish_reason"] == "length" and out["ttft_ms"] >= 0
        status, out, _ = _post_raw(port, {"prompt": "ab", "max_new_tokens": 2})
        assert status == 200 and out["tokens"] == [3, 4] and out["text"] == "DE"
        status, body = _get(port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ok"] and health["completed"] == 2
        status, text = _get(port, "/metrics")
        assert status == 200 and "acco_serve_ttft_ms_count" in text
        status, out, _ = _post_raw(port, {"tokens": [1], "max_new_tokens": 0})
        assert status == 400
    assert encode_prompt(FakeTokenizer(), "ab") == [1, 2]


def test_shed_queue_full_gets_429_with_retry_after():
    # the first request decodes for ~0.8 s: the other two arrive while it runs
    eng = StubEngine(max_slots=1, num_pages=32, decode_sleep_s=0.05)
    with _server(engine=eng, max_waiting=1, retry_after_s=3.0) as (port, sched, loop):
        results = []

        def hit():
            results.append(_post_raw(port, {"tokens": [1], "max_new_tokens": 16}))

        threads = []
        for _ in range(3):  # 1 active + 1 waiting (the queue full) + 1 shed
            threads.append(threading.Thread(target=hit))
            threads[-1].start()
            deadline = time.time() + 10
            while time.time() < deadline and len(threads) > sum(
                    r is not None for r in sched.slots) + len(sched.waiting) + len(results):
                time.sleep(0.005)  # the arrival was counted: the next may go
        for t in threads:
            t.join(timeout=30)
        statuses = sorted(s for s, _, _ in results)
        assert statuses == [200, 200, 429], statuses
        shed = next(r for r in results if r[0] == 429)
        assert shed[1]["kind"] == "queue_full" and int(shed[2]["Retry-After"]) == 3
        assert sched.allocator.in_use == 0


def test_zombie_timeout_cancels_and_frees_pages():
    eng = StubEngine(max_slots=2, num_pages=32, decode_sleep_s=0.05)
    with _server(engine=eng, request_timeout_s=0.2) as (port, sched, loop):
        status, body, _ = _post_raw(port, {"tokens": [1], "max_new_tokens": 12})
        assert status == 504 and "timed out" in body["error"]
        assert sched.allocator.in_use == 0 and all(s is None for s in sched.slots)
        assert sched.cancelled == 1


def test_drain_endpoint_finishes_in_flight_then_stops():
    eng = StubEngine(max_slots=2, num_pages=32, decode_sleep_s=0.01)
    with _server(engine=eng) as (port, sched, loop):
        results = []
        t = threading.Thread(target=lambda: results.append(
            _post_raw(port, {"tokens": [3], "max_new_tokens": 8})))
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline and not sched.has_work:
            time.sleep(0.005)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/admin/drain", data=json.dumps({"budget_s": 10}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            drain = json.loads(resp.read())
        t.join(timeout=30)
        assert drain["drained"] and drain["in_budget"] and drain["cancelled"] == 0
        status, out, _ = results[0]
        assert status == 200 and out["tokens"] == [4 + k for k in range(8)]
        status, body, headers = _post_raw(port, {"tokens": [1], "max_new_tokens": 2})
        assert status == 503 and body["kind"] == "draining" and "Retry-After" in headers
        status, body = _get(port, "/healthz")
        assert status == 503 and json.loads(body)["state"] == "draining"
        assert not loop._thread.is_alive()
        assert sched.allocator.in_use == 0


def _busy_loop(n_requests=2):
    """A loop decoding long requests at 50 ms a step."""
    eng = StubEngine(max_slots=2, num_pages=256, max_pages_per_seq=64, page_size=4,
                     vocab_size=1000, decode_sleep_s=0.05)
    sched = ContinuousBatchingScheduler(eng, prefills_per_step=2)
    loop = ServingLoop(sched).start()
    reqs = [loop.submit(GenRequest(prompt=[1 + i], max_new_tokens=200))
            for i in range(n_requests)]
    deadline = time.time() + 10
    while time.time() < deadline and sched._step_idx < 2:
        time.sleep(0.01)
    assert sched._step_idx >= 2
    return sched, loop, reqs


def _steps_during(sched, fn):
    """(fn's result, the scheduler steps started while fn ran)."""
    before = sched._step_idx
    out = fn()
    return out, sched._step_idx - before


def test_cancel_and_drain_get_the_lock_within_two_steps():
    """The regression test of the fair handoff: every call below returns
    within two 50 ms decode steps of the loop, five times over."""
    sched, loop, reqs = _busy_loop()
    try:
        for _ in range(5):
            _, steps = _steps_during(sched, loop.stats)
            assert steps <= 2, f"stats() waited {steps} steps"
            _, steps = _steps_during(sched, loop.health)
            assert steps <= 2, f"health() waited {steps} steps"
            extra = GenRequest(prompt=[7], max_new_tokens=200)
            _, steps = _steps_during(sched, lambda: loop.submit(extra))
            assert steps <= 2, f"submit() waited {steps} steps"
            ok, steps = _steps_during(sched, lambda: loop.cancel(extra))
            assert ok and steps <= 2, f"cancel() waited {steps} steps"
        assert all(not r.done.is_set() for r in reqs)  # the loop kept decoding
        summary, steps = _steps_during(sched, lambda: loop.drain(budget_s=0.0))
        assert steps <= 2, f"drain() waited {steps} steps"
        assert summary["cancelled"] == 2 and not summary["in_budget"]
        assert all(r.finish_reason == "drain" for r in reqs)
        assert sched.allocator.in_use == 0 and not loop._thread.is_alive()
    finally:
        loop.stop()


def test_stop_is_idempotent_and_raises_on_wedged_thread():
    sched = ContinuousBatchingScheduler(StubEngine())
    ServingLoop(sched).stop()  # never started: no-op
    loop = ServingLoop(sched).start()
    loop.stop()
    loop.stop()
    assert not loop._thread.is_alive()
    wedged = ServingLoop(sched)
    wedged._thread = threading.Thread(target=lambda: time.sleep(3600), daemon=True)
    wedged._thread.start()
    with pytest.raises(RuntimeError, match="did not exit"):
        wedged.stop(timeout=0.2)
