"""The port's continuous-batching scheduler and serve fault drills on
``StubEngine`` (no model, no device): the same request script through
the port's and JAX's schedulers gives identical engine call logs and
outputs (preemption and exact replay, EOS, cancellation, admission
control), and each serve fault kind acts as in
``tests/test_serve_faults.py``."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch_ranks

from acco_tpu_torch.resilience.faults import (
    SERVE_FAULT_KINDS,
    ServeFaultInjector,
    ServeFaultSpec,
    parse_serve_fault_specs,
)
from acco_tpu_torch.serve.engine import StubEngine, default_buckets
from acco_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, GenRequest, ShedError
from acco_tpu_torch.telemetry import REGISTRY

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


def run_until_done(sched, reqs, max_steps=200):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            return
        sched.step()
    raise AssertionError(
        f"not done after {max_steps} steps: "
        f"{[(r.rid, r.status, len(r.generated)) for r in reqs]}"
    )


def _script(engine_cls, sched_cls, req_cls, shed_cls):
    """One request script; returns (engine call log, outcomes, stats).
    A pool of 7 allocatable pages for requests growing to 4 pages each
    forces preemptions and replays; r3 stops on EOS; r4 is cancelled while
    it waits; r5 is shed by the full queue."""
    eng = engine_cls(page_size=4, num_pages=8, max_pages_per_seq=4, max_slots=3,
                     vocab_size=32, eos_token_id=31)
    sched = sched_cls(eng, prefills_per_step=1, max_waiting=3)
    reqs = [
        req_cls(prompt=[1, 2, 3, 4], max_new_tokens=12),
        req_cls(prompt=[5, 6, 7], max_new_tokens=12),
        req_cls(prompt=[26, 27], max_new_tokens=12),  # 28, 29, 30, then EOS 31
    ]
    for r in reqs:
        sched.submit(r)
    sched.step()
    waiting = req_cls(prompt=[9], max_new_tokens=4)
    sched.submit(waiting)
    shed = None
    for _ in range(2):
        sched.step()
    sched.submit(req_cls(prompt=[10], max_new_tokens=4))
    sched.submit(req_cls(prompt=[11], max_new_tokens=4))
    try:
        sched.submit(req_cls(prompt=[12], max_new_tokens=4))
    except shed_cls as exc:
        shed = exc.kind
    sched.cancel(waiting)
    everything = reqs + [r for r in sched.waiting]
    run_until_done(sched, everything)
    log = []
    for call in eng.calls:
        log.append((call[0],) + tuple(np.asarray(x).tolist() for x in call[1:]))  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    outcomes = [(r.rid, r.status, r.finish_reason, r.generated, r.preemptions)
                for r in everything + [waiting]]
    stats = sched.stats()
    return log, outcomes, (stats, shed, sched.allocator.in_use)


def test_scheduler_call_log_equals_jax():
    from acco_tpu.serve.engine import StubEngine as JaxStub
    from acco_tpu.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler
    from acco_tpu.serve.scheduler import GenRequest as JaxRequest
    from acco_tpu.serve.scheduler import ShedError as JaxShed

    jax_log, jax_out, jax_stats = _script(JaxStub, JaxScheduler, JaxRequest, JaxShed)
    log, out, stats = _script(StubEngine, ContinuousBatchingScheduler, GenRequest, ShedError)
    assert log == jax_log
    assert out == jax_out
    assert stats == jax_stats
    # the script exercised what it is for
    assert any(o[4] >= 1 for o in out)  # a preemption, replayed exactly
    assert any(o[2] == "stop" for o in out)
    assert stats[1] == "queue_full" and stats[2] == 0


def test_default_buckets_and_stub_as_jax():
    from acco_tpu.serve.engine import default_buckets as jax_buckets

    for page, ctx in ((4, 32), (8, 48), (16, 16), (16, 4096)):
        assert default_buckets(page, ctx) == jax_buckets(page, ctx)


def test_eviction_preempts_newest_and_replays_exactly():
    eng = StubEngine(page_size=4, num_pages=6, max_pages_per_seq=4, max_slots=2)
    sched = ContinuousBatchingScheduler(eng, prefills_per_step=1)
    r1 = GenRequest(prompt=[1, 2, 3, 4], max_new_tokens=12)
    r2 = GenRequest(prompt=[5, 6, 7, 8], max_new_tokens=12)
    sched.submit(r1)
    sched.submit(r2)
    run_until_done(sched, [r1, r2])
    assert r1.generated == list(range(5, 17))
    assert r2.generated == list(range(9, 21))
    assert r1.preemptions == 0 and r2.preemptions >= 1
    prefills = [c for c in eng.calls if c[0] == "prefill"]
    assert len(prefills) == 2 + r2.preemptions
    assert sched.allocator.in_use == 0


def test_deadline_and_cancel_free_pages():
    eng = StubEngine(max_slots=2, num_pages=32)
    sched = ContinuousBatchingScheduler(eng)
    late = sched.submit(GenRequest(prompt=[1], max_new_tokens=20, deadline_ms=1.0))
    live = sched.submit(GenRequest(prompt=[3], max_new_tokens=20))
    sched.step()
    time.sleep(0.01)
    sched.step()
    assert late.status == "cancelled" and late.finish_reason == "deadline"
    assert sched.cancel(live) and not sched.cancel(live)  # first resolution wins
    assert live.finish_reason == "cancelled"
    assert sched.allocator.in_use == 0 and all(s is None for s in sched.slots)
    sched.drain_mode()
    with pytest.raises(ShedError) as exc:
        sched.submit(GenRequest(prompt=[1]))
    assert exc.value.kind == "draining"


# -- the serve fault drills (tests/test_serve_faults.py on the port) ----------


def _injected_count():
    return REGISTRY.value("serve_faults_injected_total")


def test_registry_has_all_serve_kinds():
    assert {"engine_raise", "slow_decode", "kv_exhaust", "client_abandon"} <= set(SERVE_FAULT_KINDS)


def test_parse_serve_fault_specs():
    assert parse_serve_fault_specs(None) == []
    assert parse_serve_fault_specs("") == []
    specs = parse_serve_fault_specs("kv_exhaust@3, client_abandon@5")
    assert [(s.kind, s.step) for s in specs] == [("kv_exhaust", 3), ("client_abandon", 5)]
    specs = parse_serve_fault_specs([{"kind": "slow_decode", "step": 2, "seconds": 0.5}])
    assert specs[0].params == {"seconds": 0.5}
    with pytest.raises(ValueError, match="unknown serve fault"):
        parse_serve_fault_specs("meteor_strike@1")
    with pytest.raises(ValueError, match="kind@step"):
        parse_serve_fault_specs("engine_raise")
    with pytest.raises(ValueError, match="step must be >= 0"):
        ServeFaultSpec("engine_raise", -1)


def test_injector_from_env(monkeypatch):
    monkeypatch.setenv(ServeFaultInjector.ENV_VAR, "client_abandon@3")
    inj = ServeFaultInjector.from_env()
    assert inj is not None and len(inj.specs) == 1
    monkeypatch.delenv(ServeFaultInjector.ENV_VAR)
    assert ServeFaultInjector.from_env() is None


def test_engine_raise_fires_once_then_recovers():
    inj = ServeFaultInjector(parse_serve_fault_specs("engine_raise@1"))
    sched = ContinuousBatchingScheduler(StubEngine(), fault_injector=inj)
    req = GenRequest(prompt=[1], max_new_tokens=4)
    sched.submit(req)
    before = _injected_count()
    sched.step()
    with pytest.raises(RuntimeError, match="injected serve fault"):
        sched.step()
    assert _injected_count() == before + 1
    assert inj.specs[0].fired and not inj.pending
    run_until_done(sched, [req])
    assert req.generated == [2, 3, 4, 5]
    assert sched.allocator.in_use == 0


def test_engine_raise_through_loop_fails_requests_not_loop():
    from acco_tpu_torch.serve.server import ServingLoop

    inj = ServeFaultInjector(parse_serve_fault_specs("engine_raise@1"))
    sched = ContinuousBatchingScheduler(StubEngine(), fault_injector=inj)
    loop = ServingLoop(sched).start()
    try:
        req = loop.submit(GenRequest(prompt=[1], max_new_tokens=4))
        assert req.done.wait(timeout=10)
        assert req.status == "failed" and "engine_raise" in req.error
        assert sched.allocator.in_use == 0
        nxt = loop.submit(GenRequest(prompt=[9], max_new_tokens=2))
        assert nxt.done.wait(timeout=10)
        assert nxt.status == "finished" and nxt.generated == [10, 11]
    finally:
        loop.stop()


def test_slow_decode_delays_one_step_then_restores():
    eng = StubEngine()
    inj = ServeFaultInjector(parse_serve_fault_specs(
        [{"kind": "slow_decode", "step": 1, "seconds": 0.08}]))
    sched = ContinuousBatchingScheduler(eng, fault_injector=inj)
    req = GenRequest(prompt=[1], max_new_tokens=4)
    sched.submit(req)
    original_decode = eng.decode
    sched.step()
    t0 = time.perf_counter()
    sched.step()
    run_until_done(sched, [req])
    assert req.generated == [2, 3, 4, 5]
    assert eng.decode == original_decode
    assert time.perf_counter() - t0 >= 0.05


def test_kv_exhaust_holds_then_releases_pages():
    eng = StubEngine(page_size=4, num_pages=16, max_pages_per_seq=4, max_slots=2)
    inj = ServeFaultInjector(parse_serve_fault_specs(
        [{"kind": "kv_exhaust", "step": 1, "hold_steps": 3}]))
    sched = ContinuousBatchingScheduler(eng, fault_injector=inj)
    req = GenRequest(prompt=[1, 2, 3, 4], max_new_tokens=10)
    sched.submit(req)
    sched.step()
    assert sched.allocator.available > 0
    sched.step()
    assert sched.allocator.available == 0
    run_until_done(sched, [req])
    assert req.finish_reason == "length"
    assert req.generated == list(range(5, 15))
    assert sched.allocator.in_use == 0
    assert not inj.pending


def test_client_abandon_cancels_newest_active():
    eng = StubEngine(max_slots=2, num_pages=32)
    inj = ServeFaultInjector(parse_serve_fault_specs("client_abandon@2"))
    sched = ContinuousBatchingScheduler(eng, prefills_per_step=1, fault_injector=inj)
    r1 = GenRequest(prompt=[1], max_new_tokens=8)
    r2 = GenRequest(prompt=[5], max_new_tokens=8)
    sched.submit(r1)
    sched.submit(r2)
    for _ in range(3):
        sched.step()
    assert r2.status == "cancelled" and r2.finish_reason == "abandoned"
    assert r2.done.is_set()
    run_until_done(sched, [r1])
    assert r1.generated == [2, 3, 4, 5, 6, 7, 8, 9]
    assert sched.allocator.in_use == 0


def test_no_faults_when_injector_off():
    before = _injected_count()
    for injector in (None, ServeFaultInjector([])):
        sched = ContinuousBatchingScheduler(StubEngine(), fault_injector=injector)
        reqs = [GenRequest(prompt=[i], max_new_tokens=6) for i in (1, 5)]
        for r in reqs:
            sched.submit(r)
        run_until_done(sched, reqs)
        assert [r.finish_reason for r in reqs] == ["length", "length"]
        assert all(r.generated == [r.prompt[0] + k for k in range(1, 7)] for r in reqs)
        assert sched.allocator.in_use == 0
        assert sched.cancelled == 0 and sched.shed == 0
    assert _injected_count() == before
