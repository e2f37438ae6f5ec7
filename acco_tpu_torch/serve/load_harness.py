"""Closed-loop load harness for the port's serving stack.

Counterpart of ``tools/load_harness.py``. It drives the HTTP serving
path (admission control, deadlines, cancellation, chaos, drain) and
prints one JSON record, which it also writes to ``--out`` where given.

Two modes:

- **stub** (default): a ``StubEngine`` + ``ContinuousBatchingScheduler``
  + ``ServingLoop`` + ``serve_http`` on an ephemeral port inside this
  process; TTFT comes from the telemetry registry, and the page-leak
  check reads the allocator after the drain.
- **--url http://host:port**: an already running ``python -m
  acco_tpu_torch.serve``. Client latencies and status counts as in stub
  mode; TTFT from each 200's ``ttft_ms``; server counters scraped from
  ``/metrics``; the page-leak check reads ``/healthz``'s
  ``pages_in_use`` once the clients are done (after the drain).
  ``--no-drain`` leaves the server up for its owner to stop (SIGTERM).

Closed loop: each of ``--concurrency`` client threads issues requests
back to back (optional ``--think-s`` between them) for ``--duration-s``
seconds, prompt / max_new_tokens lengths drawn per request from
``--prompt-len`` / ``--max-new``, a ``--deadline-frac`` share of them
with a client deadline. Chaos comes from ``--chaos`` (or
``ACCO_SERVE_CHAOS``), the serve kinds of ``resilience/faults.py``.

The run FAILS (exit 1) if any request got a 500, a KV page leaked, or
the drain did not answer 200::

    python -m acco_tpu_torch.serve.load_harness --duration-s 4 \
        --concurrency 8 --chaos 'kv_exhaust@20, client_abandon@40'
    python -m acco_tpu_torch.serve.load_harness --url http://127.0.0.1:8700 \
        --duration-s 10 --concurrency 8 --out /tmp/serve_load.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys
import threading
import time
import urllib.error
import urllib.request

log = logging.getLogger("acco_tpu_torch.serve.load_harness")


class HarnessTokenizer:
    """Deterministic char tokenizer for stub mode: one token per char,
    so prompt length in chars == prompt length in tokens."""

    eos_token_id = None  # stub decodes until max_new_tokens

    def __init__(self, vocab_size: int = 64):
        self.vocab_size = vocab_size

    def __call__(self, text, **kw):
        return {"input_ids": [1 + (ord(c) % (self.vocab_size - 1)) for c in text]}

    def decode(self, ids):
        return "".join(chr(97 + (int(i) % 26)) for i in ids)


def _http(url: str, payload=None, timeout: float = 60.0):
    """POST payload (or GET when None); returns (status, body_dict)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read() or b"{}")
        except (json.JSONDecodeError, OSError):
            body = {}
        return exc.code, body


class ClientStats:
    """Per-worker tallies, merged after join (no shared mutable state
    between workers, so no locking in the hot path)."""

    def __init__(self):
        self.statuses: dict = {}
        self.latencies: list = []
        self.ttfts_ms: list = []
        self.tokens = 0

    def record(self, status: int, latency_s: float, ntokens: int, ttft_ms=None) -> None:
        self.statuses[status] = self.statuses.get(status, 0) + 1
        self.latencies.append(latency_s)
        self.tokens += ntokens
        if ttft_ms is not None:
            self.ttfts_ms.append(float(ttft_ms))

    def merge(self, other: "ClientStats") -> None:
        for k, v in other.statuses.items():
            self.statuses[k] = self.statuses.get(k, 0) + v
        self.latencies.extend(other.latencies)
        self.ttfts_ms.extend(other.ttfts_ms)
        self.tokens += other.tokens


def _quantile(values, q):
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def run_client(base_url, stats, stop_at, rng, args):
    """One closed-loop client: request, wait for the full response,
    maybe think, repeat until the deadline."""
    alphabet = "abcdefghijklmnopqrstuvwxyz "
    while time.perf_counter() < stop_at:
        plen = rng.randint(args.prompt_len[0], args.prompt_len[1])
        payload = {
            "prompt": "".join(rng.choice(alphabet) for _ in range(plen)),
            "max_new_tokens": rng.randint(args.max_new[0], args.max_new[1]),
            "temperature": 0.0,
            "seed": rng.randint(0, 2**31 - 1),
        }
        if args.deadline_frac > 0 and rng.random() < args.deadline_frac:
            payload["deadline_ms"] = args.deadline_ms
        t0 = time.perf_counter()
        try:
            status, body = _http(
                base_url + "/generate", payload, timeout=args.request_timeout_s
            )
        except OSError as exc:  # connection refused/reset mid-drain
            log.debug("client error: %s", exc)
            stats.record(-1, time.perf_counter() - t0, 0)
            continue
        ntok = len(body.get("tokens") or ()) if isinstance(body, dict) else 0
        ttft = body.get("ttft_ms") if isinstance(body, dict) and status == 200 else None
        stats.record(status, time.perf_counter() - t0, ntok, ttft)
        if args.think_s > 0:
            time.sleep(args.think_s)


def scrape_counters(base_url, names):
    """Pull ``acco_<name> <value>`` counter/gauge lines from /metrics
    (URL mode's substitute for reading REGISTRY in-process)."""
    try:
        req = urllib.request.Request(base_url + "/metrics")
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            text = resp.read().decode()
    except (OSError, urllib.error.HTTPError) as exc:
        log.warning("could not scrape /metrics: %s", exc)
        return {}
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and parts[0].removeprefix("acco_") in names:
            try:
                out[parts[0].removeprefix("acco_")] = float(parts[1])
            except ValueError:
                pass
    return out


def build_stub_stack(args):
    """In-process serving stack on an ephemeral port. Returns
    (base_url, httpd, server_thread, loop, scheduler)."""
    from acco_tpu_torch.resilience.faults import ServeFaultInjector
    from acco_tpu_torch.serve import ContinuousBatchingScheduler, StubEngine
    from acco_tpu_torch.serve.server import ServingLoop, serve_http

    engine = StubEngine(
        page_size=8,
        num_pages=args.num_pages,
        max_pages_per_seq=8,
        max_slots=args.max_slots,
        vocab_size=64,
        decode_sleep_s=args.decode_sleep_s,
    )
    injector = (
        ServeFaultInjector.from_config(args.chaos, log=log)
        if args.chaos else ServeFaultInjector.from_env(log=log)
    )
    if injector is not None and not injector.pending:
        injector = None
    scheduler = ContinuousBatchingScheduler(
        engine,
        prefills_per_step=2,
        eos_token_id=-1,  # never sampled: stub requests run to max_new
        max_waiting=args.max_waiting,
        kv_watermark=args.kv_watermark,
        retry_after_s=0.5,
        fault_injector=injector,
        log=log,
    )
    loop = ServingLoop(scheduler, log=log).start()
    httpd = serve_http(
        loop,
        HarnessTokenizer(vocab_size=64),
        host="127.0.0.1",
        port=0,
        model_name="stub",
        request_timeout_s=args.request_timeout_s,
        drain_budget_s=args.drain_budget_s,
    )
    thread = threading.Thread(
        target=httpd.serve_forever, name="load-harness-httpd", daemon=True
    )
    thread.start()
    base_url = "http://127.0.0.1:%d" % httpd.server_address[1]
    return base_url, httpd, thread, loop, scheduler


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--url", default=None,
                   help="target an already-running server instead of the "
                        "in-process stub stack")
    p.add_argument("--duration-s", type=float, default=3.0)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--think-s", type=float, default=0.0,
                   help="per-client pause between requests")
    p.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                   metavar=("LO", "HI"))
    p.add_argument("--max-new", type=int, nargs=2, default=(4, 16),
                   metavar=("LO", "HI"))
    p.add_argument("--deadline-frac", type=float, default=0.0,
                   help="fraction of requests carrying --deadline-ms")
    p.add_argument("--deadline-ms", type=float, default=200.0)
    p.add_argument("--request-timeout-s", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chaos", default=None,
                   help="serve fault spec, e.g. 'kv_exhaust@20,"
                        "client_abandon@40' (stub mode; ACCO_SERVE_CHAOS "
                        "also honored)")
    # stub-stack sizing + admission knobs
    p.add_argument("--num-pages", type=int, default=128)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-waiting", type=int, default=16)
    p.add_argument("--kv-watermark", type=float, default=0.95)
    p.add_argument("--decode-sleep-s", type=float, default=0.002,
                   help="stub per-decode sleep: gives requests real "
                        "duration so deadlines/cancellation have teeth")
    p.add_argument("--drain-budget-s", type=float, default=10.0)
    p.add_argument("--no-drain", action="store_true",
                   help="--url mode: do not POST /admin/drain at the end")
    p.add_argument("--out", default=None, help="also write the record to this path")
    args = p.parse_args(argv)
    if args.no_drain and args.url is None:
        p.error("--no-drain needs --url (the stub stack is drained to stop it)")
    return args


SERVER_COUNTERS = (
    "serve_requests_total", "serve_shed_total", "serve_cancelled_total",
    "serve_deadline_expired_total", "serve_faults_injected_total",
    "serve_tokens_total", "serve_drain_ms",
)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    )

    stub = args.url is None
    httpd = server_thread = loop = scheduler = None
    pages_before = None
    if stub:
        from acco_tpu_torch.telemetry import REGISTRY

        REGISTRY.reset()  # this process owns the registry: clean slate
        base_url, httpd, server_thread, loop, scheduler = build_stub_stack(args)
        pages_before = scheduler.allocator.available
        log.info("stub stack up at %s (%d pages free)", base_url, pages_before)
    else:
        base_url = args.url.rstrip("/")
        log.info("targeting external server %s", base_url)

    stats = ClientStats()
    workers = []
    worker_stats = []
    t_start = time.perf_counter()
    stop_at = t_start + args.duration_s
    for i in range(args.concurrency):
        ws = ClientStats()
        worker_stats.append(ws)
        rng = random.Random(args.seed * 1_000_003 + i)
        t = threading.Thread(
            target=run_client, args=(base_url, ws, stop_at, rng, args),
            name=f"load-client-{i}", daemon=True,
        )
        workers.append(t)
        t.start()
    for t in workers:
        t.join(timeout=args.duration_s + args.request_timeout_s + 30.0)
    elapsed = time.perf_counter() - t_start
    for ws in worker_stats:
        stats.merge(ws)

    # drain: server finishes in-flight work within the budget, then the
    # loop thread stops — this is the graceful-shutdown drill
    drain_status, drain_body = None, None
    if not args.no_drain:
        drain_status, drain_body = _http(
            base_url + "/admin/drain", {"budget_s": args.drain_budget_s},
            timeout=args.drain_budget_s + 30.0,
        )
        log.info("drain -> %s %s", drain_status, drain_body)

    leaked_pages = None
    server = {}
    if stub:
        from acco_tpu_torch.telemetry import REGISTRY

        httpd.shutdown()
        httpd.server_close()
        server_thread.join(timeout=10.0)
        leaked_pages = pages_before - scheduler.allocator.available
        server = {
            name: REGISTRY.scalar(name) or 0.0 for name in SERVER_COUNTERS
        }
        server["p50_ttft_ms"] = REGISTRY.quantile("serve_ttft_ms", 0.5)
        server["p99_ttft_ms"] = REGISTRY.quantile("serve_ttft_ms", 0.99)
    else:
        server = scrape_counters(base_url, SERVER_COUNTERS)
        server["p50_ttft_ms"] = _quantile(stats.ttfts_ms, 0.5)
        server["p99_ttft_ms"] = _quantile(stats.ttfts_ms, 0.99)
        _, health = _http(base_url + "/healthz")  # 503 with its body once draining
        leaked_pages = health.get("pages_in_use")

    n_requests = sum(stats.statuses.values())
    n_shed = stats.statuses.get(429, 0) + stats.statuses.get(503, 0)
    record = {
        "metric": "serve_load",
        "mode": "stub" if stub else "url",
        "duration_s": round(elapsed, 3),
        "concurrency": args.concurrency,
        "requests": n_requests,
        "ok_200": stats.statuses.get(200, 0),
        "bad_request_400": stats.statuses.get(400, 0),
        "shed_429": stats.statuses.get(429, 0),
        "shed_503": stats.statuses.get(503, 0),
        "timeout_504": stats.statuses.get(504, 0),
        "server_500": stats.statuses.get(500, 0),
        "conn_errors": stats.statuses.get(-1, 0),
        "shed_rate": round(n_shed / n_requests, 4) if n_requests else 0.0,
        "tokens_per_s": round(stats.tokens / elapsed, 2) if elapsed else 0.0,
        "p50_latency_ms": _ms(_quantile(stats.latencies, 0.5)),
        "p99_latency_ms": _ms(_quantile(stats.latencies, 0.99)),
        "p50_ttft_ms": _round(server.get("p50_ttft_ms")),
        "p99_ttft_ms": _round(server.get("p99_ttft_ms")),
        "cancelled": server.get("serve_cancelled_total"),
        "deadline_expired": server.get("serve_deadline_expired_total"),
        "faults_injected": server.get("serve_faults_injected_total"),
        "drain_ms": server.get("serve_drain_ms"),
        "drain_in_budget": bool(drain_body.get("in_budget", False))
        if isinstance(drain_body, dict) else None,
        "leaked_pages": leaked_pages,
        "chaos": args.chaos or os.environ.get("ACCO_SERVE_CHAOS") or None,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        log.info("record -> %s", args.out)

    failures = []
    if record["server_500"]:
        failures.append(f"{record['server_500']} requests got HTTP 500")
    if leaked_pages:
        failures.append(f"{leaked_pages} KV pages leaked after drain")
    if drain_status not in (None, 200):
        failures.append(f"drain endpoint returned {drain_status}")
    if failures:
        log.error("LOAD DRILL FAILED: %s", "; ".join(failures))
        return 1
    log.info(
        "load drill passed: %d requests, %.1f tok/s, shed_rate=%.3f, "
        "0 leaks, clean drain",
        n_requests, record["tokens_per_s"], record["shed_rate"],
    )
    return 0


def _ms(seconds):
    return None if seconds is None else round(seconds * 1e3, 2)


def _round(v):
    return None if v is None else round(float(v), 2)


if __name__ == "__main__":
    sys.exit(main())
