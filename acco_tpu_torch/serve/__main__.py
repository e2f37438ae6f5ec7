"""Serving entry point: continuous-batching inference from a checkpoint.

Counterpart of ``serve.py``, with its flags::

    python -m acco_tpu_torch.serve --config config/serve/llama3-8b.yaml \\
        --resume_from outputs/<run>/checkpoints/<run_name>
    curl -s localhost:8700/generate -d '{"prompt": "hello", "max_new_tokens": 16}'
    python -m acco_tpu_torch.serve --device cpu --config config/serve/tiny-cpu.yaml \\
        --resume_from <ckpt> --prompt hello

The config's ``model:`` names ``config/model/<model>.yaml`` (an
architecture file or a hub preset, ``models/registry.py``; an absolute
``model:`` names ``<model>.yaml`` itself);
``param_dtype``/``cache_dtype`` and the page, slot and bucket sizing go
to :class:`~acco_tpu_torch.serve.engine.ServeEngine`. ``--resume_from``
takes a checkpoint root (its newest valid ``step_*``) or a ``step_*``
dir; the parameters come from its ``params.npz`` (a final save of this
port or of the JAX package) or rank 0's state file
(``utils/checkpoint.load_flat_params``). ``compile_cache_dir`` is read
and ignored, as in training (the decode step is captured anew at each
start).

It runs on ``cuda:0`` unless given ``--device cpu``, and raises when no
card is visible. On a card the decode step is captured as a CUDA graph
before the parameters load and before the serving loop starts
(``--no-warmup``: at the first decode step, on the loop thread).

``--prompt`` runs one generation and exits, printing one JSON line
(``text``, ``tokens``, ``finish_reason``). Without it the HTTP server
runs until SIGTERM, which drains (in-flight requests finish within
``--drain-budget-s``, then the server stops) and prints one JSON line
(the drain summary and the scheduler's final stats). Admission control
(``max_waiting``, ``kv_watermark``), ``POST /admin/drain`` and serve chaos
(``--chaos 'kind@step,...'`` or ``ACCO_SERVE_CHAOS``) are as in
``serve.py``; drill it with ``python -m acco_tpu_torch.serve.load_harness``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="config/serve/tiny-cpu.yaml",
                   help="serve config yaml (model + cache sizing + http)")
    p.add_argument("--resume_from", required=True,
                   help="checkpoint root or a specific step_* dir")
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--host", default=None, help="override config host")
    p.add_argument("--port", type=int, default=None, help="override config port")
    p.add_argument("--prompt", default=None,
                   help="one-shot: generate for this prompt and exit")
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup", action="store_true",
                   help="capture the decode step at its first use")
    p.add_argument("--warmup-timeout", type=float, default=600.0)
    p.add_argument("--drain-budget-s", type=float, default=None,
                   help="graceful-drain budget for SIGTERM / /admin/drain "
                        "(default: config drain_budget_s or 30)")
    p.add_argument("--chaos", default=None,
                   help="serve fault spec 'kind@step,...' "
                        "(ACCO_SERVE_CHAOS also honored)")
    return p.parse_args(argv)


def build_engine(cfg: dict, device, log, repo_root: str = REPO_ROOT):
    """``(engine, model_cfg)`` for a serve config: the model from
    ``config/model/<model>.yaml`` (an absolute ``model`` names its own
    file) in ``param_dtype`` on ``device``."""
    import torch

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.serve.engine import ServeEngine

    model_name = cfg.get("model", "tiny")
    model_cfg = load_yaml(os.path.join(repo_root, "config", "model", model_name + ".yaml"))
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.get("param_dtype", "bfloat16")]
    model = build_model(model_cfg, repo_root=repo_root, dtype=dtype, device=device)
    engine = ServeEngine(
        model,
        page_size=int(cfg.get("page_size", 16)),
        num_pages=int(cfg.get("num_pages", 256)),
        max_pages_per_seq=int(cfg.get("max_pages_per_seq", 8)),
        max_slots=int(cfg.get("max_slots", 4)),
        buckets=cfg.get("buckets"),
        top_k_max=int(cfg.get("top_k_max", 64)),
        cache_dtype=cfg.get("cache_dtype"),
        log=log,
    )
    return engine, model_cfg


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    )
    log = logging.getLogger("acco_tpu_torch.serve")

    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.utils.platform import default_allocator_settings, resolve_device

    cfg = load_yaml(args.config)
    default_allocator_settings()
    device = resolve_device(args.device)
    if cfg.get("compile_cache_dir"):
        log.info("compile_cache_dir %s ignored: the decode step is captured at each start",
                 cfg["compile_cache_dir"])

    from acco_tpu_torch.utils.checkpoint import load_flat_params, resolve_serving_checkpoint

    step_dir = resolve_serving_checkpoint(args.resume_from, log=log)

    from acco_tpu_torch.data.tokenizer import load_tokenizer

    engine, model_cfg = build_engine(cfg, device, log)
    tokenizer = load_tokenizer(model_cfg.get("tokenizer"), log)
    model_name = cfg.get("model", "tiny")
    log.info(
        "engine: max_context=%d (%d pages x %d), %d slots, pool %.1f MiB on %s",
        engine.max_context, engine.max_pages_per_seq, engine.page_size,
        engine.max_slots, engine.spec.total_bytes / 2**20, device,
    )

    # capture first, THEN load: the graph reads the parameters' storage,
    # which set_params fills in place
    if not args.no_warmup:
        engine.start_warmup()
    engine.set_params(load_flat_params(step_dir, engine.model.n_params, log=log))
    if not args.no_warmup:
        engine.finish_warmup(timeout=args.warmup_timeout)

    from acco_tpu_torch.resilience import ServeFaultInjector
    from acco_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    injector = ServeFaultInjector.from_config(
        args.chaos if args.chaos is not None
        else cfg.get("fault_injection") or os.environ.get(ServeFaultInjector.ENV_VAR),
        log=log,
    )
    if injector is not None:
        log.warning("serve chaos armed: %s", injector.specs)

    scheduler = ContinuousBatchingScheduler(
        engine,
        prefills_per_step=int(cfg.get("prefills_per_step", 1)),
        max_waiting=int(cfg.get("max_waiting", 64)),
        kv_watermark=float(cfg.get("kv_watermark", 0.95)),
        retry_after_s=float(cfg.get("retry_after_s", 1.0)),
        fault_injector=injector,
        log=log,
    )

    defaults = {
        "max_new_tokens": 32, "temperature": 0.0, "top_k": 0,
        **(cfg.get("defaults") or {}),
    }
    if args.max_new_tokens is not None:
        defaults["max_new_tokens"] = args.max_new_tokens
    if args.temperature is not None:
        defaults["temperature"] = args.temperature
    if args.top_k is not None:
        defaults["top_k"] = args.top_k

    if args.prompt is not None:
        from acco_tpu_torch.serve.scheduler import GenRequest
        from acco_tpu_torch.serve.server import encode_prompt

        req = GenRequest(
            prompt=encode_prompt(tokenizer, args.prompt),
            max_new_tokens=int(defaults["max_new_tokens"]),
            temperature=float(defaults["temperature"]),
            top_k=int(defaults["top_k"]),
            seed=args.seed,
        )
        scheduler.submit(req)
        while not req.done.is_set():
            scheduler.step()
        text = tokenizer.decode(req.generated)
        log.info("generated %d tokens (finish=%s): %r",
                 len(req.generated), req.finish_reason, text)
        out = {"text": text, "tokens": req.generated, "finish_reason": req.finish_reason}
        print(json.dumps(out), flush=True)
        return out

    from acco_tpu_torch.serve.server import ServingLoop, serve_http

    loop = ServingLoop(scheduler, log=log).start()
    host = args.host or cfg.get("host", "127.0.0.1")
    port = args.port if args.port is not None else int(cfg.get("port", 8700))
    drain_budget_s = (
        args.drain_budget_s
        if args.drain_budget_s is not None
        else float(cfg.get("drain_budget_s", 30.0))
    )
    httpd = serve_http(
        loop,
        tokenizer,
        host=host,
        port=port,
        model_name=model_name,
        defaults=defaults,
        request_timeout_s=float(cfg.get("request_timeout_s", 300.0)),
        drain_budget_s=drain_budget_s,
    )

    # SIGTERM = the preemption notice (training's ShutdownHandler
    # contract): drain off the signal handler's thread (finish in-flight
    # requests within the budget), then unblock serve_forever
    drains: list = []
    drain_threads: list = []

    def _sigterm(signum, frame):
        log.info("SIGTERM: draining (budget %.1fs)", drain_budget_s)

        def _drain_and_shutdown():
            try:
                drains.append(loop.drain(budget_s=drain_budget_s))
            finally:
                httpd.shutdown()

        t = threading.Thread(target=_drain_and_shutdown, name="acco-serve-drain", daemon=True)
        drain_threads.append(t)
        t.start()

    signal.signal(signal.SIGTERM, _sigterm)

    log.info("serving %s from %s on http://%s:%d", model_name, step_dir, host,
             httpd.server_address[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log.info("shutting down")
    finally:
        for t in drain_threads:
            t.join(timeout=drain_budget_s + 30.0)
        httpd.server_close()
        loop.stop()
    out = {"drain": drains[-1] if drains else None, "stats": scheduler.stats()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
