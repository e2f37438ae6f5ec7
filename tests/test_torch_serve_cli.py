"""The port's serving entry points on the CPU: ``python -m
acco_tpu_torch.serve --device cpu --prompt`` on a ``params.npz`` made
from a JAX tiny init, whose greedy tokens must equal the argmax chain of
one teacher-forced JAX forward; the refusal without a card;
``perplexity_eval --engine serve`` against ``--engine jit``; and the
stub load harness."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
import yaml
from jax.flatten_util import ravel_pytree

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checkpoint(root, seed=1):
    """A ``step_1`` dir holding a JAX tiny Llama's ``params.npz``; returns
    (the checkpoint root, the JAX model, its params)."""
    from acco_tpu.models.registry import build_model

    with open(os.path.join(REPO, "config", "model", "tiny.yaml")) as f:
        model = build_model(yaml.safe_load(f), repo_root=REPO, param_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed))
    step = os.path.join(root, "step_1")
    os.makedirs(os.path.join(step, "state"))
    np.savez(os.path.join(step, "params.npz"), flat_params=np.asarray(ravel_pytree(params)[0]))
    with open(os.path.join(step, "meta.json"), "w") as f:
        json.dump({"step": 1}, f)
    return root, model, params


def test_cli_prompt_greedy_equals_jax_argmax_chain(tmp_path):
    from acco_tpu_torch.data.tokenizer import ByteTokenizer
    from acco_tpu_torch.serve.server import encode_prompt

    root, model, params = _checkpoint(str(tmp_path / "ckpt"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch.serve", "--device", "cpu", "--config",
         "config/serve/tiny-cpu.yaml", "--resume_from", root, "--prompt", "hello world",
         "--max-new-tokens", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    prompt = encode_prompt(ByteTokenizer(), "hello world")
    gen = out["tokens"]
    assert gen and out["finish_reason"] in ("length", "stop")
    ids = np.asarray([prompt + gen], np.int32)
    argmax = np.asarray(jax.jit(model.apply)(params, jnp.asarray(ids)))[0].argmax(-1)
    n = len(prompt)
    assert gen == argmax[n - 1 : n - 1 + len(gen)].tolist()
    if out["finish_reason"] == "stop":  # EOS is consumed, not emitted
        assert argmax[n - 1 + len(gen)] == model.config.eos_token_id
    else:
        assert len(gen) == 10


def test_cli_and_perplexity_serve_refuse_without_a_card(tmp_path, monkeypatch):
    from acco_tpu_torch import perplexity_eval
    from acco_tpu_torch.serve.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _, _ = _checkpoint(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", "config/serve/tiny-cpu.yaml", "--resume_from", root,
              "--prompt", "hi"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perplexity_eval.main(["--model", "tiny", "--engine", "serve", "--n-samples", "2"])


def test_perplexity_engine_serve_equals_jit(tmp_path, capsys):
    from acco_tpu_torch import perplexity_eval

    root, _, _ = _checkpoint(str(tmp_path / "ckpt"), seed=4)
    args = ["--device", "cpu", "--model", "tiny", "--n-samples", "4", "--max-length", "64",
            "--checkpoint", root]
    jit = perplexity_eval.main(args)
    serve = perplexity_eval.main(args + ["--engine", "serve"])
    assert serve["n"] == jit["n"] == 4
    np.testing.assert_allclose(serve["mean_perplexity"], jit["mean_perplexity"], rtol=1e-5)


def test_load_harness_stub_drill(tmp_path):
    from acco_tpu_torch.serve.load_harness import main

    out = tmp_path / "record.json"
    # tests/test_load_harness.py's drill, at its chaos steps
    rc = main(["--duration-s", "1.0", "--concurrency", "3", "--decode-sleep-s", "0.002",
               "--deadline-frac", "0.2", "--deadline-ms", "150", "--drain-budget-s", "10",
               "--chaos", "kv_exhaust@15,client_abandon@30", "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0
    assert record["server_500"] == 0 and record["leaked_pages"] == 0
    assert record["ok_200"] > 0 and record["drain_in_budget"]
    assert record["faults_injected"] == 2.0 and record["cancelled"] >= 1
    with pytest.raises(SystemExit):
        main(["--no-drain"])  # the stub stack is always drained


def test_kv_exhaust_early_releases_when_idle(tmp_path):
    """``kv_exhaust@3`` on the stub harness: the hold, taken when no
    request may be left to step the scheduler, is released at the next
    submit that finds none (the port's documented difference from JAX,
    whose copy held the pages to the drain and shed every request for KV
    pressure); the drain reports no page leaked."""
    from acco_tpu_torch.serve.load_harness import main

    out = tmp_path / "record.json"
    rc = main(["--duration-s", "1.0", "--concurrency", "3", "--decode-sleep-s", "0.002",
               "--drain-budget-s", "10", "--chaos", "kv_exhaust@3", "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0
    assert record["leaked_pages"] == 0 and record["server_500"] == 0
    assert record["faults_injected"] == 1.0 and record["ok_200"] > 0


def test_kv_exhaust_hold_released_at_idle_submit():
    """On the scheduler: a hold taken while a request runs is released by
    its step (JAX's drill); one still held when every request is done is
    released by the next submit, which is then admitted, not shed."""
    from acco_tpu_torch.resilience.faults import ServeFaultInjector, parse_serve_fault_specs
    from acco_tpu_torch.serve.engine import StubEngine
    from acco_tpu_torch.serve.scheduler import ContinuousBatchingScheduler, GenRequest

    eng = StubEngine(page_size=4, num_pages=16, max_pages_per_seq=4, max_slots=2)
    inj = ServeFaultInjector(parse_serve_fault_specs(
        [{"kind": "kv_exhaust", "step": 1, "hold_steps": 50}]))
    sched = ContinuousBatchingScheduler(eng, fault_injector=inj, kv_watermark=0.9)
    first = GenRequest(prompt=[1], max_new_tokens=3)  # runs past step 1, in one page
    sched.submit(first)
    while sched.has_work:
        sched.step()
    assert sched.kv_occupancy >= 0.9 and inj.pending  # held over the watermark, no step left
    second = sched.submit(GenRequest(prompt=[3], max_new_tokens=2))
    assert second.status == "waiting" and not inj.pending
    while sched.has_work:
        sched.step()
    assert second.finish_reason == "length" and sched.allocator.in_use == 0
