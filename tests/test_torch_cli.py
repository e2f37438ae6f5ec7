"""``python -m acco_tpu_torch``: a few CPU rounds end to end, the device
rule, ``train.fused_loss=pallas`` and its downgrade, the flash route
(``train.use_pallas_attention=true``), the keys this slice refuses by
name, and context parallelism's preconditions at one process (its runs
on two ranks: tests/test_torch_context_parallel.py)."""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from acco_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = ["data=synthetic", "train.max_length=128", "train.batch_size=2"]
TINY = ["model=tiny128", *DATA]


@pytest.mark.parametrize(
    "method, model, extra",
    [  # packed rows (acco) and padded rows (dpu), for Llama and GPT-Neo
        pytest.param("acco", "tiny128", [], id="acco-extra0"),
        pytest.param("dpu", "tiny128", ["train.const_len_batch=false"], id="dpu-extra1"),
        pytest.param("acco", "tiny_neo", [], id="acco-tiny_neo"),
        pytest.param("dpu", "tiny_neo", ["train.const_len_batch=false"], id="dpu-tiny_neo"),
    ],
)
def test_cli_runs_rounds_on_cpu(method, model, extra):
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", "--device", "cpu",
         f"train={method}", f"model={model}", *DATA, "train.nb_steps_tot=4", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["method"] == method and summary["device"] == "cpu"
    assert summary["count_grad_tot"] == 4 and summary["skipped_rounds"] == 0
    real = [r["is_real_update"] for r in summary["round_log"]]
    assert real == ([False, True, False, True] if method == "acco" else [True] * 4)
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))


def test_without_device_flag_needs_a_card(monkeypatch):
    """No ``--device cpu``: the run goes to CUDA, and without a card it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train=acco", *TINY, "train.nb_steps_tot=2"])


@pytest.mark.parametrize(
    "override, item",
    [
        ("train=ddp", "item 4"),
        ("train.finetune=true", "item 7"),
        ("train.remat=true", "remat"),
        ("train.eval=true", "item 6"),
        ("train.mesh_shape={dp: 2}", "multi-rank"),
        # keys JAX honours that the port has no code for yet
        ("train.resume_from=/nonexistent/ckpt", "queue 1, item 6"),
        ("train.microbatch_mask=[1, 0]", "queue 1, item 4"),
        ("+train.lr_grad_accounting=true", "queue 1, item 4"),
        ("train.fault_injection=nan_grads@3", "queue 1, item 8"),
        ("train.profile_steps=2", "queue 1, item 8"),
    ],
)
def test_unported_keys_raise_by_name(override, item):
    with pytest.raises(NotImplementedError, match=item):
        main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2", override])


def test_default_save_runs_and_logs_once(caplog):
    """``train.save`` defaults to true and the port writes nothing: the
    default command runs, and says so once."""
    caplog.set_level(logging.INFO, logger="acco_tpu_torch")
    summary = main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2"])
    assert summary["count_grad_tot"] == 2
    notices = [r for r in caplog.records if "writes no checkpoint" in r.message]
    assert len(notices) == 1 and notices[0].name == "acco_tpu_torch"


@pytest.mark.parametrize(
    "override, match",
    [  # context parallelism is ported: the ring needs a sequence group (sp > 1),
       # and sp > 1 needs as many processes
        ("train.use_pallas_attention=ring", "requires a sequence group"),
        ("train.mesh_shape={dp: 1, sp: 2}", "needs 2 processes"),
    ],
)
def test_context_parallel_needs_its_ranks(override, match):
    with pytest.raises(ValueError, match=match):
        main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2", override])


@pytest.mark.parametrize("model, resolved", [("tiny128", "pallas"), ("tiny_neo", "chunk")])
def test_fused_loss_pallas_runs_on_cpu(model, resolved, caplog):
    """``train.fused_loss=pallas`` trains through the fused CE's plain
    version on tiny128 (hidden 128); tiny_neo (hidden 64) is outside the
    kernel's envelope and falls back to the chunked loss with a warning,
    as in JAX."""
    summary = main(["--device", "cpu", "train=acco", f"model={model}", *DATA,
                    "train.nb_steps_tot=2", "train.fused_loss=pallas"])
    assert summary["fused_loss"] == resolved and summary["count_grad_tot"] == 2
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))
    downgraded = [r.message for r in caplog.records if "outside the kernel envelope" in r.message]
    assert len(downgraded) == (resolved == "chunk")


def test_flash_route_runs_on_cpu():
    """``train.use_pallas_attention=true`` normalises to 'flash' and trains
    through K5's plain version on the CPU; the summary names the route."""
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", "--device", "cpu", "train=acco", *TINY,
         "train.nb_steps_tot=2", "train.use_pallas_attention=true"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["attention"] == "flash" and summary["count_grad_tot"] == 2
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))
