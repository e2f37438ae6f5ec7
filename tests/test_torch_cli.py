"""``python -m acco_tpu_torch``: a few CPU rounds end to end, the device
rule, ``train.fused_loss=pallas`` and its downgrade, the flash route
(``train.use_pallas_attention=true``), the keys once refused by name
(now run), context parallelism's preconditions at one process (its runs on
two ranks: tests/test_torch_context_parallel.py), and a run that saves,
evaluates and warms up, then a second command that resumes it. Every
run writes into its test's temporary directory (``hydra.run.dir``)."""

import json
import logging
import os
import subprocess
import sys

import pytest
import torch

from acco_tpu_torch.__main__ import main
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

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
def test_cli_runs_rounds_on_cpu(method, model, extra, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", "--device", "cpu",
         f"train={method}", f"model={model}", *DATA, "train.nb_steps_tot=4", *extra,
         f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["method"] == method and summary["device"] == "cpu"
    assert summary["count_grad_tot"] == 4 and summary["skipped_rounds"] == 0
    real = [r["is_real_update"] for r in summary["round_log"]]
    assert real == ([False, True, False, True] if method == "acco" else [True] * 4)
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))


def test_without_device_flag_needs_a_card(monkeypatch, tmp_path):
    """No ``--device cpu``: the run goes to CUDA, and without a card it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train=acco", *TINY, "train.nb_steps_tot=2", f"hydra.run.dir={tmp_path}"])


@pytest.mark.parametrize(
    "override, item",
    [
        ("train.finetune=true", "item 7"),
        ("train.remat=true", "remat"),
        # keys JAX honours that the port once had no code for (item 8)
        ("train.fault_injection=nan_grads@3", "queue 1, item 8"),
        ("train.profile_steps=2", "queue 1, item 8"),
    ],
)
def test_unported_keys_raise_by_name(override, item, tmp_path):
    """Keys the port once refused, naming their item, each now runs with
    JAX's meaning: ``remat`` (item 3) trains; ``finetune`` (item 7) reads
    ``model.config_path`` as a checkpoint, which tiny128's architecture
    file is not, and raises naming the missing download;
    ``fault_injection`` (item 8) fires its drill (one guard-skipped round,
    the target reached); ``profile_steps`` (item 8) writes a profiler
    trace of that many rounds, marked as a CPU run."""
    argv = ["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2", override,
            f"hydra.run.dir={tmp_path}"]
    if override == "train.finetune=true":
        with pytest.raises(FileNotFoundError, match="no network egress"):
            main(argv)
        return
    nb = 2 if override == "train.remat=true" else 6  # past the fault's round, the profiled
    argv[argv.index("train.nb_steps_tot=2")] = f"train.nb_steps_tot={nb}"  # rounds' skip
    summary = main(argv)
    assert summary["count_grad_tot"] >= nb
    if "fault" in override:
        assert summary["skipped_rounds"] == 1 and summary["rollbacks"] == 0
    elif "profile" in override:
        prof = summary["profile"]
        assert prof["device"] == "cpu" and prof["rounds"] == 2 and os.path.exists(prof["trace"])
    else:
        assert summary["skipped_rounds"] == 0


def test_ddp_runs_on_cpu(tmp_path):
    """``train=ddp`` (once refused) runs the synchronous baseline: no seed
    round, every step an update."""
    summary = main(["--device", "cpu", "train=ddp", *TINY, "train.nb_steps_tot=2",
                    f"hydra.run.dir={tmp_path}"])
    assert summary["method"] == "ddp" and summary["seed_loss"] is None
    assert summary["count_grad_tot"] == 2 and summary["rounds"] == 2
    assert all(r["is_real_update"] and abs(r["loss"]) < 100 for r in summary["round_log"])


def test_dp_mesh_needs_its_ranks(tmp_path):
    """``train.mesh_shape={dp: 2}`` (once refused) runs under torchrun; at
    one process it raises naming the launcher (its runs on two ranks:
    tests/test_torch_data_parallel.py)."""
    with pytest.raises(ValueError, match=r"needs 2 processes.*torchrun --nproc_per_node 2"):
        main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2",
              "train.mesh_shape={dp: 2}", f"hydra.run.dir={tmp_path}"])


def test_microbatch_mask_is_shape_checked(tmp_path):
    """``train.microbatch_mask`` (once refused) is [n_acc][dp]: a flat list
    raises JAX's error."""
    with pytest.raises(ValueError, match=r"microbatch_mask must be \[n_grad_accumulation=1\]"
                                         r"\[world_size=1\], got \(2,\)"):
        main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2",
              "train.microbatch_mask=[1, 0]", f"hydra.run.dir={tmp_path}"])


def test_lr_grad_accounting_advances_the_schedule_by_the_count(tmp_path):
    """``+train.lr_grad_accounting=true`` (once refused): ACCO's two
    committed updates of 2 micro-grads each move the schedule's counter
    by 4, not 2."""
    from acco_tpu_torch.__main__ import build_trainer

    steps = {}
    for flag in ("true", "false"):
        trainer = build_trainer(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=4",
                                 f"+train.lr_grad_accounting={flag}",
                                 f"hydra.run.dir={tmp_path / flag}"])
        summary = trainer.train()
        assert summary["count_grad_tot"] == 4
        steps[flag] = int(trainer.final_state.zero1.sched_grads)
    assert steps == {"true": 4, "false": 2}


def test_default_save_runs_and_logs_once(caplog, tmp_path):
    """``train.save`` defaults to true and ``train.ckpt_async`` to true:
    the default command commits a checkpoint (its final save, with
    ``params.npz``) under the run dir's ``checkpoints/<run_name>`` through
    the overlapped save — the loop stalls once, for the snapshot, and
    the commit is on disk when the run returns — and logs the checkpoint
    once; nothing says that the save is synchronous any more."""
    from acco_tpu_torch.utils.checkpoint import latest_checkpoint, validate_checkpoint

    caplog.set_level(logging.INFO, logger="acco_tpu_torch")
    summary = main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2",
                    f"hydra.run.dir={tmp_path}"])
    assert summary["count_grad_tot"] == 2 and summary["ckpt_async"] is True
    step = latest_checkpoint(str(tmp_path / "checkpoints" / "acco"))
    assert step == summary["checkpoint"] == str(tmp_path / "checkpoints" / "acco" / "step_2")
    assert validate_checkpoint(step) is None
    assert sorted(os.listdir(step)) == ["meta.json", "params.npz", "state"]
    assert not [r for r in caplog.records if "saves synchronously" in r.message]
    notices = [r for r in caplog.records if r.message.startswith("checkpoint -> ")]
    assert len(notices) == 1 and notices[0].name == "acco_tpu_torch"
    assert "committing in the background" in notices[0].message


@pytest.mark.parametrize(
    "override, match",
    [  # context parallelism is ported: the ring needs a sequence group (sp > 1),
       # and sp > 1 needs as many processes
        ("train.use_pallas_attention=ring", "requires a sequence group"),
        ("train.mesh_shape={dp: 1, sp: 2}", "needs 2 processes"),
    ],
)
def test_context_parallel_needs_its_ranks(override, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        main(["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=2", override,
              f"hydra.run.dir={tmp_path}"])


@pytest.mark.parametrize("model, resolved", [("tiny128", "pallas"), ("tiny_neo", "chunk")])
def test_fused_loss_pallas_runs_on_cpu(model, resolved, caplog, tmp_path):
    """``train.fused_loss=pallas`` trains through the fused CE's plain
    version on tiny128 (hidden 128); tiny_neo (hidden 64) is outside the
    kernel's envelope and falls back to the chunked loss with a warning,
    as in JAX."""
    summary = main(["--device", "cpu", "train=acco", f"model={model}", *DATA,
                    "train.nb_steps_tot=2", "train.fused_loss=pallas",
                    f"hydra.run.dir={tmp_path}"])
    assert summary["fused_loss"] == resolved and summary["count_grad_tot"] == 2
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))
    downgraded = [r.message for r in caplog.records if "outside the kernel envelope" in r.message]
    assert len(downgraded) == (resolved == "chunk")


def test_flash_route_runs_on_cpu(tmp_path):
    """``train.use_pallas_attention=true`` normalises to 'flash' and trains
    through K5's plain version on the CPU; the summary names the route."""
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", "--device", "cpu", "train=acco", *TINY,
         "train.nb_steps_tot=2", "train.use_pallas_attention=true", f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["attention"] == "flash" and summary["count_grad_tot"] == 2
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(map(lambda x: abs(x) < 100, losses))


def _cli(args, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_saves_evaluates_and_resumes(tmp_path):
    """``train.n_warmup_steps=2 train.eval=true train.eval_step=2
    train.save=true hydra.run.dir=<tmp>`` (in this process) writes
    ``config.yaml``, a committed ``step_*`` with ``params.npz``,
    ``results.csv`` and the TensorBoard dir; a second command (its own
    process) with ``train.resume_from=<tmp>/checkpoints/acco`` goes on
    from the saved counters (no seed round, no warmup) to its own
    target."""
    from acco_tpu_torch.configuration import load_yaml
    from acco_tpu_torch.utils.checkpoint import latest_checkpoint

    common = ["train=acco", *TINY, "data.synthetic_num_docs=64", "train.n_warmup_steps=2",
              "train.eval=true", "train.eval_step=2", "train.save=true",
              "+train.delta_step_for_log=2"]
    first = main(["--device", "cpu", *common, "train.nb_steps_tot=6",
                  f"hydra.run.dir={tmp_path / 'a'}"])
    run = tmp_path / "a"
    assert load_yaml(str(run / "config.yaml"))["train"]["n_warmup_steps"] == 2
    step = latest_checkpoint(str(run / "checkpoints" / "acco"))
    assert step == first["checkpoint"] and step.endswith("step_6")
    assert {"meta.json", "params.npz", "state"} <= set(os.listdir(step))
    assert (run / "results.csv").read_text().count("\n") == 2  # header + one row
    assert len(list((run / "tensorboard" / "acco").iterdir())) == 1
    assert len(first["warmup_losses"]) == 2 and first["seed_loss"] is not None
    # 2 warmup grads, then ACCO's odd rounds commit 2 each: rounds 0-3
    assert first["count_grad_tot"] == 6 and first["rounds"] == 4
    assert [e["count_grad_tot"] for e in first["eval_log"]] == [4, 6]

    second = _cli([*common, "train.nb_steps_tot=10", f"hydra.run.dir={tmp_path / 'b'}",
                   f"train.resume_from={run / 'checkpoints' / 'acco'}"], tmp_path)
    assert second["seed_loss"] is None and second["warmup_losses"] == []
    assert [r["round"] for r in second["round_log"]] == [4, 5, 6, 7]
    assert second["count_grad_tot"] == 10 and second["rounds"] == 8
    assert [e["count_grad_tot"] for e in second["eval_log"]] == [8, 10]
    assert second["checkpoint"].endswith("step_10")


@pytest.mark.parametrize("remat", ["dots", "true", "dots+probs"])
def test_remat_runs_from_the_cli(remat, tmp_path):
    """``train.remat`` (once refused) runs: the rounds' losses equal remat
    off's (float32, the plain path: recomputed activations are the same
    bits on the CPU)."""
    argv = ["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=4",
            "train.use_mixed_precision=false"]
    off = main([*argv, f"hydra.run.dir={tmp_path / 'off'}"])
    on = main([*argv, f"train.remat={remat}", f"hydra.run.dir={tmp_path / 'on'}"])
    assert [r["loss"] for r in on["round_log"]] == [r["loss"] for r in off["round_log"]]
    assert on["seed_loss"] == off["seed_loss"]


def test_prefetch_off_from_the_cli_gives_the_same_rounds(tmp_path):
    """``train.prefetch=false`` builds each block on the loop's thread: the
    same rounds as the prefetching default."""
    argv = ["--device", "cpu", "train=acco", *TINY, "train.nb_steps_tot=4"]
    on = main([*argv, f"hydra.run.dir={tmp_path / 'on'}"])
    off = main([*argv, "train.prefetch=false", f"hydra.run.dir={tmp_path / 'off'}"])
    assert on["prefetch"] is True and off["prefetch"] is False
    assert [r["loss"] for r in on["round_log"]] == [r["loss"] for r in off["round_log"]]


def test_finetune_without_its_checkpoint_fails_loudly(tmp_path):
    """``train=acco-ft`` (``finetune: True``, once refused) reads
    ``model.config_path`` as a checkpoint: a hub name that is not under
    ``ACCO_MODELS_ROOT`` raises naming the missing download, and never
    trains from a random init (its runs: tests/test_torch_hf_loader.py)."""
    with pytest.raises(FileNotFoundError, match="no network egress"):
        main(["--device", "cpu", "train=acco-ft", "model=gptneo", "model.tokenizer=byte",
              "data=synthetic", f"hydra.run.dir={tmp_path}"])
