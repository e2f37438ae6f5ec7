"""Command line: ``python -m acco_tpu_torch [--device cpu] <overrides>``.

Counterpart of ``main.py``: the same Hydra-style overrides over the
shared ``config/`` tree, e.g.

    python -m acco_tpu_torch train=acco model=llama-125M data=synthetic
    python -m acco_tpu_torch --device cpu train=dpu model=tiny128 \\
        data=synthetic train.max_length=128 train.batch_size=2

The run goes to ``cuda:0`` unless ``--device cpu`` is given, and raises
when no card is visible. As ``main.py``, each run gets a run dir,
``hydra.run.dir`` (default ``./outputs/%Y-%m-%d/%H-%M-%S``, from
``config/config.yaml``; ``hydra.run.dir=<dir>`` overrides it), holding
the composed ``config.yaml``, the checkpoints (``train.save``, the
default), the TensorBoard scalars and ``results.csv``. A run resumes
with ``train.resume_from=<run dir>/checkpoints/<run_name>`` (or a
``step_*`` dir), evaluates with ``train.eval=true``. The summary dict is
returned (and printed as the last line of output as JSON).

Data and context parallelism run under torchrun (or SLURM's srun), one
process per rank, each on ``cuda:LOCAL_RANK`` over NCCL (or on the CPU
over gloo):

    torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 2}"
    torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 1, sp: 2}"

``train=ddp`` runs the synchronous baseline on the same ranks. As in
``main.py``, sp > 1 builds the model on the ring attention
(``train.zigzag_cp``, default true, picks the zig-zag layout). Tensor
parallelism runs the same way:

    torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 2, tp: 2}"

builds each rank's tp shard of the model (the vocab padded to a multiple
of tp, ``parallel/tp.pad_vocab``), and pipeline parallelism

    torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 2, pp: 2}"

each rank's stage (``num_layers / pp`` layers, the vocab padded to a
multiple of pp; the GPipe loop of ``parallel/pp.py``). The axes compose,
the ranks row-major in the mesh's key order (JAX's ``make_mesh``):

    torchrun --nproc_per_node 8 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 2, pp: 2, tp: 2}"
    torchrun --nproc_per_node 8 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 1, pp: 2, tp: 2, sp: 2}"

(tp x pp: each rank a stage's tensor shard, the vocab padded to a
multiple of pp x tp; with sp the ring inside every stage). Rank 0 alone
prints the summary.

``train.finetune=true`` (``train=acco-ft``, ``ddp-ft``, ``dpu-ft``) reads
``model.config_path`` as a local HF checkpoint directory, or a hub name
under ``$ACCO_MODELS_ROOT`` (``models/hf_loader.py``): the model comes
from its ``config.json`` and training starts from its weights (a resume
still takes precedence); a missing checkpoint raises. ``train.remat``
(false, true, dots, dots+probs) rematerialises each layer in the
backward (``models/layers.wrap_remat``).

SIGTERM or SIGINT (``train.handle_signals``, the default) stops the run
at the next round boundary with a final checkpoint; the summary says
``"interrupted": true`` and a warning names the ``train.resume_from``
that goes on. ``train.fault_injection`` (e.g. ``nan_grads@3``) runs a
drill; ``train.profile_steps=N`` writes a profiler trace of N rounds
under ``<run dir>/profile/`` (the summary's ``profile``).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split_device(argv: list[str]) -> tuple[str | None, list[str]]:
    device, rest, it = None, [], iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value (cpu or cuda)")
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def _split_run_dir(overrides: list[str]) -> tuple[str, list[str]]:
    """``hydra.run.dir=<pattern>`` (or ``+hydra.run.dir=``) out of the
    overrides, else the root config's pattern: Hydra's runtime block,
    which ``compose_config`` leaves to the caller as JAX's does."""
    from acco_tpu_torch.configuration import load_yaml

    pattern, rest = None, []
    for ov in overrides:
        key, _, value = ov.partition("=")
        if key.lstrip("+") == "hydra.run.dir":
            pattern = value
        else:
            rest.append(ov)
    if pattern is None:
        root = load_yaml(os.path.join(REPO_ROOT, "config", "config.yaml"))
        pattern = ((root.get("hydra") or {}).get("run") or {}).get(
            "dir", "./outputs/%Y-%m-%d/%H-%M-%S")
    return pattern, rest


def _make_run_dir(pattern: str, cfg, mesh) -> str:
    """The run dir (rank 0's clock names it, every rank takes its name)
    with rank 0's ``config.yaml`` in it."""
    from acco_tpu_torch.configuration import dump_yaml

    run_dir = datetime.datetime.now().strftime(pattern)
    if mesh.world_size > 1:
        import torch.distributed as dist

        name = [run_dir]
        dist.broadcast_object_list(name, src=0)
        run_dir = name[0]
    if mesh.rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            f.write(dump_yaml(cfg.to_container()))
    return run_dir


def build_trainer(argv: list[str], groups=None, eager: bool = False):
    """Everything before the first round: device, config, model, data.
    ``eager``: the rounds as eager PyTorch calls instead of the captured
    programs (``compile/graphs.py``), for comparisons; no config key
    selects it.
    For a run not launched on several ranks, ``groups`` hands in process
    groups made by the caller: the pair ``(RankGroups, sequence group or
    None)`` that ``parallel/mesh.RankGroups.around`` returns around a
    sequence, data, tensor or pipeline group, or one-rank groups of
    several of these axes. A one-rank group runs that axis's code at size
    1: the ring with no hop (sp), the count all-reduce and ZeRO-1's
    collectives as identities (dp), the layers' all-reduces, the
    vocab-parallel loss and ZeRO-1's model-group terms (tp), the GPipe
    tick loop with its per-tick recompute and the masked broadcast (pp);
    several together run the composed code (tp x pp with its combined
    model group and two-segment prefix, the ring inside the stages or
    the tensor shards). Made once, such groups serve several trainers
    without new communicators each."""
    import dataclasses

    import torch

    from acco_tpu_torch.configuration import check_supported, compose_config
    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.models.hf_loader import from_pretrained
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.parallel.mesh import init_distributed
    from acco_tpu_torch.trainer import Trainer
    from acco_tpu_torch.utils.platform import default_allocator_settings, resolve_device

    default_allocator_settings()
    device_arg, overrides = _split_device(argv)
    run_dir_pattern, overrides = _split_run_dir(overrides)
    device = resolve_device(device_arg)
    cfg = compose_config(os.path.join(REPO_ROOT, "config"), overrides)
    check_supported(cfg.train)
    mesh = init_distributed(cfg.train.get("mesh_shape"), device)
    if groups is not None:
        rank_groups, sequence_group = groups
        mesh = dataclasses.replace(mesh, sequence_group=sequence_group, groups=rank_groups)
    device = mesh.device

    logging.basicConfig(
        level=logging.INFO if mesh.rank == 0 else logging.WARNING,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    )
    log = logging.getLogger("acco_tpu_torch")
    run_dir = _make_run_dir(run_dir_pattern, cfg, mesh)
    log.info("run dir: %s", run_dir)
    use_mp = bool(cfg.train.get("use_mixed_precision", True))
    use_cp = mesh.sequence_group is not None  # context parallelism: the ring
    tg = mesh.tensor_group  # tensor parallelism (JAX: trainer.py:146-155)
    pg = mesh.pipeline_group  # pipeline parallelism (JAX: trainer.py:156-175)
    mg = mesh.model_group  # the group the vocab is split over (pp x tp composed)
    model_kw = dict(
        dtype=torch.bfloat16 if use_mp else torch.float32,
        attention="ring" if use_cp else cfg.train.get("use_pallas_attention", "auto"),
        device=device,
        sequence_group=mesh.sequence_group,
        zigzag=use_cp and bool(cfg.train.get("zigzag_cp", True)),
        remat=cfg.train.get("remat", False),
        tensor_group=tg,
        pipeline_group=pg,
        model_group=mg if tg is not None and pg is not None else None,
    )
    pad_multiple = 1 if mg is None else mg.size
    initial_params = None
    if bool(cfg.train.get("finetune", False)):
        # the model group names a local pretrained checkpoint (JAX: main.py:95-112)
        model, initial_params = from_pretrained(cfg.model.config_path,
                                                vocab_pad_multiple=pad_multiple, **model_kw)
        if mg is not None:  # this rank's shard (or stage) of the dense (padded) weights
            from acco_tpu_torch.models.convert import params_to_jax, rank_flat_from_jax

            initial_params = rank_flat_from_jax(
                params_to_jax(initial_params, model.config, vocab=model.padded_vocab), model)
        log.info("finetune: %d parameters from %s", model.n_params, cfg.model.config_path)
    else:
        model = build_model(cfg.model, repo_root=REPO_ROOT, vocab_pad_multiple=pad_multiple,
                            **model_kw)
    tokenizer = load_tokenizer(cfg.model.get("tokenizer"), log)
    train_texts, eval_texts = load_text_dataset(cfg.data, log=log)
    trainer = Trainer(
        model, tokenizer, train_texts, eval_texts, cfg.train, log,
        seed=int(cfg.select("seed", 12345)), device=device, mesh=mesh, run_dir=run_dir,
        initial_params=initial_params, eager=eager,
    )
    # train.fused_loss as the train path resolved it against the model
    # (parallel/common.make_flat_loss_fn, which logs any downgrade)
    log.info(
        "device=%s model=%s train_docs=%d eval_docs=%d method=%s fused_loss=%s "
        "attention=%s",
        device, cfg.model.config_path, len(train_texts), len(eval_texts),
        cfg.train.method_name, trainer.step.value_and_grad.fused_loss, trainer.attention,
    )
    return trainer


def main(argv: list[str] | None = None, eager: bool = False) -> dict:
    """Train as the command line asks; returns the summary dict (on every
    rank) and ends the process group this run started (``eager``: see
    :func:`build_trainer`)."""
    import torch.distributed as dist

    trainer = build_trainer(sys.argv[1:] if argv is None else argv, eager=eager)
    ranks = trainer.mesh.world_size > 1
    try:
        summary = trainer.train()
        if ranks:  # every rank past its last collective before a group goes
            dist.barrier()
    finally:
        if ranks and dist.is_initialized():
            dist.destroy_process_group()
    if summary.get("interrupted"):
        nb = int(trainer.nb_grad_tot)
        if trainer.do_save:
            # the final checkpoint is committed and drained: the stop is
            # resumable (JAX: main.py:159-177)
            trainer.log.warning("training interrupted by a shutdown request at %d/%d grads; "
                                "resume with train.resume_from=%s", summary["count_grad_tot"],
                                nb, trainer.ckpt_dir)
        else:
            trainer.log.warning("training interrupted by a shutdown request at %d/%d grads "
                                "with train.save=False: NO checkpoint was written — this "
                                "progress is lost", summary["count_grad_tot"], nb)
    trainer.log.info("done: %s", {k: v for k, v in summary.items() if k != "round_log"})
    return summary


if __name__ == "__main__":
    summary = main()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(summary))
