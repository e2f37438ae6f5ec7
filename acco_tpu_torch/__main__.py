"""Command line: ``python -m acco_tpu_torch [--device cpu] <overrides>``.

Counterpart of ``main.py``: the same Hydra-style overrides over the
shared ``config/`` tree, e.g.

    python -m acco_tpu_torch train=acco model=llama-125M data=synthetic
    python -m acco_tpu_torch --device cpu train=dpu model=tiny128 \\
        data=synthetic train.max_length=128 train.batch_size=2

The run goes to ``cuda:0`` unless ``--device cpu`` is given, and raises
when no card is visible. It writes nothing to disk; the summary dict is
returned (and printed as the last line of output as JSON).

Context parallelism runs under torchrun, one process per rank, each on
``cuda:LOCAL_RANK`` over NCCL (or on the CPU over gloo):

    torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu train=acco \
        model=tiny128 data=synthetic "train.mesh_shape={dp: 1, sp: 2}"

As in ``main.py``, sp > 1 builds the model on the ring attention
(``train.zigzag_cp``, default true, picks the zig-zag layout). Rank 0
alone prints the summary.
"""

from __future__ import annotations

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


def build_trainer(argv: list[str], sequence_group=None):
    """Everything before the first round: device, config, model, data.
    ``sequence_group`` hands in a sequence group (an
    ``ops.ring_attention.SequenceGroup``) for a run that is not launched
    with sp > 1: a one-rank group runs the context-parallel code, the ring
    included, with no hop."""
    import dataclasses

    import torch

    from acco_tpu_torch.configuration import check_supported, compose_config
    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.parallel.mesh import init_distributed
    from acco_tpu_torch.trainer import Trainer
    from acco_tpu_torch.utils.platform import resolve_device

    device_arg, overrides = _split_device(argv)
    device = resolve_device(device_arg)
    cfg = compose_config(os.path.join(REPO_ROOT, "config"), overrides)
    check_supported(cfg.train)
    mesh = init_distributed(cfg.train.get("mesh_shape"), device)
    if sequence_group is not None:
        mesh = dataclasses.replace(mesh, sequence_group=sequence_group)
    device = mesh.device

    logging.basicConfig(
        level=logging.INFO if mesh.rank == 0 else logging.WARNING,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
    )
    log = logging.getLogger("acco_tpu_torch")
    if bool(cfg.train.get("save", False)):
        log.info("train.save=True: this port writes no checkpoint, params or logs to disk "
                 "(ROADMAP.md queue 1, item 6); the summary is returned and printed")
    use_mp = bool(cfg.train.get("use_mixed_precision", True))
    use_cp = mesh.sequence_group is not None  # context parallelism: the ring
    model = build_model(
        cfg.model,
        repo_root=REPO_ROOT,
        dtype=torch.bfloat16 if use_mp else torch.float32,
        attention="ring" if use_cp else cfg.train.get("use_pallas_attention", "auto"),
        device=device,
        sequence_group=mesh.sequence_group,
        zigzag=use_cp and bool(cfg.train.get("zigzag_cp", True)),
    )
    tokenizer = load_tokenizer(cfg.model.get("tokenizer"), log)
    train_texts, eval_texts = load_text_dataset(cfg.data)
    trainer = Trainer(
        model, tokenizer, train_texts, cfg.train, log,
        seed=int(cfg.select("seed", 12345)), device=device, mesh=mesh,
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


def main(argv: list[str] | None = None) -> dict:
    """Train as the command line asks; returns the summary dict (on every
    rank) and ends the process group this run started."""
    import torch.distributed as dist

    trainer = build_trainer(sys.argv[1:] if argv is None else argv)
    try:
        summary = trainer.train()
    finally:
        if trainer.mesh.world_size > 1 and dist.is_initialized():
            dist.destroy_process_group()
    trainer.log.info("done: %s", {k: v for k, v in summary.items() if k != "round_log"})
    return summary


if __name__ == "__main__":
    summary = main()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(summary))
