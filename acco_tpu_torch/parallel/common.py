"""Shared pieces of the training modes: the microbatch block, the health
counters, the flat loss and gradient accumulation.

Counterpart of ``acco_tpu/parallel/common.py``. A microbatch whose
``valid`` entry is 0 still runs but contributes no gradient and no count
(heterogeneous workers). Nothing here reads a value back to the host.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

import torch

from acco_tpu_torch.ops.losses import model_ce, real_vocab_of, resolve_fused_loss

log = logging.getLogger("acco_tpu_torch")


class MicrobatchBlock(NamedTuple):
    """One round's microbatches: [n_acc, batch, seq] leaves + valid [n_acc]."""

    input_ids: torch.Tensor
    attention_mask: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor  # float32; 0.0 drops a microbatch's gradient and count


class HealthState(NamedTuple):
    """The in-program guard's counters (see the JAX HealthState)."""

    skipped_rounds: torch.Tensor  # int32 scalar
    consec_skipped: torch.Tensor  # int32 scalar
    pending_ok: torch.Tensor  # float32 0/1: verdict on the staged grads


def init_health(device) -> HealthState:
    return HealthState(
        skipped_rounds=torch.zeros((), dtype=torch.int32, device=device),
        consec_skipped=torch.zeros((), dtype=torch.int32, device=device),
        pending_ok=torch.ones((), dtype=torch.float32, device=device),
    )


def block_from_numpy(block: dict, device) -> MicrobatchBlock:
    """A host block (numpy, from data.loader.stack_microbatches) on ``device``."""

    def put(key, dtype):
        return torch.as_tensor(block[key]).to(device=device, dtype=dtype)

    return MicrobatchBlock(
        input_ids=put("input_ids", torch.long),
        attention_mask=put("attention_mask", torch.int32),
        labels=put("labels", torch.long),
        valid=put("valid", torch.float32),
    )


def make_flat_loss_fn(
    model, label_smoothing: float = 0.0, const_len: bool = False,
    fused_loss: "bool | str" = False,
) -> Callable:
    """``value_and_grad(flat_params, batch) -> (loss, grads)``: the model
    computes with the parameters held in ``flat_params`` (views, no copy)
    and ``grads`` are its per-parameter gradients in flat order.

    Const-len packed data carries all-ones masks by contract, so with
    ``const_len`` the mask is dropped statically, as in the JAX flat loss
    (the fused kernel then runs without its pad operand).

    ``fused_loss`` (False | 'auto' | 'chunk' | 'pallas') is resolved once,
    here, against the model (``ops.losses.resolve_fused_loss``, warning
    through the log on a downgrade); the loss then goes through
    ``ops.losses.model_ce``: 'pallas' is the fused lm-head + CE kernel
    (K3), 'chunk' the chunked loss, False the materialized CE."""
    params = [p for p, _, _ in model.flat_slices()]
    real_vocab = real_vocab_of(model)
    fused = resolve_fused_loss(fused_loss, model, real_vocab, warn=log.warning)

    def value_and_grad(flat_params: torch.Tensor, batch: dict):
        model.load_flat(flat_params)
        am = None if const_len else batch["attention_mask"]
        with torch.enable_grad():
            loss = model_ce(
                model, batch["input_ids"], am, batch["labels"],
                label_smoothing=label_smoothing, fused=fused, real_vocab=real_vocab,
            )
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    value_and_grad.fused_loss = fused
    return value_and_grad


def accumulate_grads(
    value_and_grad: Callable,
    model,
    flat_params: torch.Tensor,
    block: MicrobatchBlock,
    grad_init: Optional[torch.Tensor] = None,
    count_init: Optional[torch.Tensor] = None,
):
    """Run the block's microbatches; return (grad_sum float32 [Pp], count,
    loss_weighted_sum). Each microbatch's gradient is widened to float32
    and weighted by its ``valid`` entry before it joins the sum.
    ``grad_init``, when given, is the sum's buffer and is added into in
    place: the caller hands over a buffer of its own."""
    grad_sum = (
        grad_init
        if grad_init is not None
        else torch.zeros(flat_params.shape, dtype=torch.float32, device=flat_params.device)
    )
    zero = torch.zeros((), dtype=torch.float32, device=flat_params.device)
    count = count_init.clone() if count_init is not None else zero.clone()
    loss_wsum = zero.clone()
    slices = model.flat_slices()
    for a in range(block.valid.shape[0]):
        batch = {
            "input_ids": block.input_ids[a],
            "attention_mask": block.attention_mask[a],
            "labels": block.labels[a],
        }
        loss, grads = value_and_grad(flat_params, batch)
        valid = block.valid[a]
        for (_, offset, numel), g in zip(slices, grads):
            grad_sum[offset : offset + numel] += g.reshape(-1).float() * valid
        count = count + valid
        loss_wsum = loss_wsum + loss * valid
    return grad_sum, count, loss_wsum


def mean_loss(loss_weighted_sum: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Valid-count-weighted mean loss (one rank: no reduction)."""
    return loss_weighted_sum / valid.sum().clamp(min=1.0)


def staged_ok(grad_sum: torch.Tensor, loss: torch.Tensor) -> torch.Tensor:
    """float32 0/1 verdict on the grads a round stages: finite loss and a
    finite grad sum."""
    return (torch.isfinite(loss) & torch.isfinite(grad_sum).all()).float()
