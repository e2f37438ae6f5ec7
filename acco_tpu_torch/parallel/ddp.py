"""The synchronous baseline: data parallelism with ZeRO-1 sharded AdamW.

Counterpart of ``acco_tpu/parallel/ddp.py``'s ``DDPTrainStep``, its flat
dp x sp path: each step runs the block's microbatches forward and
backward, all-reduces the micro-grad count over dp, reduce-scatters the
flat gradient over dp x sp, applies AdamW to this rank's float32 shard
and all-gathers the new parameters. The schedule advances by one per
update, or by the count with ``lr_grad_accounting`` (JAX: ddp.py:285).

It follows JAX's flat design, not ``torch.nn.parallel.
DistributedDataParallel``, so that its flat vectors and optimizer shards
compare directly with JAX's. Its communication consumes the gradients
of the same step, so it has no second stream: that is what ACCO removes.
The guard: an unhealthy update commits nothing, bit-exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from acco_tpu_torch.ops.adamw import AdamWState
from acco_tpu_torch.parallel.common import (
    FlatTrainStep,
    HealthState,
    MicrobatchBlock,
    init_health,
)
from acco_tpu_torch.parallel.zero1 import Zero1State


class DDPState(NamedTuple):
    flat_params: torch.Tensor  # [Pp] param dtype, replicated
    zero1: Zero1State  # this rank's optimizer shard and the counters
    health: HealthState  # pending_ok: the loss was finite (layout parity with AccoState)


class StepMetrics(NamedTuple):
    loss: torch.Tensor  # valid-count-weighted world mean over the step's microbatches
    lr: torch.Tensor
    grads_this_step: torch.Tensor  # micro-grad count, summed over dp
    grad_norm: torch.Tensor  # L2 norm of the count-averaged gradient (0 without the guard)
    skipped: torch.Tensor  # bool: the guard suppressed this step's commit


class DDPTrainStep(FlatTrainStep):
    """DDP steps for one model, on one rank or on the ranks of ``groups``."""

    mode = "ddp"

    branch_probe = None  # see parallel/acco.py: DDP has the compute branch alone

    def init_state(self, flat_params: torch.Tensor) -> DDPState:
        """State from an [n_params] flat parameter vector (any float dtype)."""
        flat = self.geom.pad_flat(flat_params.to(self.model.dtype))
        return DDPState(flat_params=flat, zero1=self.init_zero1(flat_params),
                        health=init_health(flat.device))

    def step(self, state: DDPState, block: MicrobatchBlock, in_place: bool = False):
        """One step. ``in_place``: the new flat parameters and optimizer
        shard are written over the state's own (zero1's in-place step: the
        guard's verdict first, then ``where(ok, new, old)``), so that a
        captured step carries one buffer set (``compile/graphs.py``); the
        same bits as the step into new buffers."""
        if self.branch_probe is not None:
            self.branch_probe("compute")
        grad_sum, count, loss_wsum = self.accumulate(state.flat_params, block)
        raw_total = self.total_count(count)
        total = raw_total.clamp(min=1.0)
        lr = self.schedule(state.zero1.sched_grads)
        upd = self.update(grad_sum, state.zero1.opt, total, lr, in_place=in_place,
                          into=(state.flat_params, None) if in_place else None)
        loss = self.mean_loss(loss_wsum, block.valid)
        if self.nan_guard:
            new_flat, new_opt, uh = upd
            ok = uh.ok
            skipped = ~ok
            if in_place:  # selected chunk by chunk already; the count here
                new_opt = new_opt._replace(count=torch.where(ok, new_opt.count,
                                                             state.zero1.opt.count))
            else:
                new_flat = torch.where(ok, new_flat, state.flat_params, out=new_flat)
                new_opt = AdamWState(*(
                    torch.where(ok, new, old, out=new)
                    for new, old in zip(new_opt, state.zero1.opt)
                ))
            sched_inc = self.sched_increment(total, ok)
            committed = torch.where(ok, raw_total, torch.zeros_like(raw_total))
            grad_norm = uh.grad_norm
            health = HealthState(
                skipped_rounds=state.health.skipped_rounds + skipped.to(torch.int32),
                consec_skipped=torch.where(
                    skipped, state.health.consec_skipped + 1,
                    torch.zeros_like(state.health.consec_skipped),
                ),
                pending_ok=torch.isfinite(loss).float(),
            )
        else:
            new_flat, new_opt = upd
            skipped = torch.zeros((), dtype=torch.bool, device=loss.device)
            sched_inc = self.sched_increment(total, True)
            committed, grad_norm, health = raw_total, torch.zeros_like(loss), state.health
        new_state = DDPState(
            flat_params=new_flat,
            zero1=Zero1State(
                opt=new_opt,
                sched_grads=state.zero1.sched_grads + sched_inc,
                grads_committed=state.zero1.grads_committed + committed,
            ),
            health=health,
        )
        metrics = StepMetrics(loss=loss, lr=lr, grads_this_step=raw_total,
                              grad_norm=grad_norm, skipped=skipped)
        return new_state, metrics
