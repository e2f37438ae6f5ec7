"""ZeRO-1 shard geometry and the sharded AdamW step, at one rank.

Counterpart of ``acco_tpu/parallel/zero1.py``. The flat vector is padded
to ``world_size * ceil(P / world_size)`` and each rank owns one float32
shard with its Adam moments. At world size 1 the reduce-scatter and the
all-gather of ``zero1_update_shard`` are the identity, so this module
runs no collective; the NCCL versions come with the multi-rank slice
(ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from acco_tpu_torch.ops.adamw import AdamWState, adamw_shard_update, init_adamw_state


@dataclasses.dataclass(frozen=True)
class ShardGeometry:
    n_params: int
    world_size: int

    @property
    def shard_size(self) -> int:
        return -(-self.n_params // self.world_size)  # ceil

    @property
    def padded_size(self) -> int:
        return self.shard_size * self.world_size

    def pad_flat(self, flat: torch.Tensor) -> torch.Tensor:
        return F.pad(flat, (0, self.padded_size - self.n_params))

    def shard_pad_mask(self, shard_index: int, device=None) -> Optional[torch.Tensor]:
        """[S] float32 mask of real positions of one shard, or None when
        the shard holds no padding (a multiply by ones changes nothing)."""
        start = shard_index * self.shard_size
        n_real = min(max(self.n_params - start, 0), self.shard_size)
        if n_real == self.shard_size:
            return None
        return (torch.arange(self.shard_size, device=device) < n_real).float()


class UpdateHealth(NamedTuple):
    ok: torch.Tensor  # bool scalar: the update is safe to commit
    grad_norm: torch.Tensor  # float32 scalar: L2 norm of the averaged gradient


class Zero1State(NamedTuple):
    opt: AdamWState
    sched_grads: torch.Tensor  # int32 scalar: the LR schedule's counter
    grads_committed: torch.Tensor  # float32 scalar: committed micro-grads


def init_zero1_state(flat_params_f32: torch.Tensor, geom: ShardGeometry) -> Zero1State:
    padded = geom.pad_flat(flat_params_f32.float())
    device = padded.device
    return Zero1State(
        opt=init_adamw_state(padded),
        sched_grads=torch.zeros((), dtype=torch.int32, device=device),
        grads_committed=torch.zeros((), dtype=torch.float32, device=device),
    )


def zero1_update_shard(
    flat_grads: torch.Tensor,  # [padded_size] float32, this rank's grad sum
    opt_shard: AdamWState,
    grad_divisor: torch.Tensor,  # float32 scalar: total micro-grad count
    lr: torch.Tensor,
    geom: ShardGeometry,
    weight_decay: float,
    beta1: float,
    beta2: float,
    eps: float = 1e-8,
    out_dtype=torch.bfloat16,
    with_health: bool = False,
    max_grad_norm: float = 0.0,
):
    """One sharded AdamW step: (reduce-scatter) -> average by the grad
    count -> AdamW on the float32 shard -> (all-gather). Returns
    ``(new_flat [padded_size] in out_dtype, new opt shard)`` plus an
    :class:`UpdateHealth` when ``with_health``; the caller applies the
    verdict."""
    if geom.world_size != 1:
        raise NotImplementedError(
            "ZeRO-1 over more than one rank needs the NCCL collectives: "
            "ROADMAP.md queue 1, item 4"
        )
    grad_shard = flat_grads.float() / grad_divisor.float()
    pad_mask = geom.shard_pad_mask(0, flat_grads.device)
    new_opt = adamw_shard_update(
        opt_shard, grad_shard, lr=lr, weight_decay=weight_decay,
        beta1=beta1, beta2=beta2, eps=eps, pad_mask=pad_mask,
    )
    new_flat = new_opt.params.to(out_dtype)
    if not with_health:
        return new_flat, new_opt
    # where(), not a multiply, drops the padded tail: NaN * 0 is NaN
    if pad_mask is None:
        grad_ss = grad_shard.square().sum()
        param_ss = new_opt.params.square().sum()
    else:
        real = pad_mask > 0
        zero = torch.zeros((), device=grad_shard.device)
        grad_ss = torch.where(real, grad_shard, zero).square().sum()
        param_ss = torch.where(real, new_opt.params, zero).square().sum()
    ok = torch.isfinite(grad_ss) & torch.isfinite(param_ss)
    if max_grad_norm and max_grad_norm > 0:
        ok = ok & (grad_ss <= float(max_grad_norm) ** 2)
    return new_flat, new_opt, UpdateHealth(ok=ok, grad_norm=grad_ss.sqrt())
