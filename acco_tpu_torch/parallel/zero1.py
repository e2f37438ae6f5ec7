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

CHUNK = 1 << 26  # elements of the shard updated at a time (256 MB of float32)


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
    # AdamW runs chunk by chunk into fresh output buffers: the same
    # arithmetic per element as one call over the shard, but eager
    # PyTorch would hold about seven shard-sized float32 temporaries at
    # once (35 GB at 1.5e9 parameters), and the chunks hold a few of
    # CHUNK elements instead.
    S = opt_shard.params.numel()
    pad_mask = geom.shard_pad_mask(0, flat_grads.device)
    new_flat = torch.empty(S, dtype=out_dtype, device=flat_grads.device)
    out = AdamWState(
        params=torch.empty_like(opt_shard.params),
        mu=torch.empty_like(opt_shard.mu),
        nu=torch.empty_like(opt_shard.nu),
        count=opt_shard.count + 1,
    )
    zero = torch.zeros((), device=flat_grads.device)
    grad_ss, param_ss = zero, zero
    for lo in range(0, S, CHUNK):
        c = slice(lo, min(lo + CHUNK, S))
        grad_shard = flat_grads[c].float() / grad_divisor.float()
        mask = None if pad_mask is None else pad_mask[c]
        upd = adamw_shard_update(
            AdamWState(opt_shard.params[c], opt_shard.mu[c], opt_shard.nu[c], opt_shard.count),
            grad_shard, lr=lr, weight_decay=weight_decay,
            beta1=beta1, beta2=beta2, eps=eps, pad_mask=mask,
        )
        for dst, src in zip(out[:3], upd[:3]):
            dst[c] = src
        new_flat[c] = upd.params.to(out_dtype)
        if with_health:
            # where(), not a multiply, drops the padded tail: NaN * 0 is NaN
            g, prm = grad_shard, upd.params
            if mask is not None:
                real = mask > 0
                g, prm = torch.where(real, g, zero), torch.where(real, prm, zero)
            grad_ss = grad_ss + g.square().sum()
            param_ss = param_ss + prm.square().sum()
    if not with_health:
        return new_flat, out
    ok = torch.isfinite(grad_ss) & torch.isfinite(param_ss)
    if max_grad_norm and max_grad_norm > 0:
        ok = ok & (grad_ss <= float(max_grad_norm) ** 2)
    return new_flat, out, UpdateHealth(ok=ok, grad_norm=grad_ss.sqrt())
