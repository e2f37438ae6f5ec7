"""ZeRO-1 shard geometry and the sharded AdamW step.

Counterpart of ``acco_tpu/parallel/zero1.py``. The flat vector is padded
to ``world_size * ceil(P / world_size)`` and each rank owns one float32
shard with its Adam moments. Over more than one rank (the dp x sp group
of context parallelism) the step is ``reduce_scatter_tensor`` (sum) of
the flat gradient, AdamW on this rank's float32 shard, and
``all_gather_into_tensor`` of the result in the parameter dtype; the sum
in the scatter is also what adds the sequence shards' partial gradients.
At one rank both collectives are the identity and none runs.
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


def init_zero1_state(
    flat_params_f32: torch.Tensor, geom: ShardGeometry, shard_index: int = 0
) -> Zero1State:
    """This rank's shard of the padded float32 parameters, its zero
    moments and the counters."""
    S = geom.shard_size
    shard = geom.pad_flat(flat_params_f32.float())
    if geom.world_size > 1:
        shard = shard[shard_index * S:(shard_index + 1) * S].clone()
    device = shard.device
    return Zero1State(
        opt=init_adamw_state(shard),
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
    group=None,
):
    """One sharded AdamW step: reduce-scatter (sum) over ``group`` ->
    average by the grad count -> AdamW on this rank's float32 shard ->
    all-gather. Returns ``(new_flat [padded_size] in
    out_dtype, new opt shard)`` plus an :class:`UpdateHealth` when
    ``with_health`` (its two sums of squares all-reduced over the group);
    the caller applies the verdict. ``group`` None is one rank with no
    collective; a group of one rank runs them (the identity)."""
    if group is None and geom.world_size != 1:
        raise ValueError(f"a world of {geom.world_size} ranks needs a process group")
    import torch.distributed as dist

    S = opt_shard.params.numel()
    if group is not None:
        grads = torch.empty(S, dtype=torch.float32, device=flat_grads.device)
        dist.reduce_scatter_tensor(grads, flat_grads.float(), op=dist.ReduceOp.SUM, group=group)
        flat_grads = grads
    # AdamW runs chunk by chunk into fresh output buffers: the same
    # arithmetic per element as one call over the shard, but eager
    # PyTorch would hold about seven shard-sized float32 temporaries at
    # once (35 GB at 1.5e9 parameters), and the chunks hold a few of
    # CHUNK elements instead.
    shard_index = 0 if group is None else dist.get_rank(group)
    pad_mask = geom.shard_pad_mask(shard_index, flat_grads.device)
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
    if group is not None:
        gathered = torch.empty(geom.padded_size, dtype=out_dtype, device=new_flat.device)
        dist.all_gather_into_tensor(gathered, new_flat, group=group)
        new_flat = gathered
    if not with_health:
        return new_flat, out
    if group is not None:  # the shards partition the vector: one [2] all-reduce
        sums = torch.stack([grad_ss, param_ss])
        dist.all_reduce(sums, group=group)
        grad_ss, param_ss = sums[0], sums[1]
    ok = torch.isfinite(grad_ss) & torch.isfinite(param_ss)
    if max_grad_norm and max_grad_norm > 0:
        ok = ok & (grad_ss <= float(max_grad_norm) ** 2)
    return new_flat, out, UpdateHealth(ok=ok, grad_norm=grad_ss.sqrt())
