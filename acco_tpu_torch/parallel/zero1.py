"""ZeRO-1 shard geometry and the sharded AdamW step.

Counterpart of ``acco_tpu/parallel/zero1.py``. The flat vector is padded
to ``world_size * ceil(P / world_size)`` and each rank owns one float32
shard with its Adam moments: rank ``dp_index * sp + sp_index`` owns shard
``dp_index * sp + sp_index``, JAX's ``flat_shard_index(('dp', 'sp'))``,
so the shards equal JAX's per-device shards element for element. Over
more than one rank (the dp x sp group) the step is
``reduce_scatter_tensor`` (sum) of the flat gradient, AdamW on this
rank's float32 shard, and ``all_gather_into_tensor`` of the result in
the parameter dtype; the sum in the scatter adds the data-parallel
ranks' gradients and the sequence shards' partial gradients. At one rank
both collectives are the identity and none runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

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
    shard_index: Optional[int] = None,
    keep_state: bool = True,
    alloc: Optional[Callable[[int, torch.dtype], torch.Tensor]] = None,
):
    """One sharded AdamW step: reduce-scatter (sum) over ``group`` ->
    average by the grad count -> AdamW on this rank's float32 shard ->
    all-gather. Returns ``(new_flat [padded_size] in
    out_dtype, new opt shard)`` plus an :class:`UpdateHealth` when
    ``with_health`` (its two sums of squares all-reduced over the group);
    the caller applies the verdict. ``group`` None is one rank with no
    collective; a group of one rank runs them (the identity).
    ``shard_index`` (default: the rank in ``group``) must be the rank's
    place in ``group``, whose reduce-scatter hands it that shard.

    ``keep_state`` False (ACCO's speculative half-step, whose optimizer
    state is dropped) stores no new moments or master parameters: the
    step returns ``opt_shard`` itself, and only the new flat parameters
    are written, as XLA drops the dead outputs in JAX. ``alloc(numel,
    dtype)`` makes the shard-sized buffers, the returned ones and the
    reduce-scatter's output (default: ``torch.empty`` on the gradient's
    device); the chunks' temporaries come from ``torch.empty``."""
    if group is None and geom.world_size != 1:
        raise ValueError(f"a world of {geom.world_size} ranks needs a process group")
    import torch.distributed as dist

    S = opt_shard.params.numel()
    device = flat_grads.device
    empty = alloc or (lambda n, dtype: torch.empty(n, dtype=dtype, device=device))
    if group is not None:
        grads = empty(S, torch.float32)
        dist.reduce_scatter_tensor(grads, flat_grads.float(), op=dist.ReduceOp.SUM, group=group)
        flat_grads = grads
    # AdamW runs chunk by chunk into fresh output buffers: the same
    # arithmetic per element as one call over the shard, but eager
    # PyTorch would hold about seven shard-sized float32 temporaries at
    # once (35 GB at 1.5e9 parameters), and the chunks hold a few of
    # CHUNK elements instead.
    in_group = 0 if group is None else dist.get_rank(group)
    if shard_index is None:
        shard_index = in_group
    elif shard_index != in_group:
        raise ValueError(f"shard {shard_index} would receive the reduce-scatter's chunk "
                         f"{in_group}: the group's ranks are not in dp x sp order")
    pad_mask = geom.shard_pad_mask(shard_index, device)
    if group is not None:  # the shard is written in place of the all-gather's slice
        gathered = empty(geom.padded_size, out_dtype)
        new_flat = gathered[shard_index * S:(shard_index + 1) * S]
    else:
        new_flat = empty(S, out_dtype)
    out = opt_shard
    if keep_state:
        out = AdamWState(*(empty(S, torch.float32) for _ in range(3)),
                         count=opt_shard.count + 1)
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
        if keep_state:
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
