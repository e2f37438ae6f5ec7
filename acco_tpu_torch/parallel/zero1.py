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

Tensor parallelism (``tp``, JAX ``zero1.py:205-300``): the step runs
within one tp index, over its local flat vector, and applies JAX's
gradient correction (``parallel/tp.py``): the count divisor is
multiplied by tp, the replicated prefix (the local vector's first
``n_repl`` positions) is summed over the tensor group after the
division, and the guard's sums of squares count that prefix once (its
squares divided by tp before the all-reduce over every rank). Under
pipeline parallelism the same terms run over the pipeline group
(``parallel/pp.py``): ``tp`` is then pp and the prefix the stage's
replicated leaves. Under tp x pp (``parallel/tp.ComposedLayout``; JAX
``zero1.py:205-240, 266-295``) ``tp`` is pp x tp and the prefix has two
segments: ``[0:n_repl_both)``, replicated on both axes, is summed over
the combined (pp, tp) group and counted once in the guard's sums (its
squares divided by pp x tp), ``[n_repl_both:n_repl)``, each stage's own
tp-replicated leaves, is summed over the stage's tensor group only and
its squares divided by tp.
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
    into: Optional[tuple] = None,
    in_place: bool = False,
    tp: int = 1,
    n_repl: int = 0,
    tensor_group=None,
    health_group=None,
    n_repl_both: int = 0,
    inner: int = 1,
    inner_group=None,
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
    device); the chunks' temporaries come from ``torch.empty``.
    ``into`` ``(flat [padded_size] out_dtype, AdamWState[, scatter])``:
    buffers of the caller's that the returned flat parameters and (with
    ``keep_state``) the new moments and master parameters are written
    into instead (a captured round's next buffer set, ``compile/graphs.py``),
    and the reduce-scatter's [S] float32 output, which may be one of the
    new shard's buffers: each chunk of it is read before that chunk of
    the shard is written. None may be an input. ``in_place`` (``into`` the flat parameters
    the gradients came from, ``(flat, None)``): the step writes its new
    flat parameters and optimizer shard over the old ones, where the
    update is healthy (with ``with_health`` a first pass over the chunks
    computes the verdict and writes nothing; the second writes
    ``where(ok, new, old)``, the same bits as a step into new buffers
    followed by the caller's select). A captured DDP step carries one
    buffer set so (``compile/graphs.py``).

    ``tp``, ``n_repl``, ``tensor_group`` (the comm twin of the model
    group) and ``health_group`` (every rank; default ``group``): the
    tensor-parallel terms (module doc); ``n_repl_both`` (the prefix's
    first positions, replicated on every model axis: all ``n_repl`` of
    them but under tp x pp), ``inner`` and ``inner_group`` (the comm twin
    of the tensor group): the second prefix segment of tp x pp."""
    if group is None and geom.world_size != 1:
        raise ValueError(f"a world of {geom.world_size} ranks needs a process group")
    import torch.distributed as dist

    S = opt_shard.params.numel()
    device = flat_grads.device
    empty = alloc or (lambda n, dtype: torch.empty(n, dtype=dtype, device=device))
    if group is not None:
        grads = into[2] if into is not None and len(into) > 2 else empty(S, torch.float32)
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
    divisor = grad_divisor.float() * tp if tp > 1 else grad_divisor.float()
    # the replicated prefix's positions in this shard: its first k, of
    # which the first kb are replicated on every model axis
    first = shard_index * S
    k = min(max(n_repl - first, 0), S) if tp > 1 else 0
    kb = min(max(n_repl_both - first, 0), k)
    synced = repl_weight = None
    if k:
        synced = flat_grads[:k].float() / divisor
        for seg, g in ((synced[:kb], tensor_group), (synced[kb:], inner_group)):
            if seg.numel() and g is not None:
                dist.all_reduce(seg, group=g)
        # each prefix position's share in the guard's sums: one over its copies
        repl_weight = torch.cat([torch.full((kb,), 1.0 / tp, device=device),
                                 torch.full((k - kb,), 1.0 / inner, device=device)])
    into_flat, into_opt = into[:2] if into is not None else (None, None)
    if group is not None:  # the shard is written in place of the all-gather's slice
        gathered = into_flat if into_flat is not None else empty(geom.padded_size, out_dtype)
        new_flat = gathered[shard_index * S:(shard_index + 1) * S]
    else:
        new_flat = into_flat if into_flat is not None else empty(S, out_dtype)
    out = opt_shard
    if in_place:
        if not keep_state:
            raise ValueError("an in-place step keeps its state")
        out = opt_shard._replace(count=opt_shard.count + 1)
    elif keep_state:
        bufs = (into_opt[:3] if into_opt is not None
                else [empty(S, torch.float32) for _ in range(3)])
        out = AdamWState(*bufs, count=opt_shard.count + 1)
    zero = torch.zeros((), device=flat_grads.device)

    def chunk(lo: int):
        c = slice(lo, min(lo + CHUNK, S))
        grad_shard = flat_grads[c].float() / divisor
        if lo < k:
            grad_shard[: min(k, c.stop) - lo] = synced[lo:min(k, c.stop)]
        mask = None if pad_mask is None else pad_mask[c]
        upd = adamw_shard_update(
            AdamWState(opt_shard.params[c], opt_shard.mu[c], opt_shard.nu[c], opt_shard.count),
            grad_shard, lr=lr, weight_decay=weight_decay,
            beta1=beta1, beta2=beta2, eps=eps, pad_mask=mask,
        )
        return c, grad_shard, mask, upd

    def add_health(sums, lo, grad_shard, mask, prm):
        # where(), not a multiply, drops the padded tail: NaN * 0 is NaN
        g = grad_shard
        if mask is not None:
            real = mask > 0
            g, prm = torch.where(real, g, zero), torch.where(real, prm, zero)
        g2, p2 = g.square(), prm.square()
        if lo < k:  # the replicated prefix sits on every tp shard: count it once
            r = min(k, lo + g2.numel()) - lo
            w = repl_weight[lo:lo + r]
            g2 = torch.cat([g2[:r] * w, g2[r:]])
            p2 = torch.cat([p2[:r] * w, p2[r:]])
        return sums[0] + g2.sum(), sums[1] + p2.sum()

    hgroup = health_group if health_group is not None else group

    def verdict(grad_ss, param_ss):
        if hgroup is not None:  # the shards partition the model: one [2] all-reduce
            sums = torch.stack([grad_ss, param_ss])
            dist.all_reduce(sums, group=hgroup)
            grad_ss, param_ss = sums[0], sums[1]
        ok = torch.isfinite(grad_ss) & torch.isfinite(param_ss)
        if max_grad_norm and max_grad_norm > 0:
            ok = ok & (grad_ss <= float(max_grad_norm) ** 2)
        return grad_ss, ok

    sums, ok = (zero, zero), None
    if in_place and with_health:  # the verdict first: the writes below are final
        for lo in range(0, S, CHUNK):
            _, grad_shard, mask, upd = chunk(lo)
            sums = add_health(sums, lo, grad_shard, mask, upd.params)
        grad_ss, ok = verdict(*sums)
    for lo in range(0, S, CHUNK):
        c, grad_shard, mask, upd = chunk(lo)
        if in_place:
            for dst, src in zip(out[:3], upd[:3]):
                dst[c] = src if ok is None else torch.where(ok, src, dst[c])
            new = upd.params.to(out_dtype)
            new_flat[c] = new if ok is None else torch.where(ok, new, new_flat[c])
            continue
        if keep_state:
            for dst, src in zip(out[:3], upd[:3]):
                dst[c] = src
        new_flat[c] = upd.params.to(out_dtype)
        if with_health:
            sums = add_health(sums, lo, grad_shard, mask, upd.params)
    if group is not None:
        dist.all_gather_into_tensor(gathered, new_flat, group=group)
        new_flat = gathered
    if not with_health:
        return new_flat, out
    if ok is None:
        grad_ss, ok = verdict(*sums)
    return new_flat, out, UpdateHealth(ok=ok, grad_norm=grad_ss.sqrt())
