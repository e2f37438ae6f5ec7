"""Shared pieces of the training modes: the microbatch block, the health
counters, the flat loss and gradient accumulation.

Counterpart of ``acco_tpu/parallel/common.py``. A microbatch whose
``valid`` entry is 0 still runs but contributes no gradient and no count
(heterogeneous workers). Nothing here reads a value back to the host.

Data parallelism: each rank runs its own rows of the global block (its
dp index's batch slice) and its ``valid`` column; the loss metric and
the staged-grads verdict are reduced over the dp x sp world, the valid
count over dp (:func:`world_mean_loss`).

Context parallelism (a ``SequenceGroup``): :func:`prep_cp_leaves` shifts
the labels on the global sequence, applies the zig-zag permutation and
keeps this rank's chunk; the flat loss is then this rank's partial (its
chunk's loss sum over the global token count, all-reduced), so the
partials and their gradients sum over the group to the full microbatch's
(:func:`world_mean_loss`; ZeRO-1's reduce-scatter sums the gradients).

Tensor parallelism (a model built on a ``TensorGroup``): every rank of a
tensor group runs the same rows with its shard's parameters; the loss is
the vocab-parallel CE (the same value on each of them), so the loss
metric and the valid count reduce over dp x sp as without tp, while the
staged-grads verdict reduces over every rank (each tp shard stages a
different piece of the model), and ZeRO-1 runs JAX's tp terms
(``parallel/zero1.py``).

Pipeline parallelism (a model built on a pipeline group): the tensor
group's place is taken by the pipeline group, JAX's *model group*
(``acco_tpu/parallel/acco.py:232-237``): the block runs through the GPipe
loop (``parallel/pp.py``), whose loss is the same on every stage, so the
loss metric and the count reduce over dp as under tp, the verdict over
every rank, and ZeRO-1 runs the same tp terms over the pipeline group.

The compositions (JAX ``acco.py:225-275``): under tp x pp the model
group is the combined (pp, tp) group, the layout ``ComposedLayout``, and
ZeRO-1 syncs its two replicated segments (``parallel/zero1.py``); with
sp the chunk's loss is the vocab-parallel partial over the group's
target count (tp x sp), or the pipeline's (pp x sp).
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional

import torch

from acco_tpu_torch.ops.losses import (
    IGNORE_INDEX,
    model_ce,
    real_vocab_of,
    resolve_fused_loss,
    shift_labels,
)

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


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` (the identity with no group)."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=group)
    return x


def prep_cp_leaves(block: MicrobatchBlock, sg, zigzag: bool) -> MicrobatchBlock:
    """This rank's chunk of a global block under context parallelism: the
    labels shifted to next-token targets on the global sequence, the
    sequence reordered into the zig-zag layout when ``zigzag``, then the
    rank's contiguous slice. No-op without a sequence group."""
    if sg is None:
        return block
    from acco_tpu_torch.ops.ring_attention import zigzag_permutation

    ids, am, labels = block.input_ids, block.attention_mask, shift_labels(block.labels)
    L = ids.shape[-1]
    if zigzag:
        perm = torch.as_tensor(zigzag_permutation(L, sg.size)[0], device=ids.device)
        ids, am, labels = (x.index_select(-1, perm) for x in (ids, am, labels))
    lc = L // sg.size
    chunk = slice(sg.rank * lc, (sg.rank + 1) * lc)
    return MicrobatchBlock(
        input_ids=ids[..., chunk].contiguous(),
        attention_mask=am[..., chunk].contiguous(),
        labels=labels[..., chunk].contiguous(),
        valid=block.valid,
    )


def make_flat_loss_fn(
    model, label_smoothing: float = 0.0, const_len: bool = False,
    fused_loss: "bool | str" = False, sequence_group=None,
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
    (K3), 'chunk' the chunked loss, False the materialized CE.

    With ``sequence_group`` (context parallelism) the batch is this rank's
    chunk (:func:`prep_cp_leaves`): pre-shifted labels, no pad mask, and
    the loss is the chunk's partial over the group's total target count.

    Under tensor parallelism (the model's ``tensor_group``) the loss is
    vocab-parallel: 'pallas' is K3's wrapper on the shard's head slice,
    anything else the materialized vocab-parallel CE (JAX:
    ``parallel/common.py:140-162``)."""
    params = [p for p, _, _ in model.flat_slices()]
    real_vocab = real_vocab_of(model)
    vocab_group = getattr(model, "model_group", None)
    fused = resolve_fused_loss(
        fused_loss, model, real_vocab, warn=log.warning, seq_sharded=sequence_group is not None,
        n_vocab_shards=1 if vocab_group is None else vocab_group.size,
    )
    if vocab_group is not None and fused != "pallas":
        fused = False  # only the kernel has a sharded form besides the materialized CE

    def loss_of(batch: dict) -> torch.Tensor:
        if sequence_group is None:
            am = None if const_len else batch["attention_mask"]
            return model_ce(
                model, batch["input_ids"], am, batch["labels"],
                label_smoothing=label_smoothing, fused=fused, real_vocab=real_vocab,
                vocab_group=vocab_group,
            )
        targets = batch["labels"]
        num_valid = _all_reduce((targets != IGNORE_INDEX).sum().float(), sequence_group.group)
        return model_ce(
            model, batch["input_ids"], None, targets,
            label_smoothing=label_smoothing, fused=fused, real_vocab=real_vocab,
            num_valid=num_valid, shift=False, vocab_group=vocab_group,
        )

    def value_and_grad(flat_params: torch.Tensor, batch: dict):
        model.load_flat(flat_params)
        with torch.enable_grad():
            loss = loss_of(batch)
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


def world_mean_loss(
    loss_weighted_sum: torch.Tensor, valid: torch.Tensor, loss_group=None, count_group=None
) -> torch.Tensor:
    """Valid-count-weighted mean loss over the whole mesh: ranks with
    masked-out microbatches do not dilute it. The loss sums over
    ``loss_group`` (dp x sp: under context parallelism each rank's loss is
    a partial of its microbatches' losses), the valid count over
    ``count_group`` (dp only: a microbatch is one unit however many
    sequence shards computed it), as JAX's ``world_mean_loss``."""
    total = _all_reduce(loss_weighted_sum.clone(), loss_group)
    count = _all_reduce(valid.sum(), count_group)
    return total / count.clamp(min=1.0)


def staged_ok(grad_sum: torch.Tensor, loss: torch.Tensor, group=None) -> torch.Tensor:
    """float32 0/1 verdict on the grads a round stages: finite loss and a
    finite grad sum on every rank of ``group`` (every rank: the axes the
    gradient is reduced over, and the tp shards, which stage different
    pieces of the model; one scalar all-reduce), so that the verdict, a
    replicated leaf, agrees across ranks."""
    bad = _all_reduce((~torch.isfinite(grad_sum).all()).float(), group)
    return (torch.isfinite(loss) & (bad == 0)).float()


class FlatTrainStep:
    """What the ACCO/DPU round and the DDP step share: the model's flat
    loss, the rank groups, ZeRO-1's geometry over dp x sp, the AdamW
    settings, the guard and the LR accounting.

    ``groups`` (a ``parallel.mesh.RankGroups``) are the ranks' process
    groups; without them, a ``sequence_group`` alone is dp 1 over its
    ranks, and neither is one rank with no collective. Context
    parallelism (a ``sequence_group``) needs a ring-attention model built
    on that group; tensor or pipeline parallelism (the model group
    ``groups.tensor``) a model built on the groups' tensor and pipeline
    groups, whose flat vector is its shard's, its stage's or its stage's
    shard's (``tp_layout``; ``sharding/layout.check_pairing``), and
    ``self.tp`` is the model group's size. Under pp the accumulation is
    the GPipe loop (``parallel/pp.py``) and ``value_and_grad`` its block
    loss."""

    def __init__(
        self,
        model,
        schedule,
        *,
        weight_decay: float,
        beta1: float,
        beta2: float,
        eps: float = 1e-8,
        label_smoothing: float = 0.0,
        const_len_batch: bool = False,
        nan_guard: bool = True,
        guard_max_grad_norm: float = 0.0,
        fused_loss: "bool | str" = False,
        lr_grad_accounting: bool = False,
        sequence_group=None,
        groups=None,
    ):
        from acco_tpu_torch.parallel.mesh import RankGroups
        from acco_tpu_torch.parallel.zero1 import ShardGeometry
        from acco_tpu_torch.sharding.layout import check_pairing

        self.model = model
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.nan_guard = bool(nan_guard)
        self.guard_max_grad_norm = float(guard_max_grad_norm or 0.0)
        # False = the reference's schedule (one step a committed update);
        # True advances it by the committed micro-grad count (JAX: acco.py:612)
        self.lr_grad_accounting = bool(lr_grad_accounting)
        self.sequence_group = sequence_group
        self.groups = groups if groups is not None else RankGroups.of_sequence(sequence_group)
        g = self.groups
        check_pairing(model, g, sequence_group)
        self.pipelined = getattr(model, "pipeline_group", None) is not None
        # JAX's model_axis / tp_layout (acco.py:192-273): the local layout
        # and the tp terms of ZeRO-1, tp the model group's size (pp x tp
        # when composed), pp the pipeline's
        self.tp_layout = getattr(model, "tp_layout", None)
        mg = getattr(model, "model_group", None)
        self.tp = 1 if mg is None else mg.size
        self.pp = 1 if not self.pipelined else model.pipeline_group.size
        self.shard_index = 0 if g is None else g.shard_index
        self.geom = ShardGeometry(model.n_params, 1 if g is None else g.world_size)
        if self.pipelined:
            from acco_tpu_torch.parallel.pp import make_pp_loss_fn

            if not const_len_batch:
                raise ValueError("pipeline parallelism requires const_len_batch=True: the "
                                 "pipelined loss has no per-token attention mask")
            self.value_and_grad = make_pp_loss_fn(model, label_smoothing, fused_loss)
        else:
            self.value_and_grad = make_flat_loss_fn(
                model, label_smoothing, const_len_batch, fused_loss, sequence_group
            )

    @property
    def shard_axes(self):
        """The data axes ZeRO-1 shards over: 'dp', or ('dp', 'sp') under
        context parallelism (JAX: ``sharding/layout.py`` ``shard_layout``)."""
        return "dp" if self.sequence_group is None else ("dp", "sp")

    @property
    def model_axis(self):
        """JAX's model axis: None, 'tp', 'pp' or ('pp', 'tp')."""
        g = self.groups
        if g is None or g.tensor is None:
            return None
        return ("pp", "tp") if g.composed else g.model_axis

    def rule_table(self):
        """The train-state rule table of this step (``sharding/tables.py``;
        the static gates audit the state against it)."""
        from acco_tpu_torch.sharding.tables import train_state_table

        return train_state_table(self.mode, self.shard_axes, self.model_axis)

    def eval_rule_table(self):
        from acco_tpu_torch.sharding.tables import eval_state_table

        return eval_state_table(self.shard_axes, self.model_axis)

    def group(self, name: str):
        """One of ``groups``' process groups (None: one rank)."""
        return None if self.groups is None else getattr(self.groups, name)

    def init_zero1(self, flat_params: torch.Tensor):
        from acco_tpu_torch.parallel.zero1 import init_zero1_state

        return init_zero1_state(flat_params.float(), self.geom, self.shard_index)

    def accumulate(self, flat_params, block, grad_init=None, count_init=None):
        if self.pipelined:
            from acco_tpu_torch.parallel.pp import accumulate_grads_pipelined

            return accumulate_grads_pipelined(
                self.value_and_grad, self.model, flat_params, block,
                grad_init=grad_init, count_init=count_init,
            )
        return accumulate_grads(
            self.value_and_grad, self.model, flat_params, block,
            grad_init=grad_init, count_init=count_init,
        )

    def mean_loss(self, loss_wsum: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return world_mean_loss(loss_wsum, valid, self.group("world"), self.group("data"))

    def total_count(self, count: torch.Tensor) -> torch.Tensor:
        """The micro-grad count summed over dp, on the update's group: a
        fresh tensor (the all-reduce runs in place)."""
        return _all_reduce(count.clone(), self.group("comm_data"))

    def sched_increment(self, total: torch.Tensor, commit) -> torch.Tensor:
        """What a committed update adds to the schedule's counter: the
        count with ``lr_grad_accounting``, else 1; 0 where ``commit`` (a
        bool, or a bool tensor) says the update was not committed."""
        inc = (total.to(torch.int32) if self.lr_grad_accounting
               else torch.ones((), dtype=torch.int32, device=total.device))
        if isinstance(commit, bool):
            return inc if commit else torch.zeros_like(inc)
        return torch.where(commit, inc, torch.zeros_like(inc))

    def update(self, flat_grads, opt, total, lr, keep_state: bool = True, alloc=None,
               into=None, in_place: bool = False):
        """The sharded AdamW step over the comm group (see zero1; ``into``:
        the buffers its new flat parameters and optimizer shard go to;
        ``in_place``: over the old ones)."""
        from acco_tpu_torch.parallel.zero1 import zero1_update_shard

        return zero1_update_shard(
            flat_grads, opt, total, lr, self.geom,
            self.weight_decay, self.beta1, self.beta2, self.eps,
            out_dtype=self.model.dtype, with_health=self.nan_guard,
            max_grad_norm=self.guard_max_grad_norm, group=self.group("comm_world"),
            shard_index=self.shard_index, keep_state=keep_state, alloc=alloc, into=into,
            in_place=in_place, tp=self.tp,
            n_repl=0 if self.tp_layout is None else self.tp_layout.n_repl,
            tensor_group=self.group("comm_tensor"), health_group=self.group("comm_all"),
            n_repl_both=0 if self.tp_layout is None else self.tp_layout.n_repl_both,
            inner=1 if getattr(self.model, "tensor_group", None) is None
            else self.model.tensor_group.size,
            inner_group=self.group("comm_inner"),
        )
