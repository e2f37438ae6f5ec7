"""Pipeline parallelism: GPipe over a pipeline group.

Counterpart of ``acco_tpu/parallel/pp.py``. The layer stack splits into
``pp`` contiguous stages, one a rank of the pipeline group (the ranks of
one dp index, ``parallel/mesh.py``); the round's ``n_grad_accumulation``
microbatches are the pipeline's microbatches, so grad accumulation and
pipelining are one loop.

- **The parameter layout is ``TpLayout`` over the pp rule table**
  (``models/flat.py``, ``sharding/tables.py``): each stage's flat vector
  is ``[replicated leaves | this stage's slices]``, and ZeRO-1 shards it
  over the dp ranks of its pp index, as under tensor parallelism.
- **The schedule is GPipe, one loop over ``M + pp - 1`` ticks**, the same
  on every rank (JAX's ``lax.scan``, pp.py:128-233). Tick ``t``: stage 0
  injects microbatch ``t``'s embeddings (the vocab-parallel lookup, summed
  over the group); each stage runs its layers on what it holds; from
  tick ``pp - 1`` on, one masked all-reduce hands the last stage's output
  to every stage, and each stage computes its ``V/pp`` slice of the head
  and the vocab-parallel CE (``ops/losses.vocab_parallel_causal_lm_loss``,
  or K3's wrapper ``ops/fused_ce.vocab_parallel_fused_ce_loss`` under
  ``fused_loss='pallas'``), weighted by the microbatch's ``valid``; then
  the activation moves one hop to stage s+1 (no wraparound: stage 0
  receives zeros).
- **The backward schedule comes from autograd**: the hop is a
  :class:`torch.autograd.Function` whose forward sends to s+1 and receives
  from s-1 and whose backward sends the gradient to s-1 and receives from
  s+1 (``lax.ppermute``'s transpose). Every tick's compute, the hop left
  outside, is a non-reentrant ``torch.utils.checkpoint`` region (JAX's
  ``jax.checkpoint(tick_compute)``): one [b, L, D] activation is kept a
  tick, the rest recomputed in the backward.
- **Every rank issues the same collectives in the same order**, forward,
  recompute and backward: the stage-dependent choices are ``torch.where``
  over a mask, never a Python branch around a collective or around what
  feeds one, and the ticks' Python branches depend on ``t`` alone. Two
  ticks JAX computes and masks are skipped on every rank alike: the head
  and CE at the warm-up ticks (weight 0) and the embedding at the drain
  ticks (never reaches the loss); and a stage whose tick carries no
  microbatch (tick ``t`` holds microbatch ``t - s`` on stage ``s``) passes
  its input through instead of running its layers: what flows there
  never reaches the loss, its gradient is 0 in JAX's loop as well, and
  the pass-through keeps every collective connected to the loss as
  before.
- **Gradients follow JAX's ``check_vma=False`` convention**, as
  ``models/layers._TpSum`` reproduces it under tp: the masked broadcast,
  the lookup's sum and the CE's sums are all-reduces whose backward is
  the same sum, so every gradient carries a factor pp, which ZeRO-1's tp
  terms (``parallel/zero1.py``, over the pipeline group) take out, the
  replicated prefix summed over the group first.
- **The compositions** (JAX ``make_pp_loss_fn``'s ``vocab_axes`` and
  ``seq_axis``, pp.py:74-90, :110, :141, :178-188). Under tp x pp the
  stage is a tensor shard (its layers' all-reduces on the tensor group),
  and the lookup and the CE run over the model's vocab group, the
  combined (pp, tp) group, ``V / (pp * tp)`` columns a shard; the
  gradients then carry pp x tp. Under pp x sp each stage runs the ring
  (its hops on the sequence group, inside the tick's checkpoint region:
  the recompute reissues them, in the same order on every rank of the
  group, since the ranks of a sequence group are one stage), the labels
  come pre-shifted on the global sequence (``common.prep_cp_leaves``)
  and each microbatch's loss is this chunk's nll sum over the
  microbatch's global target count (summed over the sequence group), so
  that the partials sum over sp to the microbatch's mean, JAX's CP
  convention.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from acco_tpu_torch.models.layers import lm_logits, tp_all_reduce
from acco_tpu_torch.ops.losses import IGNORE_INDEX, real_vocab_of, resolve_fused_loss

log = logging.getLogger("acco_tpu_torch")


def _shift(x: torch.Tensor, pg, step: int) -> torch.Tensor:
    """``x`` moved ``step`` stages along the chain: stage ``s`` sends to
    ``s + step`` and receives from ``s - step``; a stage with no source
    gets zeros. No collective runs at one stage."""
    out = torch.zeros_like(x)
    dst, src = pg.rank + step, pg.rank - step
    ops = []
    import torch.distributed as dist

    if 0 <= dst < pg.size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(pg.group, dst),
                              pg.group))
    if 0 <= src < pg.size:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(pg.group, src), pg.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Hop(torch.autograd.Function):
    """One hop down the pipeline, JAX's ``lax.ppermute(x, pp, [(s, s +
    1)])``: the forward sends to stage s+1 and receives from s-1 (stage 0
    gets zeros), the backward sends the gradient to s-1 and receives from
    s+1."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _shift(x, pg, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.pg, -1), None


def make_pp_loss_fn(model, label_smoothing: float = 0.0,
                    fused_loss: "bool | str" = False) -> Callable:
    """The block loss of a pipeline stage (JAX ``make_pp_loss_fn``):
    ``loss_fn(flat_params, block) -> (loss_wsum, count)`` over the whole
    microbatch block (``parallel/common.MicrobatchBlock``, [M, b, L]
    leaves and ``valid`` [M]), the model computing with ``flat_params``
    (views, no copy); ``loss_wsum`` is the valid-weighted sum of the
    microbatches' mean losses, the same on every stage, and ``count``
    the valid sum. Runs as it is under ``torch.no_grad`` (the eval) and
    under autograd (:func:`accumulate_grads_pipelined`).

    ``fused_loss`` is resolved here against the per-shard vocab slice
    (``ops.losses.resolve_fused_loss`` with ``n_vocab_shards`` the vocab
    group's size: pp, or pp x tp): 'pallas' runs K3's vocab-parallel
    wrapper, anything else the materialized vocab-parallel CE ('chunk'
    has no sharded form). The verdict is ``loss_fn.fused_loss``. A model
    on a sequence group takes its chunk of a block whose labels are
    pre-shifted (the module's doc)."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    from acco_tpu_torch.ops.fused_ce import vocab_parallel_fused_ce_loss
    from acco_tpu_torch.ops.losses import vocab_parallel_causal_lm_loss

    pg = model.pipeline_group
    if pg is None:
        raise ValueError("make_pp_loss_fn needs a model built on a pipeline group")
    pp, stage = pg.size, pg.rank
    vg = model.model_group  # the vocab's group: pp, or the combined (pp, tp)
    sg = getattr(model, "sequence_group", None)
    real_vocab = real_vocab_of(model)
    fused = resolve_fused_loss(fused_loss, model, real_vocab, warn=log.warning,
                               n_vocab_shards=vg.size, seq_sharded=sg is not None)
    if fused != "pallas":
        fused = False  # only the kernel has a sharded form besides the materialized CE

    def ce(hid, labels):
        head = model.lm_head()  # [D, V/(pp*tp)]: this shard's vocab slice
        kw = dict(real_vocab=real_vocab)
        if sg is not None:  # the chunk's nll sum over the microbatch's global count
            import torch.distributed as dist

            count = (labels != IGNORE_INDEX).sum().float()
            dist.all_reduce(count, group=sg.group)
            kw.update(shift=False, num_valid=count)
        if fused == "pallas":
            return vocab_parallel_fused_ce_loss(hid, head, labels, vg, label_smoothing, **kw)
        return vocab_parallel_causal_lm_loss(lm_logits(hid, head), labels, vg,
                                             label_smoothing, **kw)

    def loss_fn(flat_params: torch.Tensor, block):
        model.load_flat(flat_params)
        ids, labels, valid = block.input_ids, block.labels, block.valid
        M, b, L = ids.shape
        device = ids.device
        first = torch.full((), stage == 0, dtype=torch.bool, device=device)
        last = torch.full((), stage == pp - 1, dtype=torch.bool, device=device)
        h = torch.zeros((b, L, model.config.hidden_size), dtype=model.dtype, device=device)
        zero = torch.zeros((), dtype=model.dtype, device=device)

        def tick(h, t: int):
            # stage 0 takes microbatch t's embeddings; the lookup's sum runs
            # on every stage (the drain ticks inject nothing)
            x0 = model.pp_embed(ids[t]).to(h.dtype) if t < M else torch.zeros_like(h)
            h_in = torch.where(first, x0, h)
            # tick t holds microbatch t - stage here: the layers run on it
            h_out = (model.stage_blocks(h_in, stage_index=stage) if 0 <= t - stage < M
                     else h_in)
            m_out = t - (pp - 1)  # the microbatch the last stage finishes
            if m_out < 0:
                return h_out, None
            h_ce = tp_all_reduce(torch.where(last, h_out, zero), pg)
            return h_out, ce(model.finalize(h_ce), labels[m_out]) * valid[m_out]

        loss_wsum = torch.zeros((), dtype=torch.float32, device=device)
        n_ticks = M + pp - 1
        # early stop off: a recompute runs its tick to the end, so that no
        # rank stops short of a collective another rank runs
        with set_checkpoint_early_stop(False):
            for t in range(n_ticks):
                if torch.is_grad_enabled():
                    h_out, wl = checkpoint(tick, h, t, use_reentrant=False,
                                           preserve_rng_state=False)
                else:
                    h_out, wl = tick(h, t)
                if wl is not None:
                    loss_wsum = loss_wsum + wl
                if t < n_ticks - 1:
                    h = _Hop.apply(h_out, pg)
        return loss_wsum, valid.sum()

    loss_fn.fused_loss = fused
    return loss_fn


def eval_block(input_ids: torch.Tensor, attention_mask: torch.Tensor,
               labels: torch.Tensor, pp: int, sequence_group=None):
    """An eval batch ([B, L]) as the pipeline's block (JAX:
    trainer.py:1751-1800): M microbatches of B / M rows, M the largest
    divisor of B that is at most ``pp`` (the pipeline fills instead of
    paying the whole bubble at M 1), each weighted by its target count
    (``valid``), so that the pipelined loss's weighted sum is the batch's
    nll sum. Under a ``sequence_group`` the batch is this rank's chunk
    with pre-shifted labels, and the weights are the microbatches' global
    counts (summed over the group): the weighted sum is then this chunk's
    nll sum. Returns the block and this rank's own target count."""
    from acco_tpu_torch.parallel.common import MicrobatchBlock

    B, L = input_ids.shape
    M = max(d for d in range(1, B + 1) if B % d == 0 and d <= pp)
    labels = labels.reshape(M, B // M, L)
    scored = labels if sequence_group is not None else labels[:, :, 1:]
    counts = (scored != IGNORE_INDEX).sum((1, 2)).float()
    valid = counts.clone()
    if sequence_group is not None:
        import torch.distributed as dist

        dist.all_reduce(valid, group=sequence_group.group)
    block = MicrobatchBlock(
        input_ids=input_ids.reshape(M, B // M, L),
        attention_mask=attention_mask.reshape(M, B // M, L),
        labels=labels,
        valid=valid,
    )
    return block, counts.sum()


def accumulate_grads_pipelined(
    loss_fn: Callable,
    model,
    flat_params: torch.Tensor,
    block,
    grad_init: Optional[torch.Tensor] = None,
    count_init: Optional[torch.Tensor] = None,
):
    """The pipelined ``common.accumulate_grads``: one backward over the
    whole block (the tick loop is the accumulation). Returns the same
    ``(grad_sum float32 [Pp], count, loss_weighted_sum)``; ``grad_init``,
    when given, is the sum's buffer and is added into in place, and
    ``count_init`` joins the count (ACCO's half-round carry-ins)."""
    params = [p for p, _, _ in model.flat_slices()]
    with torch.enable_grad():
        loss_wsum, count = loss_fn(flat_params, block)
        grads = torch.autograd.grad(loss_wsum, params)
    grad_sum = (
        grad_init
        if grad_init is not None
        else torch.zeros(flat_params.shape, dtype=torch.float32, device=flat_params.device)
    )
    for (_, offset, numel), g in zip(model.flat_slices(), grads):
        grad_sum[offset:offset + numel] += g.reshape(-1).float()
    if count_init is not None:
        count = count + count_init
    return grad_sum, count, loss_wsum.detach()
