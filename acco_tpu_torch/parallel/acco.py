"""ACCO ("Accumulate while you Communicate") and DPU rounds.

Counterpart of ``acco_tpu/parallel/acco.py``'s ``AccoTrainStep``. A round
has two data-independent branches:

- communication: consume ``pending_grads`` (the gradients handed over at
  the end of the previous round): count-averaged ZeRO-1 AdamW, giving new
  working parameters;
- compute: forward/backward over this round's microbatches at the
  *current* working parameters, accumulating a flat float32 gradient.

``mode='acco'``: even rounds are speculative — the AdamW step is computed
and its parameters become the working parameters, but the optimizer
state is not committed; odd rounds commit. The accumulation carry-in is
derived from ``pending_grads`` and the parity: even rounds accumulate on
top of the staged odd-half gradients, odd rounds start from zero.
``mode='dpu'`` is the same round with speculation off and no carry-in.

The in-program guard keeps a bad round a bit-exact no-op with
``torch.where(healthy, new, old)``; nothing in a round reads a value back
to the host. The two branches run one after the other on the current
stream (a dedicated comm stream is ROADMAP.md queue 1, item 5); the round
returns new tensors and never writes into the state it was given.

Ranks: one, or the sequence group of context parallelism at dp 1
(``sequence_group``). Then ZeRO-1 shards over the group, ``pending_grads``
is this rank's partial (its sequence chunk's gradient), the counts are
all-reduced over dp (a group of one: replicated across sp, they need no
reduction), and the loss metric and the staged-grads verdict are reduced
over the group so that every rank holds the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from acco_tpu_torch.ops.adamw import AdamWState
from acco_tpu_torch.parallel.common import (
    HealthState,
    MicrobatchBlock,
    accumulate_grads,
    init_health,
    make_flat_loss_fn,
    staged_ok,
    world_mean_loss,
)
from acco_tpu_torch.parallel.zero1 import (
    ShardGeometry,
    Zero1State,
    init_zero1_state,
    zero1_update_shard,
)


class AccoState(NamedTuple):
    """Round-carried state, as the JAX ``AccoState``, in this rank's view:
    ``zero1.opt`` is its shard, ``pending_grads`` its partial."""

    flat_params: torch.Tensor  # [Pp] param dtype: working params (θ or θ̃), replicated
    pending_grads: torch.Tensor  # [Pp] float32: this rank's grads for this round's comm
    pending_count: torch.Tensor  # [1] float32: their micro-grad count
    zero1: Zero1State
    round_idx: torch.Tensor  # int32 scalar
    health: HealthState


class AccoRoundMetrics(NamedTuple):
    loss: torch.Tensor
    lr: torch.Tensor
    round_grads: torch.Tensor  # count consumed by this round's comm
    is_real_update: torch.Tensor  # bool: the optimizer state was committed
    grad_norm: torch.Tensor
    skipped: torch.Tensor  # bool: the guard suppressed this round's update


def _where(pred, new, old, into_new: bool = False):
    """torch.where over a state leaf; a Python bool picks statically.
    ``into_new`` writes the result into ``new``, a buffer this round made
    (no third copy of a parameter-sized leaf)."""
    if isinstance(pred, bool):
        return new if pred else old
    return torch.where(pred, new, old, out=new) if into_new else torch.where(pred, new, old)


class AccoTrainStep:
    """ACCO (or DPU) rounds for one model, on one rank or on the ranks of
    a sequence group."""

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
        mode: str = "acco",
        const_len_batch: bool = False,
        nan_guard: bool = True,
        guard_max_grad_norm: float = 0.0,
        fused_loss: "bool | str" = False,
        sequence_group=None,
    ):
        if mode not in ("acco", "dpu"):
            raise ValueError(f"mode must be 'acco' or 'dpu', got {mode!r}")
        self.model = model
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.eps = eps
        self.mode = mode
        self.nan_guard = bool(nan_guard)
        self.guard_max_grad_norm = float(guard_max_grad_norm or 0.0)
        on_group = getattr(model, "sequence_group", None) is sequence_group
        if sequence_group is not None and not on_group:
            raise ValueError("context parallelism needs a ring-attention model built on the "
                             "same sequence group")
        self.sequence_group = sequence_group
        self.group = None if sequence_group is None else sequence_group.group
        self.rank = 0 if sequence_group is None else sequence_group.rank
        self.geom = ShardGeometry(
            model.n_params, 1 if sequence_group is None else sequence_group.size
        )
        self.value_and_grad = make_flat_loss_fn(
            model, label_smoothing, const_len_batch, fused_loss, sequence_group
        )

    def init_state(self, flat_params: torch.Tensor) -> AccoState:
        """State from an [n_params] flat parameter vector (any float dtype)."""
        device = flat_params.device
        flat = self.geom.pad_flat(flat_params.to(self.model.dtype))
        return AccoState(
            flat_params=flat,
            pending_grads=torch.zeros(
                self.geom.padded_size, dtype=torch.float32, device=device
            ),
            pending_count=torch.zeros(1, dtype=torch.float32, device=device),
            zero1=init_zero1_state(flat_params.float(), self.geom, self.rank),
            round_idx=torch.zeros((), dtype=torch.int32, device=device),
            health=init_health(device),
        )

    def _accumulate(self, flat_params, block, grad_init=None, count_init=None):
        return accumulate_grads(
            self.value_and_grad, self.model, flat_params, block,
            grad_init=grad_init, count_init=count_init,
        )

    def seed(self, state: AccoState, block: MicrobatchBlock):
        """Compute-only round that fills the pending buffers before round 0.
        In ACCO mode round 0 (even) accumulates on top of these grads, so
        they also join round 1's real update; in DPU mode they are
        committed once, by round 0."""
        grad_sum, count, loss_wsum = self._accumulate(state.flat_params, block)
        loss = world_mean_loss(loss_wsum, block.valid, self.group)
        health = state.health
        if self.nan_guard:
            health = health._replace(pending_ok=staged_ok(grad_sum, loss, self.group))
        return state._replace(
            pending_grads=grad_sum, pending_count=count.reshape(1), health=health
        ), loss

    def round(self, state: AccoState, block: MicrobatchBlock, parity: bool):
        """One round; ``parity`` is True for an even round. The caller
        keeps it consistent with ``state.round_idx`` (the host knows it,
        so the round never reads the counter back)."""
        speculative = self.mode == "acco" and bool(parity)
        commit = not speculative

        # ---- communication branch: consume pending_grads ----
        raw_total = state.pending_count[0]  # summed over dp: one group here
        total = raw_total.clamp(min=1.0)
        lr = self.schedule(state.zero1.sched_grads)
        upd = zero1_update_shard(
            state.pending_grads, state.zero1.opt, total, lr, self.geom,
            self.weight_decay, self.beta1, self.beta2, self.eps,
            out_dtype=self.model.dtype, with_health=self.nan_guard,
            max_grad_norm=self.guard_max_grad_norm, group=self.group,
        )
        if self.nan_guard:
            new_flat, new_opt, uh = upd
            ok, grad_norm = uh.ok, uh.grad_norm
            new_flat = _where(ok, new_flat, state.flat_params, into_new=True)
            commit_ok = ok if commit else False
        else:
            new_flat, new_opt = upd
            grad_norm = torch.zeros((), device=lr.device)
            commit_ok = commit
        opt_out = AdamWState(*(
            _where(commit_ok, new, old, into_new=True)
            for new, old in zip(new_opt, state.zero1.opt)
        ))
        one = torch.ones((), dtype=torch.int32, device=lr.device)
        sched_out = state.zero1.sched_grads + _where(commit_ok, one, torch.zeros_like(one))

        # ---- compute branch: grads at the current working params ----
        # even ACCO rounds carry in the staged grads unless the guard
        # judged them poisoned; odd and DPU rounds start from zero
        # (a copy: accumulate_grads adds into it in place)
        grad0 = count0 = None
        if speculative:
            grad0, count0 = state.pending_grads.clone(), state.pending_count[0]
            if self.nan_guard:
                pok = state.health.pending_ok > 0
                grad0 = _where(pok, grad0, torch.zeros((), device=grad0.device), into_new=True)
                count0 = torch.where(pok, count0, torch.zeros_like(count0))
        grad_sum, count, loss_wsum = self._accumulate(
            state.flat_params, block, grad_init=grad0, count_init=count0
        )
        loss = world_mean_loss(loss_wsum, block.valid, self.group)

        if self.nan_guard:
            skipped = ~ok
            health_out = HealthState(
                skipped_rounds=state.health.skipped_rounds + skipped.to(torch.int32),
                consec_skipped=torch.where(
                    skipped, state.health.consec_skipped + 1,
                    torch.zeros_like(state.health.consec_skipped),
                ),
                pending_ok=staged_ok(grad_sum, loss, self.group),
            )
        else:
            skipped = torch.zeros((), dtype=torch.bool, device=lr.device)
            health_out = state.health
        new_state = AccoState(
            flat_params=new_flat,
            pending_grads=grad_sum,
            pending_count=count.reshape(1),
            zero1=Zero1State(
                opt=opt_out,
                sched_grads=sched_out,
                grads_committed=state.zero1.grads_committed
                + _where(commit_ok, raw_total, torch.zeros_like(raw_total)),
            ),
            round_idx=state.round_idx + 1,
            health=health_out,
        )
        is_real = (
            commit_ok if isinstance(commit_ok, torch.Tensor)
            else torch.tensor(commit_ok, device=lr.device)
        )
        metrics = AccoRoundMetrics(
            loss=loss, lr=lr, round_grads=raw_total, is_real_update=is_real,
            grad_norm=grad_norm, skipped=skipped,
        )
        return new_state, metrics
