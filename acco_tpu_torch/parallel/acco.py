"""ACCO ("Accumulate while you Communicate") and DPU rounds.

Counterpart of ``acco_tpu/parallel/acco.py``'s ``AccoTrainStep``. A round
has two data-independent branches:

- communication: consume ``pending_grads`` (the gradients handed over at
  the end of the previous round): the micro-grad count all-reduced over
  dp, then count-averaged ZeRO-1 AdamW over dp x sp, giving new working
  parameters;
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
to the host. The round returns new tensors and never writes into the
state it was given.

The comm stream. On a CUDA device the communication branch runs on a
stream of its own (``comm_stream``) while the compute branch runs on the
current stream, as the reference runs ACCO on two CUDA streams. The
ordering, each round:

- the comm stream first waits for the current stream
  (:meth:`AccoTrainStep._fork`), which produced ``pending_grads`` (and
  ran the last round's readers of the buffers the comm stream may now
  reuse);
- the compute branch reads only the *old* ``flat_params`` and
  ``pending_grads``; the comm branch writes only buffers it allocates
  itself (``_where(..., into_new=True)`` writes into them), so the
  branches share no buffer that either writes;
- at the end the current stream waits on an event recorded after the
  comm branch (:meth:`AccoTrainStep._join`), before anything combines
  the two branches' results and before the round returns them.

The caching allocator keeps a pool per stream, and a block is reused
only by work on the stream whose pool holds it. The comm branch's
shard-sized buffers (the new flat parameters and optimizer shard, which
later rounds read and free on the current stream, and the
reduce-scatter's output) come from the current stream's pool, so one
pool holds the large buffers as it did with one stream, and each is
marked with ``record_stream`` as in use by the comm stream: freed, it
goes to other work only once the comm stream is past it. The AdamW
chunks and the scalars come from the comm stream's pool, which only the
comm stream reuses, after the next round's fork. The state's buffers
that the comm stream reads are held by the caller until the round has
enqueued its join, which orders their next user on the current stream
after the comm stream's reads. A speculative round stores no new
optimizer state (``keep_state``).

``into`` (a state of the same shapes, the other buffer set of a
captured round, ``compile/graphs.py``): the round writes its new flat
parameters, optimizer shard and pending gradients into those buffers
instead of fresh ones; its inputs stay unwritten. ``branch_probe``
(None, or ``probe(role)``), called at the head of each branch on its
stream, lets the profile reader name the streams of a graph's replay
(``telemetry/profile.py``). The comm branch's collectives run on process groups of their own
(``RankGroups.comm_data``, ``comm_world``): on NCCL a communicator has
one stream, and sharing one with the compute branch's collectives (the
ring's hops, the loss metric, the verdict) would queue them behind each
other. On the CPU and on gloo the same code runs with no stream.
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
    staged_ok,
)
from acco_tpu_torch.parallel.zero1 import Zero1State


class AccoState(NamedTuple):
    """Round-carried state, as the JAX ``AccoState``, in this rank's view:
    ``zero1.opt`` is its shard, ``pending_grads`` its own (unreduced)
    gradient sum and ``pending_count`` its own count."""

    flat_params: torch.Tensor  # [Pp] param dtype: working params (θ or θ̃), replicated
    pending_grads: torch.Tensor  # [Pp] float32: this rank's grads for this round's comm
    pending_count: torch.Tensor  # [1] float32: their micro-grad count
    zero1: Zero1State
    round_idx: torch.Tensor  # int32 scalar
    health: HealthState


class AccoRoundMetrics(NamedTuple):
    loss: torch.Tensor
    lr: torch.Tensor
    round_grads: torch.Tensor  # count consumed by this round's comm (summed over dp)
    is_real_update: torch.Tensor  # bool: the optimizer state was committed
    grad_norm: torch.Tensor
    skipped: torch.Tensor  # bool: the guard suppressed this round's update


class _CommOut(NamedTuple):
    """What the communication branch hands to the end of the round."""

    raw_total: torch.Tensor
    lr: torch.Tensor
    flat_params: torch.Tensor
    zero1: Zero1State
    ok: "torch.Tensor | None"
    grad_norm: torch.Tensor
    is_real: torch.Tensor


def _where(pred, new, old, into_new: bool = False):
    """torch.where over a state leaf; a Python bool picks statically.
    ``into_new`` writes the result into ``new``, a buffer this round made
    (no third copy of a parameter-sized leaf)."""
    if isinstance(pred, bool):
        return new if pred else old
    return torch.where(pred, new, old, out=new) if into_new else torch.where(pred, new, old)


def _allocator(pool_stream, user_stream):
    """``alloc(numel, dtype)``: an empty buffer from ``pool_stream``'s
    pool, marked as in use by ``user_stream``."""

    def alloc(numel: int, dtype) -> torch.Tensor:
        with torch.cuda.stream(pool_stream):
            out = torch.empty(numel, dtype=dtype, device=pool_stream.device)
        out.record_stream(user_stream)
        return out

    return alloc


class AccoTrainStep(FlatTrainStep):
    """ACCO (or DPU) rounds for one model, on one rank or on the ranks of
    ``groups`` (or of a sequence group at dp 1). ``comm_stream``: the
    stream of the communication branch; by default a new stream on a
    CUDA device and none on the CPU. Passing the current stream runs both
    branches on it, one after the other."""

    def __init__(self, model, schedule, *, mode: str = "acco", comm_stream=None, **kwargs):
        if mode not in ("acco", "dpu"):
            raise ValueError(f"mode must be 'acco' or 'dpu', got {mode!r}")
        super().__init__(model, schedule, **kwargs)
        self.mode = mode
        self.branch_probe = None
        device = next(model.parameters()).device
        if device.type == "cuda":
            self.comm_stream = (comm_stream if comm_stream is not None
                                else torch.cuda.Stream(device))
        else:
            self.comm_stream = None

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
            zero1=self.init_zero1(flat_params),
            round_idx=torch.zeros((), dtype=torch.int32, device=device),
            health=init_health(device),
        )

    def seed(self, state: AccoState, block: MicrobatchBlock, in_place: bool = False):
        """Compute-only round that fills the pending buffers before round 0.
        In ACCO mode round 0 (even) accumulates on top of these grads, so
        they also join round 1's real update; in DPU mode they are
        committed once, by round 0. ``in_place``: the grads are summed
        into the state's own ``pending_grads`` (the live buffer set of the
        captured rounds, ``compile/graphs.py``), which the seed does not
        read."""
        grad0 = state.pending_grads.zero_() if in_place else None
        grad_sum, count, loss_wsum = self.accumulate(state.flat_params, block, grad_init=grad0)
        loss = self.mean_loss(loss_wsum, block.valid)
        health = state.health
        if self.nan_guard:
            health = health._replace(
                pending_ok=staged_ok(grad_sum, loss, self.group("all")))
        return state._replace(
            pending_grads=grad_sum, pending_count=count.reshape(1), health=health
        ), loss

    def _comm_branch(self, state: AccoState, commit: bool, alloc=None, into=None) -> _CommOut:
        """Consume ``pending_grads``: the count over dp, the sharded AdamW,
        the guard's selects and the commit. Reads the state, writes only
        buffers it makes (its outputs through ``alloc``) or is handed
        (``into``'s flat parameters and optimizer shard)."""
        if self.branch_probe is not None:
            self.branch_probe("comm")
        raw_total = self.total_count(state.pending_count[0])
        total = raw_total.clamp(min=1.0)
        lr = self.schedule(state.zero1.sched_grads)
        # into: the new flat parameters and shard, and the reduce-scatter's
        # output in the new shard's nu (dead until its chunk is written, each
        # chunk read before: no third shard-sized buffer in the graph's pool)
        upd = self.update(state.pending_grads, state.zero1.opt, total, lr,
                          keep_state=commit, alloc=alloc,
                          into=None if into is None else (into.flat_params, into.zero1.opt,
                                                          into.zero1.opt.nu))
        if self.nan_guard:
            new_flat, new_opt, uh = upd
            ok, grad_norm = uh.ok, uh.grad_norm
            new_flat = _where(ok, new_flat, state.flat_params, into_new=True)
            commit_ok = ok if commit else False
        else:
            new_flat, new_opt = upd
            ok, grad_norm = None, torch.zeros((), device=lr.device)
            commit_ok = commit
        opt_out = AdamWState(*(
            _where(commit_ok, new, old, into_new=True)
            for new, old in zip(new_opt, state.zero1.opt)
        ))
        zero1 = Zero1State(
            opt=opt_out,
            sched_grads=state.zero1.sched_grads + self.sched_increment(total, commit_ok),
            grads_committed=state.zero1.grads_committed
            + _where(commit_ok, raw_total, torch.zeros_like(raw_total)),
        )
        # torch.full, not torch.tensor: a fill kernel, where a copy from
        # the host would wait for the stream's work so far
        is_real = (
            commit_ok if isinstance(commit_ok, torch.Tensor)
            else torch.full((), commit_ok, dtype=torch.bool, device=lr.device)
        )
        return _CommOut(raw_total, lr, new_flat, zero1, ok, grad_norm, is_real)

    def _compute_branch(self, state: AccoState, block: MicrobatchBlock, speculative: bool,
                        into=None):
        """Grads at the current working params. Even ACCO rounds carry in
        the staged grads unless the guard judged them poisoned; odd and DPU
        rounds start from zero (a copy: accumulate_grads adds into it in
        place; ``into.pending_grads`` when given)."""
        if self.branch_probe is not None:
            self.branch_probe("compute")
        grad0 = count0 = None
        if into is not None:
            grad0 = into.pending_grads
            if speculative:
                grad0.copy_(state.pending_grads)
            else:
                grad0.zero_()
        if speculative:
            grad0 = state.pending_grads.clone() if grad0 is None else grad0
            count0 = state.pending_count[0]
            if self.nan_guard:
                pok = state.health.pending_ok > 0
                grad0 = _where(pok, grad0, torch.zeros((), device=grad0.device), into_new=True)
                count0 = torch.where(pok, count0, torch.zeros_like(count0))
        grad_sum, count, loss_wsum = self.accumulate(
            state.flat_params, block, grad_init=grad0, count_init=count0
        )
        loss = self.mean_loss(loss_wsum, block.valid)
        pending_ok = staged_ok(grad_sum, loss, self.group("all")) if self.nan_guard else None
        return grad_sum, count, loss, pending_ok

    def _fork(self, stream) -> None:
        """The comm stream waits for the current stream's work so far."""
        stream.wait_stream(torch.cuda.current_stream(stream.device))

    def _join(self, stream) -> None:
        """The current stream waits on an event recorded after the comm
        branch."""
        done = torch.cuda.Event()
        done.record(stream)
        torch.cuda.current_stream(stream.device).wait_event(done)

    def round(self, state: AccoState, block: MicrobatchBlock, parity: bool, into=None):
        """One round; ``parity`` is True for an even round. The caller
        keeps it consistent with ``state.round_idx`` (the host knows it,
        so the round never reads the counter back). ``into``: see the
        module's doc."""
        speculative = self.mode == "acco" and bool(parity)
        stream = self.comm_stream
        if stream is None:
            comm = self._comm_branch(state, not speculative, into=into)
        else:
            alloc = _allocator(torch.cuda.current_stream(stream.device), stream)
            self._fork(stream)
            with torch.cuda.stream(stream):
                comm = self._comm_branch(state, not speculative, alloc, into)
        grad_sum, count, loss, pending_ok = self._compute_branch(state, block, speculative,
                                                                 into)
        if stream is not None:
            self._join(stream)

        if self.nan_guard:
            skipped = ~comm.ok
            health_out = HealthState(
                skipped_rounds=state.health.skipped_rounds + skipped.to(torch.int32),
                consec_skipped=torch.where(
                    skipped, state.health.consec_skipped + 1,
                    torch.zeros_like(state.health.consec_skipped),
                ),
                pending_ok=pending_ok,
            )
        else:
            skipped = torch.zeros((), dtype=torch.bool, device=loss.device)
            health_out = state.health
        new_state = AccoState(
            flat_params=comm.flat_params,
            pending_grads=grad_sum,
            pending_count=count.reshape(1),
            zero1=comm.zero1,
            round_idx=state.round_idx + 1,
            health=health_out,
        )
        metrics = AccoRoundMetrics(
            loss=loss, lr=comm.lr, round_grads=comm.raw_total, is_real_update=comm.is_real,
            grad_norm=comm.grad_norm, skipped=skipped,
        )
        return new_state, metrics
