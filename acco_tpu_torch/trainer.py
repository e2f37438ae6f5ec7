"""The training loop: the seed round (or ACCO's DPU warmup), then ACCO or
DPU rounds, or DDP steps, to the target; eval, checkpoints, exact resume
and the run's records.

Counterpart of ``DecoupledTrainer`` in ``acco_tpu/trainer.py``, slimmed:
const-len packing (or per-document truncation), a shuffled batch
iterator, then rounds (or steps) until ``nb_steps_tot`` gradients are
committed. Each round's block comes from a ``data/prefetch.py``
source: with ``prefetch`` (the default, at ``prefetch_depth`` 2) a
worker thread collates it, pins it and copies it to the card on a copy
stream of its own while the rounds before it run (JAX: trainer.py:205-209,
:1110-1120); ``prefetch: false`` makes the same blocks on the loop's
thread, with blocking copies. The packed or truncated rows are a
``native.FlatTokenDataset`` whose batches a C++ loop collates
(``native_data: false`` keeps the Python lists). Each round's loss, LR
and ``is_real_update`` stay on the device; the loop reads them back,
with the committed count and the guard's counters, in one copy every
``delta_step_for_log`` grads (JAX: trainer.py:1350-1377), so the host
runs ahead of the card in between.
The eval, the periodic save and the watchdog decide at those boundaries.
At ``delta_step_for_log=1`` every round is read back, and a round's
``ms`` is its synced wall time (both streams: the round ends with the
current stream waiting on the comm stream); the rounds themselves are
the same bits at any cadence.

Ranks: the ``mesh`` of ``parallel/mesh.py``, ``{dp: N, sp: M}`` and the model axes. Each
rank reads the rows of its dp index (the raw texts sharded by dp index
before packing, as JAX's trainer shards them) in batches of
``batch_size`` rows, and, under context parallelism (sp > 1, or a mesh
that carries a one-rank sequence group, which runs the CP code with no
hop), keeps its chunk of the sequence
(``parallel/common.prep_cp_leaves``). CP needs const-len batches and
``max_length`` divisible by sp (2 sp under the zig-zag layout).
``microbatch_mask`` ([n_acc][dp], 0/1) gives each rank its ``valid``
column: heterogeneous workers, whose masked microbatches run and count
nothing. Under tensor parallelism (``{dp: N, tp: T}``, or a mesh that
carries a one-rank tensor group; JAX: trainer.py:146-155) the model holds
its tp shard's parameters (its ``tp_layout``), every rank of a tensor
group reads the same rows (its dp index's), each rank initialises its own
shard from the seed (``models/flat.py`` ``init_flat``, no dense vector on
the card), the eval runs the vocab-parallel loss, each rank's file in a
checkpoint carries its tp index, and a final save's ``params.npz`` is
the dense model gathered over tp on rank 0 and unpadded (JAX:
trainer.py:2240-2252). Pipeline parallelism (``{dp: N, pp: P}``, or a
mesh that carries a one-rank pipeline group; JAX: trainer.py:156-175,
:337-345) runs the same way over the pipeline group: every stage of a dp
index reads that dp index's rows, each stage initialises its own slice,
the rounds and the eval run the GPipe loop (``parallel/pp.py``; the eval
splits each batch into the largest count of microbatches at most pp that
divides it), the rank files carry the pp index, and ``params.npz`` is
gathered over the stages. It needs ``const_len_batch`` and warns when
``n_grad_accumulation`` < pp (the bubble dominates). The axes compose
(JAX: trainer.py:644, :1727-1771), in ``mesh_shape``'s key order: under
tp x pp each rank is a stage's tp shard (``parallel/tp.ComposedLayout``;
its rank file carries both indices), under pp x sp or tp x sp each rank
keeps its sequence chunk and the ring runs on its layers' heads, and
the four axes at once combine the three.

The run's persistence and records, as JAX's trainer keeps them, under
``run_dir``:

- ``train.save``: a checkpoint every ``checkpoint_every_s`` (rank 0's
  clock decides, every rank follows) and a final one with rank 0's dense
  float32 ``params.npz``, under ``checkpoints/<run_name>/step_<grads>``,
  through ``resilience/manager.py``: the loop blocks only for the
  device-to-host snapshot into pinned buffers, and with ``ckpt_async``
  (the default) the commit runs on a background thread under the next
  rounds (``ckpt_async: false`` commits inline); ``ckpt_keep_last`` /
  ``ckpt_keep_every_s`` retention and a startup GC of uncommitted step
  dirs. ``train()`` returns once the last commit is on disk.
- ``train.resume_from``: a checkpoint root (its newest complete step) or
  a ``step_*`` dir; the state, the counters and the loader's position are
  restored, the host's parity mirror comes from ``state.round_idx``, and
  a resumed ACCO/DPU run skips the seed round. The final parameters then
  equal an uninterrupted run's bit for bit.
- ``train.eval``: the eval loss every ``eval_step`` grads
  (:meth:`Trainer.evaluate`, through ``ops.losses.model_ce`` under
  ``torch.no_grad()``).
- TensorBoard scalars under ``tensorboard/<run_name>/<id_run>``, the
  ``results.csv`` row and ``grad_counts/`` (``utils/logs.py``), rank 0
  only.

A run that survives (JAX: trainer.py:976-1016, :2029-2143):

- ``handle_signals`` (default true): SIGTERM/SIGINT latch a stop
  (``resilience/preemption.py``); the loop stops at the next round
  boundary — at one rank at once, on several ranks at the first
  ``preempt_sync_rounds`` boundary after any rank latched, agreed by a
  MAX all-reduce — saves, and returns with ``interrupted`` in the
  summary.
- The watchdog (``resilience/watchdog.py``) classifies each boundary's
  grad norm and skips from the values the boundary already reads back;
  ``rollback_after_skipped`` consecutive guard-skipped rounds restore the
  newest complete checkpoint with ``rollback: true`` (at most
  ``rollback_max`` times; a RuntimeError without a checkpoint) and fence
  the data window: the loader goes on from the last consumed block, not
  from the checkpoint's position. ``rollback: false`` aborts.
- ``fault_injection`` (``resilience/faults.py``) poisons the block or the
  state between rounds, for drills.
- Telemetry (``telemetry/``): the rank-0 span tracer
  (``telemetry.enabled``; ``trace_<id_run>.json`` in the run dir), the
  declared metrics, the per-round attribution closed at each boundary
  (the summary's ``attribution``; a window's wall runs from one
  boundary's read to the next), and ``profile_steps`` steady-state
  rounds under ``torch.profiler`` (``profile/``, the summary's
  ``profile``). The tracer, the metrics and the attribution read nothing
  of the device; the profiled window synchronizes at its two ends.

The rounds as programs (``compile/``, JAX: the jitted round programs
and ``compile/warmup.py``): on a card every steady-state round of acco,
dpu and ddp is a CUDA graph captured once and replayed
(``compile/graphs.py``), over two buffer sets that carry the state with
no per-round copy, a static block and per-round metric slots; the eval
step too. ``warmup_compile`` (default true) builds the run's kernel
libraries on threads from the constructor on, beside tokenization, and
captures every program before the first round; false builds at first
use and captures each program after its first round. The seed round and
ACCO's DPU warm-up rounds run once each and uncaptured. On the CPU the
same buffer-set code runs uncaptured. ``eager=True`` (a Python argument
of :class:`Trainer`, never a config key) runs the rounds as before, for
comparisons.

ACCO with ``n_warmup_steps > 0`` first runs the seed round and that many
DPU rounds on a DPU view of its step, then resets ``round_idx`` to 0 so
that ACCO's first even round folds the staged grads in (JAX:
trainer.py:1137-1160).
"""

from __future__ import annotations

import copy
import logging
import os
import time

import numpy as np
import torch

from acco_tpu_torch.compile.cache import cache_stats, libraries_for
from acco_tpu_torch.compile.graphs import EvalPrograms, RoundPrograms
from acco_tpu_torch.compile.warmup import CompileWarmup, WarmupReport
from acco_tpu_torch.data.loader import ShardedBatchIterator, shard_dataset
from acco_tpu_torch.data.prefetch import AsyncPrefetcher, block_copier, block_source
from acco_tpu_torch.ops.attention import resolve_attention_impl
from acco_tpu_torch.ops.losses import IGNORE_INDEX, model_ce, real_vocab_of
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import prep_cp_leaves
from acco_tpu_torch.parallel.ddp import DDPTrainStep
from acco_tpu_torch.resilience import (
    CheckpointManager,
    FaultInjector,
    ShutdownHandler,
    TrainingHealthMonitor,
)
from acco_tpu_torch.telemetry import metrics
from acco_tpu_torch.telemetry.attribution import StepAttribution, attribution_report
from acco_tpu_torch.telemetry.profile import RoundProfiler
from acco_tpu_torch.telemetry.trace import Tracer
from acco_tpu_torch.utils import checkpoint as ckpt
from acco_tpu_torch.utils import logs


class Trainer:
    def __init__(self, model, tokenizer, train_texts, eval_texts, args, log=None,
                 seed: int = 0, device="cpu", mesh=None, run_dir: str = ".",
                 initial_params=None, shutdown_handler=None, eager: bool = False):
        self._t_init = time.perf_counter()
        self.log = log or logging.getLogger("acco_tpu_torch")
        # eager=True: the rounds as eager PyTorch calls, for comparisons
        # (never from the config); else the buffer-set programs, captured
        # on a card (compile/graphs.py)
        self.eager = bool(eager)
        self.model = model
        self.args = args
        self.device = torch.device(device)
        self.seed = seed
        self.mesh = mesh
        self.run_dir = str(run_dir)
        # a pretrained start (finetune, JAX: trainer.py:126-128): this flat
        # vector replaces the random init; a resume still takes precedence
        self.initial_params = initial_params
        # a mesh with a sequence group (sp > 1, JAX: trainer.py:141-145, or
        # a group of one rank passed in by hand) turns context parallelism on
        self.sequence_group = None if mesh is None else mesh.sequence_group
        groups = None if mesh is None else mesh.groups
        self.dp = 1 if groups is None else groups.dp
        self.dp_index = 0 if groups is None else groups.dp_index
        self.rank = 0 if mesh is None else mesh.rank
        self.method = str(args.get("method_name", "acco"))
        if self.method not in ("acco", "ddp", "dpu"):
            raise ValueError(f"method_name must be one of acco/ddp/dpu, got {self.method!r}")
        baseline_flag = args.get("run_baseline_ddp")
        if baseline_flag is not None and bool(baseline_flag) != (self.method == "ddp"):
            raise ValueError(
                f"run_baseline_ddp={bool(baseline_flag)} contradicts "
                f"method_name={self.method!r}: the flag must be True exactly for the ddp "
                "baseline"
            )
        self.batch_size = int(args.get("batch_size", 8))
        self.n_acc = int(args.get("n_grad_accumulation", 1))
        self.max_length = int(args.get("max_length", 1024))
        self.nb_grad_tot = int(args.get("nb_steps_tot", 1000))
        self.const_len_batch = bool(args.get("const_len_batch", True))
        self.prefetch = bool(args.get("prefetch", True))
        self.prefetch_depth = int(args.get("prefetch_depth", 2))
        self.native_data = bool(args.get("native_data", True))
        if self.sequence_group is not None:
            self._check_cp(self.sequence_group.size)
        self.valid, self.grads_per_round = self._valid_column(args.get("microbatch_mask"))
        schedule = get_schedule(
            str(args.get("scheduler_name", "cosine")),
            float(args.get("learning_rate", 6e-4)),
            int(args.get("warmup", 0)),
            self.nb_grad_tot,
        )
        self.nan_guard = bool(args.get("nan_guard", True))
        self.label_smoothing = float(args.get("label_smoothing_factor", 0.0))
        common = dict(
            weight_decay=float(args.get("weight_decay", 0.0)),
            beta1=float(args.get("adam_beta1", 0.9)),
            beta2=float(args.get("adam_beta2", 0.999)),
            label_smoothing=self.label_smoothing,
            const_len_batch=self.const_len_batch,
            nan_guard=self.nan_guard,
            guard_max_grad_norm=float(args.get("guard_max_grad_norm", 0.0) or 0.0),
            fused_loss=args.get("fused_loss", False),
            lr_grad_accounting=bool(args.get("lr_grad_accounting", False)),
            sequence_group=self.sequence_group,
            groups=groups,
        )
        if self.method == "ddp":
            self.step = DDPTrainStep(model, schedule, **common)
        else:
            self.step = AccoTrainStep(model, schedule, mode=self.method, **common)
        g = self.step.groups
        self.mesh_shape = {"dp": 1 if g is None else g.dp, "sp": 1 if g is None else g.sp}
        if g is not None:
            self.mesh_shape.update(g.model_sizes())
        self.pipelined = self.step.pipelined
        if self.pipelined and self.n_acc < self.step.pp:
            self.log.warning("n_grad_accumulation (%d) < pp (%d): the pipeline bubble "
                             "dominates; use n_acc >= pp microbatches per round", self.n_acc,
                             self.step.pp)
        self.world = self.step.group("world")  # dp x sp (None: one rank)
        self.world_size = 1 if g is None else g.world_size
        # every rank (dp x sp x tp): the decisions all ranks take together
        self.all_ranks = self.step.group("all")
        self.n_ranks = 1 if g is None else g.n_ranks
        # this rank's file in a checkpoint: its model index (tp, pp, or pp x tp), then
        # its ZeRO-1 shard
        self.file_rank = (0 if g is None else g.model_index) * self.world_size + \
            self.step.shard_index
        self.pad_token_id = int(getattr(tokenizer, "pad_token_id", 0) or 0)
        self.eos_token_id = int(tokenizer.eos_token_id)
        # the attention impl the model's (global) layers run at this length
        self.attention = resolve_attention_impl(
            model.attention, self.max_length, model.config.head_dim, self.device,
            getattr(model, "remat", False),
        )
        # the kernel libraries built in the background from here on, beside
        # the data section (JAX: trainer.py:423-431)
        self.warmup_compile = bool(args.get("warmup_compile", True))
        self.libraries = libraries_for(
            self.attention, self.step.value_and_grad.fused_loss,
            local_layers="local" in tuple(getattr(model.config, "attention_layers", ())),
            const_len=self.const_len_batch)
        self._warmup = (CompileWarmup(self.libraries, log=self.log)
                        if self.warmup_compile and self.device.type == "cuda" else None)
        rows = self._rows(train_texts, tokenizer)
        self.loader = ShardedBatchIterator(
            rows, self.batch_size, self.max_length, pad_token_id=self.pad_token_id, seed=seed,
        )
        # eval rows as JAX prepares them (trainer.py:434-480): this dp
        # index's texts, packed; in order, the ragged last batch kept.
        # Packed rows are all max_length long, so eval drops its pad
        # masks exactly when training does (JAX's eval_const_len).
        self.eval_rows = self._rows(eval_texts, tokenizer) if eval_texts else []
        self.eval_loader = (
            ShardedBatchIterator(self.eval_rows, self.batch_size, self.max_length,
                                 pad_token_id=self.pad_token_id, shuffle=False,
                                 drop_last=False)
            if len(self.eval_rows) else None
        )

        self.n_warmup = int(args.get("n_warmup_steps", 0) or 0)
        self.do_eval = bool(args.get("eval", False)) and self.eval_loader is not None
        self.eval_every = int(args.get("eval_step", 0) or 0)
        self.do_save = bool(args.get("save", False))
        self.resume_from = args.get("resume_from")
        self.checkpoint_every_s = float(args.get("checkpoint_every_s", 1800))
        self.keep_last = int(args.get("ckpt_keep_last", 0) or 0)
        self.keep_every_s = float(args.get("ckpt_keep_every_s", 0.0) or 0.0)
        self.rollback = bool(args.get("rollback", True))
        self.rollback_after_skipped = max(1, int(args.get("rollback_after_skipped", 8)))
        self.rollback_max = int(args.get("rollback_max", 2))
        self.delta_step_for_log = int(args.get("delta_step_for_log", 10))
        # rank 0's: the checkpoint manager's run token, the same on every rank
        self.id_run = self._agreed(logs.create_id_run)
        run_name = str(args.get("run_name", self.method))
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints", run_name)
        self.tensorboard_dir = os.path.join(self.run_dir, "tensorboard", run_name, self.id_run)
        if self.rollback and not self.nan_guard:
            self.log.warning("rollback=True has no trigger with nan_guard=False; "
                             "auto-rollback is effectively disabled")
        # a drill's spec fails here, before any round, when it is malformed
        self.fault_injector = FaultInjector.from_config(args.get("fault_injection"), log=self.log)
        # telemetry (JAX: trainer.py:478-500): host clocks only, either way
        tel = args.get("telemetry") or {}
        self.telemetry_enabled = bool(tel.get("enabled", True))
        self.tracer = Tracer(enabled=self.telemetry_enabled and self.rank == 0,
                             process_name=f"acco-{self.method}",
                             max_events=int(tel.get("max_trace_events", 200_000)))
        self.trace_path = os.path.join(self.run_dir, f"trace_{self.id_run}.json")
        self.overlap_divergence_pct = float(tel.get("overlap_divergence_pct", 25.0))
        self.profile_steps = int(args.get("profile_steps", 0) or 0)
        # the overlapped save (JAX: trainer.py:511-523); the startup GC runs
        # in train(), on rank 0, when this run saves
        self.ckpt_manager = CheckpointManager(
            self.ckpt_dir, async_save=bool(args.get("ckpt_async", True)),
            keep_last=self.keep_last, keep_every_s=self.keep_every_s,
            rank=self.file_rank, world_size=self.n_ranks, log=self.log, gc_on_init=False,
            tracer=self.tracer, run_token=self.id_run,
        )
        # an injected handler (tests, drills); else a SIGTERM/SIGINT latch
        # installed for the duration of train() (JAX: trainer.py:524-535)
        self._shutdown = shutdown_handler
        self.handle_signals = bool(args.get("handle_signals", True))
        self.preempt_sync_rounds = max(1, int(args.get("preempt_sync_rounds", 8)))
        self.monitor = None
        self.rollbacks = 0
        self.rollback_log: list = []  # each rollback's step dir, fence and count
        self.attribution = None
        self.profiler = None
        self.final_state = None
        self.save_ms: list = []
        self.restore_ms = None
        self.source = None  # the round loop's block source (train() closes it)
        self.programs = None  # the round programs (compile/graphs.py), eager: None
        self.eval_programs = None
        self.compile_report = None
        self._report = None

    def _rows(self, texts, tokenizer):
        """This dp index's texts (JAX: trainer.py:434-441), packed
        const-len over the whole corpus (one remainder dropped in all) or
        truncated per document, as a ``FlatTokenDataset`` (JAX:
        ``_native_pack``, ``_maybe_flatten``, trainer.py:699-757), or as
        Python rows with ``native_data: false``."""
        from acco_tpu_torch.data.tokenize import pack_const_len
        from acco_tpu_torch.native import FlatTokenDataset

        if self.dp > 1:
            texts = shard_dataset(list(texts), self.dp, self.dp_index)
        # tokenized in chunks, as JAX's native path does: the packing
        # still runs over the whole corpus at once
        ids: list = []
        texts = list(texts)
        kw = {"truncation": False} if self.const_len_batch else {
            "truncation": True, "max_length": self.max_length}
        for lo in range(0, len(texts), 4096):
            ids.extend(tokenizer(texts[lo : lo + 4096], **kw)["input_ids"])
        if not self.native_data:
            if self.const_len_batch:
                return pack_const_len(ids, self.eos_token_id, self.max_length)
            return ids
        docs = FlatTokenDataset.from_rows(ids)
        if self.const_len_batch:
            return FlatTokenDataset.from_packed(
                docs.pack_const_len(self.max_length, self.eos_token_id))
        return docs

    def _valid_column(self, mask):
        """This rank's ``valid`` column [n_acc] and the valid micro-grads a
        round contributes over dp: the ``microbatch_mask`` ([n_acc][dp],
        JAX: trainer.py:776-794) and its sum, or all ones and dp x n_acc."""
        if mask is None:
            return None, float(self.dp * self.n_acc)
        mask = np.asarray(mask, np.float32)
        if mask.shape != (self.n_acc, self.dp):
            raise ValueError(
                f"microbatch_mask must be [n_grad_accumulation={self.n_acc}]"
                f"[world_size={self.dp}], got {mask.shape}"
            )
        if mask.sum() == 0:
            raise ValueError("microbatch_mask masks out every microbatch")
        return np.ascontiguousarray(mask[:, self.dp_index]), float(mask.sum())

    def _check_cp(self, sp: int) -> None:
        """JAX's context-parallel preconditions (trainer.py:318-352)."""
        if self.max_length % sp:
            raise ValueError(
                f"max_length {self.max_length} must divide evenly over the sp axis "
                f"({sp} shards)"
            )
        if getattr(self.model, "zigzag", False) and self.max_length % (2 * sp):
            raise ValueError(
                f"zig-zag context parallelism shards the sequence into 2*sp half-chunks: "
                f"max_length {self.max_length} must be divisible by {2 * sp} "
                f"(train.zigzag_cp=false uses contiguous sharding instead)"
            )
        if not self.const_len_batch:
            raise ValueError(
                "context parallelism (sp > 1) requires const_len_batch=True: the "
                "sequence-sharded attention path has no per-token attention mask, so "
                "padded (truncation-mode) batches are not supported"
            )

    def _next_block(self):
        """The next block from the source, on the device and ready for the
        current stream, with this rank's sequence chunk cut
        (``prep_cp_leaves``, after the copy's wait)."""
        block = self.source.next_block()
        return prep_cp_leaves(block, self.sequence_group, getattr(self.model, "zigzag", False))

    def train(self) -> dict:
        """The run; its TensorBoard writer, its block source (the prefetch
        worker, JAX: trainer.py:991), its in-flight checkpoint and its
        signal handlers are closed, drained and restored however it ends
        (JAX: trainer.py:966-1016)."""
        t_beg = time.time()
        writer = (logs.make_summary_writer(self.tensorboard_dir) if self.rank == 0
                  else logs.NoOpWriter())
        own_handler = False
        if self._shutdown is None and self.handle_signals:
            # made per train() and dropped after: a latch this run consumed
            # must not stop a later one at once
            self._shutdown = ShutdownHandler(log=self.log)
            own_handler = True
        installed = (self._shutdown.install()
                     if self._shutdown is not None and self.handle_signals else False)
        ok = False
        try:
            summary = self._train(writer, t_beg)
            ok = True
            return summary
        finally:
            if self.source is not None:  # kept, closed: its iter_state stays readable
                self.source.close()
            # the graphs' memory back to the allocator; the final state stays
            if self.programs is not None:
                self.compile_report = self._compile_report()
                self.programs.release()
            if self.eval_programs is not None:
                self.eval_programs.release()
            # the last commit on disk; its error raised here unless the run
            # is already unwinding another one
            self.ckpt_manager.close(raise_errors=ok)
            if self.profiler is not None:
                self.profiler.finish()
            if installed:
                self._shutdown.uninstall()
            if own_handler:
                self._shutdown = None
            writer.flush()
            writer.close()

    def _train(self, writer, t_beg: float) -> dict:
        if self.rank == 0 and self.do_save:
            self.ckpt_manager.gc_incomplete()
        if self.initial_params is not None:
            flat0 = self.initial_params.to(device=self.device, dtype=self.model.dtype)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            flat0 = self.model.init_flat(gen)
        state = self.step.init_state(flat0)
        del flat0  # the state holds its own (padded) copy

        # resume (JAX: trainer.py:1061-1105)
        meta = {"count_grad_tot": 0, "rounds_done": 0, "elapsed_s": 0.0}
        if self.resume_from:
            self.ckpt_manager.wait()
            path = self._agreed(lambda: ckpt.resolve_resume(str(self.resume_from),
                                                                 self.log))
            t0 = time.perf_counter()
            state, meta = ckpt.restore_checkpoint(path, state, rank=self.file_rank,
                                                  mesh=self.mesh_shape)
            self.restore_ms = (time.perf_counter() - t0) * 1e3
            self.log.info("Resumed from %s at %d grads", path, meta["count_grad_tot"])
        count_grad_tot = float(meta["count_grad_tot"])
        rounds_done = int(meta["rounds_done"])
        if "loader" in meta:
            self.loader.set_state(meta["loader"])
        # the background builds joined, the buffer sets made
        state = self._compile(state)
        # made after the restore, so the worker starts at the restored
        # position (JAX: trainer.py:1110-1120)
        self.source = self._block_source()

        seed_loss, warmup_losses = None, []
        if self.method != "ddp" and rounds_done == 0:
            if self.method == "acco" and self.n_warmup > 0:
                # ACCO's warmup (JAX: trainer.py:1137-1160): the seed round
                # and n_warmup DPU rounds on a DPU view of the step (its
                # geometry, loss and comm stream), then round_idx back to 0:
                # round 0 (even) carries the staged grads into round 1's
                # real update, so the last warmup round's grads are kept
                warm = copy.copy(self.step)
                warm.mode = "dpu"
                state, loss = warm.seed(state, self._next_block(),
                                        in_place=self.programs is not None)
                losses = [loss]
                for _ in range(self.n_warmup):
                    if self.programs is not None:  # over the buffer sets, uncaptured
                        self.programs.adopt(state)
                        state, m, _ = self.programs.run_uncaptured(warm, self._next_block(),
                                                                   False)
                    else:
                        state, m = warm.round(state, self._next_block(), parity=False)
                    losses.append(m.loss)
                    count_grad_tot += self.grads_per_round
                state = state._replace(round_idx=torch.zeros_like(state.round_idx))
            else:
                state, loss = self.step.seed(state, self._next_block(),
                                             in_place=self.programs is not None)
                losses = [loss]
            seed_loss, *warmup_losses = torch.stack(losses).float().tolist()  # one read
            self.log.info("seed round: loss %.4f", seed_loss)
            if self.programs is not None:  # into the live buffers
                self.programs.adopt(state)
                state = self.programs.state
        # host mirror of state.round_idx (ACCO's parity); DDP counts steps;
        # the watchdog anchored to the (resumed) skip counter (JAX: :1200-1213)
        round_idx, skipped_before, consec = self._host_counters(state, rounds_done)
        self._capture_programs(round_idx % 2 == 0)
        self.monitor = TrainingHealthMonitor(escalate_after=self.rollback_after_skipped,
                                             log=self.log)
        self.monitor.last_skipped_rounds = skipped_before
        self.rollbacks, self.rollback_log = 0, []
        attrib = self.attribution = StepAttribution()
        tracer = self.tracer
        injector = self.fault_injector
        # profile_steps rounds after ACCO's two first rounds (even, odd)
        # or DPU's/DDP's first, whose kernels build at first use
        skip = 2 if self.method == "acco" else 1
        if self.programs is not None and self.programs.capture_on and not self.warmup_compile:
            skip = 4 if self.method == "acco" else 2  # past the lazy captures
        self.profiler = RoundProfiler(
            self.profile_steps, skip,
            os.path.join(self.run_dir, "profile"), self.device, rank=self.rank,
            name=f"rounds_{self.id_run}", log=self.log)

        eval_mark = count_grad_tot
        log_epoch, rounds_this_run = 0, 0
        t_last_epoch = t_last_ckpt = time.time()
        round_log, eval_log, unread = [], [], []
        round_wall_ms: list = []
        window_mark = 0  # round_wall_ms index of the open attribution window
        # the open window's start: a window's wall runs fence to fence, so
        # that it holds its closing read, which the host may wait on for
        # many rounds of device work when it runs ahead (captured rounds)
        t_window = time.perf_counter()
        interrupted = False
        t_first_round = None  # the first round read back: the startup's end
        t_last_round = time.perf_counter()
        last_round_end_us = None
        while True:
            if count_grad_tot >= self.nb_grad_tot:
                if not (self.nan_guard and rounds_this_run > 0):
                    break
                # guard-skipped rounds commit nothing: trust the device count
                count_grad_tot = float(state.zero1.grads_committed)
                if count_grad_tot >= self.nb_grad_tot:
                    break
            self.profiler.before_round(rounds_this_run, self._profile_streams)
            ts_round = tracer.now_us()
            t0 = time.perf_counter()
            block = self._next_block()
            t_fetch = time.perf_counter()
            ts_fetch = tracer.now_us()
            if injector is not None and injector.pending:
                # a drill: poison the block or the state between rounds
                # (a poisoned state is written into the live buffers)
                state, block = injector.apply(rounds_this_run, state, block)
                if self.programs is not None:
                    self.programs.adopt(state)
                    state = self.programs.state
            if self.programs is not None:
                state, m, real = self.programs.run(block, round_idx % 2 == 0,
                                                   quiet=self.source.quiet)
            elif self.method == "ddp":
                state, m = self.step.step(state, block)
                real = ~m.skipped
            else:
                state, m = self.step.round(state, block, parity=round_idx % 2 == 0)
                real = m.is_real_update
            del block
            t_end = time.perf_counter()
            # the round's metrics stay on the device until the boundary
            unread.append((round_idx, m, real, (t_end - t0) * 1e3))
            if self.method != "acco":
                count_grad_tot += self.grads_per_round
            elif round_idx % 2 == 1:  # acco: real updates land on odd rounds
                count_grad_tot += 2 * self.grads_per_round
            round_idx += 1
            rounds_done += 1
            rounds_this_run += 1
            self.profiler.after_round(rounds_this_run)
            # per-round telemetry from host clocks around work the loop
            # does anyway (JAX: trainer.py:1295-1336): no device read
            dispatch_ms = (t_end - t_fetch) * 1e3
            wall_ms = (t_end - t_last_round) * 1e3
            t_last_round = t_end
            round_wall_ms.append(wall_ms)
            attrib.note("loader", self.source.last_wait_ms)
            attrib.note("host_stall", dispatch_ms)
            metrics.emit("train_rounds_total", 1)
            metrics.emit("train_round_wall_ms", wall_ms)
            metrics.emit("train_dispatch_ms", dispatch_ms)
            metrics.emit("train_loader_wait_ms", self.source.last_wait_ms)
            metrics.emit("loader_blocks_total", 1)
            metrics.emit("loader_block_wait_ms", self.source.last_wait_ms)
            if tracer.enabled:
                end_us = tracer.now_us()
                # the round span tiles the clock edge to edge, so boundary
                # work recorded in between nests inside the next one
                start_us = last_round_end_us if last_round_end_us is not None else ts_round
                tracer.complete_event("train/round", (end_us - start_us) / 1e3, cat="train",
                                      ts_us=start_us, args={"round": rounds_done})
                tracer.complete_event("loader/next_block", (ts_fetch - ts_round) / 1e3,
                                      cat="train", ts_us=ts_round)
                tracer.complete_event("train/dispatch", dispatch_ms, cat="train",
                                      ts_us=ts_fetch)
                last_round_end_us = end_us

            # the logging boundary (JAX: trainer.py:1350-1420), every
            # delta_step_for_log grads: the one read of the rounds since
            # the last, the count reconciled against the device counter,
            # progress, scalars, the watchdog; eval and save decide here
            nb_grad_local = rounds_done * self.n_acc
            if nb_grad_local // self.delta_step_for_log > log_epoch:
                t_sync = time.perf_counter()
                committed, consec, grad_norm, skipped_rounds = self._read_rounds(
                    unread, state, round_log)
                if t_first_round is None:
                    t_first_round = time.perf_counter()
                sync_ms = (time.perf_counter() - t_sync) * 1e3
                metrics.emit("train_log_sync_ms", sync_ms)
                tracer.complete_event("train/log_boundary_sync", sync_ms, cat="train")
                attrib.note("host_stall", sync_ms)
                # that read is the sync fence: close the attribution window
                n_since = len(round_wall_ms) - window_mark
                if n_since > 0:
                    t_fence = time.perf_counter()
                    attrib.boundary(n_since, (t_fence - t_window) * 1e3)
                    window_mark, t_window = len(round_wall_ms), t_fence
                count_grad_tot = committed
                loss = round_log[-1]["loss"]
                metrics.emit("train_loss", loss)
                metrics.emit("train_grads_committed", committed)
                log_epoch, t_last_epoch = logs.print_training_evolution(
                    self.log, nb_grad_local, rounds_this_run, self.delta_step_for_log,
                    self.rank, t_beg, t_last_epoch, loss, log_epoch,
                )
                self._scalars(writer, count_grad_tot, loss, None, t_beg)
                if self.nan_guard:
                    metrics.emit("train_grad_norm", grad_norm)
                    verdict = self.monitor.observe(grad_norm=grad_norm, loss=loss,
                                                   skipped_rounds=skipped_rounds,
                                                   consec_skipped=consec)
                    logs.log_health_to_tensorboard(
                        writer, nb_step=int(count_grad_tot), grad_norm=grad_norm,
                        skipped_rounds=skipped_rounds, consec_skipped=consec,
                        rollbacks=self.rollbacks,
                    )
                    if verdict.escalate:
                        if not self.rollback:
                            raise RuntimeError(
                                f"watchdog: {consec} consecutive anomalous rounds and "
                                "rollback=False — aborting (the guard froze params/optimizer "
                                "at the last healthy commit; checkpoints on disk are "
                                "unchanged)"
                            )
                        state, meta = self._rollback(state)
                        count_grad_tot = float(meta["count_grad_tot"])
                        rounds_done = int(meta["rounds_done"])
                        eval_mark = count_grad_tot
                        round_idx, _, consec = self._host_counters(state, rounds_done)
                        # the cadence re-anchored to the restored rounds
                        log_epoch = rounds_done * self.n_acc // self.delta_step_for_log
                        logs.log_telemetry_to_tensorboard(writer, int(count_grad_tot))
                        continue
                logs.log_telemetry_to_tensorboard(writer, int(count_grad_tot))
                # eval every eval_step grads (JAX: trainer.py:1460)
                if (self.do_eval and self.eval_every
                        and count_grad_tot - eval_mark >= self.eval_every):
                    eval_mark = count_grad_tot
                    t_ev = time.perf_counter()
                    eval_loss = self.evaluate(state.flat_params)
                    eval_ms = (time.perf_counter() - t_ev) * 1e3
                    metrics.emit("train_eval_ms", eval_ms)
                    tracer.complete_event("train/eval", eval_ms, cat="train")
                    attrib.note("host_stall", eval_ms)
                    eval_log.append({"count_grad_tot": int(count_grad_tot),
                                     "eval_loss": eval_loss, "ms": eval_ms})
                    self.log.info("eval loss %.4f at %d grads", eval_loss, int(count_grad_tot))
                    self._scalars(writer, count_grad_tot, loss, eval_loss, t_beg)
                # the periodic save: rank 0's clock decides (JAX: trainer.py:1490)
                if self.do_save and self._ckpt_due(time.time() - t_last_ckpt):
                    t_last_ckpt = time.time()
                    if consec > 0:
                        self.log.warning("periodic checkpoint skipped: state is anomalous "
                                         "(%d consecutive guard-skipped rounds)", consec)
                    else:
                        self._save(state, count_grad_tot, rounds_done, t_beg,
                                   export_npz=False)

            # preemption-safe shutdown (JAX: trainer.py:1521-1535): stop
            # between rounds, then the normal end: read-back, final save
            if self._preempted(rounds_this_run):
                interrupted = True
                self.log.warning("shutdown requested: stopping at round boundary (%d grads "
                                 "dispatched) and checkpointing%s", int(count_grad_tot),
                                 "" if self.do_save else " — save=False, so NOT saving")
                break

        self.profiler.finish()
        if unread:
            t_sync = time.perf_counter()
            count_grad_tot, consec, _, _ = self._read_rounds(unread, state, round_log)
            if t_first_round is None:
                t_first_round = time.perf_counter()
            # the final read is the last fence: close the window it drained
            attrib.note("host_stall", (time.perf_counter() - t_sync) * 1e3)
        n_since = len(round_wall_ms) - window_mark
        if n_since > 0:
            attrib.boundary(n_since, (time.perf_counter() - t_window) * 1e3)
        total_time = time.time() - t_beg
        final_loss = round_log[-1]["loss"] if round_log else seed_loss
        checkpoint = None
        if self.do_save:
            # the health gate of JAX's final save (trainer.py:1560-1600)
            self.ckpt_manager.wait()
            if consec > 0 and ckpt.latest_checkpoint(self.ckpt_dir, self.log) is not None:
                self.log.warning("final checkpoint skipped: state is anomalous (%d consecutive "
                                 "guard-skipped rounds); the newest complete checkpoint is "
                                 "preserved for recovery", consec)
            else:
                if consec > 0:
                    self.log.warning("final checkpoint saved DESPITE %d consecutive "
                                     "guard-skipped rounds: nothing is on disk yet", consec)
                checkpoint = self._save(state, count_grad_tot, rounds_done, t_beg)
        # the commit durable before the run is declared over (JAX: :1601)
        self.ckpt_manager.wait()
        health = logs.health_columns(self.monitor.summary(), int(state.health.skipped_rounds),
                                     self.rollbacks)
        report = attribution_report(attrib.summary(), None,
                                    divergence_pct=self.overlap_divergence_pct, log=self.log)
        if report is not None:
            b = report["buckets_ms"]
            metrics.emit_many({
                "train_measured_round_ms": report["round_wall_ms"],
                "attrib_loader_ms": b["loader_ms"], "attrib_ckpt_ms": b["ckpt_ms"],
                "attrib_host_stall_ms": b["host_stall_ms"], "attrib_compute_ms": b["compute_ms"],
                "attrib_exposed_comm_ms": b["exposed_comm_ms"],
            })
            self.log.info("step attribution over %d rounds (%d windows): round wall %.2f ms = "
                          "loader %.2f + ckpt %.2f + host %.2f + device %.2f (clamped %.2f ms)",
                          report["rounds"], report["windows"], report["round_wall_ms"],
                          b["loader_ms"], b["ckpt_ms"], b["host_stall_ms"], b["compute_ms"],
                          report["clamped_ms"])
        profile = self.profiler.summary
        if profile is not None and profile.get("measured_overlap_pct") is not None:
            metrics.emit("measured_overlap_pct", profile["measured_overlap_pct"])
        if self.rank == 0:
            self._write_results(final_loss, total_time, health)
            logs.save_grad_acc(self.id_run, self.run_dir, self.rank,
                               list_grad_acc=[self.n_acc] * len(round_log),
                               list_grad_times=[round(r["ms"], 2) for r in round_log])
        trace = None
        if tracer.enabled:
            try:
                trace = tracer.write(self.trace_path, other_data={
                    "attribution": report, "method": self.method,
                    "world_size": self.world_size, "id_run": self.id_run})
                self.log.info("telemetry trace -> %s", trace)
            except OSError as exc:
                self.log.warning("trace write failed: %s", exc)
        self.final_state = state
        return {
            "final_loss": final_loss,
            "count_grad_tot": int(count_grad_tot),
            "rounds": rounds_done,
            "total_time_s": total_time,
            "method": self.method,
            "fused_loss": self.step.value_and_grad.fused_loss,
            "attention": self.attention,
            "mesh": self.mesh.describe() if self.mesh is not None else {"dp": 1, "sp": 1},
            # stopped by a shutdown request before nb_steps_tot; the final
            # checkpoint makes it resumable through train.resume_from
            "interrupted": interrupted,
            "skipped_rounds": health["skipped_rounds"],
            "rollbacks": self.rollbacks,
            "n_params": self.model.n_params,
            "seed_loss": seed_loss,
            "warmup_losses": warmup_losses,
            "round_log": round_log,
            "eval_log": eval_log,
            "eval_loss": eval_log[-1]["eval_loss"] if eval_log else None,
            "checkpoint": checkpoint,
            "ckpt_async": self.ckpt_manager.async_save,
            "run_dir": self.run_dir,
            "device": str(self.device),
            "prefetch": self.prefetch,
            "block_wait_ms": self.source.median_wait_ms(),
            "attribution": report,
            "trace": trace,
            "profile": profile,
            # the round programs: captured (a card), buffer sets uncaptured
            # (the CPU) or eager; the builds and captures, and the time from
            # the constructor to the first round read back
            "rounds_as": ("eager" if self.programs is None else
                          "captured" if self.programs.capture_on else "buffer_sets"),
            "compile_report": self._compile_report() if self._report is not None else None,
            "init_to_first_round_s": (None if t_first_round is None
                                      else t_first_round - self._t_init),
        }

    def _compile(self, state):
        """Join the background builds (JAX: ``join_warmup``,
        trainer.py:890-935) and make the round programs around ``state``
        (the buffer sets; the eval step's, when this run evaluates).
        Returns the live state."""
        t0 = time.perf_counter()
        self._report = self._warmup.join() if self._warmup is not None else WarmupReport()
        if not self.eager:
            cuda = self.device.type == "cuda"
            self.programs = RoundPrograms(
                self.step, state, self._block_shapes(self.n_acc), capture=cuda,
                probe=self.profile_steps > 0 and self.rank == 0)
            state = self.programs.state
            if self.do_eval and self.eval_every:
                one = self._block_shapes(1)
                self.eval_programs = EvalPrograms(
                    self._eval_sums, (one[0][1:], one[1][1:], one[2][1:], (1,)), self.device,
                    capture=cuda)
        self._warmup_join_ms = (time.perf_counter() - t0) * 1e3
        return state

    def _capture_programs(self, parity: bool) -> None:
        """With ``warmup_compile`` on a card: every program of the round
        cycle that starts with a round of ``parity``, and the eval step's,
        warmed up and captured before the first round, the block source's
        worker held off the CUDA runtime (a capture forbids another
        thread's unsafe calls). Then ``train_warmup_join_ms`` (the builds'
        join and the captures), the span ``compile/warmup_join`` and the
        report into ``compile_report``."""
        t0 = time.perf_counter()
        programs = self.programs
        if programs is not None and programs.capture_on and self.warmup_compile:
            with self.source.quiet():
                programs.prepare(parity)
                if self.eval_programs is not None:
                    self.eval_programs.prepare([s[0] for s in programs.sets])
        join_ms = self._warmup_join_ms = self._warmup_join_ms + (time.perf_counter() - t0) * 1e3
        metrics.emit("train_warmup_join_ms", join_ms)
        self.tracer.complete_event("compile/warmup_join", join_ms, cat="compile")
        self.compile_report = self._compile_report()
        for name, r in self.compile_report["programs"].items():
            self.log.info("capture[%s]: warm-up %.0f ms, capture %.0f ms", name,
                          r["warmup_ms"] or 0.0, r["capture_ms"] or 0.0)

    def _compile_report(self) -> dict:
        """The summary's ``compile_report``: the builds, each program's
        warm-up and capture ms (those captured so far), the warm-up's
        launches, the build cache's counters."""
        records = {**(self.programs.records if self.programs is not None else {}),
                   **(self.eval_programs.records if self.eval_programs is not None else {})}
        out = {**self._report.as_dict(),
               "programs": {n: dict(vars(r)) for n, r in records.items()}}
        if self.programs is not None:  # not counted as the rounds' launches
            out["warmup_launches"] = dict(self.programs.warmup_launches)
        out.update(warmup_compile=self.warmup_compile, libraries_for=list(self.libraries),
                   cache=cache_stats(), warmup_join_ms=self._warmup_join_ms)
        return out

    def _block_shapes(self, n_acc: int) -> tuple:
        """The shapes of a round's block after this rank's sequence cut,
        in ``MicrobatchBlock``'s order."""
        sp = 1 if self.sequence_group is None else self.sequence_group.size
        tokens = (n_acc, self.batch_size, self.max_length // sp)
        return tokens, tokens, tokens, (n_acc,)

    def _block_source(self):
        return block_source(self.loader, self.n_acc, self.device, self.prefetch_depth,
                            self.prefetch, self.valid)

    def _host_counters(self, state, rounds_done: int) -> tuple:
        """The host's round index (``state.round_idx`` for ACCO/DPU, the
        step count for DDP), the state's skipped and consecutive skipped
        rounds, in one read."""
        leaves = [state.health.skipped_rounds, state.health.consec_skipped]
        if self.method != "ddp":
            leaves.append(state.round_idx)
        vals = torch.stack([t.reshape(()).to(torch.int64) for t in leaves]).tolist()
        return (vals[2] if self.method != "ddp" else rounds_done), vals[0], vals[1]

    def _profile_streams(self) -> dict:
        """The streams :class:`RoundProfiler` probes, by role."""
        if self.device.type != "cuda":
            return {}
        return {"compute": torch.cuda.current_stream(self.device),
                "comm": getattr(self.step, "comm_stream", None),
                "copy": self.source.copy_stream if self.source is not None else None}

    def _read_rounds(self, unread: list, state, round_log: list) -> tuple:
        """Read the rounds dispatched since the last boundary back in one
        copy: their loss, LR and ``is_real_update`` into ``round_log``,
        each with its dispatch ms, the last one's plus the wait for the
        copy (at ``delta_step_for_log`` 1 a round's ms is then its synced
        time); returns the state's committed count, consecutive skipped
        rounds, the last round's grad norm and the skipped rounds.
        Empties ``unread``."""
        t0 = time.perf_counter()
        health, m = state.health, unread[-1][1]
        tail = torch.stack([state.zero1.grads_committed.reshape(()).float(),
                            health.consec_skipped.float(), m.grad_norm.float(),
                            health.skipped_rounds.float()])
        values = torch.cat([torch.stack([r[1].loss.float() for r in unread]),
                            torch.stack([r[1].lr.float() for r in unread]),
                            torch.stack([r[2].float() for r in unread]), tail]).tolist()
        n = len(unread)
        for i, (idx, _, _, ms) in enumerate(unread):
            row = {"round": idx, "loss": values[i], "lr": values[n + i],
                   "is_real_update": values[2 * n + i] > 0.5, "ms": ms}
            round_log.append(row)
            self.log.info("round %d: loss %.4f lr %.3e real_update %s (%.1f ms)",
                          idx, row["loss"], row["lr"], row["is_real_update"], row["ms"])
        round_log[-1]["ms"] += (time.perf_counter() - t0) * 1e3
        unread.clear()
        committed, consec, grad_norm, skipped = values[3 * n:]
        return committed, int(consec), grad_norm, int(skipped)

    def _agreed(self, choose) -> str:
        """``choose()``'s value on rank 0 (a checkpoint path, the run id),
        broadcast to every rank, so that no two ranks restore different
        steps (one rank alone: its own choice). An error on rank 0 is raised
        on every rank."""
        if self.all_ranks is None or self.n_ranks == 1:
            return choose()
        import torch.distributed as dist

        box = [None]
        if self.rank == 0:
            try:
                box[0] = ("ok", choose())
            except Exception as exc:  # noqa: BLE001 — raised on every rank below
                box[0] = ("error", exc)
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.all_ranks, 0),
                                   group=self.all_ranks)
        kind, value = box[0]
        if kind == "error":
            raise value
        return value

    def _rollback(self, state):
        """The watchdog's rollback (JAX: trainer.py:2058-2143): restore the
        newest complete checkpoint in place and fence the poisoned data
        window — the loader goes on from the last CONSUMED block, not from
        the checkpoint's position, so the batches between the checkpoint
        and the anomaly are skipped and the same poisoned batch is never
        replayed into the same state. More than ``rollback_max`` rollbacks
        raise. Returns ``(state, meta)``."""
        self.rollbacks += 1
        if self.rollbacks > self.rollback_max:
            raise RuntimeError(
                f"watchdog: {self.rollbacks - 1} auto-rollbacks already performed "
                f"(rollback_max={self.rollback_max}) and training is anomalous again — the "
                "corruption is not recoverable by rewinding state past the bad data window; "
                "inspect the checkpoints and data shard"
            )
        # the fence before closing the source: the last consumed block's
        # exact-resume position
        fence = dict(self.source.iter_state())
        self.source.close()
        self.ckpt_manager.wait()  # the commit may still be writing that step

        def newest() -> str:
            path = ckpt.latest_checkpoint(self.ckpt_dir, log=self.log)
            if path is None:
                raise RuntimeError(
                    f"watchdog: {self.rollback_after_skipped} consecutive anomalous rounds "
                    f"and no complete checkpoint under {self.ckpt_dir!r} to roll back to — "
                    "the guard has been holding params at their last healthy values, but "
                    "recovery needs save=True (or rollback=False to disable escalation)"
                )
            return path

        path = self._agreed(newest)
        state, meta = ckpt.restore_checkpoint(path, state, rank=self.file_rank,
                                              mesh=self.mesh_shape, in_place=True)
        self.loader.set_state(fence)
        self.source = self._block_source()
        self.monitor.note_rollback()
        self.rollback_log.append({"path": path, "fence": fence,
                                  "count_grad_tot": int(meta["count_grad_tot"])})
        # the monitor's skip baseline rewound with the state
        _, self.monitor.last_skipped_rounds, _ = self._host_counters(state, 0)
        self.log.warning("watchdog: rolled back to %s (%d grads); data window fenced to "
                         "epoch=%s batch_pos=%s — the poisoned batches will not be replayed",
                         path, int(meta["count_grad_tot"]), fence.get("epoch"),
                         fence.get("batch_pos"))
        return state, meta

    def _preempted(self, rounds_this_run: int) -> bool:
        """The stop decision (JAX: trainer.py:2029-2056): at one rank the
        local latch; on several, the flags MAX-reduced over every rank
        every ``preempt_sync_rounds`` rounds on the loop's thread
        (a per-round read would serialize the dispatch), so every rank
        stops at the same boundary. A rank without a handler takes part
        with a flag of 0."""
        local = self._shutdown is not None and self._shutdown.should_stop()
        if self.all_ranks is None or self.n_ranks == 1:
            return local
        if rounds_this_run % self.preempt_sync_rounds != 0:
            return False
        import torch.distributed as dist

        flag = torch.tensor([float(local)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.all_ranks)
        return bool(flag.item())

    def _scalars(self, writer, count_grad_tot: float, loss: float, eval_loss, t_beg: float):
        logs.log_to_tensorboard(
            writer, nb_step=int(count_grad_tot),
            nb_samples=int(count_grad_tot) * self.batch_size, rank=self.rank, loss=loss,
            eval_loss=eval_loss, t0=t_beg, delta_step_for_log=1, epoch=-1,
        )

    # -- eval ---------------------------------------------------------------

    def evaluate(self, flat_params: torch.Tensor) -> float:
        """Mean eval loss over the eval batches (JAX: trainer.py:1963): per
        batch the global token-weighted mean, the masked nll sum and the
        target count each summed over dp x sp (:meth:`_eval_sums`, a
        captured program on a card unless ``eager``); the batch count is
        the least whole-batch count of any rank. Runs under ``no_grad``."""
        if self.eval_loader is None:
            return float("nan")
        n_batches = torch.tensor(len(self.eval_rows) // self.batch_size, device=self.device)
        if self.all_ranks is not None:
            import torch.distributed as dist

            dist.all_reduce(n_batches, op=dist.ReduceOp.MIN, group=self.all_ranks)
        model = self.model
        step = self.eval_programs
        if step is not None and step.capture_on:
            # captured before the eval's worker starts, the round source's
            # worker held off the CUDA runtime (see _compile)
            with self.source.quiet():
                step.prepare([flat_params])
        losses = []
        with torch.no_grad():
            for blk in self._eval_blocks(int(n_batches)):
                blk = prep_cp_leaves(blk, self.sequence_group, getattr(model, "zigzag", False))
                sums = (self._eval_sums(flat_params, blk) if step is None
                        else step(flat_params, blk))
                losses.append(float(sums[0] / sums[1].clamp(min=1.0)))
        return float(np.mean(losses)) if losses else float("nan")

    def _eval_sums(self, flat_params: torch.Tensor, blk) -> torch.Tensor:
        """One eval batch (its sequence cut made): ``[nll sum, target
        count]`` summed over dp x sp, through ``model_ce`` (K3's forward
        alone under fused_loss='pallas'; the vocab-parallel forms under
        tp, whose ranks each hold the whole sum, JAX: trainer.py:1916-1944).
        The loss form is the train path's verdict; the chunked loss, which
        has no nll-sum form (``num_valid``), gives its mean times the count.
        Under pp the batch runs the pipeline (:meth:`_pp_eval_sums`)."""
        if self.pipelined:
            return self._pp_eval_sums(flat_params, blk)
        model, fused = self.model, self.step.value_and_grad.fused_loss
        model.load_flat(flat_params)
        with torch.no_grad():
            if self.sequence_group is not None:  # labels shifted globally (JAX: :1888-1901)
                am, shift, count = None, False, (blk.labels != IGNORE_INDEX).sum()
            else:  # dense (JAX: :1930-1944)
                am = None if self.const_len_batch else blk.attention_mask
                shift, count = True, (blk.labels[:, 1:] != IGNORE_INDEX).sum()
            count = count.float()
            kw = dict(label_smoothing=self.label_smoothing, real_vocab=real_vocab_of(model),
                      shift=shift, vocab_group=getattr(model, "model_group", None))
            if fused == "chunk":
                nll_sum = model_ce(model, blk.input_ids, am, blk.labels, fused=fused,
                                   **kw) * count
            else:
                nll_sum = model_ce(model, blk.input_ids, am, blk.labels, fused=fused,
                                   num_valid=torch.ones((), device=self.device), **kw)
            sums = torch.stack([nll_sum.float(), count])
            if self.world is not None:
                import torch.distributed as dist

                dist.all_reduce(sums, group=self.world)
        return sums

    def _pp_eval_sums(self, flat_params: torch.Tensor, blk) -> torch.Tensor:
        """One eval batch through the pipeline (JAX: trainer.py:1751-1800),
        as ``parallel/pp.eval_block`` splits it: ``[nll sum, target
        count]`` summed over dp x sp (every stage holds the same sums; under
        sp each rank its chunk's, the labels shifted globally)."""
        from acco_tpu_torch.parallel.pp import eval_block

        block, count = eval_block(blk.input_ids, blk.attention_mask, blk.labels, self.step.pp,
                                  self.sequence_group)
        with torch.no_grad():
            nll_sum, _ = self.step.value_and_grad(flat_params, block)
            sums = torch.stack([nll_sum.float(), count])
            if self.world is not None:
                import torch.distributed as dist

                dist.all_reduce(sums, group=self.world)
        return sums

    def _eval_blocks(self, n_batches: int):
        """The first ``n_batches`` eval batches as one-microbatch blocks on
        the device, prefetched as the round's blocks are (JAX:
        trainer.py:1996-2015): the eval's per-batch read gives the worker
        a batch's time to collate and copy the next."""
        it = iter(self.eval_loader)
        host = ({**next(it), "valid": np.ones(1, np.float32)} for _ in range(n_batches))
        put, take, _ = block_copier(self.device, self.prefetch)
        if not self.prefetch:
            yield from map(put, host)
            return
        worker = AsyncPrefetcher(map(put, host), depth=self.prefetch_depth)
        try:
            for item in worker:
                yield item if take is None else take(item)
        finally:
            worker.close()

    # -- persistence --------------------------------------------------------

    def _ckpt_due(self, elapsed: float) -> bool:
        """The time-based checkpoint trigger: rank 0's clock decides and
        every rank follows (JAX: trainer.py:2019)."""
        due = elapsed > self.checkpoint_every_s
        if self.all_ranks is not None and self.n_ranks > 1:
            import torch.distributed as dist

            flag = torch.tensor([float(due)], device=self.device)
            dist.broadcast(flag, src=dist.get_global_rank(self.all_ranks, 0),
                           group=self.all_ranks)
            due = bool(flag.item())
        return due

    def _save(self, state, count_grad_tot: float, rounds_done: int, t_beg: float,
              export_npz: bool = True) -> str:
        """Every rank snapshots its state and commits it through the
        manager (JAX: trainer.py:2144-2200): the loop waits for the
        device-to-host copy only (after ACCO's comm stream too, which
        writes the shard), and with ``ckpt_async`` the rank file, rank 0's
        ``params.npz`` (a final save's: the dense float32 params from the
        snapshot, trimmed to ``n_params``), ``meta.json`` and the retention
        follow on the commit thread. ``save_ms`` records the loop's stall."""
        t0 = time.perf_counter()
        count = int(count_grad_tot)
        loader = self.source.iter_state()
        meta = {
            "count_grad_tot": count,
            "rounds_done": rounds_done,
            "elapsed_s": time.time() - t_beg,
            "method": self.method,
            "id_run": self.id_run,
            # the position of the last consumed block (blocks the worker
            # has prefetched are collated again on resume); each rank also
            # keeps its own in its state file
            "loader": loader,
            "mesh": dict(self.mesh_shape),
            "n_params": self.model.n_params,
            "padded_size": self.step.geom.padded_size,
            "saved_at_unix": time.time(),
        }
        extra = None
        rows = self._tp_rows(state) if export_npz and self.model.tp_layout is not None else None
        if self.rank == 0 and export_npz:
            n_params = self.model.n_params

            def extra(path: str, host: dict) -> None:
                if rows is None:
                    flat = host["flat_params"][:n_params].to(torch.float32).numpy()
                else:  # the dense model from every tp shard's row, unpadded
                    from acco_tpu_torch.parallel.tp import host_ravel

                    dense = self.model.tp_layout.gather_params(rows)
                    flat = host_ravel(self.model.unpad_vocab(dense), np.float32)
                np.savez(os.path.join(path, "params.npz"), flat_params=flat)

        comm_stream = getattr(self.step, "comm_stream", None)
        path = self.ckpt_manager.save(count, state, meta, extra_files=extra,
                                      rank_meta={"loader": loader, **self._tp_meta()},
                                      streams=() if comm_stream is None else (comm_stream,))
        stall_ms = (time.perf_counter() - t0) * 1e3
        if self.rank == 0:
            self.log.info("checkpoint -> %s (loop stall %.1f ms%s)", path, stall_ms,
                          ", committing in the background" if self.ckpt_manager.in_flight
                          else "")
        self.save_ms.append(stall_ms)
        if self.attribution is not None:
            self.attribution.note("ckpt", stall_ms)
        return path

    def _tp_meta(self) -> dict:
        """The rank file's tp index under tensor parallelism, its pp index
        under pipeline parallelism, both under tp x pp."""
        g = self.step.groups
        return {} if g is None else g.model_indices()

    def _tp_rows(self, state):
        """Under tensor or pipeline parallelism (or both), every model
        index's flat parameters (a tp shard's, a stage's, a stage's tp
        shard's) as float32 host rows on rank 0 (None elsewhere), in model
        index order, sent over rank 0's model group one row at a time: no
        card holds more than its own row. The other model groups take no
        part."""
        g = self.step.groups
        if g.dp_index != 0 or g.sp_index != 0:
            return None
        n = self.model.n_params
        mine = state.flat_params[:n].contiguous()
        # copies: a float32 CPU state's .float().cpu() is the live tensor,
        # and buf is received into again
        if g.n_model == 1:
            return [mine.to("cpu", torch.float32, copy=True).numpy()]
        import torch.distributed as dist

        if g.model_index != 0:
            dist.send(mine, dst=dist.get_global_rank(g.tensor, 0), group=g.tensor)
            return None
        rows = [mine.to("cpu", torch.float32, copy=True).numpy()]
        buf = torch.empty_like(mine)
        for t in range(1, g.n_model):
            dist.recv(buf, src=dist.get_global_rank(g.tensor, t), group=g.tensor)
            rows.append(buf.to("cpu", torch.float32, copy=True).numpy())  # lint: host-sync-ok: the export, once a save
        return rows

    def _write_results(self, final_loss, total_time: float, extra: dict) -> None:
        """The ``results.csv`` row (JAX: trainer.py:2261), health columns
        folded in."""
        args = self.args.to_container() if hasattr(self.args, "to_container") else dict(self.args)
        row = logs.create_dict_result(
            args, self.dp, node_count(), logs.platform_name(self.device), total_time,
            self.id_run, float("nan") if final_loss is None else final_loss,
        )
        row.update(extra)
        logs.save_result(os.path.join(self.run_dir, "results.csv"), row)


def node_count() -> int:
    """Nodes of the run, as JAX's ``initialize_distributed`` counts them:
    SLURM's host list, else torchrun's ``GROUP_WORLD_SIZE`` (its node
    count), else 1."""
    if "SLURM_JOB_NODELIST" in os.environ:
        from acco_tpu_torch.utils.hostlist import expand_hostlist

        return len(expand_hostlist(os.environ["SLURM_JOB_NODELIST"]))
    return int(os.environ.get("GROUP_WORLD_SIZE", "1"))
