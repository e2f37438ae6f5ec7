"""The training loop: the seed round, then ACCO or DPU rounds, or DDP steps,
to the target.

Counterpart of ``DecoupledTrainer._train`` in ``acco_tpu/trainer.py``,
slimmed: const-len packing (or per-document truncation), a shuffled
batch iterator, then rounds (or steps) until ``nb_steps_tot`` gradients
are committed. Each round logs its loss, LR and ``is_real_update``;
reading them back is the loop's one sync per round, so a round's wall
time includes its device work on both streams (the round ends with the
current stream waiting on the comm stream).

Ranks: the ``mesh`` of ``parallel/mesh.py``, ``{dp: N, sp: M}``. Each
rank reads the rows of its dp index (the raw texts sharded by dp index
before packing, as JAX's trainer shards them) in batches of
``batch_size`` rows, and, under context parallelism (sp > 1, or a mesh
that carries a one-rank sequence group, which runs the CP code with no
hop), keeps its chunk of the sequence
(``parallel/common.prep_cp_leaves``). CP needs const-len batches and
``max_length`` divisible by sp (2 sp under the zig-zag layout).
``microbatch_mask`` ([n_acc][dp], 0/1) gives each rank its ``valid``
column: heterogeneous workers, whose masked microbatches run and count
nothing.

Not here yet: ACCO's DPU warmup rounds, eval, checkpoints, TensorBoard
and ``results.csv`` (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from acco_tpu_torch.data.loader import (
    ShardedBatchIterator,
    infinite_batches,
    shard_dataset,
    stack_microbatches,
)
from acco_tpu_torch.data.tokenize import pack_texts
from acco_tpu_torch.ops.attention import resolve_attention_impl
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy, prep_cp_leaves
from acco_tpu_torch.parallel.ddp import DDPTrainStep


class Trainer:
    def __init__(self, model, tokenizer, train_texts, args, log=None, seed: int = 0,
                 device="cpu", mesh=None):
        self.log = log or logging.getLogger("acco_tpu_torch")
        self.model = model
        self.device = torch.device(device)
        self.seed = seed
        self.mesh = mesh
        # a mesh with a sequence group (sp > 1, JAX: trainer.py:141-145, or
        # a group of one rank passed in by hand) turns context parallelism on
        self.sequence_group = None if mesh is None else mesh.sequence_group
        groups = None if mesh is None else mesh.groups
        self.dp = 1 if groups is None else groups.dp
        self.dp_index = 0 if groups is None else groups.dp_index
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
        if self.method == "acco" and int(args.get("n_warmup_steps", 0)) > 0:
            raise NotImplementedError(
                "ACCO's DPU warmup rounds (n_warmup_steps > 0) are not ported "
                "yet: ROADMAP.md queue 1, item 6"
            )
        self.batch_size = int(args.get("batch_size", 8))
        self.n_acc = int(args.get("n_grad_accumulation", 1))
        self.max_length = int(args.get("max_length", 1024))
        self.nb_grad_tot = int(args.get("nb_steps_tot", 1000))
        self.const_len_batch = bool(args.get("const_len_batch", True))
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
        common = dict(
            weight_decay=float(args.get("weight_decay", 0.0)),
            beta1=float(args.get("adam_beta1", 0.9)),
            beta2=float(args.get("adam_beta2", 0.999)),
            label_smoothing=float(args.get("label_smoothing_factor", 0.0)),
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
        # this dp index's texts, then packing (JAX: trainer.py:434-441)
        if self.dp > 1:
            train_texts = shard_dataset(list(train_texts), self.dp, self.dp_index)
        if self.const_len_batch:
            rows = pack_texts(train_texts, tokenizer, self.max_length)
        else:
            rows = tokenizer(list(train_texts), truncation=True,
                             max_length=self.max_length)["input_ids"]
        self.loader = ShardedBatchIterator(
            rows, self.batch_size, self.max_length,
            pad_token_id=int(getattr(tokenizer, "pad_token_id", 0) or 0),
            seed=seed,
        )
        # the attention impl the model's (global) layers run at this length
        self.attention = resolve_attention_impl(
            model.attention, self.max_length, model.config.head_dim, self.device
        )
        self.final_state = None

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

    def train(self) -> dict:
        t_beg = time.time()
        batches = infinite_batches(self.loader)
        zigzag = getattr(self.model, "zigzag", False)

        def next_block():
            block = stack_microbatches(batches, self.n_acc, self.valid)
            return prep_cp_leaves(block_from_numpy(block, self.device), self.sequence_group,
                                  zigzag)

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = self.step.init_state(self.model.init_flat(gen))
        seed_loss = None
        if self.method != "ddp":
            state, seed_loss = self.step.seed(state, next_block())
            seed_loss = float(seed_loss)
            self.log.info("seed round: loss %.4f", seed_loss)

        count_grad_tot = 0.0
        round_idx = 0  # host mirror of state.round_idx: the parity
        round_log = []
        while True:
            if count_grad_tot >= self.nb_grad_tot:
                if not self.nan_guard:
                    break
                # guard-skipped rounds commit nothing: trust the device count
                count_grad_tot = float(state.zero1.grads_committed)
                if count_grad_tot >= self.nb_grad_tot:
                    break
            t0 = time.perf_counter()
            if self.method == "ddp":
                state, m = self.step.step(state, next_block())
                real = ~m.skipped
            else:
                state, m = self.step.round(state, next_block(), parity=round_idx % 2 == 0)
                real = m.is_real_update
            row = {"round": round_idx, "loss": float(m.loss), "lr": float(m.lr),
                   "is_real_update": bool(real)}
            row["ms"] = (time.perf_counter() - t0) * 1e3
            round_log.append(row)
            self.log.info(
                "round %d: loss %.4f lr %.3e real_update %s (%.1f ms)",
                round_idx, row["loss"], row["lr"], row["is_real_update"], row["ms"],
            )
            if self.method != "acco":
                count_grad_tot += self.grads_per_round
            elif round_idx % 2 == 1:  # acco: real updates land on odd rounds
                count_grad_tot += 2 * self.grads_per_round
            round_idx += 1

        self.final_state = state
        return {
            "final_loss": round_log[-1]["loss"] if round_log else seed_loss,
            "count_grad_tot": int(float(state.zero1.grads_committed)),
            "rounds": len(round_log),
            "total_time_s": time.time() - t_beg,
            "method": self.method,
            "fused_loss": self.step.value_and_grad.fused_loss,
            "attention": self.attention,
            "mesh": self.mesh.describe() if self.mesh is not None else {"dp": 1, "sp": 1},
            "skipped_rounds": int(state.health.skipped_rounds),
            "n_params": self.model.n_params,
            "seed_loss": seed_loss,
            "round_log": round_log,
            "device": str(self.device),
        }
