"""The registry of the programs a production run dispatches.

Counterpart of ``acco_tpu/analysis/programs.py``: ACCO (its four
captured programs, even and odd rounds over the two buffer sets), DPU,
DDP, the eval step, and the serve engine's prefill buckets and decode
step, each built by the production builders (``parallel/``'s train
steps, ``compile/graphs.py``'s ``RoundPrograms`` and ``EvalPrograms``,
the trainer's eval step, ``serve/engine.py``'s ``ServeEngine``) on a
tiny but real Llama in bf16 (:data:`TINY`, JAX's), on ``cuda:0`` unless
``device="cpu"``. On the card the rounds, the eval step and the decode
step are captured as CUDA graphs before the gates see them; on the CPU
the same buffer-set code runs uncaptured.

Each :class:`Program` carries what the gates need: its live state tree
(``rules``, ``dtypes``), its static buffers and a ``dispatch`` (the
in-place check), and for the train programs one eager round and the
comm model (``census``). ``group`` (a one-rank process group) runs the
train steps on it as their data group, so their reduce-scatter and
all-gather are issued (at one rank they move nothing); without it a
one-rank run issues no collective, as JAX's program at one shard.
Collectives of at most :data:`TINY_SMALL_ELEMS` elements count as small.
"""

from __future__ import annotations

import types
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

# JAX's tiny-but-real shape (acco_tpu/analysis/programs.py:33)
TINY = dict(
    vocab_size=257,
    hidden_size=32,
    intermediate_size=64,
    num_layers=1,
    num_heads=2,
    num_kv_heads=2,
    max_position_embeddings=64,
)
N_ACC = 1
BATCH = 2
SEQ = 32
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
# collectives at or below this many elements are bookkeeping (the count,
# health and loss sums) on the tiny programs; the flat vector is ~17k
TINY_SMALL_ELEMS = 512


@dataclass
class Program:
    """One dispatched program and what the gates read of it."""

    name: str
    kind: str  # train | eval | serve
    dispatch: Callable[[], Any]  # one dispatch; returns the live state tree
    state_tree: Any
    buffers: set  # data pointers of the program's static buffers
    dtype_rules: list
    rule_table: Any
    device: torch.device
    # one uncaptured round (the census): returns eager_in_place's report
    eager_round: Optional[Callable[[], dict]] = None
    expect_comm_bytes: float = 0.0
    expect_comm_ops: Optional[tuple] = None
    meta: dict = field(default_factory=dict)


def tiny_model(device, dtype=torch.bfloat16, seed: int = 0):
    """The tiny Llama with seeded random weights, on ``device``."""
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

    model = LlamaModel(LlamaConfig(**TINY), dtype=dtype, device=device)
    flat = model.init_flat(torch.Generator(device=device).manual_seed(seed))
    return model, flat.to(device=device, dtype=torch.float32)


def tiny_block(device, n_acc: int = N_ACC, seed: int = 0, batch: int = BATCH, seq: int = SEQ,
               vocab: int = TINY["vocab_size"]):
    from acco_tpu_torch.parallel.common import block_from_numpy

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (n_acc, batch, seq))
    return block_from_numpy({"input_ids": ids, "attention_mask": np.ones_like(ids),
                             "labels": ids, "valid": np.ones(n_acc, np.float32)}, device)


def _train_step(mode: str, model, groups):
    from acco_tpu_torch.ops.schedules import get_schedule
    from acco_tpu_torch.parallel.acco import AccoTrainStep
    from acco_tpu_torch.parallel.ddp import DDPTrainStep

    sched = get_schedule("cosine", 6e-4, 10, 100)
    kw = dict(const_len_batch=True, groups=groups, **OPT)
    if mode == "ddp":
        return DDPTrainStep(model, sched, **kw)
    return AccoTrainStep(model, sched, mode=mode, **kw)


def rank_groups(group):
    """The train steps' ``RankGroups`` around a one-rank process group
    handed in as their data group (None: no group)."""
    if group is None:
        return None
    from acco_tpu_torch.parallel.mesh import RankGroups

    return RankGroups.around(data_group=group)[0]


def build_train_program(mode: str, device="cuda", groups=None) -> Program:
    """A train mode's rounds over ``RoundPrograms`` (on a card: warmed up
    and captured, the whole cycle). ``dispatch`` runs the next round of
    the cycle (ACCO: even and odd in turn)."""
    from acco_tpu_torch.analysis.census import ring_comm_bytes
    from acco_tpu_torch.analysis.dtypes import train_state_rules
    from acco_tpu_torch.compile.graphs import RoundPrograms, flatten

    device = torch.device(device)
    model, flat = tiny_model(device)
    step = _train_step(mode, model, groups)
    state = step.init_state(flat)
    block = tiny_block(device)
    shapes = tuple(tuple(t.shape) for t in block)
    programs = RoundPrograms(step, state, shapes, capture=device.type == "cuda")
    programs.prepare(True)
    parity = [True]

    def dispatch():
        live, _, _ = programs.run(block, parity[0])
        if mode == "acco":
            parity[0] = not parity[0]
        return live

    def eager_round():
        # one uncaptured round of the same step on a copy of the live state:
        # which leaves it writes in place (``donation.eager_in_place``)
        from acco_tpu_torch.analysis.donation import eager_in_place
        from acco_tpu_torch.compile.graphs import unflatten

        copy = unflatten(programs.template, [t.clone() for t in flatten(programs.state)])
        return eager_in_place(step, copy, block)

    ns = step.geom.world_size
    with_group = groups is not None
    return Program(
        name={"acco": "acco_rounds", "dpu": "dpu_round", "ddp": "ddp_step"}[mode],
        kind="train", dispatch=dispatch, state_tree=programs.state,
        buffers={t.data_ptr() for s in programs.sets for t in s},
        dtype_rules=train_state_rules(model.dtype), rule_table=step.rule_table(),
        device=device, eager_round=eager_round,
        expect_comm_bytes=ring_comm_bytes(step.geom.padded_size, ns,
                                          torch.empty((), dtype=model.dtype).element_size()),
        expect_comm_ops=(2, 2) if with_group else None,
        meta={"programs": programs, "padded_size": step.geom.padded_size, "num_shards": ns,
              "groups": groups},
    )


def build_eval_program(train: Program) -> Program:
    """The trainer's eval step (``Trainer._eval_sums`` on a shim of the
    attributes it reads) over ``EvalPrograms``, one program for each flat
    buffer of ``train``'s buffer sets (captured on a card). Its state is
    ``{"flat_params": ...}``."""
    from acco_tpu_torch.analysis.dtypes import train_state_rules
    from acco_tpu_torch.compile.graphs import EvalPrograms
    from acco_tpu_torch.trainer import Trainer

    programs = train.meta["programs"]
    step, device = programs.step, train.device
    shim = types.SimpleNamespace(
        pipelined=False, model=step.model, step=step, sequence_group=None,
        const_len_batch=True, label_smoothing=0.0, device=device, world=None)
    block = tiny_block(device)
    one = tuple(t[0] if t.dim() > 1 else t[:1] for t in block)
    eval_programs = EvalPrograms(lambda flat, blk: Trainer._eval_sums(shim, flat, blk),
                                 tuple(tuple(t.shape) for t in one), device,
                                 capture=device.type == "cuda")
    flats = [s[0] for s in programs.sets]
    eval_programs.prepare(flats)
    which = [0]

    def dispatch():
        flat = flats[which[0] % len(flats)]
        which[0] += 1
        eval_programs(flat, one)
        return {"flat_params": flat}

    return Program(
        name="eval", kind="eval", dispatch=dispatch, state_tree={"flat_params": flats[0]},
        buffers={f.data_ptr() for f in flats}, dtype_rules=train_state_rules(step.model.dtype),
        rule_table=step.eval_rule_table(), device=device, meta={"programs": eval_programs})


def serve_state(engine) -> dict:
    """The engine's live serve state: its model's parameters (views of
    its flat vector) and the two pools."""
    k_pages, v_pages = engine.pools
    return {"params": [p for p, _, _ in engine.model.flat_slices()],
            "k_pages": k_pages, "v_pages": v_pages}


def build_serve_programs(device="cuda") -> list:
    """The serve engine's prefill buckets and its decode step (captured
    on a card), single replica: no collective expected."""
    from acco_tpu_torch.analysis.dtypes import serve_state_rules
    from acco_tpu_torch.serve.engine import ServeEngine

    device = torch.device(device)
    model, flat = tiny_model(device)
    engine = ServeEngine(model, page_size=8, num_pages=32, max_pages_per_seq=4, max_slots=2)
    engine.set_params(flat)
    engine.start_warmup()
    live = serve_state(engine)
    buffers = {t.data_ptr() for t in (*live["params"], live["k_pages"], live["v_pages"])}
    rules = serve_state_rules(model.dtype, engine.spec.torch_dtype)
    common = dict(kind="serve", buffers=buffers, dtype_rules=rules,
                  rule_table=engine.rule_table(), device=device,
                  meta={"spec": engine.spec, "engine": engine})
    out = []
    for bucket in engine.buckets:
        def prefill(bucket=bucket):
            engine.prefill(list(range(1, bucket + 1)), list(range(1, bucket // 8 + 1)))
            return serve_state(engine)

        out.append(Program(name=f"serve_prefill_{bucket}", dispatch=prefill, state_tree=live,
                           **common))
    table = np.zeros((engine.max_slots, engine.max_pages_per_seq), np.int64)
    table[:, 0] = 1

    def decode():
        engine.decode_logits(table, np.full(engine.max_slots, 3), np.ones(engine.max_slots))
        return serve_state(engine)

    out.append(Program(name="serve_decode", dispatch=decode, state_tree=live, **common))
    return out


def build_all_tiny(device="cuda", group=None) -> list:
    """Every program the gates cover: the ACCO rounds, DPU, DDP, the eval
    step, the serve prefill buckets and decode."""
    groups = rank_groups(group)  # one set of comm twins for the three steps
    progs = [build_train_program(mode, device, groups=groups) for mode in ("acco", "dpu", "ddp")]
    progs.append(build_eval_program(progs[0]))
    progs.extend(build_serve_programs(device))
    return progs
