"""The rounds as programs over two buffer sets, captured as CUDA graphs
on a card and replayed.

Counterpart of the JAX trainer's jitted round programs: there each ACCO
round is one XLA executable, specialised on the parity, and so are the
DDP step and the eval. Here a round of a given kind is captured once
with ``torch.cuda.CUDAGraph`` and replayed every round of that kind; a
replay is one launch where eager PyTorch enqueues ~1,500.

A graph reads and writes fixed addresses, so the state is carried in two
buffer sets, A and B, each a full state of the step's shapes. A round
reads one set and writes the other (``into=``: the new flat parameters,
optimizer shard and pending gradients go straight into its buffers; the
scalars are copied in at the end). Each leaf has its own phase: a leaf
the round returns unchanged stays where it is — ACCO's speculative (even)
round keeps the optimizer shard (``keep_state=False``) — so ACCO cycles
through four programs (two parities x the shard's two phases) and DPU
through two. DDP writes over its one set (see :class:`RoundPrograms`):
one program. Nothing is copied a round but the block and the metrics:

- the block: each round's block is copied into a static block buffer on
  the current stream before the replay (a few hundred KB);
- the metrics: each replay overwrites its metric vector, which is copied
  into a fresh per-round slot on the device right after; the trainer
  reads the slots back at its boundary, as it read the eager metrics.

:class:`RoundPrograms` holds the two sets; its ``state`` is the live one
(what the rollback restores into, the snapshot reads and the final count
reads). :meth:`RoundPrograms.adopt` writes a state made elsewhere (the
seed round, ACCO's DPU warm-up, a drill's poisoned tensors) into the live
buffers. :meth:`RoundPrograms.prepare` warms up each code path once (reading
the live set, writing only the other) and captures the whole cycle
ahead of the first round; without it (``warmup_compile:
false``) a program runs uncaptured at its first round and is captured
right after, JAX's lazy compile. On the CPU there is no capture: the
same buffer-set code runs uncaptured every round.

Launch counts. Each ops module counts its wrapper's calls in
``LAUNCHES``; a replay calls no wrapper, so each program measures what
its capture counted and a replay adds that (:func:`credit`). Captures
and warm-ups launch nothing that counts: their counts are taken back
and the warm-up's are reported apart. Other dict counters (a test's)
join through :func:`counting`.

:class:`EvalPrograms` does the same for the eval step, one graph per
buffer its flat parameters may live in, in a memory pool of its own
(it replays between rounds, out of the rounds' order).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from acco_tpu_torch.compile.warmup import ProgramRecord

# -- the launch counters -----------------------------------------------------

_EXTRA_COUNTERS: List[dict] = []


def counter_tables() -> List[dict]:
    """Every counter a replay credits: the ops modules' ``LAUNCHES`` and
    the dicts registered with :func:`counting`."""
    from acco_tpu_torch.ops import (
        banded_attention,
        block_attention,
        flash_attention,
        fused_attention,
        fused_ce,
    )

    return [m.LAUNCHES for m in (fused_attention, banded_attention, fused_ce, flash_attention,
                                 block_attention)] + list(_EXTRA_COUNTERS)


@contextlib.contextmanager
def counting(table: dict):
    """Count ``table`` (a dict of ints) as a launch table while open:
    captures measure it and replays credit it."""
    _EXTRA_COUNTERS.append(table)
    try:
        yield table
    finally:
        _EXTRA_COUNTERS.remove(table)


def _snapshot() -> list:
    return [(t, dict(t)) for t in counter_tables()]


def _taken_back(before: list) -> list:
    """Restore the counters to ``before``; return what was counted since
    (per table: ``{key: n}``, nonzero entries)."""
    delta = []
    for table, old in before:
        d = {k: v - old.get(k, 0) for k, v in table.items() if v != old.get(k, 0)}
        table.clear()
        table.update(old)
        if d:
            delta.append((table, d))
    return delta


def credit(delta: list) -> None:
    """Add a program's captured counts to the live counters (a replay)."""
    for table, d in delta:
        for k, n in d.items():
            table[k] = table.get(k, 0) + n


def _totals(delta: list) -> dict:
    out: dict = {}
    for _, d in delta:
        for k, n in d.items():
            out[k] = out.get(k, 0) + n
    return out


# -- the state as leaves -----------------------------------------------------

def _is_state(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(state) -> list:
    """The tensors of a NamedTuple state, depth first in field order."""
    out = []
    for v in state:
        out.extend(flatten(v) if _is_state(v) else [v])
    return out


def unflatten(template, leaves) -> Any:
    """A state of ``template``'s structure from ``leaves`` (an iterator
    or a list, in :func:`flatten`'s order)."""
    it = iter(leaves)

    def build(t):
        return type(t)(*(build(v) if _is_state(v) else next(it) for v in t))

    return build(template)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.dtype == b.dtype
            and a.device == b.device)


# -- one program ---------------------------------------------------------------

class Program:
    """One program: ``body()`` reads and writes fixed buffers and returns
    its outputs. Uncaptured, :meth:`__call__` runs the body; captured, it
    replays the graph (crediting the counters) and returns the outputs
    the capture made, which every replay overwrites."""

    def __init__(self, name: str, body: Callable):
        self.name = name
        self.body = body
        self.graph = None
        self.outputs = None
        self.delta: list = []
        self.record = ProgramRecord(name)

    def capture(self, pool, stream) -> None:
        """Capture the body on ``stream`` into ``pool``, with the default
        ``capture_error_mode`` ('global'). Not through ``torch.cuda.graph``,
        whose entry synchronizes the device and empties the caches: a
        capture adds no synchronizing call to the run. cuBLAS's cached
        workspaces are dropped before and after, as PyTorch's own graph
        trees do: a workspace made during the capture lives in the pool
        and would otherwise stay in cuBLAS's cache, keeping the pool (and
        every free block of it) alive after the graph is gone."""
        before = _snapshot()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            _clear_cublas_workspaces()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    outputs = self.body()
                finally:
                    graph.capture_end()
            _clear_cublas_workspaces()
        except Exception as exc:
            self.record.error = f"{type(exc).__name__}: {exc}"
            _taken_back(before)
            raise
        self.record.capture_ms = (time.perf_counter() - t0) * 1e3
        self.delta = _taken_back(before)
        self.graph, self.outputs = graph, outputs

    def __call__(self):
        if self.graph is None:
            return self.body()
        credit(self.delta)
        self.graph.replay()
        return self.outputs


def _memory_gib() -> tuple:
    """(allocated, reserved) GiB on the current device, after a capture."""
    return (round(torch.cuda.memory_allocated() / 2**30, 3),
            round(torch.cuda.memory_reserved() / 2**30, 3))


def _clear_cublas_workspaces() -> None:
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def _warm(body: Callable) -> tuple:
    """Run ``body`` once, on the current stream (whose cached blocks the
    round before it left), its launches taken back; returns (ms,
    counts)."""
    before = _snapshot()
    t0 = time.perf_counter()
    body()
    return (time.perf_counter() - t0) * 1e3, _totals(_taken_back(before))


def _make_room() -> None:
    """Return the allocator's cached blocks to the card before a capture
    when the free memory could not also hold the graph's pool (about the
    cache's size: a round's temporaries): with expandable segments the
    release synchronizes streams, so it runs only where memory is short
    (the long-context cells), not on every capture."""
    free, _ = torch.cuda.mem_get_info()
    cached = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    if free < 1.25 * cached:
        torch.cuda.empty_cache()


def spin_probe(role: str) -> None:
    """The branch probe of a captured round under ``profile_steps``: one
    spin kernel at the head of the compute branch, two at the head of
    the comm branch (``telemetry/profile.py`` names a replay's streams by
    their count a round)."""
    for _ in range(1 if role == "compute" else 2):
        torch.cuda._sleep(1000)


def _static_block(shapes, device):
    """A block of ``MicrobatchBlock``'s dtypes and ``shapes`` that a
    program reads: token and label 0, every mask and weight 1 (a valid
    block for the warm-ups, until a round's block is copied in)."""
    from acco_tpu_torch.data.prefetch import BLOCK_DTYPES
    from acco_tpu_torch.parallel.common import MicrobatchBlock

    return MicrobatchBlock(*(
        (torch.ones if key in ("attention_mask", "valid") else torch.zeros)(
            shape, dtype=dtype, device=device)
        for (key, dtype), shape in zip(BLOCK_DTYPES.items(), shapes)))


# -- the rounds ----------------------------------------------------------------

class RoundPrograms:
    """The rounds of one run (an ``AccoTrainStep`` in acco or dpu mode, or
    a ``DDPTrainStep``) over two buffer sets. DDP carries one: its step
    writes over its own state (zero1's in-place step), which a DDP round
    may, since nothing runs beside it; so DDP has one program and holds
    no second state during its backward, as its eager step does not.

    ``state``: the initial state, whose tensors become set A (no copy);
    set B is allocated alike. ``block_shapes``: the shapes of the
    round's block after the rank's sequence cut, in ``MicrobatchBlock``'s
    order. ``capture``: capture on a card (False: every round runs
    uncaptured, as on the CPU). ``probe``: capture the branch probes
    (``profile_steps``)."""

    def __init__(self, step, state, block_shapes, *, capture: bool, probe: bool = False):
        self.step = step
        self.ddp = not hasattr(step, "round")
        self.acco = not self.ddp and step.mode == "acco"
        self.template = state
        a = [t.detach() for t in flatten(state)]
        # DDP writes over its state (zero1's in-place step): one set
        self.in_place = self.ddp
        self.sets = (a, a if self.in_place else [torch.empty_like(t) for t in a])
        self.phases = (0,) * len(a)
        device = a[0].device
        self.capture_on = bool(capture) and device.type == "cuda"
        self.probe = bool(probe) and self.capture_on
        self.block = _static_block(block_shapes, device)
        self.programs: Dict[tuple, Program] = {}
        self.records: Dict[str, ProgramRecord] = {}
        self.warmup_launches: dict = {}
        self._warmed: set = set()
        self._warm_ms: dict = {}  # code path -> its warm-up's ms, until a record takes it
        self._pool = torch.cuda.graph_pool_handle() if self.capture_on else None
        self._stream = torch.cuda.Stream(device) if self.capture_on else None

    # the live state and the buffers
    @property
    def state(self):
        """The live state: each leaf in the set its phase names."""
        return unflatten(self.template, self._leaves(self.phases))

    def _leaves(self, phases) -> list:
        return [self.sets[p][i] for i, p in enumerate(phases)]

    def adopt(self, state) -> None:
        """Write ``state``'s leaves into the live buffers (those that are
        not the live buffers already)."""
        for live, new in zip(self._leaves(self.phases), flatten(state)):
            if not _same(live, new):
                live.copy_(new)

    def load_block(self, block) -> None:
        """Copy the round's block into the static block, on the current
        stream."""
        for dst, src in zip(self.block, block):
            if dst.shape != src.shape:
                raise ValueError(f"a captured round takes blocks of {tuple(dst.shape)}, "
                                 f"got {tuple(src.shape)}")
            dst.copy_(src)

    # the programs
    def _flag(self, parity: bool):
        """The static switch a program is specialised on: the parity for
        ACCO, nothing for DPU (every round commits) and DDP."""
        return bool(parity) if self.acco else None

    def _name(self, key) -> str:
        """e.g. ``acco_even/AAAAAAAAAAAAA``: the kind, then the set each
        leaf is read from, in :func:`flatten`'s order."""
        flag, phases = key
        kind = ("ddp" if self.ddp else self.step.mode if flag is None
                else f"acco_{'even' if flag else 'odd'}")
        return f"{kind}/{''.join('AB'[p] for p in phases)}"

    def _body(self, flag, phases: tuple, step=None):
        """The round (of ``step``, by default the programs' own) reading the
        leaves of ``phases`` and writing into the other set (DDP: over
        them); returns ``(next phases, metric vector)``, the metric vector
        ``[*metrics, real]`` in float32."""
        step = step or self.step
        inp = unflatten(self.template, self._leaves(phases))
        outs = self._leaves(tuple(1 - p for p in phases))
        if self.ddp:
            new, m = step.step(inp, self.block, in_place=True)
            real = ~m.skipped
        else:
            new, m = step.round(inp, self.block, bool(flag),
                                into=unflatten(self.template, outs))
            real = m.is_real_update
        nxt = []
        for i, (n, a, b) in enumerate(zip(flatten(new), flatten(inp), outs)):
            if _same(n, a):  # unchanged, or written over in place
                nxt.append(phases[i])
            elif b is a:  # one set: a new scalar copied over the old
                a.copy_(n)
                nxt.append(phases[i])
            else:
                if not _same(n, b):
                    b.copy_(n)
                nxt.append(1 - phases[i])
        vec = torch.stack([x.float().reshape(()) for x in (*m, real)])
        return tuple(nxt), vec

    def _program(self, key) -> Program:
        prog = self.programs.get(key)
        if prog is None:
            flag, phases = key
            holder: dict = {}

            def body(flag=flag, phases=phases):
                nxt, vec = self._body(flag, phases)
                holder["next"] = nxt
                return vec

            prog = Program(self._name(key), body)
            prog.holder = holder
            self.programs[key] = prog
            self.records[prog.name] = prog.record
        return prog

    def _warm_up(self, flag) -> None:
        """Run the code path of ``flag`` once, reading the live set and
        writing only the other one (DDP: an eager step into new buffers),
        so that every lazy initialisation (a library's load, a
        communicator, a handle) is done before a capture."""
        if flag in self._warmed:
            return
        if self.in_place:  # an eager step, into new buffers: the live set stays
            body = lambda: self.step.step(self.state, self.block)  # noqa: E731
        else:
            body = lambda: self._body(flag, self.phases)  # noqa: E731
        ms, counts = _warm(body)
        self._warmed.add(flag)
        for k, n in counts.items():
            self.warmup_launches[k] = self.warmup_launches.get(k, 0) + n
        self._warm_ms[flag] = ms

    def _capture(self, key) -> Program:
        prog = self._program(key)
        if key[0] not in self._warmed:
            self._warm_up(key[0])
        prog.record.warmup_ms = self._warm_ms.pop(key[0], None)
        _make_room()
        if self.probe:
            self.step.branch_probe = spin_probe
        try:
            prog.capture(self._pool, self._stream)
        finally:
            self.step.branch_probe = None
        prog.record.memory_gib = _memory_gib()
        return prog

    def prepare(self, parity: bool) -> None:
        """Warm up and capture every program of the cycle that starts at
        the live phases with a round of ``parity``, ahead of the first
        round (``warmup_compile``)."""
        if not self.capture_on:
            return
        # every code path warmed up first (on the current stream, in the
        # blocks the seed round left cached), then the captures
        for flag in ((True, False) if self.acco else (None,)):
            self._warm_up(flag)
        key = (self._flag(parity), self.phases)
        while key not in self.programs or self.programs[key].graph is None:
            prog = self._capture(key)
            key = ((not key[0]) if self.acco else key[0], prog.holder["next"])

    def run(self, block, parity: bool, quiet=contextlib.nullcontext):
        """One round on ``block``: returns ``(state, metrics, real)``, the
        metrics and ``real`` (the update was committed) views of the
        round's slot. A program met for the first time with capture on
        runs uncaptured and is captured after, under ``quiet()`` (the
        prefetch worker held off the CUDA runtime)."""
        self.load_block(block)
        key = (self._flag(parity), self.phases)
        prog = self._program(key)
        vec = prog()
        self.phases = prog.holder["next"]
        slot = self.slot(vec)
        if self.capture_on and prog.graph is None:
            self._warmed.add(key[0])  # the round just ran this code path
            with quiet():
                self._capture(key)
        return self.state, self._metrics(slot), slot[-1]

    def run_uncaptured(self, step, block, parity: bool):
        """One round of another step over the same sets, uncaptured (ACCO's
        DPU warm-up rounds, each run once): returns ``(state, metrics,
        real)`` as :meth:`run`."""
        self.load_block(block)
        self.phases, vec = self._body(bool(parity), self.phases, step)
        slot = self.slot(vec)
        return self.state, self._metrics(slot), slot[-1]

    def slot(self, vec: torch.Tensor) -> torch.Tensor:
        """The round's metric slot: a copy of the program's metric vector,
        which the next replay overwrites."""
        return vec.clone()

    def _metrics(self, slot):
        from acco_tpu_torch.parallel.acco import AccoRoundMetrics
        from acco_tpu_torch.parallel.ddp import StepMetrics

        kind = StepMetrics if self.ddp else AccoRoundMetrics
        return kind(*slot[:len(kind._fields)])

    def release(self) -> None:
        """Drop the graphs (the run is over): their memory pool goes back to
        the allocator; the sets, the live state among them, stay."""
        for prog in self.programs.values():
            prog.graph = prog.outputs = None
        self.programs.clear()
        self.capture_on = False



class EvalPrograms:
    """The eval step (``step_fn(flat, block) -> [2] sums``) over a static
    eval block, one program per flat buffer, captured on a card in a
    memory pool of its own."""

    def __init__(self, step_fn: Callable, block_shapes, device, *, capture: bool):
        self.step_fn = step_fn
        device = torch.device(device)
        self.capture_on = bool(capture) and device.type == "cuda"
        self.block = _static_block(block_shapes, device)
        self.programs: Dict[int, Program] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.capture_on else None
        self._stream = torch.cuda.Stream(device) if self.capture_on else None

    def _program(self, flat: torch.Tensor) -> Program:
        prog = self.programs.get(flat.data_ptr())
        if prog is None:
            prog = Program(f"eval[{len(self.programs)}]", lambda: self.step_fn(flat, self.block))
            self.programs[flat.data_ptr()] = prog
        return prog

    def prepare(self, flats) -> None:
        """Warm up and capture the eval step for each of ``flats``."""
        if not self.capture_on:
            return
        for flat in flats:
            prog = self._program(flat)
            if prog.graph is None:
                prog.record.warmup_ms, _ = _warm(prog.body)
                _make_room()
                prog.capture(self._pool, self._stream)

    def __call__(self, flat: torch.Tensor, block) -> torch.Tensor:
        """The sums of one batch: the block copied into the static block,
        then the program for ``flat``'s buffer (captured first if new)."""
        for dst, src in zip(self.block, block):
            dst.copy_(src)
        prog = self._program(flat)
        if self.capture_on and prog.graph is None:
            self.prepare([flat])
        return prog()

    @property
    def records(self) -> dict:
        return {p.name: p.record for p in self.programs.values()}

    def release(self) -> None:
        """Drop the graphs (see :meth:`RoundPrograms.release`)."""
        for prog in self.programs.values():
            prog.graph = prog.outputs = None
        self.programs.clear()
        self.capture_on = False
