"""The in-place check: the port's counterpart of honoured donation.

JAX donates the round state to each program and checks that XLA aliased
every donated input to an output (``acco_tpu/analysis/donation.py``): a
dropped donation keeps the buffer twice in HBM. The port has no donation:
its programs write the state into fixed buffers (``compile/graphs.py``:
``RoundPrograms``' two buffer sets, DDP's one, ``EvalPrograms``' flat
buffers, the serve engine's pools and flat parameter vector, which its
decode graph writes in place). So the check is on the buffers themselves,
across dispatches of a program:

- every state leaf after a dispatch is one of the program's static
  buffers (its ``data_ptr`` is in their set: ACCO's swap between the two
  sets is allowed, a new tensor is not);
- on a card, ``torch.cuda.memory_allocated()`` does not grow across the
  dispatches (a replay that allocates holds a second copy somewhere).

On the CPU the rounds run the same buffer-set code uncaptured, and are
checked the same way; :func:`eager_in_place` reports, for the eager round
(no programs), which leaves it writes in place and which it returns as
new tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

from acco_tpu_torch.sharding.rules import leaf_paths


@dataclass
class InPlaceReport:
    ok: bool
    program: str
    checked: int  # leaves checked, over every dispatch
    dispatches: int
    moved: list = field(default_factory=list)  # "path (dispatch k)" outside the buffers
    grew_bytes: int = 0  # memory_allocated() after the last dispatch - before the first

    def summary(self) -> str:
        s = (f"{self.checked} leaves over {self.dispatches} dispatches in the program's "
             f"static buffers, allocated memory {self.grew_bytes:+d} B")
        if self.moved:
            s += f"; NOT in place: {', '.join(self.moved[:4])}"
        return s


def _allocated(device) -> int:
    import torch

    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def check_in_place(name: str, dispatch: Callable[[], Any], buffers: set, n: int = 2,
                   device=None) -> InPlaceReport:
    """Run ``dispatch()`` (one dispatch of a program, returning its live
    state tree) once and then ``n`` times; every leaf of each state must
    lie in ``buffers`` (data pointers), and on a card the allocated
    memory must not grow across the ``n`` (the state's returns dropped;
    the first dispatch may make a library's lazy workspace, such as
    cuBLAS's for the stream, which a capture drops)."""
    import torch

    device = torch.device(device or "cpu")
    moved, checked = [], [0]

    def check(k: int) -> None:
        for path, leaf in leaf_paths(dispatch()):
            checked[0] += 1
            if leaf.data_ptr() not in buffers:
                moved.append(f"{path} (dispatch {k})")

    check(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = _allocated(device)
    for k in range(1, n + 1):
        check(k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    grew = _allocated(device) - before
    return InPlaceReport(ok=not moved and grew <= 0, program=name, checked=checked[0],
                         dispatches=n + 1, moved=moved, grew_bytes=grew)


def eager_in_place(step, state, block, parity: bool = True) -> dict:
    """``{"in_place": [...], "new": [...]}``: which leaves of ``state`` one
    eager round (``step.round``, or DDP's ``step.step(..., in_place=True)``)
    returns in the same buffer, and which as new tensors."""
    before = {path: leaf.data_ptr() for path, leaf in leaf_paths(state)}
    if hasattr(step, "round"):
        new, _ = step.round(state, block, parity)
    else:
        new, _ = step.step(state, block, in_place=True)
    out = {"in_place": [], "new": []}
    for path, leaf in leaf_paths(new):
        out["in_place" if before.get(path) == leaf.data_ptr() else "new"].append(path)
    return out


@contextlib.contextmanager
def watch_round_programs():
    """While installed, every ``RoundPrograms.run`` (a trainer's captured
    or buffer-set round) is checked: the state it returns lies in the two
    buffer sets. Yields ``{"rounds", "replays", "leaves", "moved"}``
    (``moved``: "round k: path" of each leaf outside them), which the
    caller reads after the run."""
    from acco_tpu_torch.compile import graphs

    report = {"rounds": 0, "replays": 0, "leaves": 0, "moved": []}
    original = graphs.RoundPrograms.run

    def run(self, block, parity, *args, **kwargs):
        prog = self.programs.get((self._flag(parity), self.phases))
        replay = prog is not None and prog.graph is not None
        out = original(self, block, parity, *args, **kwargs)
        allowed = {t.data_ptr() for s in self.sets for t in s}
        report["rounds"] += 1
        report["replays"] += replay
        for path, leaf in leaf_paths(out[0]):
            report["leaves"] += 1
            if leaf.data_ptr() not in allowed:
                report["moved"].append(f"round {report['rounds']}: {path}")
        return out

    graphs.RoundPrograms.run = run
    try:
        yield report
    finally:
        graphs.RoundPrograms.run = original
