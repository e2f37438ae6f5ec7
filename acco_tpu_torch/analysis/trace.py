"""The collectives of a round: from a ``torch.profiler`` trace, or counted
at the port's own call sites.

Counterpart of ``acco_tpu/analysis/hlo.py``'s collective and schedule
parsing: where JAX reads the scheduled HLO of a compiled program, the
port reads what a profiled round did.

- :func:`collectives_from_trace`: each ``record_param_comms`` event of a
  Chrome trace (what ``ProcessGroupNCCL`` records for every collective:
  ``Collective name``, ``In msg nelems``, ``Out msg nelems``, ``Group
  size``, ``dtype``) as a :class:`Collective`, with the stream its NCCL
  kernel ran on when the trace has one (the launch inside the event's
  range carries the kernel's correlation).
- :class:`CollectiveRecorder`: gloo records no ``record_param_comms``
  (the CPU build of torch 2.13 traces ``c10d::allreduce_``-style ops
  without the group size), so on gloo the census counts at the port's own
  call sites: the recorder wraps ``torch.distributed``'s
  ``reduce_scatter_tensor``, ``all_gather_into_tensor``, ``all_reduce``,
  ``broadcast``, ``send`` and ``recv`` while it is installed, which is
  every collective the rounds issue (``parallel/zero1.py``,
  ``parallel/common.py``, the tp and pp layers). The program gates
  install it on the CPU; on the card they read the trace.

The streams of a trace are named by ``telemetry/profile.py``'s reader
(:func:`~acco_tpu_torch.telemetry.profile.event_sides`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

DTYPE_BYTES = {
    "float32": 4, "float": 4, "float16": 2, "half": 2, "bfloat16": 2, "c10::bfloat16": 2,
    "float64": 8, "double": 8, "int32": 4, "int": 4, "int64": 8, "long": 8, "int8": 1,
    "uint8": 1, "bool": 1, "byte": 1, "char": 1,
}

def collective_kind(name: str) -> Optional[str]:
    """The kind of a collective from its name in either source
    (``_reduce_scatter_base``, ``allgather_into_tensor_coalesced``,
    ``all_reduce``, ...); None for what moves nothing (a barrier, a wait)."""
    n = name.lower().replace("_", "")
    for key, kind in (("reducescatter", "reduce-scatter"), ("allgather", "all-gather"),
                      ("allreduce", "all-reduce"), ("broadcast", "broadcast"),
                      ("send", "send"), ("recv", "recv")):
        if key in n:
            return kind
    return None


def dtype_bytes(dtype: str) -> int:
    d = str(dtype).lower().removeprefix("torch.").removeprefix("at::")
    if d not in DTYPE_BYTES:
        raise ValueError(f"unknown collective dtype {dtype!r}")
    return DTYPE_BYTES[d]


@dataclass(frozen=True)
class Collective:
    """One collective: ``elems`` is its whole payload (a reduce-scatter's
    input, an all-gather's output, an all-reduce's tensor), ``group_size``
    its group's ranks, ``stream`` where its kernel ran (None: unknown, or
    no kernel: gloo, or NCCL at one rank)."""

    kind: str
    elems: int
    dtype: str
    group_size: int
    stream: Any = None

    @property
    def payload_bytes(self) -> int:
        return self.elems * dtype_bytes(self.dtype)

    def wire_bytes(self) -> float:
        """Bytes each rank sends, as a bandwidth-optimal ring moves them:
        ``(g-1)/g`` of the payload for a reduce-scatter or an all-gather,
        twice that for an all-reduce, the payload for a broadcast, send or
        recv over more than one rank."""
        g = max(int(self.group_size), 1)
        share = (g - 1) / g
        if self.kind in ("reduce-scatter", "all-gather"):
            return share * self.payload_bytes
        if self.kind == "all-reduce":
            return 2 * share * self.payload_bytes
        return float(self.payload_bytes) if g > 1 else 0.0


def _args(e: dict) -> dict:
    return e.get("args") or {}


def _arg(args: dict, *names, default=None):
    for name in names:
        if name in args:
            return args[name]
    return default


def collectives_from_trace(events: list) -> list:
    """The :class:`Collective` of each ``record_param_comms`` event (a
    host-side op) of a Chrome trace, in time order, with the stream of
    the NCCL kernel it launched where the trace shows one."""
    kernel_stream = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            kernel_stream[_args(e).get("correlation")] = _args(e).get("stream", e.get("tid"))
    launches = [(float(e["ts"]), e.get("pid"), e.get("tid"), _args(e).get("correlation"))
                for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"]
    out = []
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("name") == "record_param_comms"
                     and e.get("cat") != "kernel"), key=lambda e: float(e["ts"])):
        args = _args(e)
        kind = collective_kind(str(_arg(args, "Collective name", default="")))
        if kind is None:
            continue
        n_in = int(_arg(args, "In msg nelems", "In msg size", default=0) or 0)
        n_out = int(_arg(args, "Out msg nelems", "Out msg size", default=0) or 0)
        beg = float(e["ts"])
        end = beg + float(e.get("dur", 0))
        stream = next((kernel_stream[c] for ts, pid, tid, c in launches
                       if pid == e.get("pid") and tid == e.get("tid") and beg <= ts <= end
                       and c in kernel_stream), None)
        out.append(Collective(kind, max(n_in, n_out), str(_arg(args, "dtype", default="")),
                              int(_arg(args, "Group size", default=1) or 1), stream))
    return out


def nccl_kernels(events: list) -> int:
    """The NCCL kernels a trace shows (at one rank NCCL may launch none)."""
    return sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "nccl" in str(e.get("name", "")).lower())


class CollectiveRecorder(contextlib.ContextDecorator):
    """Inside ``with CollectiveRecorder() as rec:``, every call of the
    wrapped ``torch.distributed`` functions appends its
    :class:`Collective` to ``rec.calls`` (the port calls them as
    ``dist.<name>``, so the module's attributes are what it reaches)."""

    # name -> (kind, which argument holds the whole payload)
    WRAPPED = {"reduce_scatter_tensor": ("reduce-scatter", 1),
               "all_gather_into_tensor": ("all-gather", 0),
               "all_reduce": ("all-reduce", 0), "broadcast": ("broadcast", 0),
               "send": ("send", 0), "recv": ("recv", 0)}

    def __init__(self) -> None:
        self.calls: list = []
        self._saved: dict = {}

    def __enter__(self):
        import torch.distributed as dist

        for name, (kind, pos) in self.WRAPPED.items():
            original = getattr(dist, name)
            self._saved[name] = original

            def wrapped(*args, _original=original, _kind=kind, _pos=pos, **kwargs):
                tensor = args[_pos] if len(args) > _pos else kwargs.get(
                    "input" if _kind == "reduce-scatter" else "tensor",
                    kwargs.get("output_tensor"))
                group = kwargs.get("group")
                self.calls.append(Collective(
                    _kind, tensor.numel(), str(tensor.dtype).removeprefix("torch."),
                    dist.get_world_size(group)))
                return _original(*args, **kwargs)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        for name, original in self._saved.items():
            setattr(dist, name, original)
        self._saved.clear()
