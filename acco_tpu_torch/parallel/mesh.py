"""Process groups from torchrun's environment, shaped as the JAX mesh.

Counterpart of ``acco_tpu/parallel/mesh.py`` for the axes this port runs:
``{dp: 1, sp: N}``, where the whole world is the sequence (``sp``) group
of context parallelism. :func:`init_distributed` reads torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``
and initialises the default group: NCCL for CUDA, each rank on
``cuda:LOCAL_RANK``, gloo for the CPU. A world of one rank initialises no
process group. ``dp > 1`` (ROADMAP.md queue 1, item 4) and the ``tp`` and
``pp`` axes (item 9) raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from acco_tpu_torch.ops.ring_attention import SequenceGroup

AXES = ("dp", "sp", "tp", "pp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's layout: ``dp`` data-parallel groups of ``sp`` sequence
    shards, this rank, and the sequence group (None at one rank, unless a
    caller hands in a one-rank group to run the CP code without hops)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    sequence_group: Optional[SequenceGroup] = None

    @property
    def world_size(self) -> int:
        return self.dp * self.sp

    def describe(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}


def check_mesh(mesh_shape) -> dict:
    """``{axis: size}`` for every axis (1 where the config leaves it out).
    Raises ValueError for an unknown axis and NotImplementedError, naming
    the ROADMAP item, for the axes this port does not run: everything but
    ``{dp: 1, sp: N}``."""
    mesh_shape = dict(mesh_shape or {})
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh_shape axes must be among {AXES}, got {sorted(unknown)}")
    sizes = {axis: int(mesh_shape.get(axis) or 1) for axis in AXES}
    if sizes["dp"] > 1:
        raise NotImplementedError(
            f"mesh_shape={dict(mesh_shape)}: data parallelism over more than one "
            "rank (multi-rank dp, DDP) is not ported yet: ROADMAP.md queue 1, item 4"
        )
    for axis in ("tp", "pp"):
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"mesh_shape={dict(mesh_shape)}: the {axis} axis (multi-rank tensor "
                "and pipeline parallelism) is not ported yet: ROADMAP.md queue 1, item 9"
            )
    return sizes


def init_distributed(mesh_shape, device) -> Mesh:
    """The mesh of this process, from torchrun's environment. ``device`` is
    the device the caller asked for; under CUDA each rank takes
    ``cuda:LOCAL_RANK`` (and raises without a card, as ``resolve_device``
    does). The world size must equal dp x sp."""
    import torch.distributed as dist

    sizes = check_mesh(mesh_shape)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != sizes["dp"] * sizes["sp"]:
        raise ValueError(
            f"mesh_shape={dict(mesh_shape or {})} needs {sizes['dp'] * sizes['sp']} "
            f"processes, the launcher started {world} (torchrun --nproc_per_node)"
        )
    device = torch.device(device)
    if world == 1:
        return Mesh(dp=1, sp=1, rank=0, device=device)
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass --device cpu to run on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    return Mesh(dp=1, sp=world, rank=rank, device=device,
                sequence_group=SequenceGroup.of(dist.group.WORLD))
