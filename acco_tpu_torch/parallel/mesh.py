"""Process groups from the launcher's environment, shaped as the JAX mesh.

Counterpart of ``acco_tpu/parallel/mesh.py`` (``initialize_distributed``,
``make_mesh``) for the axes this port runs: ``{dp: N, sp: M}``. Ranks
lie row-major as on JAX's CPU mesh, dp outer and sp inner, so rank ``r``
is ``dp_index * sp + sp_index``; the data-parallel (dp) groups are the
ranks that share an ``sp_index``, the sequence (sp) groups of context
parallelism those that share a ``dp_index``, and ZeRO-1 shards over the
whole dp x sp world.

:func:`init_distributed` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``, or, as JAX does, SLURM's
``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_JOB_NODELIST`` (the first
host, port ``ACCO_COORD_PORT`` or 12346), and initialises the default
group: NCCL for CUDA, each rank on ``cuda:LOCAL_RANK``, gloo for the CPU.
A world of one rank initialises no process group. The ``tp`` and ``pp``
axes raise (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from acco_tpu_torch.ops.ring_attention import SequenceGroup

AXES = ("dp", "sp", "tp", "pp")
DEFAULT_COORD_PORT = 12346  # JAX's SLURM rendezvous port


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """The process groups a train step reduces over, and this rank's place
    in the dp x sp layout. ``None`` is a scope of one rank (no collective).

    Each scope has two groups: the compute branch's (the loss metric and
    the staged-grads verdict; the ring's hops go on the sequence group)
    and the comm branch's (the count all-reduce and ZeRO-1's collectives).
    On NCCL every communicator has its own stream, so the comm branch's
    collectives never queue behind the compute branch's."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    data: object = None  # compute: the dp ranks sharing this sp index
    world: object = None  # compute: dp x sp
    comm_data: object = None  # comm: the dp ranks sharing this sp index
    comm_world: object = None  # comm: dp x sp, ZeRO-1's shards

    @property
    def world_size(self) -> int:
        return self.dp * self.sp

    @property
    def shard_index(self) -> int:
        """This rank's ZeRO-1 shard: JAX's ``flat_shard_index(('dp', 'sp'))``."""
        return self.dp_index * self.sp + self.sp_index

    @classmethod
    def of_sequence(cls, sg: Optional[SequenceGroup]) -> Optional["RankGroups"]:
        """dp 1 over ``sg``'s ranks, every scope on ``sg``'s own group."""
        if sg is None:
            return None
        return cls(dp=1, sp=sg.size, dp_index=0, sp_index=sg.rank, world=sg.group,
                   comm_world=sg.group)

    @classmethod
    def around(cls, sequence_group: Optional[SequenceGroup] = None,
               data_group=None) -> "RankGroups":
        """The groups around a group made by hand: a sequence group (dp 1)
        or a data group (sp 1), with comm groups of the same ranks made
        here (every rank of the default group must call this)."""
        import torch.distributed as dist

        if (sequence_group is None) == (data_group is None):
            raise ValueError("hand in a sequence group or a data group, not both")
        group = data_group if sequence_group is None else sequence_group.group
        comm = dist.new_group(dist.get_process_group_ranks(group))
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if sequence_group is not None:
            return cls(dp=1, sp=size, dp_index=0, sp_index=rank, world=group, comm_world=comm)
        return cls(dp=size, sp=1, dp_index=rank, sp_index=0, data=group, world=group,
                   comm_data=comm, comm_world=comm)

    @classmethod
    def build(cls, dp: int, sp: int, rank: int) -> tuple["RankGroups", Optional[SequenceGroup]]:
        """Every group of a dp x sp world (each rank makes them all, in one
        order); returns this rank's groups and its sequence group (None at
        sp 1)."""
        import torch.distributed as dist

        dp_index, sp_index = divmod(rank, sp)
        world = dist.group.WORLD
        comm_world = dist.new_group(list(range(dp * sp)))

        def mine(n_groups, ranks_of, index):
            """This rank's group of a family of ``n_groups`` (all made)."""
            return [dist.new_group(ranks_of(i)) for i in range(n_groups)][index]

        data = comm_data = seq = None
        if dp > 1 and sp == 1:
            data, comm_data = world, comm_world
        elif dp > 1:
            dp_ranks = lambda s: [d * sp + s for d in range(dp)]  # noqa: E731
            data = mine(sp, dp_ranks, sp_index)
            comm_data = mine(sp, dp_ranks, sp_index)
        if sp > 1:
            seq = world if dp == 1 else mine(dp, lambda d: list(range(d * sp, (d + 1) * sp)),
                                             dp_index)
        groups = cls(dp=dp, sp=sp, dp_index=dp_index, sp_index=sp_index, data=data,
                     world=world, comm_data=comm_data, comm_world=comm_world)
        return groups, None if seq is None else SequenceGroup.of(seq)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's layout: ``dp`` data-parallel groups of ``sp`` sequence
    shards, this rank, its groups (None at one rank, unless a caller hands
    in a one-rank group to run the multi-rank code) and its sequence group
    (None unless context parallelism is on)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    sequence_group: Optional[SequenceGroup] = None
    groups: Optional[RankGroups] = None

    @property
    def world_size(self) -> int:
        return self.dp * self.sp

    def describe(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}


def check_mesh(mesh_shape) -> dict:
    """``{axis: size}`` for every axis (1 where the config leaves it out).
    Raises ValueError for an unknown axis and NotImplementedError, naming
    the ROADMAP item, for the ``tp`` and ``pp`` axes."""
    mesh_shape = dict(mesh_shape or {})
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh_shape axes must be among {AXES}, got {sorted(unknown)}")
    sizes = {axis: int(mesh_shape.get(axis) or 1) for axis in AXES}
    for axis in ("tp", "pp"):
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"mesh_shape={dict(mesh_shape)}: the {axis} axis (multi-rank tensor "
                "and pipeline parallelism) is not ported yet: ROADMAP.md queue 1, item 9"
            )
    return sizes


def _launch_env() -> tuple[int, int, int, Optional[str]]:
    """``(world, rank, local rank, init_method)`` from torchrun's variables
    or, without them, SLURM's (JAX: ``initialize_distributed``); one rank
    and no init method when neither launched this process."""
    if "RANK" in os.environ:
        return (int(os.environ.get("WORLD_SIZE", "1")), int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", "0")), "env://")
    if "SLURM_PROCID" in os.environ and int(os.environ.get("SLURM_NTASKS", "1")) > 1:
        from acco_tpu_torch.utils.hostlist import expand_hostlist

        hosts = expand_hostlist(os.environ["SLURM_JOB_NODELIST"])
        port = int(os.environ.get("ACCO_COORD_PORT", str(DEFAULT_COORD_PORT)))
        return (int(os.environ["SLURM_NTASKS"]), int(os.environ["SLURM_PROCID"]),
                int(os.environ.get("SLURM_LOCALID", "0")), f"tcp://{hosts[0]}:{port}")
    return 1, 0, 0, None


def init_distributed(mesh_shape, device) -> Mesh:
    """The mesh of this process, from the launcher's environment.
    ``device`` is the device the caller asked for; under CUDA each rank
    takes ``cuda:LOCAL_RANK`` (and raises without a card, as
    ``resolve_device`` does). The world size must equal dp x sp."""
    import torch.distributed as dist

    sizes = check_mesh(mesh_shape)
    dp, sp = sizes["dp"], sizes["sp"]
    world, rank, local_rank, init_method = _launch_env()
    if world != dp * sp:
        raise ValueError(
            f"mesh_shape={dict(mesh_shape or {})} needs {dp * sp} processes, the "
            f"launcher started {world} (torchrun --nproc_per_node {dp * sp})"
        )
    device = torch.device(device)
    if world == 1:
        return Mesh(dp=1, sp=1, rank=0, device=device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass --device cpu to run on the CPU")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    groups, sequence_group = RankGroups.build(dp, sp, rank)
    return Mesh(dp=dp, sp=sp, rank=rank, device=device, sequence_group=sequence_group,
                groups=groups)
