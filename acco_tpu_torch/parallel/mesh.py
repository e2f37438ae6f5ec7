"""Process groups from the launcher's environment, shaped as the JAX mesh.

Counterpart of ``acco_tpu/parallel/mesh.py`` (``initialize_distributed``,
``make_mesh``) for the axes this port runs: ``{dp: N, sp: M}``, ``{dp: N, tp: T}``
and ``{dp: N, pp: P}``.
Ranks lie row-major as on JAX's CPU mesh. With sp, dp is outer and sp
inner, so rank ``r`` is ``dp_index * sp + sp_index``; the data-parallel
(dp) groups are the ranks that share an ``sp_index``, the sequence (sp)
groups of context parallelism those that share a ``dp_index``, and
ZeRO-1 shards over the whole dp x sp world. With tp the axes lie in
``mesh_shape``'s own key order (JAX ``make_mesh``): ``{dp: 2, tp: 2}``
puts rank ``dp_index * 2 + tp_index``, ``{tp: 2, dp: 2}`` rank
``tp_index * 2 + dp_index``; the tensor groups are the ranks that share
a ``dp_index``, and ZeRO-1 shards each tp index's local flat vector over
the dp ranks that share it. The ``pp`` axis lies the same way: the
pipeline groups are the ranks that share a ``dp_index`` (the stages of
one model replica), and ZeRO-1 shards each stage's local flat vector
over the dp ranks that share its pp index.

:func:`init_distributed` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``, or, as JAX does, SLURM's
``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_JOB_NODELIST`` (the first
host, port ``ACCO_COORD_PORT`` or 12346), and initialises the default
group: NCCL for CUDA, each rank on ``cuda:LOCAL_RANK``, gloo for the CPU.
A world of one rank initialises no process group. ``pp`` together with
``tp`` or ``sp``, and ``tp`` together with ``sp``, raise
(ROADMAP.md queue 1, item 9.4).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from acco_tpu_torch.models.layers import TensorGroup
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
    collectives never queue behind the compute branch's.

    Under tensor parallelism ``world`` is the dp x sp ranks of this tp
    index (ZeRO-1's), ``tensor`` the tp ranks of this dp index (the
    layers' all-reduces and the vocab-parallel loss), ``comm_tensor`` its
    comm twin (ZeRO-1's sync of the replicated prefix), and ``all`` /
    ``comm_all`` every rank (the staged-grads verdict, the guard's
    sums, the trainer's decisions). Without tp, ``all`` is ``world``.

    ``tensor``, ``comm_tensor``, ``tp`` and ``tp_index`` are JAX's *model
    group* (``acco_tpu/parallel/acco.py:232-237``): the ranks that hold
    different pieces of one model replica, over the axis ``model_axis``
    names. Under pipeline parallelism (``model_axis`` 'pp') they are the
    pipeline group of this dp index, its size pp and this rank's stage:
    ZeRO-1's terms, the staged-grads verdict and the checkpoint's rank
    files read them alike for both axes."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    data: object = None  # compute: the dp ranks sharing this sp (and tp) index
    world: object = None  # compute: dp x sp
    comm_data: object = None  # comm: the dp ranks sharing this sp (and tp) index
    comm_world: object = None  # comm: dp x sp, ZeRO-1's shards
    tp: int = 1
    tp_index: int = 0
    tensor: object = None  # compute: the tp ranks sharing this dp index
    comm_tensor: object = None  # comm: the same ranks
    all: object = None  # compute: every rank (dp x sp x tp)
    comm_all: object = None  # comm: every rank
    model_axis: str = "tp"  # the axis of the model group: 'tp' or 'pp'

    def __post_init__(self):
        if self.tensor is None and self.all is None:
            object.__setattr__(self, "all", self.world)
            object.__setattr__(self, "comm_all", self.comm_world)

    @property
    def world_size(self) -> int:
        """The ranks ZeRO-1 shards over: dp x sp."""
        return self.dp * self.sp

    @property
    def n_ranks(self) -> int:
        return self.dp * self.sp * self.tp

    def model_group(self) -> Optional[TensorGroup]:
        """The model group (None without tensor or pipeline parallelism)."""
        if self.tensor is None:
            return None
        return TensorGroup(self.tensor, self.tp, self.tp_index)

    def tensor_group(self) -> Optional[TensorGroup]:
        """The model's tensor group (None without tensor parallelism)."""
        return self.model_group() if self.model_axis == "tp" else None

    def pipeline_group(self) -> Optional[TensorGroup]:
        """The pipeline group (None without pipeline parallelism)."""
        return self.model_group() if self.model_axis == "pp" else None

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
               data_group=None, tensor_group=None, pipeline_group=None) -> "RankGroups":
        """The groups around a group made by hand: a sequence group (dp 1),
        a data group (sp 1), a tensor group or a pipeline group (a process
        group: dp 1, tp or pp its size), with comm groups of the same ranks
        made here (every rank of the default group must call this)."""
        import torch.distributed as dist

        given = [g for g in (sequence_group, data_group, tensor_group, pipeline_group)
                 if g is not None]
        if len(given) != 1:
            raise ValueError("hand in one of a sequence group, a data group, a tensor group "
                             "or a pipeline group")
        group = sequence_group.group if sequence_group is not None else given[0]
        comm = dist.new_group(dist.get_process_group_ranks(group))
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if sequence_group is not None:
            return cls(dp=1, sp=size, dp_index=0, sp_index=rank, world=group, comm_world=comm)
        if tensor_group is not None or pipeline_group is not None:
            return cls(dp=1, sp=1, dp_index=0, sp_index=0, tp=size, tp_index=rank,
                       tensor=group, comm_tensor=comm, all=group, comm_all=comm,
                       model_axis="tp" if tensor_group is not None else "pp")
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

    @classmethod
    def build_tp(cls, dp: int, tp: int, rank: int, dp_major: bool = True,
                 axis: str = "tp") -> "RankGroups":
        """Every group of a dp x tp world (each rank makes them all, in one
        order), the axes row-major with dp outer when ``dp_major`` (the
        mesh_shape's key order, as JAX's ``make_mesh``); returns this
        rank's groups. A dp scope of one rank is None. ``axis`` 'pp'
        makes the same groups for a dp x pp world, ``tp`` then the pipeline
        size: the model groups are the pipelines."""
        import torch.distributed as dist

        def rank_of(d: int, t: int) -> int:
            return d * tp + t if dp_major else t * dp + d

        if dp_major:
            dp_index, tp_index = divmod(rank, tp)
        else:
            tp_index, dp_index = divmod(rank, dp)
        world = dist.group.WORLD
        comm_all = dist.new_group(list(range(dp * tp)))

        def mine(n_groups, ranks_of, index):
            """This rank's group of a family of ``n_groups`` (all made)."""
            return [dist.new_group(ranks_of(i)) for i in range(n_groups)][index]

        data = comm_data = None
        if dp > 1:
            dp_ranks = lambda t: [rank_of(d, t) for d in range(dp)]  # noqa: E731
            data = mine(tp, dp_ranks, tp_index)
            comm_data = mine(tp, dp_ranks, tp_index)
        tp_ranks = lambda d: [rank_of(d, t) for t in range(tp)]  # noqa: E731
        tensor = world if dp == 1 else mine(dp, tp_ranks, dp_index)
        comm_tensor = comm_all if dp == 1 else mine(dp, tp_ranks, dp_index)
        return cls(dp=dp, sp=1, dp_index=dp_index, sp_index=0, data=data, world=data,
                   comm_data=comm_data, comm_world=comm_data, tp=tp, tp_index=tp_index,
                   tensor=tensor, comm_tensor=comm_tensor, all=world, comm_all=comm_all,
                   model_axis=axis)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's layout: ``dp`` data-parallel groups of ``sp`` sequence
    shards, this rank, its groups (None at one rank, unless a caller hands
    in a one-rank group to run the multi-rank code) and its sequence group
    (None unless context parallelism is on); ``tp`` the model group's
    size: tensor-parallel (its group is ``groups.tensor_group()``) or,
    under pipeline parallelism, the pipeline's (``groups.pipeline_group()``)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    sequence_group: Optional[SequenceGroup] = None
    groups: Optional[RankGroups] = None
    tp: int = 1

    @property
    def world_size(self) -> int:
        """Every rank of the run: dp x sp x tp (or x pp)."""
        return self.dp * self.sp * self.tp

    @property
    def tensor_group(self) -> Optional[TensorGroup]:
        return None if self.groups is None else self.groups.tensor_group()

    @property
    def pipeline_group(self) -> Optional[TensorGroup]:
        return None if self.groups is None else self.groups.pipeline_group()

    def describe(self) -> dict:
        out = {"dp": self.dp, "sp": self.sp}
        if self.groups is not None and self.groups.tensor is not None:
            out[self.groups.model_axis] = self.tp
        return out


def check_mesh(mesh_shape) -> dict:
    """``{axis: size}`` for every axis (1 where the config leaves it out).
    Raises ValueError for an unknown axis and NotImplementedError, naming
    ROADMAP item 9.4, for ``pp`` together with ``tp`` or ``sp`` and for
    ``tp`` together with ``sp``."""
    from acco_tpu_torch.sharding.layout import check_pipeline

    mesh_shape = dict(mesh_shape or {})
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh_shape axes must be among {AXES}, got {sorted(unknown)}")
    sizes = {axis: int(mesh_shape.get(axis) or 1) for axis in AXES}
    if sizes["pp"] > 1:
        check_pipeline(sizes["pp"], tp=sizes["tp"], sp=sizes["sp"])
    if sizes["tp"] > 1 and sizes["sp"] > 1:
        raise NotImplementedError(
            f"mesh_shape={dict(mesh_shape)}: tp together with sp (tensor parallelism "
            "composed with context parallelism) is not ported yet: ROADMAP.md queue 1, "
            "item 9.4")
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
    ``resolve_device`` does). The world size must equal dp x sp x tp x pp."""
    import torch.distributed as dist

    sizes = check_mesh(mesh_shape)
    dp, sp = sizes["dp"], sizes["sp"]
    model_axis = "pp" if sizes["pp"] > 1 else "tp"
    tp = sizes[model_axis]  # the model group's size (at most one of tp and pp is > 1)
    world, rank, local_rank, init_method = _launch_env()
    if world != dp * sp * tp:
        raise ValueError(
            f"mesh_shape={dict(mesh_shape or {})} needs {dp * sp * tp} processes, the "
            f"launcher started {world} (torchrun --nproc_per_node {dp * sp * tp})"
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
    if tp > 1:
        keys = [axis for axis in dict(mesh_shape) if axis in ("dp", model_axis)]
        groups = RankGroups.build_tp(dp, tp, rank, dp_major=keys[0] == "dp", axis=model_axis)
        return Mesh(dp=dp, sp=1, rank=rank, device=device, groups=groups, tp=tp)
    groups, sequence_group = RankGroups.build(dp, sp, rank)
    return Mesh(dp=dp, sp=sp, rank=rank, device=device, sequence_group=sequence_group,
                groups=groups)
