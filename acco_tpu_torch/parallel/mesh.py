"""Process groups from the launcher's environment, shaped as the JAX mesh.

Counterpart of ``acco_tpu/parallel/mesh.py`` (``initialize_distributed``,
``make_mesh``): any subset of the axes ``{dp, sp, tp, pp}``. Ranks lie
row-major over ``mesh_shape``'s own key order, as JAX's ``make_mesh``
lays devices out: ``{dp: 2, tp: 2}`` puts rank ``dp_index * 2 +
tp_index``, ``{tp: 2, dp: 2}`` rank ``tp_index * 2 + dp_index``, the
preset ``{dp: 2, pp: 8, tp: 2}`` rank ``(dp_index * 8 + pp_index) * 2 +
tp_index`` and ``{dp: 1, pp: 2, tp: 2, sp: 2}`` rank ``(pp_index * 2 +
tp_index) * 2 + sp_index``; an axis the config leaves out has size 1.
:meth:`RankGroups.build` makes, on every rank and in one order, every
group of the mesh (a scope of one rank is None):

- the data-parallel (dp) groups: the ranks that share every other index;
- the sequence (sp) groups of context parallelism (the ring);
- the tensor (tp) groups: the layers' all-reduces;
- the pipeline (pp) groups: the stages of one model replica;
- the model group, JAX's model axis (``acco_tpu/parallel/acco.py:
  225-275``): the tensor group, the pipeline group, or, with both, the
  combined (pp, tp) group in ``pp_index * tp + tp_index`` order, over
  which the vocab is split and the fully replicated prefix summed;
- ZeRO-1's world: the dp x sp ranks of one model index, in
  ``dp_index * sp + sp_index`` order (JAX's ``flat_shard_index(('dp',
  'sp'))``);
- every rank, for the staged-grads verdict, the guard's sums and the
  trainer's decisions;

and a comm twin of each group the communication branch reduces over
(``parallel/acco.py``). A group whose ranks are not in increasing order
(the world of an sp-major mesh, the model group of a tp-major one) keeps
its order through ``new_group(..., sort_ranks=False)``.

:func:`init_distributed` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``PORT``, or, as JAX does, SLURM's
``SLURM_PROCID``, ``SLURM_NTASKS`` and ``SLURM_JOB_NODELIST`` (the first
host, port ``ACCO_COORD_PORT`` or 12346), and initialises the default
group: NCCL for CUDA, each rank on ``cuda:LOCAL_RANK``, gloo for the CPU.
A world of one rank initialises no process group.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import torch

from acco_tpu_torch.models.layers import TensorGroup
from acco_tpu_torch.ops.ring_attention import SequenceGroup

AXES = ("dp", "sp", "tp", "pp")
COMPOSED = "pp,tp"  # the model axis of a tp x pp mesh: JAX's ('pp', 'tp') tuple
DEFAULT_COORD_PORT = 12346  # JAX's SLURM rendezvous port


def _new_group(ranks):
    """A process group of ``ranks``, its group ranks in the order given."""
    import torch.distributed as dist

    ranks = list(ranks)
    return dist.new_group(ranks, sort_ranks=ranks == sorted(ranks))


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """The process groups a train step reduces over, and this rank's place
    in the mesh. ``None`` is a scope of one rank (no collective).

    Each scope has two groups: the compute branch's (the loss metric, the
    staged-grads verdict, the layers' and the ring's collectives) and the
    comm branch's (the count all-reduce and ZeRO-1's collectives). On
    NCCL every communicator has its own stream, so the comm branch's
    collectives never queue behind the compute branch's.

    ``world`` is the dp x sp ranks of this model index (ZeRO-1's shards),
    ``tensor`` the model group (JAX's model axis, ``model_axis``: 'tp',
    'pp', or :data:`COMPOSED` for the combined (pp, tp) group), of size
    ``n_model`` with this rank at ``model_index``, ``comm_tensor`` its comm twin
    (ZeRO-1's sync of the replicated prefix), and ``all`` / ``comm_all``
    every rank. Without a model group, ``all`` is ``world``. Under tp x
    pp, ``pp`` is the pipeline's size, ``inner`` the tensor group of this
    stage (the layers' all-reduces) with ``comm_inner`` its comm twin
    (ZeRO-1's sum of the stage-split, tp-replicated segment) and ``pipe``
    the pipeline group (the hops and the broadcast of the last stage's
    output). ZeRO-1's terms, the staged-grads verdict and the
    checkpoint's rank files read the model group alike for every
    axis."""

    dp: int
    sp: int
    dp_index: int
    sp_index: int
    data: object = None  # compute: the dp ranks sharing every other index
    world: object = None  # compute: dp x sp of this model index
    comm_data: object = None  # comm: the same ranks as data
    comm_world: object = None  # comm: dp x sp, ZeRO-1's shards
    n_model: int = 1  # the model group's size: tp, pp, or pp x tp when composed
    model_index: int = 0
    tensor: object = None  # compute: the model group
    comm_tensor: object = None  # comm: the same ranks
    all: object = None  # compute: every rank
    comm_all: object = None  # comm: every rank
    model_axis: str = "tp"  # the axis of the model group: 'tp', 'pp' or COMPOSED
    pp: int = 1  # composed: the pipeline's size
    inner: object = None  # composed, compute: the tensor group of this stage
    comm_inner: object = None  # composed, comm: the same ranks
    pipe: object = None  # composed, compute: the pipeline group of this tp index

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
        return self.dp * self.sp * self.n_model

    @property
    def composed(self) -> bool:
        return self.model_axis == COMPOSED

    def model_sizes(self) -> dict:
        """``{axis: size}`` of the model axes (empty without a model group)."""
        if self.tensor is None:
            return {}
        if self.composed:
            return {"pp": self.pp, "tp": self.n_model // self.pp}
        return {self.model_axis: self.n_model}

    def model_indices(self) -> dict:
        """``{axis index name: index}`` of this rank on the model axes."""
        if self.tensor is None:
            return {}
        if self.composed:
            stage, shard = divmod(self.model_index, self.n_model // self.pp)
            return {"pp_index": stage, "tp_index": shard}
        return {f"{self.model_axis}_index": self.model_index}

    def model_group(self) -> Optional[TensorGroup]:
        """The model group (None without tensor or pipeline parallelism): the
        vocab's group."""
        if self.tensor is None:
            return None
        return TensorGroup(self.tensor, self.n_model, self.model_index)

    def tensor_group(self) -> Optional[TensorGroup]:
        """The model's tensor group (None without tensor parallelism)."""
        if self.composed:
            inner = self.n_model // self.pp
            return TensorGroup(self.inner, inner, self.model_index % inner)
        return self.model_group() if self.model_axis == "tp" else None

    def pipeline_group(self) -> Optional[TensorGroup]:
        """The pipeline group (None without pipeline parallelism)."""
        if self.composed:
            return TensorGroup(self.pipe, self.pp,
                               self.model_index // (self.n_model // self.pp))
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
               data_group=None, tensor_group=None, pipeline_group=None
               ) -> tuple["RankGroups", Optional[SequenceGroup]]:
        """The groups around groups made by hand, one per axis: a sequence
        group (sp), a data group (dp), a tensor group (tp) and a pipeline
        group (pp), any of them. One group alone may span several ranks
        (the other axes of size 1); several must each be of one rank (the
        composed code at every axis's size 1). The comm twins, the world
        (dp x sp), the combined model group under tp x pp and the
        all-rank groups are made here, of the same ranks (every rank of
        the default group must call this). Returns the groups and the
        sequence group, as :meth:`build` does."""
        import torch.distributed as dist

        sp_group = None if sequence_group is None else sequence_group.group
        given = [g for g in (sp_group, data_group, tensor_group, pipeline_group)
                 if g is not None]
        if not given:
            raise ValueError("hand in a sequence group, a data group, a tensor group or a "
                             "pipeline group")
        if len(given) > 1 and any(dist.get_world_size(g) != 1 for g in given):
            raise ValueError("groups handed in together must each be of one rank")
        ranks = dist.get_process_group_ranks(given[0])

        def new(twin_of=True):
            """A new group of the same ranks (None as the twin of None)."""
            return None if twin_of is None else dist.new_group(ranks)

        def place(group):
            return (1, 0) if group is None else (dist.get_world_size(group),
                                                 dist.get_rank(group))

        (dp, dp_index), (sp, sp_index) = place(data_group), place(sp_group)
        world = new() if sp_group is not None and data_group is not None else (
            sp_group if sp_group is not None else data_group)
        comm_data = new(data_group)
        kw = dict(dp=dp, sp=sp, dp_index=dp_index, sp_index=sp_index, data=data_group,
                  comm_data=comm_data, world=world,
                  comm_world=comm_data if world is data_group else new(world))
        if tensor_group is not None and pipeline_group is not None:
            kw.update(tensor=new(), model_axis=COMPOSED, inner=tensor_group,
                      comm_inner=new(), pipe=pipeline_group)
        elif tensor_group is not None or pipeline_group is not None:
            model = tensor_group if tensor_group is not None else pipeline_group
            n_model, model_index = place(model)
            kw.update(tensor=model, n_model=n_model, model_index=model_index,
                      model_axis="tp" if tensor_group is not None else "pp")
        if "tensor" in kw:
            kw["comm_tensor"] = new()
            if len(given) == 1:  # every rank: the model group alone
                kw.update(all=kw["tensor"], comm_all=kw["comm_tensor"])
            else:
                kw.update(all=new(), comm_all=new())
        return cls(**kw), sequence_group

    @classmethod
    def build(cls, mesh_shape: dict, rank: int) -> tuple["RankGroups", Optional[SequenceGroup]]:
        """Every group of the mesh ``mesh_shape`` (``{axis: size}`` in its
        key order; axes left out have size 1), each rank making them all in
        one order; returns this rank's groups and its sequence group (None
        at sp 1)."""
        import torch.distributed as dist

        order = [a for a in mesh_shape if a in AXES] + [a for a in AXES if a not in mesh_shape]
        sizes = {a: int(mesh_shape.get(a) or 1) for a in order}
        n = 1
        for a in order:
            n *= sizes[a]
        coords, rest = {}, rank
        for a in reversed(order):
            rest, coords[a] = divmod(rest, sizes[a])

        def rank_of(c: dict) -> int:
            r = 0
            for a in order:
                r = r * sizes[a] + c[a]
            return r

        made = {}  # (ranks, comm) -> group: one group per rank list and branch

        def family(axes: tuple, comm: bool = False):
            """This rank's group over ``axes`` (major to minor) of the family
            of such groups, every one made (the other indices fixed)."""
            others = [a for a in order if a not in axes]
            mine = None
            for fixed in itertools.product(*(range(sizes[a]) for a in others)):
                c = dict(zip(others, fixed))
                ranks = tuple(rank_of({**c, **dict(zip(axes, idx))})
                              for idx in itertools.product(*(range(sizes[a]) for a in axes)))
                if (ranks, comm) not in made:
                    whole = not comm and ranks == tuple(range(n))
                    made[ranks, comm] = dist.group.WORLD if whole else _new_group(ranks)
                if all(coords[a] == c[a] for a in others):
                    mine = made[ranks, comm]
            return mine

        dp, sp, tp, pp = (sizes[a] for a in ("dp", "sp", "tp", "pp"))
        model = (("pp", "tp") if tp > 1 and pp > 1 else ("tp",) if tp > 1
                 else ("pp",) if pp > 1 else ())
        comm_all = family(tuple(order), comm=True)
        kw = dict(dp=dp, sp=sp, dp_index=coords["dp"], sp_index=coords["sp"],
                  all=dist.group.WORLD, comm_all=comm_all)
        if dp * sp > 1:
            kw.update(world=family(("dp", "sp")), comm_world=family(("dp", "sp"), comm=True))
        if dp > 1:
            kw.update(data=family(("dp",)), comm_data=family(("dp",), comm=True))
        seq = family(("sp",)) if sp > 1 else None
        if model:
            kw.update(n_model=tp * pp, model_index=coords["pp"] * tp + coords["tp"],
                      tensor=family(model), comm_tensor=family(model, comm=True),
                      model_axis=COMPOSED if len(model) == 2 else model[0])
        if len(model) == 2:
            kw.update(pp=pp, inner=family(("tp",)), comm_inner=family(("tp",), comm=True),
                      pipe=family(("pp",)))
        return cls(**kw), None if seq is None else SequenceGroup.of(seq)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The run's layout: ``dp`` data-parallel groups of ``sp`` sequence
    shards, this rank, its groups (None at one rank, unless a caller hands
    in one-rank groups to run the multi-rank code) and its sequence group
    (None unless context parallelism is on)."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    sequence_group: Optional[SequenceGroup] = None
    groups: Optional[RankGroups] = None

    @property
    def world_size(self) -> int:
        """Every rank of the run: dp x sp x tp x pp."""
        return self.dp * self.sp * (1 if self.groups is None else self.groups.n_model)

    @property
    def tensor_group(self) -> Optional[TensorGroup]:
        return None if self.groups is None else self.groups.tensor_group()

    @property
    def pipeline_group(self) -> Optional[TensorGroup]:
        return None if self.groups is None else self.groups.pipeline_group()

    @property
    def model_group(self) -> Optional[TensorGroup]:
        return None if self.groups is None else self.groups.model_group()

    def describe(self) -> dict:
        out = {"dp": self.dp, "sp": self.sp}
        if self.groups is not None:
            out.update(self.groups.model_sizes())
        return out


def check_mesh(mesh_shape) -> dict:
    """``{axis: size}`` for every axis (1 where the config leaves it out).
    Raises ValueError for an unknown axis or a size below 1; whether pp
    divides the layers is the model's check (``sharding/layout.py``)."""
    mesh_shape = dict(mesh_shape or {})
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh_shape axes must be among {AXES}, got {sorted(unknown)}")
    sizes = {axis: int(mesh_shape.get(axis) or 1) for axis in AXES}
    bad = {a: s for a, s in sizes.items() if s < 1}
    if bad:
        raise ValueError(f"mesh_shape sizes must be >= 1, got {bad}")
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
    n = sizes["dp"] * sizes["sp"] * sizes["tp"] * sizes["pp"]
    world, rank, local_rank, init_method = _launch_env()
    if world != n:
        raise ValueError(
            f"mesh_shape={dict(mesh_shape or {})} needs {n} processes, the "
            f"launcher started {world} (torchrun --nproc_per_node {n})"
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
    order = {a: sizes[a] for a in dict(mesh_shape)}
    groups, sequence_group = RankGroups.build(order, rank)
    return Mesh(dp=groups.dp, sp=groups.sp, rank=rank, device=device,
                sequence_group=sequence_group, groups=groups)
