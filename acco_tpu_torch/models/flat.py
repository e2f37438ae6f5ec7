"""Model parameters as views into one flat vector, in ``ravel_pytree`` order.

Both model families of the port keep their parameters this way: the
order and per-leaf layout of the flat vector equal JAX's ``ravel_pytree``
over the JAX model's ``init`` (dict keys sorted at every level, every
layer leaf stacked as ``[num_layers, ...]``), so flat parameters,
gradients and optimizer state compare elementwise with the JAX train
state. Each layer owns its slice of a stacked leaf as a separate
parameter, so autograd hands back per-layer gradients that
:meth:`FlatParamModel.gather_grads` copies into a flat gradient without
any [num_layers, ...] scatter.

Under tensor parallelism (a ``tensor_group``) the model holds only its tp
shard's parameters: the flat vector is ``parallel/tp.TpLayout``'s local
one, ``[replicated leaves | this shard's slices]``, each leaf at its
local shape, so it compares elementwise with JAX's row of the
``[tp, ...]`` stacked state.

Under pipeline parallelism (a ``pipeline_group``, JAX ``pp_param_specs``)
the same layout runs over the pp rule table: a stage holds
``num_layers / pp`` contiguous layers, ``V_pad / pp`` embedding rows
(and, for an untied Llama head, ``V_pad / pp`` head columns) and the
replicated leaves (the final norm; GPT-Neo's position table), its flat
vector ``[replicated leaves | this stage's slices]``.

Under both (a ``tensor_group`` and a ``pipeline_group``, with their
combined ``model_group``: JAX's tp x pp) the model is one stage's tensor
shard: ``parallel/tp.ComposedLayout``'s local vector, its layers' heads
and ffn columns split over the tensor group, the vocab over the combined
(pp, tp) group, ``V_pad / (pp * tp)`` rows a shard.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acco_tpu_torch.models.layers import normal_init


def sorted_layout(tree: dict) -> list[tuple[str, tuple, int]]:
    """``(path, shape, offset)`` per leaf of a two-level tree of shapes, in
    ``ravel_pytree`` order; ``path`` joins nested keys with '/'."""
    out, offset = [], 0
    for key in sorted(tree):
        sub = tree[key]
        items = (
            [(f"{key}/{k}", sub[k]) for k in sorted(sub)]
            if isinstance(sub, dict)
            else [(key, sub)]
        )
        for path, shape in items:
            out.append((path, shape, offset))
            offset += int(torch.Size(shape).numel())
    return out


class ParamBlock(nn.Module):
    """One layer's parameters: its slice of each stacked leaf."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device)))


def tensor_parallel_layout(family: str, dense_layout, tp: int, axis: str = "tp"):
    """``parallel/tp.TpLayout`` of a dense ``(path, shape, offset)``
    layout at ``tp`` shards, its split dims from the family's rule table
    for ``axis`` ('tp', or 'pp': ``tp`` stages; ``sharding/tables.py``
    ``model_split_specs``)."""
    from acco_tpu_torch.parallel.tp import TpLayout, shape_tree
    from acco_tpu_torch.sharding import model_split_specs

    shapes = shape_tree(dense_layout)
    return TpLayout(shapes, model_split_specs(family, shapes, axis), tp)


def composed_layout(family: str, dense_layout, pp: int, tp: int):
    """``parallel/tp.ComposedLayout`` of a dense layout at ``pp`` stages of
    ``tp`` tensor shards (``sharding/tables.py`` ``composed_split_specs``)."""
    from acco_tpu_torch.parallel.tp import ComposedLayout, shape_tree
    from acco_tpu_torch.sharding import composed_split_specs

    shapes = shape_tree(dense_layout)
    outer, inner = composed_split_specs(family, shapes)
    return ComposedLayout(shapes, outer, pp, inner, tp)


class FlatParamModel(nn.Module):
    """Parameters for ``layout``: a top-level leaf ``p`` is the attribute
    :meth:`attr_name` ``(p)``, and a leaf ``layers/x`` is ``layers[i].x``.
    ``layout`` is the dense model's; with a ``tensor_group`` the model
    holds its tp shard's part of it, with a ``pipeline_group`` its
    stage's, with both (and their combined ``model_group``) its stage's
    tp shard's (``tp_layout``, over the model axes' rule tables)."""

    family = ""  # the sharding tables' family name

    def __init__(self, layout, num_layers: int, dtype, device, tensor_group=None,
                 pipeline_group=None, model_group=None):
        super().__init__()
        self.dense_layout = layout
        self.tensor_group = tensor_group
        self.pipeline_group = pipeline_group
        # the group the parameters are split over (JAX's model axis): the
        # tensor or pipeline group, their combined (pp, tp) group under
        # both (the vocab's group), or None
        self.model_group = mg = check_model_group(tensor_group, pipeline_group, model_group)
        if tensor_group is not None and pipeline_group is not None:
            self.tp_layout = composed_layout(self.family, layout, pipeline_group.size,
                                             tensor_group.size)
        else:
            self.tp_layout = (None if mg is None else tensor_parallel_layout(
                self.family, layout, mg.size, "tp" if tensor_group is not None else "pp"))
        if self.tp_layout is not None:
            layout = self.tp_layout.layout
            num_layers //= 1 if pipeline_group is None else pipeline_group.size
        self.layout = layout
        self.dtype = dtype
        self.n_params = sum(int(torch.Size(s).numel()) for _, s, _ in layout)
        layer_shapes = {}
        for path, shape, _ in layout:
            if path.startswith("layers/"):
                layer_shapes[path.split("/", 1)[1]] = shape[1:]
            else:
                setattr(self, self.attr_name(path), nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device)
                ))
        self.layers = nn.ModuleList(
            ParamBlock(layer_shapes, dtype, device) for _ in range(num_layers)
        )

    @staticmethod
    def attr_name(path: str) -> str:
        return path

    @staticmethod
    def init_fill(path: str) -> Optional[float]:
        """The constant a leaf starts at, or None for normal(0, std)."""
        raise NotImplementedError

    def flat_slices(self) -> list[tuple[nn.Parameter, int, int]]:
        """``(parameter, offset, numel)`` for every parameter, in flat order."""
        out = []
        for path, shape, offset in self.layout:
            if path.startswith("layers/"):
                name = path.split("/", 1)[1]
                per = int(torch.Size(shape[1:]).numel())
                for i, block in enumerate(self.layers):
                    out.append((getattr(block, name), offset + i * per, per))
            else:
                param = getattr(self, self.attr_name(path))
                out.append((param, offset, param.numel()))
        return out

    def load_flat(self, flat: torch.Tensor) -> None:
        """Point every parameter at its slice of ``flat`` (no copy): the
        model then computes with whatever ``flat`` holds."""
        for param, offset, numel in self.flat_slices():
            param.data = flat[offset : offset + numel].view(param.shape)

    def gather_grads(self, grads, out: torch.Tensor) -> torch.Tensor:
        """Copy per-parameter ``grads`` (flat_slices order) into ``out``."""
        for (param, offset, numel), g in zip(self.flat_slices(), grads):
            out[offset : offset + numel].copy_(g.reshape(-1))
        return out

    @property
    def tp(self) -> int:
        return 1 if self.tensor_group is None else self.tensor_group.size

    def dense_shapes(self) -> dict:
        """The dense parameter tree's shapes (``parallel/tp.Leaf`` leaves)."""
        from acco_tpu_torch.parallel.tp import shape_tree

        return shape_tree(self.dense_layout)

    def tp_param_specs(self) -> dict:
        """Tensor-parallel split dim per leaf of the dense tree: None
        (replicated on every tp shard) or the int dim split over the tp
        shards, from the family's rule table (JAX: ``tp_param_specs``)."""
        from acco_tpu_torch.sharding import model_split_specs

        return model_split_specs(self.family, self.dense_shapes())

    def pp_param_specs(self) -> dict:
        """Pipeline split dim per leaf of the dense tree: the stacked layer
        leaves on their layer dim, the embedding (and an untied head) on
        the vocab dim, the rest replicated (JAX: ``pp_param_specs``)."""
        from acco_tpu_torch.sharding import model_split_specs

        return model_split_specs(self.family, self.dense_shapes(), "pp")

    def init_flat(self, generator: torch.Generator) -> torch.Tensor:
        """A fresh flat parameter vector: each leaf at its ``init_fill``
        constant, else normal(0, initializer_range) (the JAX init's
        distributions; the random draws differ). Under tensor parallelism
        the dense model's leaves are drawn in the dense order, one at a
        time, and this shard's slice of each is kept: the values are the
        dense init's at any tp (the same bits at tp 1), and the largest
        transient is one dense leaf in float32, as in the dense init. A
        pipeline stage, or a stage's tensor shard, keeps its slice of
        each leaf alike (the dense bits at pp 1)."""
        device = next(self.parameters()).device
        flat = torch.empty(self.n_params, dtype=self.dtype, device=device)
        local = {path: (shape, offset) for path, shape, offset in self.layout}
        tpl = self.tp_layout
        for path, shape, _ in self.dense_layout:
            n = int(torch.Size(shape).numel())
            local_shape, offset = local[path]
            m = int(torch.Size(local_shape).numel())
            fill = self.init_fill(path)
            if fill is not None:
                flat[offset : offset + m] = fill
                continue
            leaf = normal_init((n,), self.config.initializer_range, self.dtype, generator,
                               device)
            if tpl is not None:
                leaf = tpl.slice_leaf(path, leaf.view(shape), self.model_group.rank)
            flat[offset : offset + m] = leaf.reshape(-1)
        return flat


def check_model_group(tensor_group, pipeline_group, model_group):
    """The group the vocab is split over: the one model group, or under
    both a tensor and a pipeline group ``model_group``, which must be
    their combined (pp, tp) group, this rank at ``pp_index * tp +
    tp_index`` (JAX's ``lax.axis_index(('pp', 'tp'))``)."""
    if tensor_group is None or pipeline_group is None:
        if model_group is not None:
            raise ValueError("model_group is the combined group of a tensor and a pipeline "
                             "group: pass it with both")
        return tensor_group if tensor_group is not None else pipeline_group
    if model_group is None:
        raise ValueError("a model on a tensor and a pipeline group (tp x pp) needs their "
                         "combined (pp, tp) group as its model_group")
    want = (pipeline_group.size * tensor_group.size,
            pipeline_group.rank * tensor_group.size + tensor_group.rank)
    if (model_group.size, model_group.rank) != want:
        raise ValueError(f"model_group is {model_group.size} ranks with this one at "
                         f"{model_group.rank}; the combined (pp, tp) group is {want[0]} with "
                         f"this rank at {want[1]}")
    return model_group


def check_tp(config, tensor_group, vocab_pad_to, heads, pipeline_group=None) -> int:
    """The padded vocab; raises where tensor or pipeline parallelism
    cannot run: tp not dividing the head counts, pp not dividing the
    layers (``sharding/layout.check_pipeline``), a pad below the vocab.
    Every composition with the ring (a ``sequence_group``) runs: under
    tp the ring takes this shard's heads."""
    padded = int(vocab_pad_to or config.vocab_size)
    if padded < config.vocab_size:
        raise ValueError(f"vocab_pad_to={vocab_pad_to} < vocab_size={config.vocab_size}")
    if pipeline_group is not None:
        from acco_tpu_torch.sharding.layout import check_pipeline

        check_pipeline(pipeline_group.size, num_layers=config.num_layers)
    if tensor_group is None:
        return padded
    tp = tensor_group.size
    if any(h % tp for h in heads):
        raise ValueError(f"tensor parallelism size {tp} must divide the head counts {heads}")
    return padded


def unpad_vocab_tree(params: dict, vocab: int, padded: int) -> dict:
    """``params`` with the embedding's rows (and an untied head's columns)
    past ``vocab`` removed."""
    if padded == vocab:
        return params
    out = dict(params)
    out["wte"] = params["wte"][:vocab]
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"][:, :vocab]
    return out


def check_serve(model) -> None:
    """The serving surface runs one replica of the dense model, whole, as
    JAX's does (``acco_tpu/models/llama.py:360-365``: its models refuse a
    sequence or tensor axis; JAX has no pipeline-staged model)."""
    if model.sequence_group is not None or model.tensor_group is not None:
        raise ValueError(
            "the serving decode path is single-replica: build the model "
            "without a sequence group or a tensor group"
        )
    if model.pipeline_group is not None:
        raise ValueError(
            f"the serving decode path is single-replica: this model is pipeline stage "
            f"{model.pipeline_group.rank} of {model.pipeline_group.size} and holds only "
            "its layers; build the model without a pipeline group")


def check_whole(model) -> None:
    """The dense forward (``hidden``/``apply``) needs every layer: a
    pipeline stage holds only its own and runs through ``parallel/pp.py``."""
    if model.pipeline_group is not None:
        raise ValueError(
            f"this model is pipeline stage {model.pipeline_group.rank} of "
            f"{model.pipeline_group.size}: it holds only its layers; run it through "
            "parallel/pp.py (make_pp_loss_fn)")
