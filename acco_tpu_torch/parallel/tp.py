"""Tensor parallelism for the flat-vector train state: the per-shard layout.

Counterpart of ``acco_tpu/parallel/tp.py`` (``host_ravel``, ``pad_vocab``,
``TpLayout``). A Megatron-style ``tp`` mesh axis shards each Llama or
GPT-Neo layer's matrices across the ranks of a tensor group (attention
by heads, the MLP by the ffn dim, the embedding and an untied head by
the vocab), while the small replicated leaves (norm scales, GPT-Neo's
position table and output biases) stay whole on every tp shard. ZeRO-1
then runs within each tp index: every rank's flat parameter vector is
its tp shard's local one, and the optimizer shards it over dp (x sp).

The flat layout per tp shard is ``[replicated leaves | this shard's
slices]``, each part in ``ravel_pytree`` order (dict keys sorted), as
JAX's: the replicated segment comes first, so the gradient
synchronisation below is a contiguous prefix, and each rank's flat
vector, gradients and ZeRO-1 shard compare elementwise with JAX's row
of the ``[tp, ...]`` stacked state.

Gradients follow JAX's convention. Under ``shard_map(check_vma=False)``
the transpose of a forward ``psum`` is again a ``psum``; the port's
all-reduce (``models/layers.py`` ``tp_all_reduce``) does the same in
its backward. Every backward path through a tp all-reduce then carries
a factor tp, so the pending gradients hold what JAX's hold, and ZeRO-1
(``parallel/zero1.py``) applies JAX's correction: every gradient is
divided by tp (folded into the count divisor) and the replicated
prefix, whose per-shard gradients are mixtures of partial and duplicated
contributions, is summed over the tensor group first.

Pipeline parallelism's layout *is* a ``TpLayout`` (JAX ``pp.py:12-17``)
over the pp rule table (``sharding/tables.py``): ``tp`` is then the
pipeline size, the layer leaves split on their layer dim into contiguous
stages and the vocab-split rows padded with ``pad_vocab(V, pp)``; the
class needs nothing more.

``ComposedLayout`` (JAX ``tp.py:239-429``) is tp x pp: the stages are
the outer split, the tensor shards of a stage the inner one, one local
flat vector per (stage, tp shard) in three contiguous segments, each in
``ravel_pytree`` order: ``[0:n_repl_both)`` the leaves replicated on
both axes (the final norm; GPT-Neo's position table),
``[n_repl_both:n_repl)`` the stage-split, tp-replicated leaves (the
layers' norm scales and output biases), ``[n_repl:n_local)`` the
tp-split leaves (the layer matrices, stage-sliced then head- or
ffn-sliced; the vocab tables double-sliced, rows ``(o * tp + i) *
V / (pp * tp)`` on). ZeRO-1 sums the first segment's gradients over the
combined (pp, tp) group and the second's over the tensor group
(``parallel/zero1.py``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from acco_tpu_torch.sharding.rules import leaf_paths


class Leaf:
    """A shape-only tree leaf (a dense parameter's shape, no data)."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)

    def __repr__(self) -> str:
        return f"Leaf{self.shape}"


def shape_tree(layout) -> dict:
    """Nested dict of :class:`Leaf` from a ``(path, shape, offset)`` layout."""
    return _tree_of([(path, Leaf(shape)) for path, shape, _ in layout])


def _get(tree: dict, path: str):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def _set(tree: dict, path: str, value) -> None:
    *parents, name = path.split("/")
    node = tree
    for key in parents:
        node = node.setdefault(key, {})
    node[name] = value


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def host_ravel(tree: Any, dtype=None) -> np.ndarray:
    """Flat host vector of a tree: leaves in ``leaf_paths`` order (JAX's
    tree-flatten order), raveled and concatenated, with no device
    placement. ``TpLayout.stack_flat`` and the trainer's ``params.npz``
    export share it."""
    leaves = [np.ravel(np.asarray(leaf)) for _, leaf in leaf_paths(tree)]
    if dtype is not None:
        leaves = [x.astype(dtype, copy=False) for x in leaves]
    return np.concatenate(leaves) if leaves else np.empty((0,), dtype or np.float32)


def pad_vocab(vocab_size: int, tp: int, align: int = 128) -> int:
    """Smallest padded vocab >= ``vocab_size`` that is ``align``-aligned
    and divisible by ``tp`` (Megatron's convention: 50257 -> 50304 at
    tp <= 4); ``vocab_size`` itself when tp already divides it."""
    if vocab_size % tp == 0:
        return vocab_size
    p = -(-vocab_size // align) * align
    while p % tp:
        p += align
    return p


def slice_dim(leaf, dim: int, parts: int, index: int):
    """Part ``index`` of ``parts`` equal parts of ``leaf`` along ``dim``
    (a numpy array, a torch tensor, or a :class:`Leaf`)."""
    size = leaf.shape[dim] // parts
    if isinstance(leaf, Leaf):
        shape = list(leaf.shape)
        shape[dim] = size
        return Leaf(shape)
    sl = [slice(None)] * len(leaf.shape)
    sl[dim] = slice(index * size, (index + 1) * size)
    return leaf[tuple(sl)]


class _RowLayout:
    """What the per-model-index layouts share: ``layout`` (``(path, local
    shape, offset)`` in flat order), ``tp`` rows and ``split_row``."""

    def unravel_local(self, flat_local) -> dict:
        """[n_local] flat vector (numpy or torch) -> this row's local params
        tree (views where the input allows)."""
        tree: dict = {}
        for path, shape, offset in self.layout:
            _set(tree, path, flat_local[offset:offset + _numel(shape)].reshape(shape))
        return tree

    def stack_flat(self, params: dict, pad_to: Optional[int] = None) -> np.ndarray:
        """[tp, n_local (padded to ``pad_to``)] host array of every row's
        flat vector, in numpy: no device sees a row."""
        host = _tree_of([(path, np.asarray(leaf)) for path, leaf in leaf_paths(params)])
        out = np.stack([host_ravel(self.split_row(host, m)) for m in range(self.tp)])
        if pad_to is not None and pad_to > out.shape[1]:
            out = np.pad(out, ((0, 0), (0, pad_to - out.shape[1])))
        return out


class TpLayout(_RowLayout):
    """Per-tp-shard flat packing of a model's parameter tree.

    ``params``: the dense tree (nested dicts) of arrays or :class:`Leaf`
    shapes; ``specs``: the same tree with, per leaf, None (replicated on
    every tp shard) or the int dim split across the tp shards (the
    models' ``tp_param_specs``, from ``sharding/tables.py``)."""

    def __init__(self, params: dict, specs: dict, tp: int):
        self.tp = int(tp)
        self.specs = specs
        self.paths = [path for path, _ in leaf_paths(params)]
        for path, leaf in leaf_paths(params):
            spec = _get(specs, path)
            if spec is not None and leaf.shape[spec] % self.tp:
                raise ValueError(
                    f"tp={self.tp} does not divide dim {spec} of the sharded leaf {path} "
                    f"with shape {tuple(leaf.shape)}: for the vocab-parallel embedding and "
                    "head this means padding the vocab to a multiple of tp (e.g. 50257 -> "
                    "50304, parallel/tp.pad_vocab), as Megatron does"
                )
        self.layout = []  # (path, local shape, offset) in [replicated | sharded] order
        offset = 0
        shapes = _tree_of([(path, Leaf(leaf.shape)) for path, leaf in leaf_paths(params)])
        for path, leaf in leaf_paths(self.split_local(shapes, 0)):
            self.layout.append((path.split("/", 1)[1], leaf.shape, offset))
            offset += _numel(leaf.shape)
        self.n_local = offset
        self.n_repl = sum(_numel(shape) for path, shape, _ in self.layout
                          if _get(specs, path) is None)
        # one model axis: the whole prefix is replicated on all of it
        self.n_repl_both = self.n_repl

    def spec(self, path: str) -> Optional[int]:
        return _get(self.specs, path)

    def slice_leaf(self, path: str, leaf, index: int):
        """Shard ``index``'s part of the dense leaf at ``path`` (the leaf
        itself where it is replicated)."""
        spec = self.spec(path)
        return leaf if spec is None else slice_dim(leaf, spec, self.tp, index)

    # -- tree <-> (replicated, shard) pair ------------------------------------

    def split_local(self, params: dict, index: int) -> tuple:
        """``(replicated subtree, shard index's slice subtree)``: nested
        dicts holding only their own leaves (JAX's pair with None leaves,
        which its flatten skips)."""
        repl, shard = {}, {}
        for path, leaf in leaf_paths(params):
            spec = _get(self.specs, path)
            if spec is None:
                _set(repl, path, leaf)
            else:
                _set(shard, path, slice_dim(leaf, spec, self.tp, index))
        return repl, shard

    split_row = split_local

    # -- flat packing ------------------------------------------------------------

    def gather_params(self, stacked) -> dict:
        """Inverse of :meth:`stack_flat`: [tp, >= n_local] shard rows -> the
        dense params tree (numpy), the replicated leaves from shard 0 and
        the sharded slices concatenated. Host numpy only."""
        shards = [self.unravel_local(np.asarray(row[: self.n_local])) for row in stacked]
        dense: dict = {}
        for path in self.paths:
            spec = _get(self.specs, path)
            leaves = [np.asarray(_get(s, path)) for s in shards]
            _set(dense, path, leaves[0] if spec is None else np.concatenate(leaves, axis=spec))
        return dense


class ComposedLayout(_RowLayout):
    """Per-(stage, tp shard) flat packing of a model's parameter tree over
    two model axes, JAX's ``ComposedLayout``: ``outer`` pipeline stages
    (``outer_specs``, the pp table's split dims) of ``inner`` tensor shards
    (``inner_specs``, the tp table's). The row of stage ``o`` and shard
    ``i`` is ``o * inner + i`` (JAX's ``P(('pp', 'tp'))`` dim-0 order),
    ``tp`` the product (ZeRO-1's name for the model group's size). The
    surface is :class:`TpLayout`'s."""

    def __init__(self, params: dict, outer_specs: dict, outer: int, inner_specs: dict,
                 inner: int):
        self.outer, self.inner = int(outer), int(inner)
        self.tp = self.outer * self.inner
        self.outer_specs, self.inner_specs = outer_specs, inner_specs
        self.paths = [path for path, _ in leaf_paths(params)]
        for path, leaf in leaf_paths(params):
            o, i = _get(outer_specs, path), _get(inner_specs, path)
            shape = list(leaf.shape)
            if o is not None:
                if shape[o] % self.outer:
                    raise ValueError(f"pp={self.outer} does not divide dim {o} of {path} "
                                     f"with shape {tuple(shape)}")
                shape[o] //= self.outer
            if i is not None and shape[i] % self.inner:
                raise ValueError(
                    f"tp={self.inner} does not divide dim {i} of the stage's slice of {path}, "
                    f"shape {tuple(shape)}: pad the vocab to a multiple of pp x tp "
                    "(parallel/tp.pad_vocab with pp * tp)")
        shapes = _tree_of([(path, Leaf(leaf.shape)) for path, leaf in leaf_paths(params)])
        self.layout = []  # (path, local shape, offset) in segment order
        offset, ends = 0, []
        for seg in self.split_local(shapes, 0, 0):
            for path, leaf in leaf_paths(seg):
                self.layout.append((path, leaf.shape, offset))
                offset += _numel(leaf.shape)
            ends.append(offset)
        self.n_repl_both, self.n_repl, self.n_local = ends

    def spec(self, path: str) -> tuple:
        """``(outer dim, inner dim)`` of the leaf at ``path`` (None: not split)."""
        return _get(self.outer_specs, path), _get(self.inner_specs, path)

    def slice_leaf(self, path: str, leaf, index: int):
        """Row ``index``'s (``o * inner + i``) part of the dense leaf at ``path``."""
        o, i = self.spec(path)
        oidx, iidx = divmod(index, self.inner)
        if o is not None:
            leaf = slice_dim(leaf, o, self.outer, oidx)
        return leaf if i is None else slice_dim(leaf, i, self.inner, iidx)

    def split_local(self, params: dict, oidx: int, iidx: int) -> tuple:
        """``(both, outer_only, inner)`` subtrees of stage ``oidx``'s shard
        ``iidx``: the leaves replicated on both axes, the stage slices of
        the tp-replicated leaves, the (stage then) shard slices of the
        tp-split leaves."""
        segs = ({}, {}, {})
        for path, leaf in leaf_paths(params):
            o, i = self.spec(path)
            seg = 0 if o is None and i is None else 1 if i is None else 2
            _set(segs[seg], path, self.slice_leaf(path, leaf, oidx * self.inner + iidx))
        return segs

    def split_row(self, params: dict, index: int) -> tuple:
        return self.split_local(params, *divmod(index, self.inner))

    def gather_params(self, stacked) -> dict:
        """Inverse of :meth:`stack_flat`: [pp * tp, >= n_local] rows -> the
        dense params tree (numpy): each leaf's inner slices joined, then
        its stages. Host numpy only."""
        shards = [self.unravel_local(np.asarray(row[: self.n_local])) for row in stacked]
        dense: dict = {}
        for path in self.paths:
            o, i = self.spec(path)
            stages = []
            for oidx in range(self.outer):
                parts = [np.asarray(_get(shards[oidx * self.inner + k], path))
                         for k in range(self.inner)]
                stages.append(parts[0] if i is None else np.concatenate(parts, axis=i))
            _set(dense, path, stages[0] if o is None else np.concatenate(stages, axis=o))
        return dense


def _tree_of(items) -> dict:
    tree: dict = {}
    for path, leaf in items:
        _set(tree, path, leaf)
    return tree
