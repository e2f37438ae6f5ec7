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
class needs nothing more. ``ComposedLayout`` (pp x tp) is not ported yet:
ROADMAP.md queue 1, item 9.4.
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


class TpLayout:
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

    def spec(self, path: str) -> Optional[int]:
        return _get(self.specs, path)

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

    # -- flat packing ------------------------------------------------------------

    def unravel_local(self, flat_local) -> dict:
        """[n_local] flat vector (numpy or torch) -> this shard's local
        params tree (views where the input allows)."""
        tree: dict = {}
        for path, shape, offset in self.layout:
            _set(tree, path, flat_local[offset:offset + _numel(shape)].reshape(shape))
        return tree

    def stack_flat(self, params: dict, pad_to: Optional[int] = None) -> np.ndarray:
        """[tp, n_local (padded to ``pad_to``)] host array of every shard's
        flat vector, in numpy: no device sees a row."""
        host = _tree_of([(path, np.asarray(leaf)) for path, leaf in leaf_paths(params)])
        out = np.stack([host_ravel(self.split_local(host, i)) for i in range(self.tp)])
        if pad_to is not None and pad_to > out.shape[1]:
            out = np.pad(out, ((0, 0), (0, pad_to - out.shape[1])))
        return out

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


def _tree_of(items) -> dict:
    tree: dict = {}
    for path, leaf in items:
        _set(tree, path, leaf)
    return tree
