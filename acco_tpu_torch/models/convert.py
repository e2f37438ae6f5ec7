"""Carry model weights between the JAX package and the port.

``params_from_jax`` takes a JAX ``LlamaModel``'s or ``GPTNeoModel``'s
params pytree (nested dict of numpy arrays) and returns the port's flat
vector, in the same order and layout as JAX's ``ravel_pytree``; the
config's type picks the family. :func:`params_to_jax` is its inverse.
Both take the (Megatron-padded) vocab of the tree, default the config's.

Under tensor parallelism JAX's state is a ``[tp, n_local]`` stack of
per-shard flat vectors (``TpLayout.stack_flat``) and each port rank holds
one row of it: :func:`rank_flat_from_jax` cuts a rank's row from a JAX
params pytree, :func:`dense_from_rank_flats` puts the ranks' rows back
into the dense pytree (the inverse, ``TpLayout.gather_params``). Under
pipeline parallelism the same two carry a stage's local flat vector
(``TpLayout`` over the pp rule table), by pp index. Neither imports JAX:
the pytree arrives as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from acco_tpu_torch.models import gpt_neo, llama


def _layout(config, vocab=None):
    if isinstance(config, llama.LlamaConfig):
        return llama.param_layout(config, vocab)
    if isinstance(config, gpt_neo.GPTNeoConfig):
        return gpt_neo.param_layout(config, vocab)
    raise TypeError(f"no parameter layout for {type(config).__name__}")


def _leaf(tree: dict, path: str):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def params_from_jax(tree: dict, config, vocab=None) -> torch.Tensor:
    """Flat [n_params] float32 tensor from a JAX params pytree; the
    model's ``load_flat`` then makes it the module's parameters."""
    parts = []
    for path, shape, _ in _layout(config, vocab):
        arr = np.asarray(_leaf(tree, path), dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {tuple(shape)}")
        parts.append(arr.reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def params_to_jax(flat: torch.Tensor, config, vocab=None) -> dict:
    """Nested dict of float32 numpy arrays, the JAX params pytree's shape."""
    flat = flat.detach().float().cpu().numpy()
    tree: dict = {}
    for path, shape, offset in _layout(config, vocab):
        n = int(np.prod(shape))
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = flat[offset : offset + n].reshape(shape).copy()
    return tree


def rank_flat_from_jax(tree: dict, model) -> torch.Tensor:
    """This rank's local flat vector (float32) of a tensor- or
    pipeline-parallel ``model`` from a dense JAX params pytree: JAX's
    ``TpLayout.stack_flat`` row for the model's tp (or pp) index."""
    rows = model.tp_layout.stack_flat(tree)
    return torch.from_numpy(np.ascontiguousarray(rows[model.model_group.rank], np.float32))


def dense_from_rank_flats(rows, model) -> dict:
    """The dense params pytree (numpy) from every tp rank's (or stage's)
    local flat vector, in tp (pp) order (JAX's ``TpLayout.gather_params``)."""
    return model.tp_layout.gather_params(
        [np.asarray(torch.as_tensor(r).detach().float().cpu()) for r in rows])
