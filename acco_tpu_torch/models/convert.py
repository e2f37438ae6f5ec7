"""Carry model weights between the JAX package and the port.

``params_from_jax`` takes a JAX ``LlamaModel``'s or ``GPTNeoModel``'s
params pytree (nested dict of numpy arrays) and returns the port's flat
vector, in the same order and layout as JAX's ``ravel_pytree``; the
config's type picks the family. :func:`params_to_jax` is its inverse.
Neither imports JAX: the pytree arrives as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from acco_tpu_torch.models import gpt_neo, llama


def _layout(config):
    if isinstance(config, llama.LlamaConfig):
        return llama.param_layout(config)
    if isinstance(config, gpt_neo.GPTNeoConfig):
        return gpt_neo.param_layout(config)
    raise TypeError(f"no parameter layout for {type(config).__name__}")


def _leaf(tree: dict, path: str):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def params_from_jax(tree: dict, config) -> torch.Tensor:
    """Flat [n_params] float32 tensor from a JAX params pytree; the
    model's ``load_flat`` then makes it the module's parameters."""
    parts = []
    for path, shape, _ in _layout(config):
        arr = np.asarray(_leaf(tree, path), dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {tuple(shape)}")
        parts.append(arr.reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def params_to_jax(flat: torch.Tensor, config) -> dict:
    """Nested dict of float32 numpy arrays, the JAX params pytree's shape."""
    flat = flat.detach().float().cpu().numpy()
    tree: dict = {}
    for path, shape, offset in _layout(config):
        n = int(np.prod(shape))
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = flat[offset : offset + n].reshape(shape).copy()
    return tree
