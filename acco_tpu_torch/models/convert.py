"""Carry Llama weights between the JAX package and the port.

``params_from_jax`` takes the JAX ``LlamaModel``'s params pytree (nested
dict of numpy arrays) and returns the port's flat vector, in the same
order and layout as JAX's ``ravel_pytree``. :func:`params_to_jax` is its
inverse. Neither imports JAX: the pytree arrives as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from acco_tpu_torch.models.llama import LlamaConfig, param_layout


def _leaf(tree: dict, path: str):
    node = tree
    for key in path.split("/"):
        node = node[key]
    return node


def params_from_jax(tree: dict, config: LlamaConfig) -> torch.Tensor:
    """Flat [n_params] float32 tensor from a JAX Llama params pytree;
    ``LlamaModel.load_flat`` then makes it the module's parameters."""
    parts = []
    for path, shape, _ in param_layout(config):
        arr = np.asarray(_leaf(tree, path), dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {tuple(shape)}")
        parts.append(arr.reshape(-1))
    return torch.from_numpy(np.concatenate(parts))


def params_to_jax(flat: torch.Tensor, config: LlamaConfig) -> dict:
    """Nested dict of float32 numpy arrays, the JAX params pytree's shape."""
    flat = flat.detach().float().cpu().numpy()
    tree: dict = {}
    for path, shape, offset in param_layout(config):
        n = int(np.prod(shape))
        node = tree
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = flat[offset : offset + n].reshape(shape).copy()
    return tree
