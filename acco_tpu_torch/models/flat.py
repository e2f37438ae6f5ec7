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


class FlatParamModel(nn.Module):
    """Parameters for ``layout``: a top-level leaf ``p`` is the attribute
    :meth:`attr_name` ``(p)``, and a leaf ``layers/x`` is ``layers[i].x``."""

    def __init__(self, layout, num_layers: int, dtype, device):
        super().__init__()
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

    def init_flat(self, generator: torch.Generator) -> torch.Tensor:
        """A fresh flat parameter vector: each leaf at its ``init_fill``
        constant, else normal(0, initializer_range) (the JAX init's
        distributions; the random draws differ)."""
        device = next(self.parameters()).device
        flat = torch.empty(self.n_params, dtype=self.dtype, device=device)
        for path, shape, offset in self.layout:
            n = int(torch.Size(shape).numel())
            fill = self.init_fill(path)
            if fill is None:
                flat[offset : offset + n] = normal_init(
                    (n,), self.config.initializer_range, self.dtype, generator, device
                )
            else:
                flat[offset : offset + n] = fill
        return flat
