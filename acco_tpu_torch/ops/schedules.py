"""Learning-rate schedules (the HF ``get_scheduler`` factor curves).

Counterpart of ``acco_tpu/ops/schedules.py``: a schedule maps the
cumulative step counter (an int32 scalar tensor of the train state) to a
float32 scalar tensor, on the counter's device, so the round never reads
the counter back to the host. The step unit is one optimizer update, the
JAX package's default.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def get_schedule(
    name: str, base_lr: float, num_warmup_steps: int, num_training_steps: int
) -> Schedule:
    """'cosine' | 'linear' | 'constant' | 'constant_with_warmup'."""
    name = name.lower()
    warmup = float(max(num_warmup_steps, 0))
    total = float(max(num_training_steps, 1))

    def warmup_factor(step: torch.Tensor) -> torch.Tensor:
        if warmup <= 0:
            return torch.ones_like(step)
        return torch.clamp(step / max(warmup, 1.0), max=1.0)

    if name == "cosine":

        def fn(step: torch.Tensor) -> torch.Tensor:
            step = step.float()
            progress = torch.clamp((step - warmup) / max(total - warmup, 1.0), 0.0, 1.0)
            cos_factor = 0.5 * (1.0 + torch.cos(math.pi * progress))
            return base_lr * torch.where(step < warmup, warmup_factor(step), cos_factor)

    elif name == "linear":

        def fn(step: torch.Tensor) -> torch.Tensor:
            step = step.float()
            decay = torch.clamp((total - step) / max(total - warmup, 1.0), 0.0, 1.0)
            return base_lr * torch.where(step < warmup, warmup_factor(step), decay)

    elif name in ("constant", "constant_with_warmup"):

        def fn(step: torch.Tensor) -> torch.Tensor:
            step = step.float()
            if name == "constant_with_warmup":
                return base_lr * warmup_factor(step)
            return torch.full_like(step, base_lr)

    else:
        raise ValueError(
            f"Unknown scheduler_name {name!r}; supported: cosine, linear, "
            f"constant, constant_with_warmup"
        )
    return fn
