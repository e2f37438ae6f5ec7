"""AdamW on a flat float32 shard, torch semantics, mask-aware.

Counterpart of ``acco_tpu/ops/adamw.py`` (plain tensor code there too, so
no kernel is owed):

    t   <- t + 1
    mu  <- b1*mu + (1-b1)*g
    nu  <- b2*nu + (1-b2)*g^2
    p   <- p - lr*wd*p - lr * (mu/(1-b1^t)) / (sqrt(nu/(1-b2^t)) + eps)

``pad_mask`` zeroes gradient, update and decay on the padded tail of the
flat vector. The update is functional: it returns new tensors and leaves
the old state intact, since a speculative ACCO round keeps the old state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    params: torch.Tensor  # [S] float32 master copy
    mu: torch.Tensor  # [S] float32
    nu: torch.Tensor  # [S] float32
    count: torch.Tensor  # scalar int32, torch's 'step'


def init_adamw_state(param_shard: torch.Tensor) -> AdamWState:
    p = param_shard.float().clone()
    return AdamWState(
        params=p,
        mu=torch.zeros_like(p),
        nu=torch.zeros_like(p),
        count=torch.zeros((), dtype=torch.int32, device=p.device),
    )


def adamw_shard_update(
    state: AdamWState,
    grad_shard: torch.Tensor,  # [S] float32, already averaged
    lr: torch.Tensor,  # float32 scalar tensor
    weight_decay: float,
    beta1: float,
    beta2: float,
    eps: float = 1e-8,
    pad_mask: Optional[torch.Tensor] = None,  # [S] 1.0 = real, 0.0 = padding
) -> AdamWState:
    g = grad_shard.float()
    if pad_mask is not None:
        g = g * pad_mask
    count = state.count + 1
    mu = beta1 * state.mu + (1.0 - beta1) * g
    nu = beta2 * state.nu + (1.0 - beta2) * g.square()
    t = count.float()
    mu_hat = mu / (1.0 - beta1**t)
    nu_hat = nu / (1.0 - beta2**t)
    update = lr * mu_hat / (nu_hat.sqrt() + eps)
    decay = lr * weight_decay * state.params
    if pad_mask is not None:
        update = update * pad_mask
        decay = decay * pad_mask
    params = state.params - decay - update
    return AdamWState(params=params, mu=mu, nu=nu, count=count)
