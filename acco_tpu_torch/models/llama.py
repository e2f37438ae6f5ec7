"""Llama-family causal LM (RMSNorm, RoPE, SwiGLU, GQA, tied head).

Counterpart of ``acco_tpu/models/llama.py`` for the training path. The
parameters are ``nn.Parameter`` views into one flat vector whose order
and per-leaf layout equal JAX's ``ravel_pytree`` over
``LlamaModel.init``: dict keys sorted at every level, and every layer
leaf stacked as ``[num_layers, ...]`` (so ``flat_params``, gradients and
optimizer state compare elementwise with the JAX train state). Each layer
owns its slice of a stacked leaf as a separate parameter, so autograd
hands back per-layer gradients that :meth:`LlamaModel.gather_grads`
copies into a flat gradient without any [num_layers, ...] scatter.

The batch is const-len in pretraining, so callers pass no attention mask
and the mask is dropped statically, as the JAX flat loss does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from acco_tpu_torch.models.layers import (
    apply_rope,
    merge_heads,
    normal_init,
    rms_norm,
    rope_angles,
    split_heads,
)
from acco_tpu_torch.ops.attention import (
    attention_mask_bias,
    dot_product_attention,
    resolve_attention_impl,
)
from acco_tpu_torch.ops.fused_attention import fused_dot_product_attention

LAYER_LEAVES = (
    "attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv",
)  # sorted, as ravel_pytree orders them


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 2048
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12
    max_position_embeddings: int = 1024
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    bos_token_id: int = 50256
    eos_token_id: int = 50256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields and v is not None})


def param_layout(cfg: LlamaConfig) -> list[tuple[str, tuple, int]]:
    """``(path, shape, offset)`` per leaf of the JAX params pytree, in
    ``ravel_pytree`` order; ``path`` joins nested keys with '/'."""
    D, Fd, N = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Dkv = cfg.num_kv_heads * cfg.head_dim
    layer = {
        "attn_norm": (N, D), "mlp_norm": (N, D),
        "wq": (N, D, D), "wk": (N, D, Dkv), "wv": (N, D, Dkv), "wo": (N, D, D),
        "w_gate": (N, D, Fd), "w_up": (N, D, Fd), "w_down": (N, Fd, D),
    }
    tree = {"wte": (cfg.vocab_size, D), "final_norm": (D,), "layers": layer}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = (D, cfg.vocab_size)
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


class LlamaBlock(nn.Module):
    """One transformer block's parameters (a slice of each stacked leaf)."""

    def __init__(self, shapes: dict, dtype, device):
        super().__init__()
        for name in LAYER_LEAVES:
            setattr(self, name, nn.Parameter(
                torch.empty(shapes[name], dtype=dtype, device=device)
            ))


class LlamaModel(nn.Module):
    def __init__(
        self,
        config: LlamaConfig,
        dtype=torch.bfloat16,
        attention: str = "auto",
        device="cpu",
    ):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.attention = attention
        self.layout = param_layout(config)
        self.n_params = sum(int(torch.Size(s).numel()) for _, s, _ in self.layout)
        shapes = {path: shape for path, shape, _ in self.layout}
        empty = lambda shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=dtype, device=device)
        )
        self.wte = empty(shapes["wte"])
        self.final_norm = empty(shapes["final_norm"])
        if not config.tie_word_embeddings:
            self.lm_head_weight = empty(shapes["lm_head"])
        layer_shapes = {n: shapes[f"layers/{n}"][1:] for n in LAYER_LEAVES}
        self.layers = nn.ModuleList(
            LlamaBlock(layer_shapes, dtype, device) for _ in range(config.num_layers)
        )

    # -- the flat view ----------------------------------------------------

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
                param = self.lm_head_weight if path == "lm_head" else getattr(self, path)
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
        """A fresh flat parameter vector: normal(0, initializer_range) for
        matrices and embeddings, ones for norm scales (the JAX init's
        distributions; the random draws differ)."""
        cfg = self.config
        device = self.wte.device
        flat = torch.empty(self.n_params, dtype=self.dtype, device=device)
        for path, shape, offset in self.layout:
            n = int(torch.Size(shape).numel())
            if path.endswith("norm"):
                flat[offset : offset + n] = 1
            else:
                flat[offset : offset + n] = normal_init(
                    (n,), cfg.initializer_range, self.dtype, generator, device
                )
        return flat

    # -- forward ------------------------------------------------------------

    def lm_head(self) -> torch.Tensor:
        """[D, V] output projection (wte transposed when tied)."""
        if self.config.tie_word_embeddings:
            return self.wte.t()
        return self.lm_head_weight

    def apply(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, V] float32 logits. The head's product runs in the
        activation dtype and is then widened (the JAX version asks XLA
        for float32 output directly)."""
        return torch.matmul(self.hidden(input_ids, attention_mask), self.lm_head()).float()

    def hidden(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, D] final-norm hidden states in the activation dtype."""
        cfg = self.config
        L = input_ids.shape[1]
        if L > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {L} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        device = input_ids.device
        impl = resolve_attention_impl(self.attention, L, cfg.head_dim, device)
        x = F.embedding(input_ids, self.wte)
        bias = attention_mask_bias(L, 0, attention_mask, device) if impl == "xla" else None
        cos, sin = rope_angles(L, cfg.head_dim, cfg.rope_theta, device)
        eps = cfg.rms_norm_eps
        for blk in self.layers:
            h = rms_norm(x, blk.attn_norm, eps)
            q = split_heads(h @ blk.wq, cfg.num_heads)
            k = split_heads(h @ blk.wk, cfg.num_kv_heads)
            v = split_heads(h @ blk.wv, cfg.num_kv_heads)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            if impl == "fused":
                ctx = fused_dot_product_attention(
                    q.contiguous(), k.contiguous(), v.contiguous(), attention_mask
                )
            else:
                ctx = dot_product_attention(q, k, v, bias)
            x = x + merge_heads(ctx) @ blk.wo
            h = rms_norm(x, blk.mlp_norm, eps)
            x = x + (F.silu(h @ blk.w_gate) * (h @ blk.w_up)) @ blk.w_down
        return rms_norm(x, self.final_norm, eps)
