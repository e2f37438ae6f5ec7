"""Llama-family causal LM (RMSNorm, RoPE, SwiGLU, GQA, tied or untied head).

Counterpart of ``acco_tpu/models/llama.py`` for the training path. The
parameters are ``nn.Parameter`` views into one flat vector in the order
of JAX's ``ravel_pytree`` over ``LlamaModel.init`` (``models/flat.py``).

The batch is const-len in pretraining, so callers pass no attention mask
and the mask is dropped statically, as the JAX flat loss does.

Context parallelism (``attention='ring'`` with a ``sequence_group``):
the input is this rank's chunk of the sequence, RoPE takes the chunk's
absolute positions (contiguous: rank * chunk length on; zig-zag:
``zigzag_positions``), the position check is on the global length, and
every layer runs the ring (``ops/ring_attention.py``). Pad masks are
refused: the ring serves const-len packed sequences.

``remat`` (False | True | 'dots' | 'dots+probs') runs each layer, the
context-parallel one included, through ``layers.wrap_remat`` (JAX:
llama.py:300-304, :562-567) and moves 'auto''s flash threshold
(``ops.attention.resolve_attention_impl``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
from torch.nn import functional as F

from acco_tpu_torch.models.flat import FlatParamModel, sorted_layout
from acco_tpu_torch.models.layers import (
    apply_rope,
    lm_logits,
    merge_heads,
    rms_norm,
    rope_angles,
    split_heads,
    wrap_remat,
)
from acco_tpu_torch.ops.attention import (
    attention_mask_bias,
    dot_product_attention,
    normalize_attention_impl,
    normalize_remat,
    resolve_attention_impl,
)
from acco_tpu_torch.ops.flash_attention import flash_dot_product_attention
from acco_tpu_torch.ops.fused_attention import fused_dot_product_attention
from acco_tpu_torch.ops.ring_attention import (
    SequenceGroup,
    ring_attention,
    zigzag_positions,
    zigzag_ring_attention,
)


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
    return sorted_layout(tree)


class LlamaModel(FlatParamModel):
    def __init__(
        self,
        config: LlamaConfig,
        dtype=torch.bfloat16,
        attention: str = "auto",
        device="cpu",
        sequence_group: Optional[SequenceGroup] = None,
        zigzag: bool = False,
        remat=False,
    ):
        if (normalize_attention_impl(attention) == "ring") != (sequence_group is not None):
            raise ValueError("attention='ring' requires a sequence group, and a sequence "
                             "group attention='ring'")
        super().__init__(param_layout(config), config.num_layers, dtype, device)
        self.config = config
        self.attention = attention
        self.sequence_group = sequence_group
        self.zigzag = bool(zigzag)
        self.remat = normalize_remat(remat)

    @staticmethod
    def attr_name(path: str) -> str:
        return "lm_head_weight" if path == "lm_head" else path  # lm_head is a method

    @staticmethod
    def init_fill(path: str):
        """Ones for the norm scales; every other leaf is drawn."""
        return 1.0 if path.endswith("norm") else None

    # -- forward ------------------------------------------------------------

    def lm_head(self) -> torch.Tensor:
        """[D, V] output projection (wte transposed when tied)."""
        if self.config.tie_word_embeddings:
            return self.wte.t()
        return self.lm_head_weight

    def apply(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, V] float32 logits, accumulated in float32 from the
        activation-dtype head product (``layers.lm_logits``), as the JAX
        version's ``preferred_element_type=jnp.float32`` einsum."""
        return lm_logits(self.hidden(input_ids, attention_mask), self.lm_head())

    def hidden(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, D] final-norm hidden states in the activation dtype."""
        cfg = self.config
        L = input_ids.shape[1]  # ring: this rank's chunk length
        device = input_ids.device
        impl = resolve_attention_impl(self.attention, L, cfg.head_dim, device, self.remat)
        sg = self.sequence_group
        global_len = L
        if impl == "ring":
            if attention_mask is not None:
                raise ValueError(
                    "attention='ring' does not support padding masks — it serves "
                    "const-len packed sequences; pass attention_mask=None"
                )
            global_len = sg.size * L
        if global_len > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {global_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        x = F.embedding(input_ids, self.wte)
        bias = attention_mask_bias(L, 0, attention_mask, device) if impl == "xla" else None
        if impl == "ring" and self.zigzag:
            positions = zigzag_positions(global_len, sg.size, sg.rank, device)
            cos, sin = rope_angles(L, cfg.head_dim, cfg.rope_theta, device, positions=positions)
        else:
            offset = sg.rank * L if impl == "ring" else 0
            cos, sin = rope_angles(L, cfg.head_dim, cfg.rope_theta, device, offset=offset)
        layer = wrap_remat(self._layer, self.remat)
        for blk in self.layers:
            x = layer(x, blk, cos, sin, attention_mask, bias, impl)
        return rms_norm(x, self.final_norm, cfg.rms_norm_eps)

    def _layer(self, x, blk, cos, sin, attention_mask, bias, impl: str) -> torch.Tensor:
        """One decoder layer: attention, then the SwiGLU MLP."""
        cfg = self.config
        eps = cfg.rms_norm_eps
        h = rms_norm(x, blk.attn_norm, eps)
        q = split_heads(h @ blk.wq, cfg.num_heads)
        k = split_heads(h @ blk.wk, cfg.num_kv_heads)
        v = split_heads(h @ blk.wv, cfg.num_kv_heads)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if impl == "fused":
            ctx = fused_dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), attention_mask
            )
        elif impl == "flash":  # the pad mask as segment ids (JAX's flash path)
            ctx = flash_dot_product_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), attention_mask
            )
        elif impl == "ring":
            ring = zigzag_ring_attention if self.zigzag else ring_attention
            ctx = ring(q, k, v, self.sequence_group)
        else:
            ctx = dot_product_attention(q, k, v, bias)
        x = x + merge_heads(ctx) @ blk.wo
        h = rms_norm(x, blk.mlp_norm, eps)
        return x + (F.silu(h @ blk.w_gate) * (h @ blk.w_up)) @ blk.w_down
