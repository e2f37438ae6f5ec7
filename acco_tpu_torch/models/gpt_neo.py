"""GPT-Neo causal LM: alternating global / local sliding-window attention.

Counterpart of ``acco_tpu/models/gpt_neo.py`` for the training path:
learned position embeddings, LayerNorm with biases, ``gelu_new``, a fused
qkv projection stored ``[N, D, 3, D]``, **unscaled** attention scores
(GPT-Neo's quirk, ``scale=1.0``) and the tied head. The parameters are
``nn.Parameter`` views into one flat vector in the order of JAX's
``ravel_pytree`` over ``GPTNeoModel.init`` (``models/flat.py``).

Attention dispatch, as the JAX ``_dense_attn_plan`` and ``_block_body``:

- 'fused', no pad mask, and the local window inside
  ``supports_banded_attention``: global layers run K1
  (``fused_dot_product_attention``, window 0) and local layers K2
  (``banded_dot_product_attention``, window W);
- 'fused' otherwise (a pad mask, from ``const_len_batch=false``): every
  layer runs K1 with its own window and the mask;
- 'xla': the plain path, with the per-layer window's additive bias.

Context parallelism (a ``sequence_group``), as the JAX ``_cp_positions``:
the input is this rank's chunk, the learned positions are looked up at
the chunk's absolute positions (contiguous or zig-zag), and every layer
runs ``windowed_ring_attention`` with its window (0 or W), whose blocks
are K4's positional variant on the card.

``remat`` runs each layer, the context-parallel one included, through
``layers.wrap_remat`` (JAX: gpt_neo.py:305-317, :737-746).

``attention='auto'`` resolves as for Llama (``ops/attention.py``): K1's
envelope on the card, the plain path on the CPU. The JAX package has one
more plan, banded local layers beside einsum global layers, which it takes
only where 'auto' does not pick its full-tile kernel (L past its VMEM
wall). K1 here has no L cap and takes every shape K2 takes, so on the card
that plan is never chosen and is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
from torch.nn import functional as F

from acco_tpu_torch.models.flat import FlatParamModel, sorted_layout
from acco_tpu_torch.models.layers import (
    gelu_new,
    layer_norm,
    lm_logits,
    merge_heads,
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
from acco_tpu_torch.ops.banded_attention import (
    banded_dot_product_attention,
    supports_banded_attention,
)
from acco_tpu_torch.ops.fused_attention import fused_dot_product_attention
from acco_tpu_torch.ops.ring_attention import (
    SequenceGroup,
    windowed_ring_attention,
    zigzag_positions,
)


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    window_size: int = 256
    attention_layers: tuple = ("global", "local") * 6
    activation_function: str = "gelu_new"
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    bos_token_id: int = 50256
    eos_token_id: int = 50256

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def layer_windows(self) -> list[int]:
        """Per-layer window sizes; 0 = global."""
        if len(self.attention_layers) != self.num_layers:
            raise ValueError(
                f"attention_layers has {len(self.attention_layers)} entries "
                f"for {self.num_layers} layers"
            )
        return [0 if kind == "global" else self.window_size for kind in self.attention_layers]

    @classmethod
    def from_json(cls, path: str) -> "GPTNeoConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        if kwargs.get("intermediate_size", "keep") is None:
            kwargs.pop("intermediate_size")
        if "attention_layers" in kwargs:
            kwargs["attention_layers"] = tuple(kwargs["attention_layers"])
        return cls(**kwargs)


def param_layout(cfg: GPTNeoConfig) -> list[tuple[str, tuple, int]]:
    """``(path, shape, offset)`` per leaf of the JAX params pytree, in
    ``ravel_pytree`` order; ``path`` joins nested keys with '/'."""
    D, Fd, N = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers
    layer = {
        "ln1_scale": (N, D), "ln1_bias": (N, D),
        "w_qkv": (N, D, 3, D), "wo": (N, D, D), "wo_bias": (N, D),
        "ln2_scale": (N, D), "ln2_bias": (N, D),
        "w_fc": (N, D, Fd), "b_fc": (N, Fd), "w_proj": (N, Fd, D), "b_proj": (N, D),
    }
    return sorted_layout({
        "wte": (cfg.vocab_size, D),
        "wpe": (cfg.max_position_embeddings, D),
        "layers": layer,
        "lnf_scale": (D,),
        "lnf_bias": (D,),
    })


class GPTNeoModel(FlatParamModel):
    def __init__(
        self,
        config: GPTNeoConfig,
        dtype=torch.bfloat16,
        attention: str = "auto",
        device="cpu",
        sequence_group: Optional[SequenceGroup] = None,
        zigzag: bool = False,
        tensor_axis: Optional[str] = None,
        vocab_pad_to: Optional[int] = None,
        remat=False,
    ):
        for value, what in (
            (tensor_axis, "tensor_axis (tensor parallelism)"),
            (vocab_pad_to, "vocab_pad_to (Megatron vocab padding)"),
        ):
            if value:
                raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1, item 9")
        impl = normalize_attention_impl(attention)
        if impl == "ring" and sequence_group is None:
            raise ValueError("attention='ring' requires a sequence group")
        if impl == "flash":
            raise ValueError(
                "GPT-Neo's local sliding-window layers do not run the flash "
                "kernel (as in the JAX model): use attention='fused', 'xla' "
                "or 'auto'"
            )
        super().__init__(param_layout(config), config.num_layers, dtype, device)
        self.config = config
        self.attention = attention
        self.sequence_group = sequence_group
        self.zigzag = bool(zigzag)
        self.remat = normalize_remat(remat)

    @staticmethod
    def init_fill(path: str):
        """Ones for the LayerNorm scales, zeros for every bias; the
        embeddings and projection matrices are drawn."""
        if path.endswith("_scale"):
            return 1.0
        if path.endswith("bias") or path in ("layers/b_fc", "layers/b_proj"):
            return 0.0
        return None

    # -- forward ------------------------------------------------------------

    def lm_head(self) -> torch.Tensor:
        """[D, V] output projection: the tied ``wte`` transposed (a view)."""
        return self.wte.t()

    def apply(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, V] float32 logits through the tied head
        (``layers.lm_logits``)."""
        return lm_logits(self.hidden(input_ids, attention_mask), self.lm_head())

    def _attention_fn(self, L: int, attention_mask, device):
        """``attend(q, k, v, window) -> [B, H, L, D]`` for this forward."""
        cfg = self.config
        impl = resolve_attention_impl(self.attention, L, cfg.head_dim, device, self.remat)
        if impl == "xla":
            biases = {
                w: attention_mask_bias(L, w, attention_mask, device)
                for w in set(cfg.layer_windows)
            }
            return lambda q, k, v, w: dot_product_attention(q, k, v, biases[w], scale=1.0)
        if attention_mask is None and supports_banded_attention(L, cfg.head_dim, cfg.window_size):

            def attend(q, k, v, w):
                q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
                if w == 0:
                    return fused_dot_product_attention(q, k, v, window=0, scale=1.0)
                return banded_dot_product_attention(q, k, v, window=w, scale=1.0)

            return attend
        return lambda q, k, v, w: fused_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), attention_mask, window=w, scale=1.0
        )

    def _cp_plan(self, L: int, attention_mask):
        """Under context parallelism: this rank's absolute positions (a host
        tensor) and ``attend(q, k, v, window)`` through the windowed ring;
        outside it, (None, None). Refuses pad masks."""
        sg = self.sequence_group
        if sg is None:
            return None, None
        if attention_mask is not None:
            raise ValueError(
                "context parallelism does not support padding masks — it serves "
                "const-len packed sequences; pass attention_mask=None"
            )
        if self.zigzag:
            global_len = sg.size * L

            def kv_positions(src):
                return zigzag_positions(global_len, sg.size, src)
        else:

            def kv_positions(src):
                return src * L + torch.arange(L)

        positions = kv_positions(sg.rank)

        def attend(q, k, v, window):
            return windowed_ring_attention(q, k, v, sg, window, positions, kv_positions, scale=1.0)

        return positions, attend

    def hidden(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """[B, L, D] final-norm hidden states in the activation dtype."""
        cfg = self.config
        L = input_ids.shape[1]  # CP: this rank's chunk length
        positions, attend = self._cp_plan(L, attention_mask)
        global_len = L if positions is None else self.sequence_group.size * L
        if global_len > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {global_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        if attend is None:
            attend = self._attention_fn(L, attention_mask, input_ids.device)
            wpe = self.wpe[:L]
        else:
            wpe = self.wpe[positions.to(input_ids.device, non_blocking=True)]
        x = F.embedding(input_ids, self.wte) + wpe[None, :, :]
        layer = wrap_remat(self._layer, self.remat)
        for blk, window in zip(self.layers, cfg.layer_windows):
            x = layer(x, blk, attend, window)
        return layer_norm(x, self.lnf_scale, self.lnf_bias, cfg.layer_norm_epsilon)

    def _layer(self, x, blk, attend, window: int) -> torch.Tensor:
        """One block: attention with this layer's window, then the MLP."""
        cfg = self.config
        eps, D = cfg.layer_norm_epsilon, cfg.hidden_size
        h = layer_norm(x, blk.ln1_scale, blk.ln1_bias, eps)
        q, k, v = (h @ blk.w_qkv.reshape(D, 3 * D)).split(D, dim=-1)
        ctx = attend(
            split_heads(q, cfg.num_heads), split_heads(k, cfg.num_heads),
            split_heads(v, cfg.num_heads), window,
        )
        x = x + merge_heads(ctx) @ blk.wo + blk.wo_bias
        h = layer_norm(x, blk.ln2_scale, blk.ln2_bias, eps)
        return x + gelu_new(h @ blk.w_fc + blk.b_fc) @ blk.w_proj + blk.b_proj
