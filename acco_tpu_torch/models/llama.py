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

The serving surface (JAX: llama.py:354-452; ``serve/engine.py`` drives
it): :meth:`LlamaModel.kv_spec`, :meth:`LlamaModel.prefill` (the plain
causal forward whatever ``attention`` says, with every layer's post-RoPE
K/V) and :meth:`LlamaModel.decode` (one position per request slot
against the rows gathered from the paged cache,
``ops.attention.cached_attention``).

Tensor parallelism (a ``tensor_group``, JAX's ``tensor_axis``;
llama.py:81-135, :170-230, :284-345): the model holds its tp shard's
parameters (``models/flat.py``, ``parallel/tp.TpLayout``): the
vocab-parallel embedding and head, ``num_heads / tp`` query heads and
``num_kv_heads / tp`` KV heads, ``intermediate_size / tp`` MLP columns,
and one all-reduce after ``wo`` and one after ``w_down``
(``layers.tp_all_reduce``, whose backward is again the sum, as JAX's
``psum`` under ``check_vma=False``). ``apply`` then gives this shard's
[B, L, V/tp] logits, which the vocab-parallel CE reads
(``ops/losses.py``). ``vocab_pad_to`` pads the vocab (Megatron's
padding, ``parallel/tp.pad_vocab``); the padded rows are never looked
up and never enter the loss (``real_vocab``), and :meth:`unpad_vocab`
strips them for export. With a ``sequence_group`` too (tp x sp; JAX
llama.py:253-338) the ring runs this shard's heads; serving under tp is
not ported yet (ROADMAP.md queue 1, item 9.5).

Pipeline parallelism (a ``pipeline_group``, JAX's ``pipeline_axis``;
llama.py:456-575): the model is one stage, ``num_layers / pp``
contiguous layers, the vocab-split embedding (and untied head) and the
replicated final norm (``models/flat.py``). ``parallel/pp.py`` drives
it through :meth:`LlamaModel.pp_embed` (the vocab-parallel lookup over
the pipeline group), :meth:`LlamaModel.stage_blocks` (this stage's
layers, the same math as the span of :meth:`LlamaModel.hidden`) and
:meth:`LlamaModel.finalize` (the final norm); ``hidden`` and ``apply``
refuse a stage, and serving one is item 9.5. A stage takes a tensor
group (tp x pp, with the combined ``model_group``: the stage's layers
run their all-reduces and the lookup and the loss run over the combined
group) and a sequence group (pp x sp: the ring inside the stage).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
from torch.nn import functional as F

from acco_tpu_torch.models.flat import (
    FlatParamModel,
    check_serve,
    check_tp,
    check_whole,
    sorted_layout,
    unpad_vocab_tree,
)
from acco_tpu_torch.models.layers import (
    apply_rope,
    apply_rope_at,
    lm_logits,
    tp_all_reduce,
    vocab_parallel_embed,
    merge_heads,
    rms_norm,
    rope_angles,
    split_heads,
    wrap_remat,
)
from acco_tpu_torch.ops.attention import (
    attention_mask_bias,
    cached_attention,
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


def param_layout(cfg: LlamaConfig, vocab: Optional[int] = None) -> list[tuple[str, tuple, int]]:
    """``(path, shape, offset)`` per leaf of the JAX params pytree, in
    ``ravel_pytree`` order; ``path`` joins nested keys with '/'. ``vocab``:
    the (padded) vocab rows of the embedding and head (default the
    config's)."""
    V = cfg.vocab_size if vocab is None else int(vocab)
    D, Fd, N = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Dkv = cfg.num_kv_heads * cfg.head_dim
    layer = {
        "attn_norm": (N, D), "mlp_norm": (N, D),
        "wq": (N, D, D), "wk": (N, D, Dkv), "wv": (N, D, Dkv), "wo": (N, D, D),
        "w_gate": (N, D, Fd), "w_up": (N, D, Fd), "w_down": (N, Fd, D),
    }
    tree = {"wte": (V, D), "final_norm": (D,), "layers": layer}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = (D, V)
    return sorted_layout(tree)


class LlamaModel(FlatParamModel):
    family = "llama"

    def __init__(
        self,
        config: LlamaConfig,
        dtype=torch.bfloat16,
        attention: str = "auto",
        device="cpu",
        sequence_group: Optional[SequenceGroup] = None,
        zigzag: bool = False,
        remat=False,
        tensor_group=None,
        vocab_pad_to: Optional[int] = None,
        pipeline_group=None,
        model_group=None,
    ):
        if (normalize_attention_impl(attention) == "ring") != (sequence_group is not None):
            raise ValueError("attention='ring' requires a sequence group, and a sequence "
                             "group attention='ring'")
        padded = check_tp(config, tensor_group, vocab_pad_to,
                          (config.num_heads, config.num_kv_heads), pipeline_group)
        super().__init__(param_layout(config, padded), config.num_layers, dtype, device,
                         tensor_group, pipeline_group, model_group)
        self.config = config
        self.padded_vocab = padded
        self.n_heads = config.num_heads // self.tp
        self.n_kv_heads = config.num_kv_heads // self.tp
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
        check_whole(self)
        return self.finalize(self.stage_blocks(self.embed(input_ids), attention_mask))

    def stage_blocks(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                     stage_index: Optional[int] = None) -> torch.Tensor:
        """The layers this model holds over [B, L, D] hidden states: every
        layer, or one pipeline stage's (JAX: ``stage_blocks``). Llama's
        layers are position-uniform, so ``stage_index`` (GPT-Neo's window
        offset) is not read."""
        cfg = self.config
        L = x.shape[1]  # ring: this rank's chunk length
        device = x.device
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
        return x

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm over the last layer's hidden states."""
        return rms_norm(x, self.final_norm, self.config.rms_norm_eps)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embedding; vocab-parallel under a tensor or pipeline group."""
        if self.model_group is None:
            return F.embedding(input_ids, self.wte)
        return vocab_parallel_embed(self.wte, input_ids, self.model_group)

    # a pipeline's token embeddings (JAX: ``pp_embed``): the vocab-split
    # lookup, summed over the pipeline group
    pp_embed = embed

    def unpad_vocab(self, params: dict) -> dict:
        """The dense params tree without the Megatron vocab padding (for
        ``params.npz`` and HF export): the plain config's shapes."""
        return unpad_vocab_tree(params, self.config.vocab_size, self.padded_vocab)

    def _layer(self, x, blk, cos, sin, attention_mask, bias, impl: str) -> torch.Tensor:
        """One decoder layer: attention, then the SwiGLU MLP."""
        q, k, v = self._qkv(x, blk, cos, sin)
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
        return self._out(x, blk, ctx)

    def _qkv(self, x, blk, cos, sin, rope=apply_rope):
        """The layer's post-RoPE q, k, v in [B, H(kv), L, D]."""
        cfg = self.config
        h = rms_norm(x, blk.attn_norm, cfg.rms_norm_eps)
        q = split_heads(h @ blk.wq, self.n_heads)
        k = split_heads(h @ blk.wk, self.n_kv_heads)
        v = split_heads(h @ blk.wv, self.n_kv_heads)
        return rope(q, cos, sin), rope(k, cos, sin), v

    def _out(self, x, blk, ctx) -> torch.Tensor:
        """The layer after its attention: the output projection, the MLP."""
        tg = self.tensor_group
        x = x + tp_all_reduce(merge_heads(ctx) @ blk.wo, tg)
        h = rms_norm(x, blk.mlp_norm, self.config.rms_norm_eps)
        return x + tp_all_reduce((F.silu(h @ blk.w_gate) * (h @ blk.w_up)) @ blk.w_down, tg)

    # -- serving surface (serve/) ------------------------------------------

    def kv_spec(self) -> tuple[int, int, int]:
        """(n_layers, n_kv_heads, head_dim): the per-token KV-cache row
        shape the paged pool allocates (``serve/kv_cache.CacheSpec``)."""
        cfg = self.config
        return cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def _check_serve(self) -> None:
        check_serve(self)

    def prefill(self, input_ids: torch.Tensor):
        """Serving prefill: the plain causal forward (whatever
        ``attention`` says, so the committed cache rows are what decode's
        plain attention replays) that also returns every layer's post-RoPE
        K/V. Right-padded prompts need no mask: pad positions cannot reach
        real ones, and their cache rows stay masked by decode's strict
        ``kv_pos < q_pos`` until overwritten.

        Returns ``(logits [B, L, V] float32, k, v [n_layers, B, L, Hkv, D])``.
        """
        cfg = self.config
        self._check_serve()
        L = input_ids.shape[1]
        if L > cfg.max_position_embeddings:
            raise ValueError(
                f"prefill length {L} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        device = input_ids.device
        x = F.embedding(input_ids, self.wte)
        bias = attention_mask_bias(L, 0, None, device)
        cos, sin = rope_angles(L, cfg.head_dim, cfg.rope_theta, device)
        ks, vs = [], []
        for blk in self.layers:
            q, k, v = self._qkv(x, blk, cos, sin)
            x = self._out(x, blk, dot_product_attention(q, k, v, bias))
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return lm_logits(x, self.lm_head()), torch.stack(ks), torch.stack(vs)

    def decode(
        self,
        token_ids: torch.Tensor,  # [R] one token per request slot
        positions: torch.Tensor,  # [R] absolute position being decoded
        k_ctx: torch.Tensor,  # [n_layers, R, C, Hkv, D] gathered cache rows
        v_ctx: torch.Tensor,
        kv_positions: torch.Tensor,  # [C] or [R, C] absolute row positions
    ):
        """One continuous-batching decode step over the gathered paged
        cache: each slot attends its own context rows (strict ``kv_pos <
        q_pos``) plus the current token, and emits this position's K/V for
        the write-back.

        Returns ``(logits [R, V] float32, k_new, v_new [n_layers, R, Hkv, D])``.
        """
        cfg = self.config
        self._check_serve()
        x = F.embedding(token_ids, self.wte)[:, None, :]  # [R, 1, D]
        cos, sin = rope_angles(1, cfg.head_dim, cfg.rope_theta, token_ids.device,
                               positions=positions)  # [R, D/2] per-slot angles
        k_new, v_new = [], []
        for blk, kc, vc in zip(self.layers, k_ctx, v_ctx):
            q, k, v = self._qkv(x, blk, cos, sin, rope=apply_rope_at)
            ctx = cached_attention(q, kc, vc, k, v, positions, kv_positions)
            x = self._out(x, blk, ctx)
            k_new.append(k[:, :, 0])
            v_new.append(v[:, :, 0])
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        return lm_logits(x, self.lm_head())[:, 0], torch.stack(k_new), torch.stack(v_new)

