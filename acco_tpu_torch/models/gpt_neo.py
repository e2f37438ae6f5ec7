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

The serving surface (JAX: gpt_neo.py:518-649; ``serve/engine.py``
drives it): :meth:`GPTNeoModel.kv_spec`, :meth:`GPTNeoModel.prefill`
(the plain path with each layer's window bias, whatever ``attention``
says, returning every layer's K/V) and :meth:`GPTNeoModel.decode`, whose
local layers read the narrow band gather when the engine passes one
(the per-layer window is static here: a Python branch, not JAX's
``cond``).

Tensor parallelism (a ``tensor_group``, JAX gpt_neo.py:111-185,
:222-303), as for Llama: the vocab-parallel ``wte``, ``num_heads / tp``
heads from the local third of each of ``w_qkv``'s q, k and v (dim 3),
``w_fc`` and ``b_fc`` split on the ffn dim, and one all-reduce after
``wo`` and one after ``w_proj``, with ``wo_bias`` and ``b_proj`` added
after them; ``wpe``, the norms and the output biases stay replicated.
``vocab_pad_to`` pads ``wte``'s rows (``models/llama.py``).

Pipeline parallelism (a ``pipeline_group``, JAX gpt_neo.py:653-760): the
model is one stage, ``num_layers / pp`` contiguous layers, the
vocab-split ``wte`` and the replicated ``wpe`` and final norm.
:meth:`GPTNeoModel.pp_embed` is the vocab-parallel lookup plus the
learned positions, :meth:`GPTNeoModel.stage_blocks` runs the stage's
layers with their windows cut from the whole ``layer_windows`` table at
``stage_index * layers_per_stage`` (the global/local pattern is indexed
by the absolute layer), :meth:`GPTNeoModel.finalize` the final norm.

The compositions (JAX gpt_neo.py:274-276, :666-700): with a tensor and
a sequence group the windowed ring runs this shard's heads; a stage on a
tensor group (tp x pp, with the combined ``model_group``) runs its
layers' all-reduces and looks its tokens up over the combined group; a
stage on a sequence group (pp x sp) runs the windowed ring with the
learned positions at its chunk's offsets.
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
    gelu_new,
    layer_norm,
    lm_logits,
    merge_heads,
    split_heads,
    tp_all_reduce,
    vocab_parallel_embed,
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
from acco_tpu_torch.utils.platform import device_constant


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


def param_layout(cfg: GPTNeoConfig, vocab: Optional[int] = None) -> list[tuple[str, tuple, int]]:
    """``(path, shape, offset)`` per leaf of the JAX params pytree, in
    ``ravel_pytree`` order; ``path`` joins nested keys with '/'. ``vocab``:
    the (padded) rows of ``wte`` (default the config's)."""
    D, Fd, N = cfg.hidden_size, cfg.ffn_dim, cfg.num_layers
    layer = {
        "ln1_scale": (N, D), "ln1_bias": (N, D),
        "w_qkv": (N, D, 3, D), "wo": (N, D, D), "wo_bias": (N, D),
        "ln2_scale": (N, D), "ln2_bias": (N, D),
        "w_fc": (N, D, Fd), "b_fc": (N, Fd), "w_proj": (N, Fd, D), "b_proj": (N, D),
    }
    return sorted_layout({
        "wte": (cfg.vocab_size if vocab is None else int(vocab), D),
        "wpe": (cfg.max_position_embeddings, D),
        "layers": layer,
        "lnf_scale": (D,),
        "lnf_bias": (D,),
    })


class GPTNeoModel(FlatParamModel):
    family = "gpt_neo"

    def __init__(
        self,
        config: GPTNeoConfig,
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
        impl = normalize_attention_impl(attention)
        if impl == "ring" and sequence_group is None:
            raise ValueError("attention='ring' requires a sequence group")
        if impl == "flash":
            raise ValueError(
                "GPT-Neo's local sliding-window layers do not run the flash "
                "kernel (as in the JAX model): use attention='fused', 'xla' "
                "or 'auto'"
            )
        padded = check_tp(config, tensor_group, vocab_pad_to,
                          (config.num_heads,), pipeline_group)
        super().__init__(param_layout(config, padded), config.num_layers, dtype, device,
                         tensor_group, pipeline_group, model_group)
        self.config = config
        self.padded_vocab = padded
        self.n_heads = config.num_heads // self.tp
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
        check_whole(self)
        return self.finalize(self.stage_blocks(self.pp_embed(input_ids, attention_mask),
                                               attention_mask))

    def pp_embed(self, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token plus learned position embeddings: the vocab-split lookup
        summed over the tensor or pipeline group (JAX: ``pp_embed``), the
        positions this rank's (its chunk's under context parallelism)."""
        cfg = self.config
        L = input_ids.shape[1]  # CP: this rank's chunk length
        positions, _ = self._cp_plan(L, attention_mask)
        global_len = L if positions is None else self.sequence_group.size * L
        if global_len > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {global_len} exceeds max_position_embeddings "
                f"{cfg.max_position_embeddings}"
            )
        if positions is None:
            wpe = self.wpe[:L]
        else:
            # the layout's host positions, on the card once (no copy in a
            # captured round)
            wpe = self.wpe[device_constant(positions, input_ids.device)]
        mg = self.model_group
        tok = (F.embedding(input_ids, self.wte) if mg is None
               else vocab_parallel_embed(self.wte, input_ids, mg))
        return tok + wpe[None, :, :]

    def stage_blocks(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                     stage_index: Optional[int] = None) -> torch.Tensor:
        """The layers this model holds over [B, L, D] hidden states (JAX:
        ``stage_blocks``): every layer, or pipeline stage ``stage_index``'s,
        whose windows are cut from the whole ``layer_windows`` table at
        ``stage_index * layers_per_stage`` (stage 0's pattern on every
        stage would be wrong wherever the stages' patterns differ)."""
        cfg = self.config
        n_stage = len(self.layers)
        if stage_index is None and n_stage != cfg.num_layers:
            raise ValueError("stage_blocks on a layer sub-stack needs stage_index: GPT-Neo's "
                             "global/local window pattern is absolute-layer-indexed")
        first = 0 if stage_index is None else stage_index * n_stage
        windows = cfg.layer_windows[first:first + n_stage]
        L = x.shape[1]
        _, attend = self._cp_plan(L, attention_mask)
        if attend is None:
            attend = self._attention_fn(L, attention_mask, x.device)
        layer = wrap_remat(self._layer, self.remat)
        for blk, window in zip(self.layers, windows):
            x = layer(x, blk, attend, window)
        return x

    def finalize(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm over the last layer's hidden states."""
        return layer_norm(x, self.lnf_scale, self.lnf_bias, self.config.layer_norm_epsilon)

    def _layer(self, x, blk, attend, window: int) -> torch.Tensor:
        """One block: attention with this layer's window, then the MLP."""
        q, k, v = self._qkv(x, blk)
        return self._out(x, blk, attend(q, k, v, window))

    def _qkv(self, x, blk):
        """The block's q, k, v in [B, H, L, D] (no positional rotation)."""
        cfg = self.config
        D, Dl = cfg.hidden_size, blk.w_qkv.shape[-1]  # Dl: this shard's third
        h = layer_norm(x, blk.ln1_scale, blk.ln1_bias, cfg.layer_norm_epsilon)
        q, k, v = (h @ blk.w_qkv.reshape(D, 3 * Dl)).split(Dl, dim=-1)
        return (split_heads(q, self.n_heads), split_heads(k, self.n_heads),
                split_heads(v, self.n_heads))

    def _out(self, x, blk, ctx) -> torch.Tensor:
        """The block after its attention: the output projection, the MLP."""
        eps, tg = self.config.layer_norm_epsilon, self.tensor_group
        x = x + tp_all_reduce(merge_heads(ctx) @ blk.wo, tg) + blk.wo_bias
        h = layer_norm(x, blk.ln2_scale, blk.ln2_bias, eps)
        return x + tp_all_reduce(gelu_new(h @ blk.w_fc + blk.b_fc) @ blk.w_proj, tg) + blk.b_proj

    def unpad_vocab(self, params: dict) -> dict:
        """The dense params tree without the Megatron vocab padding."""
        return unpad_vocab_tree(params, self.config.vocab_size, self.padded_vocab)

    # -- serving surface (serve/) ------------------------------------------

    def kv_spec(self) -> tuple[int, int, int]:
        """(n_layers, n_heads, head_dim): the per-token KV-cache row shape
        (``serve/kv_cache.CacheSpec``); GPT-Neo has no GQA."""
        cfg = self.config
        return cfg.num_layers, cfg.num_heads, cfg.head_dim

    def _check_serve(self) -> None:
        check_serve(self)

    def prefill(self, input_ids: torch.Tensor):
        """Serving prefill (see ``LlamaModel.prefill`` for the padding
        contract): the plain path with each layer's window bias, always,
        so the committed cache rows are what decode's plain attention
        replays.

        Returns ``(logits [B, L, V] float32, k, v [n_layers, B, L, H, D])``.
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
        biases = {w: attention_mask_bias(L, w, None, device) for w in set(cfg.layer_windows)}
        x = F.embedding(input_ids, self.wte) + self.wpe[:L][None, :, :]
        ks, vs = [], []
        for blk, window in zip(self.layers, cfg.layer_windows):
            q, k, v = self._qkv(x, blk)
            x = self._out(x, blk, dot_product_attention(q, k, v, biases[window], scale=1.0))
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
        x = layer_norm(x, self.lnf_scale, self.lnf_bias, cfg.layer_norm_epsilon)
        return lm_logits(x, self.lm_head()), torch.stack(ks), torch.stack(vs)

    def decode(
        self,
        token_ids: torch.Tensor,  # [R] one token per request slot
        positions: torch.Tensor,  # [R] absolute position being decoded
        k_ctx: torch.Tensor,  # [n_layers, R, C, H, D] gathered cache rows
        v_ctx: torch.Tensor,
        kv_positions: torch.Tensor,  # [C] or [R, C] absolute row positions
        band=None,  # (k_band, v_band [n_layers, R, Cb, H, D], band_positions [R, Cb])
    ):
        """One continuous-batching decode step. Global layers attend the
        full gathered context; local layers attend it under their window,
        or, when the engine passes ``band`` (``serve/kv_cache.gather_band``),
        only the pages covering the window, so that their cost stays
        O(window). Unscaled scores (GPT-Neo's ``scale=1.0``).

        Returns ``(logits [R, V] float32, k_new, v_new [n_layers, R, H, D])``.
        """
        cfg = self.config
        self._check_serve()
        x = (F.embedding(token_ids, self.wte) + self.wpe[positions])[:, None, :]
        k_new, v_new = [], []
        for i, (blk, window) in enumerate(zip(self.layers, cfg.layer_windows)):
            q, k, v = self._qkv(x, blk)
            if band is not None and window:
                k_band, v_band, band_positions = band
                ctx = cached_attention(q, k_band[i], v_band[i], k, v, positions,
                                       band_positions, window=window, scale=1.0)
            else:
                ctx = cached_attention(q, k_ctx[i], v_ctx[i], k, v, positions,
                                       kv_positions, window=window, scale=1.0)
            x = self._out(x, blk, ctx)
            k_new.append(k[:, :, 0])
            v_new.append(v[:, :, 0])
        x = layer_norm(x, self.lnf_scale, self.lnf_bias, cfg.layer_norm_epsilon)
        return lm_logits(x, self.lm_head())[:, 0], torch.stack(k_new), torch.stack(v_new)
