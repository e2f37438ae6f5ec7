"""Pretrained weights: a local HF checkpoint directory into the port's flat
parameters.

Counterpart of ``acco_tpu/models/hf_loader.py``, which serves the
reference's finetune mode (``from_pretrained`` of a local checkpoint when
``train.finetune``) and the perplexity eval of a pretrained model. The
tensors are read without ``safetensors`` or ``transformers``, so that
loading needs neither:

- ``model.safetensors``, or the shards that ``model.safetensors.index.json``
  names: an 8-byte little-endian header length, the JSON header (dtype,
  shape and byte range of each tensor), then the raw bytes, read through
  ``torch.frombuffer`` over a memory map (BF16, F16 and F32 become
  float32 numpy, which holds every such value exactly);
- ``pytorch_model.bin`` through ``torch.load(weights_only=True)``.

:func:`convert_llama` and :func:`convert_gpt_neo` are JAX's: the HF names
mapped onto the JAX params pytree (projections transposed from HF's
``[out, in]``, per-layer tensors stacked on a leading layer axis,
GPT-Neo's q/k/v stacked as ``[D, 3, D]``; a missing ``lm_head.weight``
means a tied head). ``models/convert.params_from_jax`` then lays the tree
out as the port's flat vector, so the port's parameters equal JAX's
``from_pretrained`` by construction. The architecture comes from the
checkpoint's ``config.json``.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Any, Callable

import numpy as np
import torch

_SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy: floating types as float32 (exact for
    bf16/f16/f32), others as they are."""
    t = t.detach()
    if t.is_floating_point() and t.dtype != torch.float64:
        t = t.float()
    return t.contiguous().numpy().copy()


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of one ``.safetensors`` file, as numpy."""
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        if size == 8 + n:  # no tensor bytes (mmap refuses an empty map)
            return {}
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as mm:
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
                if dtype is None:
                    raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                     "which this reader does not take")
                begin, end = info["data_offsets"]
                raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                                       offset=8 + n + begin)
                out[name] = _to_numpy(raw.view(dtype).reshape(info["shape"]))
                del raw
    return out


def read_hf_state(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a local HF checkpoint directory, as numpy."""
    index = os.path.join(path, "model.safetensors.index.json")
    single = os.path.join(path, "model.safetensors")
    torch_bin = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        state: dict[str, np.ndarray] = {}
        for shard in sorted(set(weight_map.values())):
            state.update(read_safetensors(os.path.join(path, shard)))
        return state
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(torch_bin):
        raw = torch.load(torch_bin, map_location="cpu", weights_only=True)
        return {name: _to_numpy(t) for name, t in raw.items()}
    raise FileNotFoundError(
        f"No model.safetensors[.index.json] or pytorch_model.bin under {path!r}"
    )


def read_hf_config(path: str) -> dict[str, Any]:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# HF config key -> the port's config field, per family; keys the HF config
# lacks take the dataclass defaults
_LLAMA_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "max_position_embeddings": "max_position_embeddings",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_norm_eps",
    "tie_word_embeddings": "tie_word_embeddings",
    "bos_token_id": "bos_token_id",
    "eos_token_id": "eos_token_id",
}
_GPT_NEO_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "num_layers": "num_layers",
    "num_heads": "num_heads",
    "max_position_embeddings": "max_position_embeddings",
    "window_size": "window_size",
    "attention_layers": "attention_layers",
    "intermediate_size": "intermediate_size",
    "activation_function": "activation_function",
    "layer_norm_epsilon": "layer_norm_epsilon",
    "tie_word_embeddings": "tie_word_embeddings",
    "bos_token_id": "bos_token_id",
    "eos_token_id": "eos_token_id",
}


def _map_config(hf_cfg: dict, keys: dict[str, str]) -> dict:
    return {ours: hf_cfg[theirs] for theirs, ours in keys.items()
            if theirs in hf_cfg and hf_cfg[theirs] is not None}


def _stack(state: dict, n_layers: int, fmt: str, transform: Callable) -> np.ndarray:
    return np.stack([transform(state[fmt.format(i)]) for i in range(n_layers)])


def _t(w: np.ndarray) -> np.ndarray:  # HF Linear [out, in] -> x @ W [in, out]
    return w.T


def _same(w: np.ndarray) -> np.ndarray:
    return w


def convert_llama(state: dict[str, np.ndarray], cfg) -> dict:
    """HF ``LlamaForCausalLM`` tensors -> the JAX ``LlamaModel`` pytree."""
    N = cfg.num_layers
    pre = "model.layers.{0}."
    params = {
        "wte": state["model.embed_tokens.weight"],
        "layers": {
            "attn_norm": _stack(state, N, pre + "input_layernorm.weight", _same),
            "wq": _stack(state, N, pre + "self_attn.q_proj.weight", _t),
            "wk": _stack(state, N, pre + "self_attn.k_proj.weight", _t),
            "wv": _stack(state, N, pre + "self_attn.v_proj.weight", _t),
            "wo": _stack(state, N, pre + "self_attn.o_proj.weight", _t),
            "mlp_norm": _stack(state, N, pre + "post_attention_layernorm.weight", _same),
            "w_gate": _stack(state, N, pre + "mlp.gate_proj.weight", _t),
            "w_up": _stack(state, N, pre + "mlp.up_proj.weight", _t),
            "w_down": _stack(state, N, pre + "mlp.down_proj.weight", _t),
        },
        "final_norm": state["model.norm.weight"],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _t(state["lm_head.weight"])
    return params


def convert_gpt_neo(state: dict[str, np.ndarray], cfg) -> dict:
    """HF ``GPTNeoForCausalLM`` tensors -> the JAX ``GPTNeoModel`` pytree."""
    N = cfg.num_layers
    pre = "transformer.h.{0}."

    def qkv(i: int) -> np.ndarray:  # [D, 3, D]
        a = pre.format(i) + "attn.attention."
        return np.stack([_t(state[a + "q_proj.weight"]), _t(state[a + "k_proj.weight"]),
                         _t(state[a + "v_proj.weight"])], axis=1)

    return {
        "wte": state["transformer.wte.weight"],
        "wpe": state["transformer.wpe.weight"],
        "layers": {
            "ln1_scale": _stack(state, N, pre + "ln_1.weight", _same),
            "ln1_bias": _stack(state, N, pre + "ln_1.bias", _same),
            "w_qkv": np.stack([qkv(i) for i in range(N)]),
            "wo": _stack(state, N, pre + "attn.attention.out_proj.weight", _t),
            "wo_bias": _stack(state, N, pre + "attn.attention.out_proj.bias", _same),
            "ln2_scale": _stack(state, N, pre + "ln_2.weight", _same),
            "ln2_bias": _stack(state, N, pre + "ln_2.bias", _same),
            "w_fc": _stack(state, N, pre + "mlp.c_fc.weight", _t),
            "b_fc": _stack(state, N, pre + "mlp.c_fc.bias", _same),
            "w_proj": _stack(state, N, pre + "mlp.c_proj.weight", _t),
            "b_proj": _stack(state, N, pre + "mlp.c_proj.bias", _same),
        },
        "lnf_scale": state["transformer.ln_f.weight"],
        "lnf_bias": state["transformer.ln_f.bias"],
    }


def resolve_pretrained_dir(name_or_path: str, models_root: str | None = None) -> str:
    """A hub name or a path to a local checkpoint directory: an existing
    directory as it is, else ``<models_root or $ACCO_MODELS_ROOT>/<name>``
    (the reference's ``root_path_model`` prefix); otherwise it raises."""
    if os.path.isdir(name_or_path):
        return name_or_path
    root = models_root or os.environ.get("ACCO_MODELS_ROOT", "")
    candidate = os.path.join(root, name_or_path) if root else None
    if candidate and os.path.isdir(candidate):
        return candidate
    raise FileNotFoundError(
        f"Pretrained checkpoint {name_or_path!r} not found locally"
        + (f" (also tried {candidate!r})" if candidate else "")
        + ". This environment has no network egress: pre-download the HF "
        "checkpoint and point ACCO_MODELS_ROOT (or the config_path itself) "
        "at its directory."
    )


def from_pretrained(
    name_or_path: str,
    *,
    dtype=torch.bfloat16,
    models_root: str | None = None,
    vocab_pad_multiple: int = 1,
    **model_kwargs,
):
    """A local HF checkpoint directory (or a hub name under
    ``ACCO_MODELS_ROOT``) -> ``(model, flat)``: the model from its
    ``config.json`` in ``dtype`` (``model_kwargs``: attention, device,
    sequence_group, zigzag, remat), and its weights as an [n_params]
    float32 flat vector in the model's order. ``vocab_pad_multiple``
    other than 1 (Megatron vocab padding) raises: tensor parallelism is
    not ported."""
    from acco_tpu_torch.models.convert import params_from_jax
    from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

    if int(vocab_pad_multiple) != 1:
        raise NotImplementedError(
            f"vocab_pad_multiple={vocab_pad_multiple} (vocab padding for tensor "
            "parallelism) is not ported yet: ROADMAP.md queue 1, item 9")
    path = resolve_pretrained_dir(name_or_path, models_root)
    hf_cfg = read_hf_config(path)
    state = read_hf_state(path)
    model_type = hf_cfg.get("model_type", "")
    if model_type == "llama":
        tied = bool(hf_cfg.get("tie_word_embeddings", False))
        if "lm_head.weight" not in state:
            tied = True  # a tied head: HF omits the tensor
        cfg = LlamaConfig(**{**_map_config(hf_cfg, _LLAMA_KEYS), "tie_word_embeddings": tied})
        model = LlamaModel(cfg, dtype=dtype, **model_kwargs)
        tree = convert_llama(state, cfg)
    elif model_type == "gpt_neo":
        kwargs = _map_config(hf_cfg, _GPT_NEO_KEYS)
        kwargs.setdefault("tie_word_embeddings", True)  # GPT-Neo's default
        if "attention_layers" in kwargs:
            kwargs["attention_layers"] = tuple(kwargs["attention_layers"])
        cfg = GPTNeoConfig(**kwargs)
        model = GPTNeoModel(cfg, dtype=dtype, **model_kwargs)
        tree = convert_gpt_neo(state, cfg)
    else:
        raise ValueError(
            f"Unsupported model_type {model_type!r} in {path}/config.json "
            "(supported: llama, gpt_neo)"
        )
    return model, params_from_jax(tree, cfg)
