"""Model construction from the ``model=`` config group.

Counterpart of ``acco_tpu/models/registry.py``: ``config_path`` is a
repo-relative ``/config/model/*.json`` architecture file (``model_type``
``llama`` or ``gpt_neo``, the default) or one of the hub names the
reference's model group points at, built here from its architecture
preset with random init (no download). With ``train.finetune=true`` the
entry point instead reads a local pretrained checkpoint for that name
(``models/hf_loader.from_pretrained``, ``ACCO_MODELS_ROOT``).
"""

from __future__ import annotations

import json
import os

import torch

from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

_MODEL_TYPES = {"llama": (LlamaConfig, LlamaModel), "gpt_neo": (GPTNeoConfig, GPTNeoModel)}

# the hub names of the reference's model group, as architecture presets
PRESETS: dict[str, tuple[str, dict]] = {
    "EleutherAI/gpt-neo-125M": ("gpt_neo", {}),
    "EleutherAI/gpt-neo-2.7B": (
        "gpt_neo",
        dict(
            hidden_size=2560,
            num_layers=32,
            num_heads=20,
            max_position_embeddings=2048,
            attention_layers=("global", "local") * 16,
        ),
    ),
    "meta-llama/Meta-Llama-3-8B": (
        "llama",
        dict(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            max_position_embeddings=8192,
            rope_theta=500000.0,
            tie_word_embeddings=False,
        ),
    ),
}


def model_config(config_path: str, repo_root: str = "."):
    """``(model_type, config)`` for an architecture file or a preset name."""
    if config_path.endswith(".json"):
        path = config_path
        if not os.path.exists(path):
            path = os.path.join(repo_root, config_path.lstrip("/"))
        with open(path) as f:
            model_type = json.load(f).get("model_type", "gpt_neo")
        if model_type not in _MODEL_TYPES:
            raise ValueError(f"Unknown model_type {model_type!r} in {path}")
        return model_type, _MODEL_TYPES[model_type][0].from_json(path)
    if config_path in PRESETS:
        model_type, overrides = PRESETS[config_path]
        return model_type, _MODEL_TYPES[model_type][0](**overrides)
    raise ValueError(
        f"config_path {config_path!r} is neither a .json arch file nor a "
        f"known preset ({sorted(PRESETS)})"
    )


def build_model(
    model_cfg: dict,
    repo_root: str = ".",
    dtype=torch.bfloat16,
    attention: str = "auto",
    device="cpu",
    sequence_group=None,
    zigzag: bool = False,
    remat=False,
):
    """A model, random parameters to come, from a ``config/model/*.yaml``
    node. ``sequence_group`` (an ``ops.ring_attention.SequenceGroup``) and
    ``zigzag`` select context parallelism and its layout; ``remat`` the
    layers' rematerialisation (``models/layers.wrap_remat``)."""
    model_type, cfg = model_config(model_cfg["config_path"], repo_root)
    return _MODEL_TYPES[model_type][1](
        cfg, dtype=dtype, attention=attention, device=device,
        sequence_group=sequence_group, zigzag=zigzag, remat=remat,
    )
