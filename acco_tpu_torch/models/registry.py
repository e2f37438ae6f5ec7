"""Model construction from the ``model=`` config group.

Counterpart of ``acco_tpu/models/registry.py`` for architecture files:
``model_type`` ``llama`` or ``gpt_neo`` (the default, as in the JAX
registry). Hub presets and pretrained checkpoints come with ROADMAP.md
queue 1, item 7 (``models/hf_loader.py``).
"""

from __future__ import annotations

import json
import os

import torch

from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel

_MODEL_TYPES = {"llama": (LlamaConfig, LlamaModel), "gpt_neo": (GPTNeoConfig, GPTNeoModel)}


def build_model(
    model_cfg: dict,
    repo_root: str = ".",
    dtype=torch.bfloat16,
    attention: str = "auto",
    device="cpu",
    sequence_group=None,
    zigzag: bool = False,
):
    """A model from a ``config/model/*.yaml`` node whose ``config_path``
    names a repo-relative ``/config/model/*.json`` architecture file.
    ``sequence_group`` (an ``ops.ring_attention.SequenceGroup``) and
    ``zigzag`` select context parallelism and its layout."""
    config_path = model_cfg["config_path"]
    if not config_path.endswith(".json"):
        raise NotImplementedError(
            f"config_path {config_path!r}: hub presets and pretrained "
            "checkpoints are not ported yet (ROADMAP.md queue 1, item 7)"
        )
    path = config_path
    if not os.path.exists(path):
        path = os.path.join(repo_root, config_path.lstrip("/"))
    with open(path) as f:
        model_type = json.load(f).get("model_type", "gpt_neo")
    if model_type not in _MODEL_TYPES:
        raise ValueError(f"Unknown model_type {model_type!r} in {path}")
    cfg_cls, model_cls = _MODEL_TYPES[model_type]
    return model_cls(
        cfg_cls.from_json(path), dtype=dtype, attention=attention, device=device,
        sequence_group=sequence_group, zigzag=zigzag,
    )
