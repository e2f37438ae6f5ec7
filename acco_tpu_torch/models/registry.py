"""Model construction from the ``model=`` config group.

Counterpart of ``acco_tpu/models/registry.py``. Only the Llama family is
in this slice of the port; GPT-Neo comes with ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

import json
import os

import torch

from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel


def build_model(
    model_cfg: dict,
    repo_root: str = ".",
    dtype=torch.bfloat16,
    attention: str = "auto",
    device="cpu",
) -> LlamaModel:
    """A model from a ``config/model/*.yaml`` node whose ``config_path``
    names a repo-relative ``/config/model/*.json`` architecture file."""
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
    if model_type != "llama":
        raise NotImplementedError(
            f"model_type {model_type!r} ({path}): only Llama is ported; "
            "GPT-Neo comes with ROADMAP.md queue 1, item 7"
        )
    return LlamaModel(
        LlamaConfig.from_json(path), dtype=dtype, attention=attention, device=device
    )
