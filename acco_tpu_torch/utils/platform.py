"""Device selection: the card unless the caller asks for the CPU.

There is no fallback: a run that asked for (or defaulted to) CUDA on a
machine without a card raises instead of quietly training on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device | None = None) -> torch.device:
    """``None`` / ``'cuda'`` -> ``cuda:0``; ``'cpu'`` -> the CPU; a CUDA
    request without a visible card raises."""
    device = torch.device("cuda" if requested is None else requested)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {requested!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "pass --device cpu to run on the CPU"
        )
    return torch.device("cuda", 0 if device.index is None else device.index)
