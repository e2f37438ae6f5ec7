"""Device selection: the card unless the caller asks for the CPU.

There is no fallback: a run that asked for (or defaulted to) CUDA on a
machine without a card raises instead of quietly training on the CPU.
"""

from __future__ import annotations

import os

import torch

# the CUDA caching allocator's settings unless the caller sets their own
ALLOCATOR_SETTINGS = "expandable_segments:True"


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


def default_allocator_settings() -> None:
    """Give the CUDA caching allocator expandable segments unless
    ``PYTORCH_CUDA_ALLOC_CONF`` is set. ACCO's comm stream allocates from
    a pool of its own; with fixed segments the two pools fragment device
    memory, and on a card near full (the long-context cells on an H100)
    the allocator then frees its cache behind device-wide syncs. Takes
    effect only before the process first initialises CUDA."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOCATOR_SETTINGS)
