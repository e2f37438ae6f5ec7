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


# (device, dtype, shape, bytes) -> the tensor on that device
_CONSTANTS: dict = {}


def device_constant(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` (a CPU tensor that is a pure function of the layout, such
    as the ring's absolute positions) on ``device``, copied once and kept:
    a later call with the same values returns the same device tensor. So
    a captured round (``compile/graphs.py``), whose warm-up made the copy,
    holds no host-to-device copy of pageable memory, which a capture
    refuses, and reads an address that stays put."""
    device = torch.device(device)
    if device.type == "cpu":
        return host
    host = host.detach().contiguous()
    key = (str(device), host.dtype, tuple(host.shape), host.numpy().tobytes())
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = host.to(device)
    return out
