"""The kernel libraries' cache: which libraries a run launches, their
key, and what the builds of this process did.

Counterpart of ``acco_tpu/compile/cache.py``. JAX keeps its compiled XLA
programs in a persistent compilation cache keyed by the program; the
port's compiled artefacts are the CUDA libraries of ``csrc/``, which
``utils/cuda_build.py`` builds with ``nvcc`` into ``build/`` under a
name that carries :func:`library_key`: a hash of the source, every
``csrc/*.cuh`` header and the flags. A second launch of the same
checkout builds nothing (a hit); an edited source, header or flag is a
new key (a build). The captured rounds themselves (``compile/graphs.py``)
are CUDA graphs, which cannot outlive their process: they are captured
again by every run, in about a round's time each.

- :func:`libraries_for`: the libraries a run's configuration launches
  (K1 alone for Llama-125M; K1 + K2 for GPT-Neo-125M; K5 + K3 for the
  long-context Llama; K4 on the ring);
- :func:`cache_stats`: hits, builds and build seconds of this process,
  from ``cuda_build.BUILD_INFO`` (JAX's ``cache_stats``).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Optional, Sequence

# each kernel family's library under csrc/ (the name cuda_build.load takes)
K1, K2, K3, K4, K5 = ("fused_attention", "banded_attention", "fused_ce", "block_attention",
                      "flash_attention")


def library_key(name: str, csrc: Optional[Path] = None,
                flags: Optional[Sequence[str]] = None) -> str:
    """The 16-hex-digit key of ``csrc/<name>.cu``'s build: a sha256 over
    the source, every ``*.cuh`` header beside it (sorted by name) and the
    nvcc flags. It reads files only, so it runs without ``nvcc``."""
    from acco_tpu_torch.utils import cuda_build

    csrc = Path(csrc) if csrc is not None else cuda_build.PACKAGE_DIR / "csrc"
    flags = cuda_build.NVCC_FLAGS if flags is None else tuple(flags)
    source = csrc / f"{name}.cu"
    headers = sorted(csrc.glob("*.cuh"))
    return hashlib.sha256(
        b"".join(p.read_bytes() for p in [source, *headers]) + " ".join(flags).encode()
    ).hexdigest()[:16]


def libraries_for(attention: str, fused_loss, *, local_layers: bool = False,
                  const_len: bool = True) -> list:
    """The libraries a run launches, from its resolved attention impl
    (``ops.attention.resolve_attention_impl``: 'fused', 'flash', 'ring' or
    'xla'), its resolved fused loss ('pallas' launches K3) and whether
    the model has local (windowed) layers, which run K2 on mask-free
    (``const_len``) batches under 'fused'. K2's backward runs K1's delta
    kernel, so K2 never comes without K1."""
    out = []
    if attention == "fused":
        out.append(K1)
        if local_layers and const_len:
            out.append(K2)
    elif attention == "flash":
        out.append(K5)
    elif attention == "ring":
        out.append(K4)
    if fused_loss == "pallas":
        out.append(K3)
    return out


def cache_stats() -> dict:
    """``{"hits", "builds", "build_s", "libraries"}`` over the libraries
    this process built or found (``cuda_build.BUILD_INFO``): a hit is a
    library that was already in ``build/`` under its key."""
    from acco_tpu_torch.utils import cuda_build

    info = dict(cuda_build.BUILD_INFO)
    built = [n for n, r in info.items() if not r.get("cached", False)]
    return {
        "hits": len(info) - len(built),
        "builds": len(built),
        "build_s": sum(float(info[n].get("seconds", 0.0)) for n in built),
        "libraries": sorted(info),
    }
