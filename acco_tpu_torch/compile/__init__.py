"""Compile once: the kernel libraries built in the background at
construction and the rounds captured as CUDA graphs and replayed.

Counterpart of ``acco_tpu/compile/``: where JAX compiles each round
program once (``warmup.py``, on threads beside tokenization) and keeps
it across launches (``cache.py``, the persistent XLA cache), the port
builds its CUDA libraries ahead of the first round and keeps them in
``build/`` by source hash (:mod:`cache`, :mod:`warmup`), and captures
each round program once and replays it (:mod:`graphs`).
"""

from acco_tpu_torch.compile.cache import cache_stats, libraries_for, library_key
from acco_tpu_torch.compile.graphs import EvalPrograms, RoundPrograms, counting
from acco_tpu_torch.compile.warmup import CompileWarmup, WarmupReport

__all__ = [
    "CompileWarmup",
    "EvalPrograms",
    "RoundPrograms",
    "WarmupReport",
    "cache_stats",
    "counting",
    "libraries_for",
    "library_key",
]
