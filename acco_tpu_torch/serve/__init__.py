"""Serving: continuous-batching inference from any checkpoint.

Counterpart of ``acco_tpu/serve/``: training produces checkpoints, this
package turns them into tokens. Four layers:

- :mod:`kv_cache` — the paged KV-cache layout (page pool + page table),
  the gather/scatter ops the decode step is built from (the writes in
  place), and the host-side page allocator;
- :mod:`engine` — the device surface: bucketed eager prefill, one decode
  step captured as a CUDA graph on a card, sampling with the port's own
  counter-based generator;
- :mod:`scheduler` — continuous batching (a copy of JAX's): admit/evict
  per decode step against the page budget, LIFO preemption with exact
  replay, admission control, deadlines, cancellation, drain;
- :mod:`server` — the stdlib-http front end (JSON /generate, /healthz,
  /metrics, /admin/drain) and the serving loop thread, which hands its
  lock over fairly to callers between steps.

The model halves live with the models (``kv_spec``/``prefill``/``decode``
on ``LlamaModel`` and ``GPTNeoModel``) and ``ops.attention.
cached_attention``. Entry points: ``python -m acco_tpu_torch.serve``
and ``python -m acco_tpu_torch.serve.load_harness``.
"""

from acco_tpu_torch.serve.engine import ServeEngine, StubEngine
from acco_tpu_torch.serve.kv_cache import CacheSpec, PageAllocator
from acco_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler,
    GenRequest,
    ShedError,
)
from acco_tpu_torch.serve.server import ServingLoop, serve_http

__all__ = [
    "CacheSpec",
    "ContinuousBatchingScheduler",
    "GenRequest",
    "PageAllocator",
    "ServeEngine",
    "ServingLoop",
    "ShedError",
    "StubEngine",
    "serve_http",
]
