"""Paged KV cache: page pool + page table, vLLM-style, as PyTorch ops.

Counterpart of ``acco_tpu/serve/kv_cache.py``. The pool is two tensors
(K and V) of shape::

    [n_layers, num_pages, page_size, n_kv_heads, head_dim]

A request owns a list of PHYSICAL page ids; its page table row maps
logical page ``i`` (positions ``[i*page_size, (i+1)*page_size)``) to a
physical page. Page 0 is reserved as the NULL page: unallocated table
slots point at it, writes to it are discarded garbage, and reads from it
are always masked (``cached_attention``'s strict ``kv_pos < q_pos``), so
no gather or scatter needs a validity branch.

The device tensors keep one shape for the serving lifetime, which is what
lets the engine capture its decode step once as a CUDA graph
(``serve/engine.py``). The writes (:func:`write_token`,
:func:`write_prefill`) go into the pools in place, the counterpart of
JAX's donated pools: a captured graph keeps reading and writing the same
storage.

:func:`gather_band` reads only the pages that cover GPT-Neo's sliding
window on local layers: long-context decode on those layers costs
O(window), not O(context).

Not ported here: ``CacheSpec.pool_specs``/``abstract`` (the sharding
rule table and the aval sizing, ROADMAP.md queue 1, items 9 and 12).
"""

from __future__ import annotations

import dataclasses
import math

import torch

NULL_PAGE = 0


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape contract of one paged pool (from ``model.kv_spec()`` and the
    serve config's sizing knobs)."""

    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    num_pages: int = 256  # includes the reserved null page 0
    max_pages_per_seq: int = 8
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 2:
            raise ValueError(
                f"need page_size >= 1 and num_pages >= 2 (one is the "
                f"reserved null page); got {self.page_size}/{self.num_pages}"
            )

    @property
    def max_context(self) -> int:
        """Longest sequence (prompt + generated) one request can hold."""
        return self.max_pages_per_seq * self.page_size

    @property
    def page_shape(self) -> tuple:
        return (self.n_layers, self.num_pages, self.page_size, self.n_kv_heads,
                self.head_dim)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def page_bytes(self) -> int:
        """Bytes of ONE page across all layers, K+V."""
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        return 2 * self.n_layers * self.page_size * self.n_kv_heads * self.head_dim * itemsize

    @property
    def total_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    def alloc(self, device="cpu") -> tuple:
        """Two distinct zeroed pools (K, V): zeros, so that a masked read
        of a never-written row multiplies a finite value by 0."""
        return tuple(torch.zeros(self.page_shape, dtype=self.torch_dtype, device=device)
                     for _ in range(2))

    def pages_for(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))


# -- device-side gather/scatter ----------------------------------------------


def _gather_pages(pages, ids):
    """``pages[:, ids]`` ([n_layers, R, n, page, Hkv, D] for ids [R, n])
    flattened to [n_layers, R, n * page, Hkv, D]: one ``index_select`` of
    whole pages (contiguous rows of page*Hkv*D elements)."""
    n_layers, num_pages, page_size, n_kv, d = pages.shape
    r, n = ids.shape
    rows = pages.reshape(n_layers, num_pages, -1).index_select(1, ids.reshape(-1))
    return rows.view(n_layers, r, n * page_size, n_kv, d)


def gather_context(k_pages, v_pages, page_table):
    """Gather every request's full logical context from the pool.

    ``page_table`` [R, max_pages_per_seq] physical ids (null-page padded).
    Returns ``k_ctx, v_ctx`` [n_layers, R, C, Hkv, D] with ``C =
    max_pages_per_seq * page_size``, page-major, so row ``c`` holds
    absolute position ``c`` of each sequence.
    """
    return _gather_pages(k_pages, page_table), _gather_pages(v_pages, page_table)


def context_positions(max_pages_per_seq: int, page_size: int, device=None) -> torch.Tensor:
    """[C] absolute position of each gathered row: the same for every
    request, because logical page ``i`` always covers ``i*page_size``."""
    return torch.arange(max_pages_per_seq * page_size, dtype=torch.int64, device=device)


def band_pages(window: int, page_size: int) -> int:
    """Pages covering a ``window``-token sliding band that may straddle a
    page boundary (conservative: +1 partial page on each side collapses to
    one extra page)."""
    return (window + page_size - 1) // page_size + 1


def gather_band(k_pages, v_pages, page_table, seq_lens, window: int, page_size: int):
    """Gather only the pages covering each request's sliding window.

    Returns ``(k_band, v_band [n_layers, R, Cb, Hkv, D], band_positions
    [R, Cb])`` with ``Cb = band_pages(window, page_size) * page_size``.
    Band positions come from the UNCLIPPED logical page index: a band page
    past the request's table gathers garbage (clipped physical lookup), but
    its positions are ``>= seq_len`` and so masked by ``cached_attention``'s
    strict ``kv_pos < q_pos``.
    """
    r, pmax = page_table.shape
    bp = band_pages(window, page_size)
    # the first logical page holding an in-window position (the oldest
    # in-window key is seq_len - window + 1; seq_lens counts committed
    # tokens, the current query sits at position seq_len)
    first = (seq_lens - (window - 1)).clamp(min=0) // page_size  # [R]
    logical = first[:, None] + torch.arange(bp, dtype=seq_lens.dtype, device=seq_lens.device)
    phys = torch.gather(page_table, 1, logical.clamp(max=pmax - 1))  # [R, bp]
    offs = torch.arange(page_size, dtype=torch.int64, device=seq_lens.device)
    band_positions = (logical[:, :, None].long() * page_size + offs).reshape(r, bp * page_size)
    return _gather_pages(k_pages, phys), _gather_pages(v_pages, phys), band_positions


def write_token(k_pages, v_pages, page_table, seq_lens, k_new, v_new) -> None:
    """Scatter each slot's freshly decoded K/V row into its page at
    position ``seq_lens[r]``, in place (cast to the pool's dtype). ``k_new/v_new`` [n_layers, R, Hkv,
    D]. Inactive slots (null page table rows) scatter into the null page.
    """
    page_size = k_pages.shape[2]
    phys = torch.gather(page_table, 1, (seq_lens // page_size)[:, None])[:, 0]  # [R]
    off = seq_lens % page_size
    k_pages[:, phys, off] = k_new.to(k_pages.dtype)
    v_pages[:, phys, off] = v_new.to(v_pages.dtype)


def write_prefill(k_pages, v_pages, k_new, v_new, page_ids) -> None:
    """Scatter a prefill bucket's K/V ([n_layers, L, Hkv, D], L a page
    multiple) into the pages listed in ``page_ids`` [L / page_size], in
    place (null-page padded past the prompt's allocation: the garbage tail
    lands in page 0)."""
    n_layers, _, page_size, n_kv, d = k_pages.shape
    n_pg = page_ids.shape[0]
    k_pages[:, page_ids] = k_new.reshape(n_layers, n_pg, page_size, n_kv, d).to(k_pages.dtype)
    v_pages[:, page_ids] = v_new.reshape(n_layers, n_pg, page_size, n_kv, d).to(v_pages.dtype)


# -- host-side allocation (a copy of JAX's) -----------------------------------


class PageAllocator:
    """Free-list over physical page ids (page 0 reserved as null).

    Pure host-side Python: the scheduler's admission/eviction decisions
    happen here; the device tensors never resize. Not thread-safe: the
    serving loop owns it (server.ServingLoop serializes scheduler steps).
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages={num_pages} must exceed reserved={reserved}"
            )
        self.num_pages = num_pages
        self.reserved = reserved
        # pop() takes from the end: keep ascending ids there for
        # deterministic, debuggable allocation order
        self._free = list(range(num_pages - 1, reserved - 1, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - self.reserved - len(self._free)

    def alloc(self, n: int):
        """``n`` physical page ids, or None if the pool can't cover it
        (all-or-nothing: a partial grant would deadlock two growing
        requests)."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not (self.reserved <= p < self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
