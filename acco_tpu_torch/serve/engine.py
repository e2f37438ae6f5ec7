"""The device surface of the serving path: bucketed prefill, one decode
step captured as a CUDA graph, sampling.

Counterpart of ``acco_tpu/serve/engine.py``, with the same host surface
(numpy in, numpy out) so that the scheduler drives either unchanged:

- ``prefill`` runs one prompt, right-padded to its bucket, through the
  model's plain causal forward (eagerly, one forward per admitted
  prompt) and writes every layer's K/V into the prompt's pages;
- ``decode`` is ONE step for the whole serving lifetime: gather every
  slot's context rows (plus the window band on GPT-Neo's local layers),
  one ``model.decode``, write the new K/V row back. On a card it is
  captured once as a CUDA graph over static device buffers (the page
  table, ``seq_lens``, the fed tokens, the pools, the parameters) and
  replayed: each step copies its inputs from pinned host buffers into
  those buffers and replays, the counterpart of JAX's AOT-warmed decode
  program. On the CPU the same body runs eagerly;
- ``sample`` is greedy (``argmax``, the first maximum) or gumbel-max at a
  temperature with an optional top-k (the threshold at the k-th largest
  value, k clipped to ``top_k_max``), as JAX's. The noise comes from the
  port's own counter-based generator (:func:`philox4x32`, in plain
  integer tensor ops, so the same bits on the CPU and the card): a row's
  key is ``uint32[2]``, (seed word, draw counter); a draw depends only on
  the row's key and logits, and advances its counter. JAX's
  ``jax.random`` bits cannot be reproduced here, so sampled tokens at a
  temperature above 0 differ from JAX's by design.

The parameters are the model's own tensors, views into one flat vector
that the engine allocates: :meth:`ServeEngine.set_params` copies a flat
vector (``ravel_pytree`` order) into that storage, and the pools are
written in place, so a captured graph stays valid across both.

:meth:`ServeEngine.abstract_state` is the serve state as meta tensors
(the parameter tree and both pools, no allocation) and
:meth:`ServeEngine.rule_table` its rule table: the static gates
(``analysis/``) walk them and the memory sieve prices them.
"""

from __future__ import annotations

import bisect
import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from acco_tpu_torch.serve.kv_cache import (
    CacheSpec,
    band_pages,
    context_positions,
    gather_band,
    gather_context,
    write_prefill,
    write_token,
)

_log = logging.getLogger(__name__)


def default_buckets(page_size: int, max_context: int) -> list[int]:
    """Power-of-two page-multiple prompt buckets ending exactly at
    ``max_context`` (the top bucket MUST reach it: an evicted request
    re-prefills its whole prompt+generated prefix, which can be any length
    below max_context)."""
    buckets = []
    b = page_size
    while b < max_context:
        buckets.append(b)
        b *= 2
    buckets.append(max_context)
    return buckets


# -- the counter-based generator and sampling ---------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_NOISE_SALT = 0x5E5A0F11  # the second Philox key word of every sampling draw


def _mulhilo(m: int, x: torch.Tensor) -> tuple:
    """High and low 32-bit words of ``m * x`` (``x`` int64 in [0, 2^32)),
    in 16-bit halves so that no int64 product overflows."""
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter: tuple, key: tuple, rounds: int = 10) -> tuple:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    words: four counter words and two key words (tensors or ints, which
    broadcast) to four random words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for i in range(rounds):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[R, n] float32 standard Gumbel noise, row ``r`` from its key alone
    (``keys`` int64 [R, 2]: the seed word and the draw counter): element
    ``j`` is word ``j % 4`` of Philox at counter ``(j // 4, draw counter,
    0, 0)`` under key ``(seed word, salt)``; 24 of its bits give a uniform
    strictly inside (0, 1)."""
    device = keys.device
    idx = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)[None, :]
    seed, ctr = keys[:, :1], keys[:, 1:]
    zero = torch.zeros_like(idx)
    words = philox4x32((idx, ctr + zero, zero, zero), (seed, _NOISE_SALT))
    bits = torch.stack(words, dim=-1).reshape(keys.shape[0], -1)[:, :n]
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits, keys, temps, top_ks, kmax: int) -> tuple:
    """One token per row: ``argmax`` where the temperature is <= 0, else
    ``argmax(masked scaled logits + gumbel noise)``, the mask keeping the
    values at or above the ``top_k``-th largest (all of them for
    ``top_k`` <= 0; k clipped to ``kmax``), as JAX's ``sample_fn``.
    Returns ``(tokens [R] int64, keys with their counters advanced)``."""
    tokens = logits.argmax(dim=-1)
    hot = (temps > 0).nonzero()[:, 0]  # the rows that draw (a row's draw needs only its own)
    if hot.numel():
        scaled = logits[hot].float() / temps[hot, None].clamp(min=1e-6)
        masked = scaled.masked_fill(~topk_allowed(scaled, top_ks[hot], kmax), float("-inf"))
        tokens[hot] = (masked + gumbel_noise(keys[hot], logits.shape[-1])).argmax(dim=-1)
    new_keys = keys.clone()
    new_keys[:, 1] = (keys[:, 1] + 1) & _MASK32
    return tokens, new_keys


def topk_allowed(scaled, top_ks, kmax: int) -> torch.Tensor:
    """Bool [R, V]: the entries at or above each row's k-th largest value
    (ties included), every entry where ``top_k`` <= 0."""
    vals = torch.topk(scaled, kmax, dim=-1).values
    take = torch.where(top_ks <= 0, torch.full_like(top_ks, kmax), top_ks).clamp(1, kmax)
    thresh = vals.gather(1, (take - 1)[:, None])
    return (top_ks[:, None] <= 0) | (scaled >= thresh)


def key_from_seed(seed: int) -> np.ndarray:
    """uint32[2]: the seed folded to one word, draw counter 0."""
    seed = int(seed)
    word = (seed & _MASK32) ^ (((seed >> 32) * _PHILOX_W[0]) & _MASK32)
    return np.asarray([word, 0], np.uint32)


# -- the engine ------------------------------------------------------------------


class ServeEngine:
    """Device state and programs of one serving replica: the model's
    parameters (one flat vector the engine owns), the paged pools, the
    bucketed prefill, the captured decode step and the sampler.

    Single-replica by design (the models' serve methods refuse a sequence
    group): a serving fleet scales by replicas behind a balancer. The
    engine runs on the model's device; on a card the decode step is a
    CUDA graph, captured by :meth:`start_warmup` (or at the first decode)
    before any other thread makes a CUDA call. A capture that fails
    raises: there is no eager fallback.
    """

    def __init__(
        self,
        model,
        *,
        page_size: int = 16,
        num_pages: int = 256,
        max_pages_per_seq: int = 8,
        max_slots: int = 4,
        buckets: Optional[Sequence[int]] = None,
        top_k_max: int = 64,
        cache_dtype=None,
        log=None,
    ):
        self.model = model
        self.log = log or _log
        cfg = model.config
        self.device = next(model.parameters()).device
        n_layers, n_kv, head_dim = model.kv_spec()
        dtype = cache_dtype or model.dtype
        self.spec = CacheSpec(
            n_layers=n_layers,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            page_size=int(page_size),
            num_pages=int(num_pages),
            max_pages_per_seq=int(max_pages_per_seq),
            dtype=str(dtype).removeprefix("torch."),
        )
        if self.spec.max_context > cfg.max_position_embeddings:
            raise ValueError(
                f"max_pages_per_seq*page_size = {self.spec.max_context} "
                f"exceeds the model's max_position_embeddings "
                f"{cfg.max_position_embeddings} — shrink the page budget "
                "per sequence"
            )
        self.max_slots = int(max_slots)
        self.buckets = sorted(
            int(b) for b in (buckets or default_buckets(self.spec.page_size,
                                                        self.spec.max_context))
        )
        for b in self.buckets:
            if b % self.spec.page_size:
                raise ValueError(
                    f"prefill bucket {b} is not a multiple of page_size "
                    f"{self.spec.page_size}"
                )
        if self.buckets[-1] < self.spec.max_context:
            # an evicted request's replayed prefix can be any length up to
            # max_context; the top bucket must cover it
            self.buckets.append(self.spec.max_context)
        self.top_k_max = int(top_k_max)
        self.eos_token_id = getattr(cfg, "eos_token_id", None)
        self.vocab_size = cfg.vocab_size
        # GPT-Neo's local layers read the narrow band gather instead of the
        # full context, where the band is narrower than the page table
        windows = getattr(cfg, "layer_windows", None)
        self._use_band = bool(
            windows
            and any(w > 0 for w in windows)
            and band_pages(cfg.window_size, self.spec.page_size) < self.spec.max_pages_per_seq
        )
        # the parameters: the model's tensors become views into this vector
        self._flat = torch.zeros(model.n_params, dtype=model.dtype, device=self.device)
        model.load_flat(self._flat)
        self._params_set = False
        self._k_pages = self._v_pages = None
        self._inputs = None  # the decode step's static buffers (and pinned twins)
        self._graph = None  # the captured decode step (compile.graphs.Program)
        self.report: dict = {}
        self.counters = {"prefills": 0, "decode_steps": 0}

    @property
    def max_prefill_len(self) -> int:
        return self.buckets[-1]

    @property
    def page_size(self) -> int:
        return self.spec.page_size

    @property
    def num_pages(self) -> int:
        return self.spec.num_pages

    @property
    def max_pages_per_seq(self) -> int:
        return self.spec.max_pages_per_seq

    @property
    def max_context(self) -> int:
        return self.spec.max_context

    @property
    def capture_on(self) -> bool:
        return self.device.type == "cuda"

    def bucket_for(self, n_tokens: int) -> int:
        i = bisect.bisect_left(self.buckets, n_tokens)
        if i == len(self.buckets):
            raise ValueError(
                f"prompt of {n_tokens} tokens exceeds the largest prefill "
                f"bucket {self.buckets[-1]}"
            )
        return self.buckets[i]

    # -- the abstract state (the static gates and the memory sieve) -----------

    def abstract_params(self) -> dict:
        """The parameter tree (JAX's init tree, ``jax.eval_shape(model.init,
        key)``: ``wte``, ``layers/wq``, ...) nested by the model's layout, as
        tensors on the meta device in the model's dtype: no storage."""
        tree: dict = {}
        for path, shape, _ in self.model.layout:
            *outer, leaf = path.split("/")
            node = tree
            for key in outer:
                node = node.setdefault(key, {})
            node[leaf] = torch.empty(shape, dtype=self.model.dtype, device="meta")
        return tree

    def rule_table(self):
        """The serve state's rule table (params and KV pools)."""
        from acco_tpu_torch.sharding.tables import model_family, serve_state_table

        return serve_state_table(model_family(self.model))

    def abstract_state(self) -> dict:
        """``{"params", "k_pages", "v_pages"}`` as meta tensors, keyed as the
        rule table and the gates walk them."""
        kp, vp = self.spec.abstract()
        return {"params": self.abstract_params(), "k_pages": kp, "v_pages": vp}

    # -- device state ---------------------------------------------------------

    def set_params(self, flat) -> None:
        """Copy a flat parameter vector (``ravel_pytree`` order: a
        ``params.npz``'s ``flat_params``, a rank file's, ``model.init_flat``
        or ``models.convert.params_from_jax``) into the engine's storage,
        cast to the model's dtype. The storage stays where it is, so a
        captured decode step reads the new values."""
        flat = torch.as_tensor(flat).reshape(-1)
        if flat.numel() != self._flat.numel():
            raise ValueError(
                f"{flat.numel()} params for a model of {self._flat.numel()} — "
                "wrong model config for this checkpoint?"
            )
        self._flat.copy_(flat)
        self._params_set = True

    def _ensure_pages(self) -> None:
        if self._k_pages is None:
            self._k_pages, self._v_pages = self.spec.alloc(self.device)

    @property
    def pools(self) -> tuple:
        """(k_pages, v_pages), allocated on first use."""
        self._ensure_pages()
        return self._k_pages, self._v_pages

    def _ensure_inputs(self) -> dict:
        """The decode step's static device buffers (and, on a card, their
        pinned host twins that each step copies from)."""
        if self._inputs is None:
            r, pmax = self.max_slots, self.spec.max_pages_per_seq
            shapes = {"page_table": (r, pmax), "seq_lens": (r,), "tokens": (r,)}
            dev = {k: torch.zeros(s, dtype=torch.int64, device=self.device)
                   for k, s in shapes.items()}
            host = ({k: torch.zeros(s, dtype=torch.int64, pin_memory=True)
                     for k, s in shapes.items()} if self.capture_on else None)
            self._inputs = {"dev": dev, "host": host,
                            "positions": context_positions(pmax, self.spec.page_size,
                                                           self.device)}
        return self._inputs

    # -- the decode step ------------------------------------------------------

    def _decode_body(self) -> torch.Tensor:
        """One decode step over the static buffers: the logits [R, V]
        float32, the new K/V rows written into the pools."""
        inp = self._ensure_inputs()
        page_table, seq_lens, tokens = (inp["dev"][k] for k in ("page_table", "seq_lens", "tokens"))
        k_pages, v_pages = self.pools
        with torch.no_grad():
            k_ctx, v_ctx = gather_context(k_pages, v_pages, page_table)
            kw = {}
            if self._use_band:
                kw["band"] = gather_band(k_pages, v_pages, page_table, seq_lens,
                                         self.model.config.window_size, self.spec.page_size)
            logits, k_new, v_new = self.model.decode(tokens, seq_lens, k_ctx, v_ctx,
                                                     inp["positions"], **kw)
            write_token(k_pages, v_pages, page_table, seq_lens, k_new, v_new)
        return logits

    def _stage(self, page_table, seq_lens, tokens) -> None:
        """Copy one step's inputs into the static buffers (through the
        pinned twins on a card, on the current stream)."""
        inp = self._ensure_inputs()
        for name, value in (("page_table", page_table), ("seq_lens", seq_lens),
                            ("tokens", tokens)):
            value = torch.as_tensor(np.asarray(value, dtype=np.int64))
            if inp["host"] is None:
                inp["dev"][name].copy_(value)
            else:
                inp["host"][name].copy_(value)
                inp["dev"][name].copy_(inp["host"][name], non_blocking=True)

    def start_warmup(self) -> dict:
        """On a card: allocate the pools and the static buffers, run a
        prefill of the smallest bucket into the null page and a sample
        (their first calls' lazy set-up, which can take seconds, would
        otherwise land on the first request), run the decode step
        once eagerly (reading the static buffers, writing only the null
        page), then capture it as a CUDA graph. Call it before any other
        thread makes a CUDA call (``capture_error_mode`` 'global'), i.e.
        before ``ServingLoop.start()``; the parameters may come after
        (:meth:`set_params` writes in place). On the CPU there is nothing
        to capture. Returns the report (warm-up and capture ms, memory)."""
        if not self.capture_on or self._graph is not None:
            return self.report
        from acco_tpu_torch.compile.graphs import Program, _memory_gib, _warm

        self._ensure_inputs()
        self._ensure_pages()
        t0 = time.perf_counter()
        bucket = self.buckets[0]
        self._prefill(torch.zeros((1, bucket), dtype=torch.int64, device=self.device),
                      torch.zeros((bucket // self.spec.page_size,), dtype=torch.int64,
                                  device=self.device))
        r = self.max_slots
        self.sample(np.zeros((r, self.vocab_size), np.float32), np.zeros((r, 2), np.uint32),
                    np.ones(r, np.float32), np.zeros(r, np.int32))
        self.report["prefill_sample_warmup_ms"] = (time.perf_counter() - t0) * 1e3
        prog = Program("decode", self._decode_body)
        self.report["warmup_ms"], _ = _warm(prog.body)
        prog.capture(torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device))
        self.report["capture_ms"] = prog.record.capture_ms
        self.report["memory_gib"] = _memory_gib()
        self._graph = prog
        return self.report

    def finish_warmup(self, timeout: Optional[float] = None) -> dict:
        """The warm-up's report, logged (the capture ran in
        :meth:`start_warmup`, on the calling thread: nothing to join)."""
        if self.report:
            self.log.info("serve decode step: %s", self.report)
        return self.report

    def decode_logits(self, page_table, seq_lens, tokens, *, eager: bool = False):
        """One decode step; the device logits [R, V] float32, which the next
        step overwrites on a card. ``eager`` runs the body uncaptured (an
        oracle for the captured step)."""
        if not self._params_set:
            raise RuntimeError("set_params() before serving")
        self._stage(page_table, seq_lens, tokens)
        if eager or not self.capture_on:
            logits = self._decode_body()
        else:
            if self._graph is None:
                self.start_warmup()
            logits = self._graph()
        self.counters["decode_steps"] += 1
        return logits

    def decode(self, page_table, seq_lens, tokens):
        """One continuous-batching decode step over all slots; commits each
        active slot's new K/V row; returns logits [R, V] (float32, numpy)."""
        return self._host(self.decode_logits(page_table, seq_lens, tokens))

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu").numpy().copy()

    # -- prefill and scoring ---------------------------------------------------

    def _bucketed(self, token_ids) -> tuple:
        n = len(token_ids)
        bucket = self.bucket_for(n)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = token_ids
        return n, bucket, torch.from_numpy(ids).to(self.device)

    def prefill(self, token_ids: Sequence[int], page_ids: Sequence[int]):
        """Run one prompt through its bucket's forward, committing its K/V
        pages; returns the last real position's logits [V] (float32,
        numpy)."""
        if not self._params_set:
            raise RuntimeError("set_params() before serving")
        n, bucket, ids = self._bucketed(token_ids)
        page_vec = np.zeros((bucket // self.spec.page_size,), np.int64)
        page_vec[: len(page_ids)] = page_ids
        logits = self._prefill(ids, torch.from_numpy(page_vec).to(self.device))
        self.counters["prefills"] += 1
        return self._host(logits[0, n - 1])

    def _prefill(self, ids: torch.Tensor, page_vec: torch.Tensor) -> torch.Tensor:
        """The bucket's forward on ``ids`` [1, bucket], its K/V written into
        the pages of ``page_vec``; the logits [1, bucket, V] float32."""
        k_pages, v_pages = self.pools
        with torch.no_grad():
            logits, k, v = self.model.prefill(ids)
            write_prefill(k_pages, v_pages, k[:, 0], v[:, 0], page_vec)
        return logits

    def score_nll(self, token_ids: Sequence[int]):
        """Summed shifted NLL of one prompt through the serve forward
        (``model.prefill`` at the prompt's bucket), as ``(nll_sum,
        n_scored_tokens)``: perplexity_eval's ``--engine serve``. No KV
        page is touched, so a scoring-only engine never allocates the
        pool."""
        from acco_tpu_torch.data.loader import IGNORE_INDEX
        from acco_tpu_torch.ops.losses import _per_token_ce

        if not self._params_set:
            raise RuntimeError("set_params() before scoring")
        n, bucket, ids = self._bucketed(token_ids)
        labels = torch.full((1, bucket), IGNORE_INDEX, dtype=torch.int64, device=self.device)
        labels[0, :n] = ids[0, :n]
        with torch.no_grad():
            logits, _k, _v = self.model.prefill(ids)
            nll, mask = _per_token_ce(logits[:, :-1], labels[:, 1:], 0.0)
        return float((nll * mask).sum()), int(mask.sum())

    # -- sampling ---------------------------------------------------------------

    def sample(self, logits, keys, temps, top_ks):
        """Sample one token per row on the engine's device; returns
        ``(tokens [R] int32, advanced keys [R, 2] uint32)`` (numpy)."""
        dev = self.device
        toks, new_keys = sample_tokens(
            torch.as_tensor(np.asarray(logits, np.float32)).to(dev),
            torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64)).to(dev),
            torch.as_tensor(np.asarray(temps, np.float32)).to(dev),
            torch.as_tensor(np.asarray(top_ks, np.int64)).to(dev),
            min(self.top_k_max, self.vocab_size),
        )
        return (toks.cpu().numpy().astype(np.int32),
                new_keys.cpu().numpy().astype(np.uint32))

    def make_key(self, seed: int):
        """A fresh row key (host numpy: a handler thread may call it)."""
        return key_from_seed(seed)


class StubEngine:
    """Deterministic pure-host engine for the scheduler's tests (a copy of
    JAX's): the same surface as ServeEngine, no device state. The 'model'
    emits ``(last_input_token + 1) % vocab_size``: enough to assert request
    lifecycle, page accounting, and eviction replay."""

    def __init__(
        self,
        *,
        page_size: int = 4,
        num_pages: int = 16,
        max_pages_per_seq: int = 4,
        max_slots: int = 2,
        vocab_size: int = 32,
        eos_token_id: Optional[int] = None,
        buckets: Optional[Sequence[int]] = None,
        decode_sleep_s: float = 0.0,
    ):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.max_slots = max_slots
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.max_context = page_size * max_pages_per_seq
        self.buckets = sorted(buckets) if buckets else default_buckets(
            page_size, self.max_context
        )
        self.max_prefill_len = self.buckets[-1]
        # optional per-decode host sleep: makes the stub slow enough for
        # timeout/deadline/cancellation drills without a real engine
        self.decode_sleep_s = float(decode_sleep_s)
        self.calls: list[tuple] = []  # (kind, payload) history for tests
        self.counters = {"prefills": 0, "decode_steps": 0}

    def bucket_for(self, n_tokens: int) -> int:
        i = bisect.bisect_left(self.buckets, n_tokens)
        if i == len(self.buckets):
            raise ValueError(f"prompt of {n_tokens} exceeds {self.buckets[-1]}")
        return self.buckets[i]

    def prefill(self, token_ids, page_ids):
        self.calls.append(("prefill", list(token_ids), list(page_ids)))
        self.counters["prefills"] += 1
        logits = np.zeros((self.vocab_size,), np.float32)
        logits[(int(token_ids[-1]) + 1) % self.vocab_size] = 1.0
        return logits

    def decode(self, page_table, seq_lens, tokens):
        self.calls.append(
            ("decode", np.array(page_table), np.array(seq_lens), np.array(tokens))
        )
        self.counters["decode_steps"] += 1
        if self.decode_sleep_s > 0:
            time.sleep(self.decode_sleep_s)
        r = len(tokens)
        logits = np.zeros((r, self.vocab_size), np.float32)
        for i in range(r):
            logits[i, (int(tokens[i]) + 1) % self.vocab_size] = 1.0
        return logits

    def sample(self, logits, keys, temps, top_ks):
        return np.argmax(logits, axis=-1).astype(np.int32), np.asarray(keys)

    def make_key(self, seed: int):
        return np.zeros((2,), np.uint32)
