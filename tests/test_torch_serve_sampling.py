"""The port's sampler: greedy and the top-k allowed set against JAX's
``ServeEngine.sample`` (the one JAX serve program these tests compile),
the port's own counter-based generator (Philox4x32-10 against the
published known-answer vectors), the key contract (a draw depends on the
row's key and logits only, never on its slot) and the draws' frequencies
against the softmax. Sampled tokens at a temperature above 0 differ from
JAX's by design (JAX's ``jax.random`` bits are not reproduced)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
import yaml

from acco_tpu_torch.serve.engine import (
    ServeEngine,
    gumbel_noise,
    philox4x32,
    sample_tokens,
    topk_allowed,
)

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines():
    """JAX's and the port's engines on the tiny Llama (V 257, top_k_max 64)."""
    from acco_tpu.models.registry import build_model as jax_build
    from acco_tpu.serve.engine import ServeEngine as JaxEngine
    from acco_tpu_torch.models.registry import build_model

    with open(os.path.join(REPO, "config", "model", "tiny.yaml")) as f:
        cfg = yaml.safe_load(f)
    kw = dict(page_size=8, num_pages=4, max_pages_per_seq=4, max_slots=4, cache_dtype="float32")
    jax_engine = JaxEngine(jax_build(cfg, repo_root=REPO, param_dtype=jnp.float32), **kw)
    port = ServeEngine(build_model(cfg, repo_root=REPO, dtype=torch.float32), **kw)
    return jax_engine, port


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _logits(rows, vocab, seed, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((rows, vocab)).astype(np.float32) * 3
    if ties:  # repeated maxima: the first one wins
        logits[:, 5] = logits[:, 17] = logits.max() + 1.0
    return logits


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_bit_equal_to_jax(engines, ties):
    jax_engine, port = engines
    logits = _logits(4, 257, 0, ties)
    keys = np.stack([jax_engine.make_key(s) for s in range(4)])
    temps = np.zeros(4, np.float32)
    top_ks = np.array([0, 1, 5, 64], np.int32)
    want, _ = jax_engine.sample(logits, keys, temps, top_ks)
    got, new_keys = port.sample(logits, np.stack([port.make_key(s) for s in range(4)]),
                                temps, top_ks)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and new_keys.dtype == np.uint32
    if ties:
        assert (got == 5).all()


def test_topk_allowed_set_equals_jax(engines):
    """The allowed set of JAX's ``sample_fn`` (engine.py:212-219, computed
    here in jnp) equals the port's, and every token either sampler draws
    lies in it."""
    jax_engine, port = engines
    logits = _logits(4, 257, 1)
    logits[2, :80] = 2.0  # a tie across the threshold
    temps = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_ks = np.array([0, 3, 50, 500], np.int32)  # 500 clips to top_k_max 64
    kmax = min(jax_engine.top_k_max, jax_engine.vocab_size)
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
    vals, _ = jax.lax.top_k(scaled, kmax)
    tk = jnp.asarray(top_ks)
    take = jnp.clip(jnp.where(tk <= 0, kmax, tk), 1, kmax)
    thresh = jnp.take_along_axis(vals, (take - 1)[:, None], axis=1)
    want = np.asarray((tk[:, None] <= 0) | (scaled >= thresh))
    got = topk_allowed(torch.from_numpy(logits) / torch.from_numpy(temps)[:, None],
                       torch.from_numpy(top_ks).long(), kmax).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[1].sum() == 3 and want[2].sum() >= 80
    jkeys = np.stack([jax_engine.make_key(s) for s in range(4)])
    pkeys = np.stack([port.make_key(s) for s in range(4)])
    for _ in range(20):
        jt, jkeys = jax_engine.sample(logits, jkeys, temps, top_ks)
        pt, pkeys = port.sample(logits, pkeys, temps, top_ks)
        for row in range(4):
            assert want[row, jt[row]] and want[row, pt[row]]


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32(tuple(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want


def test_same_key_same_draws_in_any_slot():
    """A row's draw depends on its key and logits alone: the same key in
    slot 0 of a batch of 1 and in slot 3 of a batch of 4 (beside other
    rows) gives the same token, and the same key advanced the same way
    gives the same sequence."""
    eng = _engines()[1]
    logits = _logits(4, 257, 2)
    row = logits[1]
    temps, top_ks = np.ones(4, np.float32), np.zeros(4, np.int32)
    key = eng.make_key(1234)
    keys = np.stack([eng.make_key(s) for s in (7, 8, 9)] + [key])
    batch = logits.copy()
    batch[3] = row
    alone_key, batch_keys = key[None].copy(), keys.copy()
    for _ in range(25):
        alone, alone_key = eng.sample(row[None], alone_key, temps[:1], top_ks[:1])
        toks, batch_keys = eng.sample(batch, batch_keys, temps, top_ks)
        assert alone[0] == toks[3]
    np.testing.assert_array_equal(alone_key[0], batch_keys[3])
    assert alone_key[0, 1] == 25  # the draw counter advanced once a draw
    # another seed gives another sequence of 25 draws
    other = eng.make_key(1235)[None]
    seq = []
    for _ in range(25):
        t, other = eng.sample(row[None], other, temps[:1], top_ks[:1])
        seq.append(int(t[0]))
    alone_key = key[None].copy()
    ref = []
    for _ in range(25):
        t, alone_key = eng.sample(row[None], alone_key, temps[:1], top_ks[:1])
        ref.append(int(t[0]))
    assert seq != ref


def test_draw_frequencies_follow_the_softmax():
    """Temperature 1 at V 4: 4000 draws (one key per draw) against the
    softmax, each frequency within 4.5 standard errors."""
    logits = torch.tensor([[0.0, 1.0, -0.5, 2.0]])
    n = 4000
    keys = torch.stack([torch.arange(n, dtype=torch.int64) * 7919 + 11,
                        torch.zeros(n, dtype=torch.int64)], dim=1)
    toks, new_keys = sample_tokens(logits.expand(n, -1), keys, torch.ones(n),
                                   torch.zeros(n, dtype=torch.int64), kmax=4)
    assert (new_keys[:, 1] == 1).all()
    freq = torch.bincount(toks, minlength=4).double() / n
    p = torch.softmax(logits[0].double(), -1)
    se = torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() < 4.5 * se).all(), (freq, p)
    # top-k 2 at temperature 1: only the two largest, renormalised
    toks, _ = sample_tokens(logits.expand(n, -1), keys, torch.ones(n),
                            torch.full((n,), 2, dtype=torch.int64), kmax=4)
    freq = torch.bincount(toks, minlength=4).double() / n
    p2 = torch.softmax(torch.tensor([1.0, 2.0], dtype=torch.float64), -1)
    assert freq[0] == 0 and freq[2] == 0
    assert (freq[[1, 3]] - p2).abs().max() < 4.5 * torch.sqrt(p2 * (1 - p2) / n).max()


def test_gumbel_noise_is_finite_and_standard():
    keys = torch.tensor([[3, 0], [3, 1], [0xFFFFFFFF, 0xFFFFFFFF]], dtype=torch.int64)
    g = gumbel_noise(keys, 10_001)
    assert g.shape == (3, 10_001) and torch.isfinite(g).all()
    # Gumbel(0, 1): mean ~0.5772, variance pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.03
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.1
    assert not torch.equal(g[0], g[1])  # the counter moves the stream
