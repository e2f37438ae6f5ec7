"""The port's serving path against the JAX package's on the CPU: the paged
KV-cache ops, the models' prefill K/V, prefill + K decode steps through
``ServeEngine`` against one full JAX forward (the decode-parity anchor
of ``tests/test_serve_decode.py``, at its atol 1e-5, for both families
and both GPT-Neo lanes), the scoring lane, and the decode attention
alone. fp32 throughout; no Pallas interpreter and no JAX ServeEngine
program (JAX's model functions are jitted where they run whole)."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
import yaml

from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.serve import kv_cache as tkv
from acco_tpu_torch.serve.engine import ServeEngine

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # tests/test_serve_decode.py's bar


def _model_cfg(name):
    with open(os.path.join(REPO, "config", "model", name + ".yaml")) as f:
        return yaml.safe_load(f)


_MODELS: dict = {}


def models(name, seed=0):
    """(JAX model, its params, the port's model on the same flat params)."""
    key = (name, seed)
    if key not in _MODELS:
        from acco_tpu.models.registry import build_model as jax_build
        from acco_tpu_torch.models.registry import build_model

        jm = jax_build(_model_cfg(name), repo_root=REPO, param_dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(_model_cfg(name), repo_root=REPO, dtype=torch.float32)
        tm.load_flat(params_from_jax(jax.tree.map(np.asarray, params), tm.config))
        _MODELS[key] = (jm, params, tm)
    return _MODELS[key]


def engine_for(name, seed=0, **kw):
    jm, params, tm = models(name, seed)
    engine = ServeEngine(tm, cache_dtype="float32", **kw)
    engine.set_params(params_from_jax(jax.tree.map(np.asarray, params), tm.config))
    return engine


# -- the paged KV-cache ops, bit for bit ---------------------------------------


def _pools_and_table(seed=0):
    rng = np.random.default_rng(seed)
    n_layers, num_pages, page, hkv, d, r, pmax = 2, 12, 4, 2, 8, 3, 5
    kp = rng.standard_normal((n_layers, num_pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_layers, num_pages, page, hkv, d)).astype(np.float32)
    table = np.zeros((r, pmax), np.int32)
    table[0, :4] = [3, 7, 1, 9]
    table[1, :2] = [2, 11]
    # row 2: inactive, all null pages
    seq_lens = np.array([14, 5, 0], np.int32)
    return kp, vp, table, seq_lens


def _t(x):
    return torch.from_numpy(np.asarray(x)).long() if np.asarray(x).dtype.kind == "i" \
        else torch.from_numpy(np.array(x))


def test_gather_context_bit_equal_to_jax():
    from acco_tpu.serve import kv_cache as jkv

    kp, vp, table, _ = _pools_and_table()
    jk, jv = jkv.gather_context(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table))
    tk, tv = tkv.gather_context(_t(kp), _t(vp), _t(table))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tkv.context_positions(5, 4).numpy(),
                                  np.asarray(jkv.context_positions(5, 4)))


@pytest.mark.parametrize("window", [3, 4, 6, 9])
def test_gather_band_bit_equal_to_jax(window):
    from acco_tpu.serve import kv_cache as jkv

    kp, vp, table, seq_lens = _pools_and_table(1)
    assert tkv.band_pages(window, 4) == jkv.band_pages(window, 4)
    jk, jv, jpos = jkv.gather_band(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                                   jnp.asarray(seq_lens), window, 4)
    tk, tv, tpos = tkv.gather_band(_t(kp), _t(vp), _t(table), _t(seq_lens), window, 4)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_write_token_and_prefill_bit_equal_to_jax():
    from acco_tpu.serve import kv_cache as jkv

    kp, vp, table, seq_lens = _pools_and_table(2)
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    # the inactive row writes the null page: compare the live pages, and
    # the null page apart from the inactive slot's row
    jk, jv = jkv.write_token(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                             jnp.asarray(seq_lens), jnp.asarray(k_new), jnp.asarray(v_new))
    tk, tv = _t(kp), _t(vp)
    tkv.write_token(tk, tv, _t(table), _t(seq_lens), _t(k_new), _t(v_new))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    # a prefill bucket of 3 pages: two allocated, the tail into page 0
    page_ids = np.array([5, 8, 0], np.int32)
    kb = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    vb = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    jk, jv = jkv.write_prefill(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kb),
                               jnp.asarray(vb), jnp.asarray(page_ids))
    tk, tv = _t(kp), _t(vp)
    tkv.write_prefill(tk, tv, _t(kb), _t(vb), _t(page_ids))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_cache_spec_and_allocator_as_jax():
    from acco_tpu.serve import kv_cache as jkv

    kw = dict(n_layers=32, n_kv_heads=8, head_dim=128, page_size=16, num_pages=2048,
              max_pages_per_seq=256, dtype="bfloat16")
    js, ts = jkv.CacheSpec(**kw), tkv.CacheSpec(**kw)
    for attr in ("max_context", "page_shape", "page_bytes", "total_bytes"):
        assert getattr(ts, attr) == getattr(js, attr), attr
    assert ts.total_bytes == 4 * 2**30  # 2 MiB a page, as the config says
    assert ts.pages_for(33) == js.pages_for(33) == 3
    with pytest.raises(ValueError):
        tkv.CacheSpec(1, 1, 1, num_pages=1)
    ja, ta = jkv.PageAllocator(6), tkv.PageAllocator(6)
    assert ta.alloc(3) == ja.alloc(3) and ta.alloc(3) is None and ja.alloc(3) is None
    ta.free([1]), ja.free([1])
    assert (ta.available, ta.in_use) == (ja.available, ja.in_use)
    with pytest.raises(ValueError, match="double free"):
        ta.free([1])
    with pytest.raises(ValueError, match="invalid page"):
        ta.free([0])


# -- the decode attention and the per-row RoPE ----------------------------------


@pytest.mark.parametrize("window, scale", [(0, None), (5, 1.0)])
def test_cached_attention_matches_jax(window, scale):
    from acco_tpu.ops.attention import cached_attention as jax_cached
    from acco_tpu_torch.ops.attention import cached_attention

    rng = np.random.default_rng(4)
    R, H, Hkv, C, D = 3, 4, 2, 12, 8
    q = rng.standard_normal((R, H, 1, D)).astype(np.float32)
    kc = rng.standard_normal((R, C, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((R, C, Hkv, D)).astype(np.float32)
    kn = rng.standard_normal((R, Hkv, 1, D)).astype(np.float32)
    vn = rng.standard_normal((R, Hkv, 1, D)).astype(np.float32)
    qpos = np.array([7, 0, 11], np.int32)
    kvpos = np.arange(C, dtype=np.int32)
    want = jax_cached(*(jnp.asarray(x) for x in (q, kc, vc, kn, vn, qpos, kvpos)),
                      window=window, scale=scale)
    got = cached_attention(*(torch.from_numpy(x) for x in (q, kc, vc, kn, vn)),
                           torch.from_numpy(qpos).long(), torch.from_numpy(kvpos).long(),
                           window=window, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_apply_rope_at_matches_jax():
    from acco_tpu.models.layers import apply_rope_at as jax_rope_at
    from acco_tpu.models.layers import rope_angles as jax_angles
    from acco_tpu_torch.models.layers import apply_rope_at, rope_angles

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    pos = np.array([0, 9, 130], np.int32)
    cos, sin = rope_angles(1, 16, 10000.0, positions=torch.from_numpy(pos).long())
    assert cos.shape == (3, 8)  # per-slot angles [R, D/2]
    jcos, jsin = jax_angles(1, 16, 10000.0, positions=jnp.asarray(pos))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    got = apply_rope_at(torch.from_numpy(x), cos, sin)
    want = jax_rope_at(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# -- the models' prefill -----------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "tiny_neo"])
def test_prefill_kv_matches_jax(name):
    jm, params, tm = models(name)
    ids = np.random.default_rng(6).integers(0, jm.config.vocab_size, (1, 24)).astype(np.int32)
    jl, jk, jv = jax.jit(jm.prefill)(params, jnp.asarray(ids))
    with torch.no_grad():
        tl, tk, tv = tm.prefill(torch.from_numpy(ids).long())
    assert tk.shape == jk.shape == (tm.config.num_layers, 1, 24, tm.kv_spec()[1],
                                    tm.kv_spec()[2])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_serve_surface_refuses_a_sequence_group():
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from acco_tpu_torch.ops.ring_attention import SequenceGroup

    model = LlamaModel(LlamaConfig(vocab_size=16, hidden_size=8, intermediate_size=16,
                                   num_layers=1, num_heads=2, num_kv_heads=2),
                       dtype=torch.float32, attention="ring",
                       sequence_group=SequenceGroup(None, 1, 0))
    with pytest.raises(ValueError, match="single-replica"):
        model.prefill(torch.zeros((1, 4), dtype=torch.long))


# -- prefill + K decode steps against one full JAX forward ------------------------


def _parity_case(name, *, n_prompt, n_decode, page_size, max_pages_per_seq, seed=0,
                 want_band=None):
    """tests/test_serve_decode.py's ``_parity_case`` through the port's
    engine: one request in slot 0 with every page preallocated; every
    emitted logits row against one uncached JAX forward over N+K."""
    jm, params, _ = models(name, seed)
    total = n_prompt + n_decode
    ids = np.random.default_rng(seed).integers(0, jm.config.vocab_size,
                                                size=(1, total)).astype(np.int32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))  # [1, total, V]
    engine = engine_for(name, seed, page_size=page_size,
                        num_pages=max_pages_per_seq * 2 + 2,
                        max_pages_per_seq=max_pages_per_seq, max_slots=2)
    if want_band is not None:
        assert engine._use_band is want_band
    assert total <= engine.max_context
    n_pages = -(-total // page_size)
    pages = list(range(1, n_pages + 1))
    last = engine.prefill(list(ids[0, :n_prompt]), pages[: -(-n_prompt // page_size)])
    np.testing.assert_allclose(last, ref[0, n_prompt - 1], atol=ATOL, rtol=0)
    page_table = np.zeros((2, max_pages_per_seq), np.int32)
    page_table[0, : len(pages)] = pages
    for t in range(n_decode):
        logits = engine.decode(page_table, np.array([n_prompt + t, 0], np.int32),
                               np.array([ids[0, n_prompt + t], 0], np.int32))
        np.testing.assert_allclose(logits[0], ref[0, n_prompt + t], atol=ATOL, rtol=0,
                                   err_msg=f"decode step {t} (position {n_prompt + t})")
    assert engine.counters == {"prefills": 1, "decode_steps": n_decode}


def test_llama_decode_parity():
    # the prompt off the page boundary: the prefill's garbage tail in its
    # last page stays masked until decode overwrites each row
    _parity_case("tiny", n_prompt=13, n_decode=7, page_size=4, max_pages_per_seq=8)


def test_gptneo_decode_parity_band_lane():
    # window 16, page 4: a band of 5 pages < a table of 8 — the local layers
    # read the band, and the sequence crosses the window
    _parity_case("tiny_neo", n_prompt=20, n_decode=12, page_size=4, max_pages_per_seq=8,
                 want_band=True)


def test_gptneo_decode_parity_full_context_lane():
    # page 16: band_pages(16, 16) = 2, not narrower than the table of 2
    _parity_case("tiny_neo", n_prompt=9, n_decode=8, page_size=16, max_pages_per_seq=2,
                 want_band=False)


def test_score_nll_matches_jax_token_nll():
    from acco_tpu.ops.losses import token_nll

    jm, params, _ = models("tiny", 3)
    ids = np.random.default_rng(3).integers(0, jm.config.vocab_size, size=13).astype(np.int32)
    engine = engine_for("tiny", 3, page_size=4, num_pages=2, max_pages_per_seq=8, max_slots=1)
    nll_sum, n_tok = engine.score_nll(list(ids))
    logits = jax.jit(jm.apply)(params, jnp.asarray(ids[None, :]))
    nll, mask = token_nll(logits, jnp.asarray(ids[None, :]))
    assert n_tok == int(mask.sum())
    np.testing.assert_allclose(nll_sum, float(nll.sum()), rtol=1e-5)
    # scoring never touched the pool
    assert engine._k_pages is None and engine.counters["prefills"] == 0


def test_engine_checks_as_jax():
    _, _, tm = models("tiny")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ServeEngine(tm, page_size=16, max_pages_per_seq=16)  # 256 > 128
    with pytest.raises(ValueError, match="multiple of page_size"):
        ServeEngine(tm, page_size=8, max_pages_per_seq=4, buckets=[12])
    eng = ServeEngine(tm, page_size=8, max_pages_per_seq=4, buckets=[8])
    assert eng.buckets == [8, 32]  # the top bucket reaches max_context
    assert eng.bucket_for(9) == 32
    with pytest.raises(ValueError, match="exceeds the largest"):
        eng.bucket_for(33)
    with pytest.raises(RuntimeError, match="set_params"):
        eng.prefill([1, 2], [1])
    with pytest.raises(ValueError, match="wrong model"):
        eng.set_params(np.zeros(3, np.float32))
    assert not eng.capture_on  # the CPU: decode runs eagerly
    assert eng.start_warmup() == {} and eng._graph is None
