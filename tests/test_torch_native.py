"""The port's native (C++) data path, ``acco_tpu_torch/native``, the
counterpart of ``tests/test_native.py:22-95``: the C++ loops equal their
numpy fallback, which equals JAX's ``FlatTokenDataset`` and the port's
Python paths (``data/loader.py``'s collate, ``data/tokenize.py``'s
packing); the library is built into ``build/``, not beside the source;
the trainer's rows go through it unless ``native_data: false``."""

import numpy as np
import pytest

import acco_tpu.native as jax_native
import acco_tpu_torch.native as native
from acco_tpu_torch.data.loader import ShardedBatchIterator
from acco_tpu_torch.data.tokenize import pack_const_len as py_pack
from acco_tpu_torch.native import FlatTokenDataset
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


def _rows(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=int(rng.integers(1, 40))).tolist() for _ in range(n)]


@pytest.fixture
def fallback(monkeypatch):
    """The numpy path: the library taken as failed to build."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", True)


def test_native_builds_into_build_dir():
    assert native.native_available()
    so = native._so_path()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent == native.SOURCE.parents[2]  # the checkout's root
    assert not list(native.SOURCE.parent.glob("*.so"))  # nothing beside the source


def test_flat_dataset_roundtrip():
    rows = _rows()
    ds = FlatTokenDataset.from_rows(rows)
    assert len(ds) == len(rows)
    for i in (0, 7, len(rows) - 1):
        np.testing.assert_array_equal(ds[i]["input_ids"], rows[i])


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_collate_matches_python_iterator_and_jax(path, request):
    """Every batch of two shuffled epochs: the port's native (or numpy)
    collate, the port's Python loop and JAX's ``FlatTokenDataset``."""
    if path == "fallback":
        request.getfixturevalue("fallback")
    rows = _rows()
    kw = dict(batch_size=8, max_length=16, pad_token_id=0, shuffle=True, seed=3)
    flat = ShardedBatchIterator(FlatTokenDataset.from_rows(rows), **kw)
    plain = ShardedBatchIterator(rows, **kw)
    jflat = jax_native.FlatTokenDataset.from_rows(rows)
    before = dict(native.CALLS)
    for epoch in range(2):
        for got, want in zip(flat, plain):
            for key in ("input_ids", "attention_mask", "labels"):
                np.testing.assert_array_equal(got[key], want[key])
        idx = np.asarray([3, 0, 11, 11, 49])
        jb = jflat.collate(idx, 16, pad_id=0)
        pb = flat.rows.collate(idx, 16, pad_id=0)
        for key in jb:
            np.testing.assert_array_equal(pb[key], jb[key])
    n_native = native.CALLS["collate_batch"] - before["collate_batch"]
    assert n_native == (2 * (len(flat) + 1) if path == "native" else 0)


def test_collate_native_equals_fallback(monkeypatch):
    ds = FlatTokenDataset.from_rows(_rows(seed=5))
    idx = np.asarray([3, 0, 11, 11, 49])
    out_native = ds.collate(idx, 24, pad_id=7)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", True)
    out_py = ds.collate(idx, 24, pad_id=7)
    for key in out_native:
        np.testing.assert_array_equal(out_native[key], out_py[key])


@pytest.mark.parametrize("path", ["native", "fallback"])
def test_pack_const_len_matches_python_and_jax(path, request):
    if path == "fallback":
        request.getfixturevalue("fallback")
    rows = _rows(seed=9)
    out = FlatTokenDataset.from_rows(rows).pack_const_len(13, eos_id=1000)
    np.testing.assert_array_equal(out, py_pack(rows, eos_token_id=1000, context_length=13))
    jax_out = jax_native.FlatTokenDataset.from_rows(rows).pack_const_len(13, eos_id=1000)
    np.testing.assert_array_equal(out, jax_out)
    packed = FlatTokenDataset.from_packed(out)
    assert len(packed) == out.shape[0] and packed.min_row_len() == 13
    np.testing.assert_array_equal(packed[2]["input_ids"], out[2])


def test_shard_parity():
    rows = _rows(seed=13)
    shard = FlatTokenDataset.from_rows(rows).shard(4, 1)
    expect = [rows[i] for i in range(1, len(rows), 4)]
    assert len(shard) == len(expect)
    for i, e in enumerate(expect):
        np.testing.assert_array_equal(shard[i]["input_ids"], e)
    jshard = jax_native.FlatTokenDataset.from_rows(rows).shard(4, 1)
    np.testing.assert_array_equal(shard.flat, jshard.flat)
    np.testing.assert_array_equal(shard.offsets, jshard.offsets)


def test_min_row_len():
    ds = FlatTokenDataset.from_rows([[1, 2, 3], [4, 5], [6, 7, 8, 9]])
    assert ds.min_row_len() == 2
    assert FlatTokenDataset.from_rows([[1]]).min_row_len() == 1


def test_failed_build_warns_and_falls_back(monkeypatch, caplog, tmp_path):
    """No compiler: JAX's warning, then the numpy path's results."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", False)
    monkeypatch.setattr(native, "_so_path", lambda: tmp_path / "collate-none.so")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    ds = FlatTokenDataset.from_rows(_rows(seed=2))
    with caplog.at_level("WARNING"):
        out = ds.pack_const_len(8, eos_id=999)
    assert "native collate build failed" in caplog.text and "using numpy path" in caplog.text
    monkeypatch.setattr(native, "_LIB_FAILED", True)
    np.testing.assert_array_equal(out, ds.pack_const_len(8, eos_id=999))


@pytest.mark.parametrize("const_len", [True, False])
def test_trainer_rows_native_or_python(const_len, tmp_path):
    """The trainer packs (or truncates) into a ``FlatTokenDataset`` by
    default, Python rows with ``native_data: false``: the same batches."""
    import torch

    from acco_tpu_torch.configuration import ConfigNode
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from acco_tpu_torch.trainer import Trainer

    texts = ["".join(np.random.default_rng(i).choice(list("abcdefgh "), 40 + 9 * i))
             for i in range(9)]

    def trainer(native_data):
        args = ConfigNode.wrap(dict(batch_size=2, max_length=32, const_len_batch=const_len,
                                    native_data=native_data, save=False))
        model = LlamaModel(LlamaConfig(vocab_size=257, hidden_size=16, intermediate_size=16,
                                       num_layers=1, num_heads=2, num_kv_heads=2,
                                       max_position_embeddings=32), dtype=torch.float32)
        return Trainer(model, load_tokenizer("byte"), texts, None, args, seed=1,
                       run_dir=str(tmp_path))

    nat, py = trainer(True), trainer(False)
    assert isinstance(nat.loader.rows, FlatTokenDataset)
    assert not isinstance(py.loader.rows, FlatTokenDataset)
    assert len(nat.loader) == len(py.loader) > 0
    for got, want in zip(nat.loader, py.loader):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
