"""The port's text datasets (``acco_tpu_torch/data/datasets.py``) against
JAX's ``acco_tpu/data/datasets.py``: with HF ``datasets`` importable the
train/eval split is JAX's ``train_test_split`` (the same documents in the
same order); without it, the seeded permutation, logged once; a local
json file that the test writes loads through ``datasets.load_dataset``
offline, split as JAX splits it; a path that does not load falls back to
the synthetic corpus with JAX's warning. No test reaches the network: the
hub is switched off and the failing loader is a stub."""

import json
import logging

import datasets as hf_datasets
import huggingface_hub
import pytest

from acco_tpu.data import datasets as jax_datasets
from acco_tpu_torch.data import datasets
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """The hub off, and the datasets cache in the test's directory."""
    monkeypatch.setattr(hf_datasets.config, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hf_datasets.config, "HF_DATASETS_OFFLINE", True)
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hf_datasets.config, "HF_DATASETS_CACHE", tmp_path / "hf_cache")
    monkeypatch.setenv("HF_DATASETS_CACHE", str(tmp_path / "hf_cache"))


def _texts(split) -> list:
    return list(split["text"])


@pytest.mark.parametrize("num_docs, seed", [(2048, 0), (97, 5)])
def test_synthetic_split_equals_jax(num_docs, seed, offline):
    cfg = {"path": "synthetic", "synthetic_num_docs": num_docs, "synthetic_seed": seed}
    train, test = datasets.load_text_dataset(cfg)
    jtrain, jtest = jax_datasets.load_text_dataset(cfg)
    assert train == _texts(jtrain) and test == _texts(jtest)
    assert len(test) == -(-num_docs * 5 // 100)  # ceil(0.05 n)


def test_without_datasets_the_permutation_split_is_logged_once(monkeypatch, caplog):
    monkeypatch.setattr(datasets, "_hf_datasets", lambda: None)
    monkeypatch.setattr(datasets, "_warned_no_datasets", False)
    docs = [f"doc {i}" for i in range(200)]
    with caplog.at_level(logging.WARNING):
        first = datasets.train_eval_split(docs)
        second = datasets.train_eval_split(docs)
    assert first == second == datasets.permutation_split(docs)
    assert caplog.text.count("not JAX's train_test_split") == 1
    assert sorted(first[0] + first[1]) == sorted(docs) and len(first[1]) == 10


def test_local_json_loads_offline_as_jax_loads_it(tmp_path, offline):
    data = tmp_path / "corpus"
    data.mkdir()
    with open(data / "train.jsonl", "w") as f:
        for i in range(60):
            f.write(json.dumps({"text": f"local document {i}: " + "word " * (i % 7)}) + "\n")
    train, test = datasets.load_text_dataset({"path": str(data)})
    jtrain, jtest = jax_datasets.load_text_dataset({"path": str(data)})
    assert len(train) == 57 and len(test) == 3
    assert train == _texts(jtrain) and test == _texts(jtest)
    assert all(t.startswith("local document") for t in train + test)


def test_a_path_that_does_not_load_falls_back_loudly(monkeypatch, caplog):
    class NoLoad:
        Dataset = hf_datasets.Dataset

        @staticmethod
        def load_dataset(path):
            raise FileNotFoundError(f"no dataset at {path}")

    monkeypatch.setattr(datasets, "_hf_datasets", lambda: NoLoad)
    cfg = {"path": "some/corpus", "synthetic_num_docs": 40}
    with caplog.at_level(logging.WARNING):
        train, test = datasets.load_text_dataset(cfg)
    assert "FALLING BACK TO THE SYNTHETIC corpus" in caplog.text and "some/corpus" in caplog.text
    want = datasets.train_eval_split(datasets.synthetic_corpus(40, 0))
    assert (train, test) == want
