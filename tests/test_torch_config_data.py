"""The port's configuration and data path against the JAX package's.

Config: ``compose_config(...).to_container()`` equals
``acco_tpu.configuration``'s for the argv cases of
tests/test_configuration.py, and the YAML-subset reader equals
``yaml.safe_load`` on every file under config/. Data: the synthetic
corpus, ``pack_const_len`` and the loader's stacked blocks equal the JAX
modules' for the same documents. All comparisons are exact.
"""

import glob
import os

import numpy as np
import pytest
import yaml

from acco_tpu import configuration as jax_configuration
from acco_tpu.data import datasets as jax_datasets
from acco_tpu.data import loader as jax_loader
from acco_tpu.data import tokenize as jax_tokenize
from acco_tpu_torch import configuration
from acco_tpu_torch.data import datasets, loader, tokenize
from acco_tpu_torch.data.tokenizer import ByteTokenizer
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(REPO, "config")
YAML_FILES = sorted(
    os.path.relpath(p, CONFIG_DIR)
    for p in glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True)
)

ARGV_CASES = [
    [],
    ["train=ddp", "data=alpaca"],
    ["train.learning_rate=1e-3", "train.batch_size=2", "seed=7", "train.eval=true"],
    ["+train.new_flag=5"],
    ["train=acco-ft"],
    ["train=dpu"],
    ["train=ddp-ft"],
    ["train=dpu-ft"],
    ["train=acco-350m-32k-v5e16"],
    ["train=acco", "model=llama-125M", "data=synthetic", "train.nb_steps_tot=6"],
    ["train.mesh_shape={dp: 2, tp: 2}", "train.scheduler_name='linear'"],
]


def _same(a, b):
    """Equal values with equal types (True is not 1, 1.0 is not 1)."""
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("argv", ARGV_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_compose_matches_jax(argv):
    got = configuration.compose_config(CONFIG_DIR, argv).to_container()
    want = jax_configuration.compose_config(CONFIG_DIR, argv).to_container()
    _same(got, want)


@pytest.mark.parametrize(
    "argv, error",
    [(["train.not_a_flag=1"], KeyError), (["train=never-heard-of-it"], FileNotFoundError)],
)
def test_compose_errors_match_jax(argv, error):
    with pytest.raises(error):
        jax_configuration.compose_config(CONFIG_DIR, argv)
    with pytest.raises(error):
        configuration.compose_config(CONFIG_DIR, argv)


@pytest.mark.parametrize("relpath", YAML_FILES)
def test_yaml_subset_reader_matches_safe_load(relpath):
    with open(os.path.join(CONFIG_DIR, relpath)) as f:
        text = f.read()
    _same(configuration.load_yaml_text(text), yaml.safe_load(text))


@pytest.mark.parametrize(
    "text", ["6e-4", "1e-3", "25.0", "0", "-3", "true", "False", "null", "'dots'", "{dp: 8}",
             "[1, 2]", "off", ".inf", "abc", "1_000"],
)
def test_scalar_typing_matches_safe_load(text):
    _same(configuration.parse_value(text), yaml.safe_load(text))


def test_synthetic_corpus_and_packing_match_jax():
    docs = datasets.synthetic_corpus(64, seed=3)
    assert docs == jax_datasets.synthetic_corpus(64, seed=3)
    tok = ByteTokenizer()
    ids = tok(docs)["input_ids"]
    np.testing.assert_array_equal(
        tokenize.pack_const_len(ids, tok.eos_token_id, 128),
        jax_tokenize.pack_const_len(ids, tok.eos_token_id, 128),
    )


def test_split_is_seeded_and_disjoint():
    docs = [f"doc {i}" for i in range(200)]
    train, test = datasets.train_eval_split(docs)
    assert len(test) == 10 and len(train) == 190
    assert sorted(train + test) == sorted(docs)
    assert datasets.train_eval_split(docs) == (train, test)


@pytest.mark.parametrize("const_len", [True, False])
def test_loader_blocks_match_jax(const_len):
    tok = ByteTokenizer()
    docs = jax_datasets.synthetic_corpus(96, seed=5)
    if const_len:
        rows = tokenize.pack_const_len(tok(docs)["input_ids"], tok.eos_token_id, 64)
    else:
        rows = tok(docs, truncation=True, max_length=64)["input_ids"]
    kw = dict(batch_size=4, max_length=64, pad_token_id=tok.pad_token_id, seed=11)
    it_t = loader.infinite_batches(loader.ShardedBatchIterator(list(rows), **kw))
    it_j = jax_loader.infinite_batches(
        jax_loader.ShardedBatchIterator([{"input_ids": r} for r in rows], **kw)
    )
    for _ in range(30):  # crosses an epoch boundary
        got = loader.stack_microbatches(it_t, 2)
        want = jax_loader.stack_microbatches(it_j, 2)
        assert set(got) == set(want) | {"valid"}
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["valid"], np.ones(2, np.float32))
