"""Text datasets: a local or hub dataset, the synthetic corpus, and the
train/eval split.

Counterpart of ``acco_tpu/data/datasets.py``. Where HF ``datasets`` is
importable, the split is JAX's: ``train_test_split(test_size=0.05,
seed=42)`` on a ``Dataset`` of the documents (the synthetic corpus built
in memory, no download), so both packages train and evaluate on the same
documents in the same order. Where it is not installed, the split is a
seeded numpy permutation with the same test fraction, which picks other
documents; that is logged once.

A ``data.path`` other than ``synthetic`` goes to
``datasets.load_dataset(path)`` (a local json/text/csv file or directory,
or a dataset already in the HF cache; nothing here asks for a download),
and on any failure the run falls back to the synthetic corpus with a loud
warning, as JAX's does. Texts come back as lists of strings (the ``text``
column).
"""

from __future__ import annotations

import logging

import numpy as np

_module_log = logging.getLogger(__name__)
_warned_no_datasets = False

_WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "or his from at which but have an had they you were their one all we can "
    "her has there been if more when will would who so no out up into time "
    "model tensor gradient optimizer shard device mesh collective overlap "
    "communication accumulate while you communicate train loss step epoch"
).split()


def synthetic_corpus(num_docs: int, seed: int = 0) -> list[str]:
    """Deterministic pseudo-English corpus for offline runs."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(num_docs):
        n_words = int(rng.integers(16, 256))
        words = rng.choice(len(_WORDS), size=n_words)
        docs.append(" ".join(_WORDS[w] for w in words))
    return docs


def _hf_datasets():
    """The ``datasets`` module, or None where it is not installed."""
    try:
        import datasets
    except ImportError:
        return None
    return datasets


def permutation_split(
    docs: list, test_size: float = 0.05, seed: int = 42
) -> tuple[list, list]:
    """Seeded permutation split: ``ceil(test_size * n)`` documents to eval,
    the rest to train, each in permuted order (the split where
    ``datasets`` is missing)."""
    n = len(docs)
    n_test = int(np.ceil(test_size * n))
    order = np.random.default_rng(seed).permutation(n)
    return [docs[i] for i in order[n_test:]], [docs[i] for i in order[:n_test]]


def train_eval_split(
    docs: list, test_size: float = 0.05, seed: int = 42, log=None
) -> tuple[list, list]:
    """``(train, eval)`` texts: HF's ``train_test_split`` on an in-memory
    ``Dataset`` (JAX's split) where ``datasets`` is importable, else
    :func:`permutation_split`, logged once."""
    global _warned_no_datasets
    hf = _hf_datasets()
    if hf is None:
        if not _warned_no_datasets:
            _warned_no_datasets = True
            (log or _module_log).warning(
                "HF datasets is not installed: the train/eval split is a seeded numpy "
                "permutation, not JAX's train_test_split (other documents)")
        return permutation_split(docs, test_size, seed)
    split = hf.Dataset.from_dict({"text": list(docs)}).train_test_split(
        test_size=test_size, seed=seed)
    return list(split["train"]["text"]), list(split["test"]["text"])


def load_text_dataset(data_cfg, test_size: float = 0.05, seed: int = 42, log=None):
    """``(train_texts, eval_texts)`` for a ``config/data`` node (or a path)."""
    path = data_cfg["path"] if isinstance(data_cfg, dict) else data_cfg
    cfg = data_cfg if isinstance(data_cfg, dict) else {}
    if path != "synthetic":
        hf = _hf_datasets()
        try:
            if hf is None:
                raise ImportError("HF datasets is not installed")
            ds = hf.load_dataset(path)["train"]
            split = ds.train_test_split(test_size=test_size, seed=seed)
            return list(split["train"]["text"]), list(split["test"]["text"])
        except Exception as exc:
            # loud: a run that silently trains on word salad would be worse
            (log or _module_log).warning(
                "Could not load dataset %r (%s: %s); FALLING BACK TO THE "
                "SYNTHETIC corpus — results will not reflect %r",
                path, type(exc).__name__, exc, path,
            )
    docs = synthetic_corpus(
        int(cfg.get("synthetic_num_docs", 2048)), int(cfg.get("synthetic_seed", 0))
    )
    return train_eval_split(docs, test_size, seed, log)
