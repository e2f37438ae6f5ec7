"""Text datasets: the synthetic corpus and a seeded train/eval split.

Counterpart of ``acco_tpu/data/datasets.py`` for ``data=synthetic``.
The split differs from the JAX package's on purpose: that one calls HF
``datasets``' ``train_test_split(test_size=0.05, seed=42)``, which the
machine with the card does not have, so this one takes a seeded numpy
permutation with the same test fraction. The two pick different
documents (split parity: ROADMAP.md queue 1, item 2). Hub datasets are
not loaded here at all.
"""

from __future__ import annotations

import numpy as np

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


def train_eval_split(
    docs: list, test_size: float = 0.05, seed: int = 42
) -> tuple[list, list]:
    """Seeded permutation split: ``ceil(test_size * n)`` documents to eval,
    the rest to train, each in permuted order."""
    n = len(docs)
    n_test = int(np.ceil(test_size * n))
    order = np.random.default_rng(seed).permutation(n)
    return [docs[i] for i in order[n_test:]], [docs[i] for i in order[:n_test]]


def load_text_dataset(data_cfg, test_size: float = 0.05, seed: int = 42):
    """``(train_texts, eval_texts)`` for a ``config/data`` node."""
    path = data_cfg["path"] if isinstance(data_cfg, dict) else data_cfg
    if path != "synthetic":
        raise NotImplementedError(
            f"data path {path!r}: HF hub datasets are not ported yet "
            "(ROADMAP.md queue 1, item 2); use data=synthetic"
        )
    cfg = data_cfg if isinstance(data_cfg, dict) else {}
    docs = synthetic_corpus(
        int(cfg.get("synthetic_num_docs", 2048)), int(cfg.get("synthetic_seed", 0))
    )
    return train_eval_split(docs, test_size, seed)
