"""Host-side batching into the round's microbatch blocks.

Counterpart of ``acco_tpu/data/loader.py`` (its ``ShardedBatchIterator``
becomes :class:`BatchIterator`): fixed-shape
``[batch_size, max_length]`` int32 batches, padded with the pad id and
masked through ``attention_mask`` / ``labels == -100``, shuffled per
epoch from ``seed + epoch``, and stacked into ``[n_acc, batch, seq]``
blocks with a ``valid`` [n_acc] float32 mask — the layout the round
consumes. One process, one rank: rank sharding comes with the multi-rank
slice.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

IGNORE_INDEX = -100  # label value excluded from the LM loss (HF convention)


class BatchIterator:
    """Iterate fixed-shape LM batches over a dataset of token-id rows."""

    def __init__(
        self,
        rows,
        batch_size: int,
        max_length: int,
        pad_token_id: int,
        seed: int = 0,
    ) -> None:
        if len(rows) == 0:
            raise ValueError("Empty dataset shard — nothing to batch")
        if len(rows) < batch_size:
            raise ValueError(
                f"Dataset has {len(rows)} rows < batch_size {batch_size}: the "
                "loader (which drops the ragged last batch) would yield none"
            )
        self.rows = rows
        self.batch_size = batch_size
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.rows) // self.batch_size

    def _collate(self, rows: list) -> Dict[str, np.ndarray]:
        bs, L = len(rows), self.max_length
        input_ids = np.full((bs, L), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((bs, L), dtype=np.int32)
        labels = np.full((bs, L), IGNORE_INDEX, dtype=np.int32)
        for i, row in enumerate(rows):
            ids = np.asarray(row, dtype=np.int32)[:L]
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
            labels[i, : len(ids)] = ids
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.rows))
        np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield self._collate([self.rows[int(i)] for i in idx])


def infinite_batches(loader: BatchIterator) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-wrapping iterator."""
    while True:
        yield from loader


def stack_microbatches(
    batch_iter: Iterator[Dict[str, np.ndarray]], n: int
) -> Dict[str, np.ndarray]:
    """Pull ``n`` batches and stack to [n, bs, L], with ``valid`` [n]
    all ones (every microbatch counts)."""
    batches = [next(batch_iter) for _ in range(n)]
    block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    block["valid"] = np.ones((n,), np.float32)
    return block
