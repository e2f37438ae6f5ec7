"""Host-side batching: rank sharding, per-epoch shuffling, static shapes.

Counterpart of ``acco_tpu/data/loader.py``: :func:`shard_dataset` takes
one rank's rows (``[index::num_shards]``, as JAX's list path),
:class:`ShardedBatchIterator` yields fixed-shape
``[batch_size, max_length]`` int32 batches over them, padded with the
pad id and masked through ``attention_mask`` / ``labels == -100``,
shuffled per epoch from ``seed + epoch`` (or in order, as the eval
loader reads, with the ragged last batch kept), with ``iter_state`` /
``set_state`` for an exact resume. Rows that come as a
``native.FlatTokenDataset`` are collated by its C++ loop (JAX:
loader.py:137-147), the same batches as the Python loop here.
:func:`stack_microbatches` stacks
them into ``[n_acc, batch, seq]`` blocks with this rank's ``valid``
[n_acc] float32 column — the layout the round consumes.

The trainer shards the raw texts by the **dp index** before packing (as
JAX's trainer shards before tokenizing): the sequence ranks of one dp
group read the same rows and cut their own chunks of the sequence
(``parallel/common.prep_cp_leaves``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

IGNORE_INDEX = -100  # label value excluded from the LM loss (HF convention)


class ShardedBatchIterator:
    """Iterate fixed-shape LM batches over one rank's rows of token ids,
    ``batch_size`` of them a batch: with ``shuffle`` in a per-epoch order
    from ``seed + epoch``, else in order; with ``drop_last`` the ragged
    last batch is dropped, else it is a shorter batch."""

    def __init__(
        self,
        rows,
        batch_size: int,
        max_length: int,
        pad_token_id: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        if len(rows) == 0:
            raise ValueError("Empty dataset shard — nothing to batch")
        if drop_last and len(rows) < batch_size:
            raise ValueError(
                f"Dataset shard has {len(rows)} rows < batch_size {batch_size} with "
                "drop_last: the loader would yield zero batches and an epoch-wrapping "
                "consumer would spin forever"
            )
        self.rows = rows
        self.batch_size = batch_size
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0  # epoch the next __iter__ will run
        self._iter_epoch: Optional[int] = None  # epoch in progress
        self._pos = 0  # batches yielded (or skipped on resume) this epoch
        self._skip = 0  # batches to fast-forward at the next __iter__

    def __len__(self) -> int:
        n = len(self.rows)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def iter_state(self) -> Dict[str, int]:
        """The position of the iteration in progress: the shuffle order is
        a pure function of ``seed + epoch``, so ``(epoch, batch_pos)``
        fixes the rest of the stream. Taken between two batches it is the
        position of the last one consumed: after the last batch of an
        epoch, ``(epoch, len(self))``, which replays as "skip them all,
        the next batch opens the next epoch". Before the first batch, a
        pending fast-forward is the position."""
        if self._iter_epoch is None:
            return {"epoch": self.epoch, "batch_pos": self._skip}
        return {"epoch": self._iter_epoch, "batch_pos": self._pos}

    def set_state(self, state: Dict[str, int]) -> None:
        """Resume at a position from :meth:`iter_state`: the next
        ``__iter__`` replays that epoch's order and skips its first
        ``batch_pos`` batches."""
        self.epoch = int(state["epoch"])
        self._skip = int(state.get("batch_pos", 0))
        self._iter_epoch = None

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
        n = len(self.rows)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self._iter_epoch = self.epoch
        self._pos = 0
        skip, self._skip = self._skip, 0
        if skip > len(self):
            raise ValueError(
                f"loader resume skip ({skip}) > batches per epoch ({len(self)}): the "
                "restored position does not fit this dataset/batch_size"
            )
        self.epoch += 1
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        native = hasattr(self.rows, "collate")  # a FlatTokenDataset
        for start in range(0, end, self.batch_size):
            self._pos += 1
            if self._pos <= skip:  # resume fast-forward: the order is fixed
                continue
            idx = order[start : start + self.batch_size]
            if native:
                yield self.rows.collate(idx, self.max_length, self.pad_token_id)
            else:
                yield self._collate([self.rows[int(i)] for i in idx])


def infinite_batches(loader: ShardedBatchIterator) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-wrapping iterator."""
    while True:
        yield from loader


def shard_dataset(rows, num_shards: int, index: int):
    """Rank ``index``'s rows of ``num_shards``: ``rows[index::num_shards]``
    (a dataset with a ``shard`` method shards itself)."""
    if hasattr(rows, "shard"):
        return rows.shard(num_shards=num_shards, index=index)
    return [rows[i] for i in range(index, len(rows), num_shards)]


def stack_microbatches(
    batch_iter: Iterator[Dict[str, np.ndarray]], n: int, valid: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """Pull ``n`` batches and stack to [n, bs, L], with ``valid`` [n]: this
    rank's column of the microbatch mask, or all ones (every microbatch
    counts)."""
    batches = [next(batch_iter) for _ in range(n)]
    block = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    block["valid"] = (np.ones((n,), np.float32) if valid is None
                      else np.asarray(valid, np.float32).reshape(n))
    return block
