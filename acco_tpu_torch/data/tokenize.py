"""Const-len packing for pretraining (``const_len_batch: True``).

Counterpart of ``acco_tpu/data/tokenize.py``: append EOS to every
document, concatenate, and slice into ``[n, context_length]`` rows,
dropping the remainder. Packed rows carry no padding.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pack_const_len(
    docs_token_ids: Sequence[Sequence[int]],
    eos_token_id: int,
    context_length: int,
) -> np.ndarray:
    """EOS-join ``docs_token_ids`` and reshape into [n, context_length]."""
    if context_length <= 0:
        raise ValueError(f"context_length must be positive, got {context_length}")
    chunks = []
    for ids in docs_token_ids:
        chunks.append(np.asarray(ids, dtype=np.int32))
        chunks.append(np.asarray([eos_token_id], dtype=np.int32))
    concat = np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)
    n_rows = len(concat) // context_length
    return concat[: n_rows * context_length].reshape(n_rows, context_length)
