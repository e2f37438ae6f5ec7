"""Native (C++) host-side data path, loaded with ctypes.

Counterpart of ``acco_tpu/native/__init__.py``: ``collate.cpp`` (a copy
of the JAX package's) is built with ``g++`` at first use into ``build/``
at the root of the checkout, as ``utils/cuda_build.py`` builds the CUDA
sources (the file name carries a hash of the source and the flags), and
:class:`FlatTokenDataset` exposes it to numpy. Every entry point has a
numpy fallback with the same results, taken with a warning where the
library cannot be built or loaded; ``native_data: false`` in the train
config keeps the trainer off this path altogether.

:data:`CALLS` counts the calls into the library, so a run can show that
its batches were collated natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "collate.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
IGNORE_INDEX = -100

# calls into the native library since the last reset (the numpy fallback
# is not counted)
CALLS = {"collate_batch": 0, "pack_const_len": 0}
# the g++ build this process made, if it made one: {"path", "seconds"}
BUILD_INFO: dict = {}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


def _so_path() -> Path:
    from acco_tpu_torch.utils.cuda_build import BUILD_DIR

    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"collate-{digest[:16]}.so"


def _build() -> Optional[Path]:
    so = _so_path()
    if so.exists():
        return so
    # a pid-unique temporary name: concurrent builders (pytest-xdist,
    # several ranks) must not interleave g++ output into one file, and
    # os.replace is atomic
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0)
        return so
    except Exception as exc:  # no toolchain, read-only tree: numpy fallback
        log.warning("native collate build failed (%s); using numpy path", exc)
        try:
            tmp.unlink()
        except OSError:
            pass
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        so = _build()
        if so is None:
            _LIB_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:  # a corrupt or foreign build: numpy fallback
            log.warning("native collate load failed (%s); using numpy path", exc)
            _LIB_FAILED = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.collate_batch.argtypes = [
            i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
        ]
        lib.collate_batch.restype = None
        lib.pack_const_len.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p,
        ]
        lib.pack_const_len.restype = ctypes.c_int64
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _lib() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class FlatTokenDataset:
    """A tokenized corpus as one flat int32 buffer and int64 row offsets:
    the layout the native loops work on, and an ordinary
    ``__len__``/``__getitem__`` dataset of ``{"input_ids": row}``."""

    def __init__(self, flat: np.ndarray, offsets: np.ndarray) -> None:
        self.flat = np.ascontiguousarray(flat, dtype=np.int32)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if self.offsets.ndim != 1 or self.offsets[0] != 0:
            raise ValueError("offsets must be 1-D starting at 0")
        if self.offsets[-1] != self.flat.size:
            raise ValueError("offsets[-1] must equal flat.size")

    @classmethod
    def from_rows(cls, rows: Sequence[Sequence[int]]) -> "FlatTokenDataset":
        lens = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        flat = np.empty(int(offsets[-1]), np.int32)
        for i, r in enumerate(rows):
            flat[offsets[i] : offsets[i + 1]] = r
        return cls(flat, offsets)

    @classmethod
    def from_dataset(cls, dataset, column: str = "input_ids") -> "FlatTokenDataset":
        """From an HF dataset (or a list of dicts) with an ``input_ids``
        column."""
        if hasattr(dataset, "column_names"):
            rows = dataset[column]
        else:
            rows = [row[column] for row in dataset]
        return cls.from_rows(rows)

    @classmethod
    def from_packed(cls, packed: np.ndarray) -> "FlatTokenDataset":
        """From [n_rows, ctx_len] packed rows, without a copy."""
        n, ctx = packed.shape
        return cls(packed.reshape(-1), np.arange(n + 1, dtype=np.int64) * ctx)

    @property
    def column_names(self) -> list:
        return ["input_ids"]

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def min_row_len(self) -> int:
        """The shortest row's length, from the offsets."""
        if len(self.offsets) < 2:
            return 0
        return int(np.diff(self.offsets).min())

    def __getitem__(self, i: int) -> dict:
        return {"input_ids": self.flat[self.offsets[i] : self.offsets[i + 1]]}

    def shard(self, num_shards: int, index: int) -> "FlatTokenDataset":
        """Rows ``index::num_shards`` (``datasets.Dataset.shard``'s
        contiguous=False split)."""
        rows = [
            self.flat[self.offsets[i] : self.offsets[i + 1]]
            for i in range(index, len(self), num_shards)
        ]
        return FlatTokenDataset.from_rows(rows)

    # -- native loops ------------------------------------------------------

    def collate(self, idx: np.ndarray, max_len: int, pad_id: int) -> dict:
        """``input_ids``, ``attention_mask``, ``labels`` [len(idx), max_len]
        int32: each row truncated to ``max_len``, the tail ``pad_id`` with
        mask 0 and label -100."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        n = idx.size
        ids = np.empty((n, max_len), np.int32)
        am = np.empty((n, max_len), np.int32)
        labels = np.empty((n, max_len), np.int32)
        lib = _lib()
        if lib is not None:
            lib.collate_batch(
                _ptr(self.flat, ctypes.c_int32), _ptr(self.offsets, ctypes.c_int64),
                _ptr(idx, ctypes.c_int64), n, max_len, pad_id, IGNORE_INDEX,
                _ptr(ids, ctypes.c_int32), _ptr(am, ctypes.c_int32),
                _ptr(labels, ctypes.c_int32),
            )
            CALLS["collate_batch"] += 1
            return {"input_ids": ids, "attention_mask": am, "labels": labels}
        ids[:] = pad_id
        am[:] = 0
        labels[:] = IGNORE_INDEX
        for r, row in enumerate(idx):
            seg = self.flat[self.offsets[row] : self.offsets[row + 1]][:max_len]
            ids[r, : seg.size] = seg
            am[r, : seg.size] = 1
            labels[r, : seg.size] = seg
        return {"input_ids": ids, "attention_mask": am, "labels": labels}

    def pack_const_len(self, ctx_len: int, eos_id: int) -> np.ndarray:
        """EOS after every row, the rows joined and cut into [n_rows,
        ctx_len] int32, the remainder dropped."""
        total = int((self.flat.size + len(self)) // ctx_len * ctx_len)
        out = np.empty(total, np.int32)
        lib = _lib()
        if lib is not None:
            n_rows = lib.pack_const_len(
                _ptr(self.flat, ctypes.c_int32), _ptr(self.offsets, ctypes.c_int64),
                len(self), ctx_len, eos_id, _ptr(out, ctypes.c_int32),
            )
            CALLS["pack_const_len"] += 1
            return out[: n_rows * ctx_len].reshape(n_rows, ctx_len)
        pieces = []
        for i in range(len(self)):
            pieces.append(self.flat[self.offsets[i] : self.offsets[i + 1]])
            pieces.append(np.asarray([eos_id], np.int32))
        concat = np.concatenate(pieces) if pieces else np.zeros((0,), np.int32)
        n_rows = concat.size // ctx_len
        return concat[: n_rows * ctx_len].reshape(n_rows, ctx_len)
