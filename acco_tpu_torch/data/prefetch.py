"""The input pipeline off the round: blocks collated and copied to the
card on a worker thread, ahead of the round that reads them.

Counterpart of ``acco_tpu/data/prefetch.py``. Without it every round
starts with its block built in numpy on the host and four blocking
pageable ``.to(device)`` copies, and a pageable copy waits for the
stream to drain: the host stops while the card finishes the last round,
then the card waits while the host builds the next block. Here a worker
pulls the loader's batches, stacks the block and puts it on the device
into a bounded queue, so round N+1's block is on the card while round N
runs.

:class:`AsyncPrefetcher` is JAX's: a bounded queue, a stop-aware timed
put, the worker's exceptions raised on the consumer, and a ``close()``
that never deadlocks against a worker blocked on a full queue.
:class:`PrefetchingBlockSource` keeps JAX's two invariants:

- **exact resume**: :meth:`PrefetchingBlockSource.iter_state` is the
  loader position of the last *consumed* block, never of the last
  prefetched one, so a checkpoint taken with blocks in the queue resumes
  by collating those blocks again (the shuffle order is a function of
  seed and epoch);
- ``prefetch=False`` runs the same interface synchronously, with the
  same blocks.

The CUDA part is new (:class:`PinnedBlockCopy`). The worker pins the
block (a copy from pageable memory is synchronous even when asked not
to block), issues the four host-to-device copies with
``non_blocking=True`` on a copy stream of its own and records an event
after them. The consumer makes its current stream wait on that event
before anything reads the block, and marks each tensor with
``record_stream`` for the current stream: the tensors come from the copy
stream's pool, and freed they go back to it only once the current
stream is past its reads. ACCO's comm stream reads nothing of the block
(the round's loss count, ``mean_loss(loss_wsum, block.valid)``, runs in
the compute branch on the current stream; the comm branch reads the
state's ``pending_count``), so no other stream is marked. The current
device and stream are per thread: the worker sets its device and enters
its stream inside the thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from acco_tpu_torch.data.loader import infinite_batches, stack_microbatches
from acco_tpu_torch.parallel.common import MicrobatchBlock


class _Sentinel:
    def __init__(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<prefetch {self.name}>"


_DONE = _Sentinel("done")
_ERROR = _Sentinel("error")


class AsyncPrefetcher:
    """Run an iterator on a background thread into a bounded queue.

    ``depth`` bounds how far the producer runs ahead of the consumer (at
    most ``depth`` items' host and device buffers alive beyond the one
    being consumed). The thread is a daemon and stop-aware: ``close()``
    wakes a put blocked on a full queue and joins the thread.
    """

    def __init__(self, items: Iterable[Any], depth: int = 2,
                 name: str = "acco-prefetch") -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(iter(items),), name=name,
                                        daemon=True)
        self._thread.start()

    # -- producer side --------------------------------------------------------

    def _run(self, it: Iterator[Any]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return  # closed while producing
            self._put(_DONE)
        except BaseException as exc:  # noqa: BLE001 — must cross the thread
            self._error = exc
            self._put(_ERROR)

    def _put(self, item: Any) -> bool:
        """Stop-aware bounded put: never deadlocks against close()."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side --------------------------------------------------------

    def __iter__(self) -> "AsyncPrefetcher":
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise RuntimeError("prefetcher is closed")
        while True:
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    # the worker ended without queueing its sentinel:
                    # surface whatever it recorded
                    if self._error is not None:
                        raise self._error
                    raise RuntimeError("prefetch worker exited without a result")
                continue
            if item is _DONE:
                raise StopIteration
            if item is _ERROR:
                assert self._error is not None
                raise self._error
            return item

    def close(self, join_timeout: float = 10.0) -> None:
        """Stop the worker and join it; safe to call more than once."""
        self._stop.set()
        # join before draining: the timed put notices the stop within
        # 50 ms, whereas draining first would free a slot and let the
        # worker make one more block after close() was asked
        self._thread.join(timeout=join_timeout)
        while True:  # free the queued blocks' buffers
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def __enter__(self) -> "AsyncPrefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class PinnedBlockCopy:
    """``put`` (on the worker): a numpy block (``stack_microbatches``'s
    dict, or a loader batch) into pinned host tensors of the round's
    dtypes, copied to ``device`` on this object's copy stream, with an
    event after the copies; ``take`` (on the consumer): the current
    stream waits on the event and each tensor is marked in use by it.
    ``dtypes`` maps each key to its device dtype, in order."""

    def __init__(self, device, dtypes: Optional[Dict[str, torch.dtype]] = None) -> None:
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedBlockCopy needs a CUDA device, got {self.device}")
        self.dtypes = dict(dtypes if dtypes is not None else BLOCK_DTYPES)
        self.stream: Optional[torch.cuda.Stream] = None

    def put(self, host: Dict[str, np.ndarray]):
        if self.stream is None:  # the first call, on the worker thread
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(device=self.device)
        pinned = []
        for key, dtype in self.dtypes.items():
            arr = host[key]
            t = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            pinned.append(t)
        with torch.cuda.stream(self.stream):
            out = [t.to(self.device, non_blocking=True) for t in pinned]
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, item) -> list:
        tensors, ready = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for t in tensors:
            t.record_stream(stream)
        return tensors


# the round's dtypes, in MicrobatchBlock's order (parallel.common.block_from_numpy)
BLOCK_DTYPES = {"input_ids": torch.long, "attention_mask": torch.int32,
                "labels": torch.long, "valid": torch.float32}


class PrefetchingBlockSource:
    """Device blocks, prefetched ahead of the round.

    Wraps a ``data.loader.ShardedBatchIterator``: the worker pulls
    ``n_acc`` batches a block through ``stack_microbatches`` (with this
    rank's ``valid`` column) and runs ``put_block`` on them before
    queueing; the consumer's :meth:`next_block` runs ``take_block`` (the
    identity by default) on what comes out. With ``prefetch=False`` both
    run on the consumer, in turn, with no thread: the same blocks, the
    same ``iter_state``.

    ``last_wait_ms`` is how long the consumer waited for its last block
    (about 0 when the worker ran ahead), ``wait_ms`` every block's wait.
    ``copier``: the :class:`PinnedBlockCopy` behind ``put_block``, whose
    stream :attr:`copy_stream` names (the profile reader's copy side).
    """

    def __init__(
        self,
        loader,
        n_acc: int,
        put_block: Callable[[Dict[str, Any]], Any],
        depth: int = 2,
        prefetch: bool = True,
        valid: Optional[np.ndarray] = None,
        take_block: Optional[Callable[[Any], Any]] = None,
        copier: Optional["PinnedBlockCopy"] = None,
    ) -> None:
        self._loader = loader
        self._copier = copier
        self._n_acc = int(n_acc)
        self._valid = valid
        self._put_block = put_block
        self._take_block = take_block
        # the position of the last consumed block: the loader's current
        # (perhaps just restored) one before the first, so that a
        # checkpoint written then resumes where this run began
        self._consumed_state: Dict[str, int] = dict(loader.iter_state())
        self.last_wait_ms = 0.0
        self.wait_ms: list = []
        self._prefetch = bool(prefetch) and depth > 0
        if self._prefetch:
            self._worker: Optional[AsyncPrefetcher] = AsyncPrefetcher(self._produce(),
                                                                      depth=depth)
            self._stream = None
        else:
            self._worker = None
            self._stream = infinite_batches(loader)

    def _produce(self) -> Iterator[tuple]:
        stream = infinite_batches(self._loader)
        while True:
            stacked = stack_microbatches(stream, self._n_acc, self._valid)
            # the position after this block's batches: once the consumer
            # takes the block, its resume point
            state = dict(self._loader.iter_state())
            yield self._put_block(stacked), state

    def next_block(self) -> Any:
        t0 = time.perf_counter()
        if self._worker is not None:
            item, state = next(self._worker)
            self._consumed_state = state
        else:
            stacked = stack_microbatches(self._stream, self._n_acc, self._valid)
            self._consumed_state = dict(self._loader.iter_state())
            item = self._put_block(stacked)
        block = item if self._take_block is None else self._take_block(item)
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        self.wait_ms.append(self.last_wait_ms)
        return block

    @property
    def copy_stream(self):
        """The worker's copy stream (None before its first block, off a
        card, or with the prefetch off)."""
        return None if self._copier is None else self._copier.stream

    def median_wait_ms(self) -> float:
        """The median of the consumer's waits for its blocks (the first
        block's includes the worker's start)."""
        return float(np.median(self.wait_ms)) if self.wait_ms else 0.0

    def iter_state(self) -> Dict[str, int]:
        """The loader position of the last consumed block (blocks waiting
        in the queue are not counted: a restored run collates them
        again)."""
        return dict(self._consumed_state)

    def close(self) -> None:
        if self._worker is not None:
            self._worker.close()

    def __enter__(self) -> "PrefetchingBlockSource":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def block_copier(device, prefetch: bool = True):
    """``(put, take, copier)`` that bring a numpy block to ``device`` as a
    ``MicrobatchBlock``: on a card with the prefetch on, pinned copies on a
    copy stream (``copier``, a :class:`PinnedBlockCopy`; ``put`` on the
    worker, ``take`` on the consumer); otherwise ``block_from_numpy`` and
    no ``take`` or ``copier`` (None)."""
    from acco_tpu_torch.parallel.common import block_from_numpy

    device = torch.device(device)
    if prefetch and device.type == "cuda":
        pinned = PinnedBlockCopy(device)
        return pinned.put, lambda item: MicrobatchBlock(*pinned.take(item)), pinned
    return (lambda block: block_from_numpy(block, device)), None, None


def block_source(loader, n_acc: int, device, depth: int = 2, prefetch: bool = True,
                 valid: Optional[np.ndarray] = None) -> PrefetchingBlockSource:
    """The trainer's source of ``MicrobatchBlock``s on ``device``
    (:func:`block_copier`'s, on the worker with the prefetch on; on the
    caller, with blocking copies, with it off)."""
    put, take, copier = block_copier(device, prefetch)
    return PrefetchingBlockSource(loader, n_acc, put, depth=depth, prefetch=prefetch,
                                  valid=valid, take_block=take, copier=copier)
