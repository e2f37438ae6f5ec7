"""Overlapped checkpointing: train while you commit.

Counterpart of ``acco_tpu/resilience/manager.py``. A synchronous save
stalls the loop for the whole serialize and write; :class:`CheckpointManager`
splits the save at its seam (``utils/checkpoint.py``):

* ``save()`` blocks only for the device-to-host snapshot
  (:func:`~acco_tpu_torch.utils.checkpoint.snapshot`): the state is
  copied into pinned host buffers, made at the first save and reused, on
  a copy stream of the manager's own that first waits for the current
  stream and for the ``streams`` given (ACCO's comm stream, which writes
  the shard); the loop then waits on the event after the copies, and no
  later round can write into what is being saved;
* with ``async_save`` (``ckpt_async: true``, the default) the commit —
  the rank file, rank 0's ``extra_files`` (the ``params.npz`` export,
  built from the snapshot), the file gate over every rank's file,
  ``meta.json`` last, the retention — runs on one background thread,
  ``acco-ckpt-finalize``, under the next rounds; with ``async_save``
  false it runs inline.

The commit thread issues no collective: on a card the world group is
NCCL, and the loop's thread uses the same communicators. Rank 0's commit
waits for the other ranks' files instead
(:func:`~acco_tpu_torch.utils.checkpoint.wait_for_rank_files`).

Saves are serialized: the next ``save()`` first drains the last one. A
save into a step dir that holds a checkpoint overwrites it, as JAX's
``force=True`` does: each save carries a generation, ``run_token`` and
the manager's count of saves, the same on every rank, and rank 0's
commit takes the old commit back before any rank writes
(``utils/checkpoint.py`` ``commit``).
Failure semantics as JAX's: an error in the commit is recorded and
re-raised on the loop at the next ``save()``, ``wait()`` or ``close()``
(``close()`` logs it when the loop is already unwinding another error),
never swallowed. The step dir it leaves has no ``meta.json``, so a
restart's GC removes it and the resume takes the previous complete
step. Every reader of checkpoints on the loop thread (resume, rollback)
calls ``wait()`` first.

Retention (``keep_last`` / ``keep_every_s``) and the startup GC of
incomplete ``step_*`` dirs are ``utils/checkpoint.py``'s
``apply_retention`` and ``gc_incomplete``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Optional

from acco_tpu_torch.telemetry import metrics
from acco_tpu_torch.utils import checkpoint as ckpt

_module_log = logging.getLogger(__name__)


class CheckpointManager:
    """Async (or sync) committed checkpoints under ``ckpt_dir`` with
    retention and startup GC.

    Every rank calls :meth:`save` and runs its own commit; only rank 0
    writes ``meta.json``, GCs and applies the retention (a shared
    filesystem, like the trainer's other rank-0 gates). ``world_size``
    is the number of rank files rank 0's commit waits for. Over several
    ranks, ``run_token`` must be the same on every rank and differ from
    that of any earlier manager that saved into ``ckpt_dir``.
    """

    def __init__(
        self,
        ckpt_dir: str,
        *,
        async_save: bool = True,
        keep_last: int = 0,
        keep_every_s: float = 0.0,
        rank: int = 0,
        world_size: int = 1,
        log: Optional[logging.Logger] = None,
        gc_on_init: bool = True,
        tracer=None,
        run_token: str = "run",
    ) -> None:
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.async_save = bool(async_save)
        self.keep_last = int(keep_last)
        self.keep_every_s = float(keep_every_s)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.log = log or _module_log
        # the snapshot span lands on the loop's thread, the commit span on
        # the commit thread: the trace shows the commit under the rounds
        self.tracer = tracer
        self.buffers = ckpt.SnapshotBuffers()
        self.copy_stream = None  # made at the first save of a CUDA state
        # per save: the loop's snapshot ms, the part of it that allocated
        # host buffers (the first save), the snapshot's bytes; the commit ms
        self.snapshot_log: list = []
        self.commit_log: list = []
        # a save's generation: the token every rank's manager shares (the
        # trainer's agreed run id) and the count of saves, which advances
        # on every rank alike
        self.run_token = str(run_token)
        self.saves = 0
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if gc_on_init:
            self.gc_incomplete()

    def gc_incomplete(self) -> list:
        """Remove the ``step_*`` dirs a killed saver left without a
        committed ``meta.json``; rank 0 only, before this manager's own
        saves start (one live writer per ``ckpt_dir``, as JAX's)."""
        if self.rank != 0:
            return []
        return ckpt.gc_incomplete(self.ckpt_dir, self.log)

    # -- saving -------------------------------------------------------------

    def _snapshot(self, state: Any, streams) -> ckpt.Snapshot:
        """The device-to-host copy, not yet waited for."""
        if self.copy_stream is None:
            leaf = next(iter(ckpt.state_leaves(state).values()))
            if leaf.is_cuda:
                import torch

                self.copy_stream = torch.cuda.Stream(leaf.device)
        return ckpt.snapshot(state, self.buffers, copy_stream=self.copy_stream,
                             streams=streams, wait=False)

    def _wait_snapshot(self, snap: ckpt.Snapshot) -> None:
        """The loop's one wait: for the snapshot's copies."""
        snap.wait()

    def save(
        self,
        step: int,
        state: Any,
        meta: dict,
        *,
        extra_files: Optional[Callable[[str, dict], None]] = None,
        rank_meta: Optional[dict] = None,
        streams=(),
    ) -> str:
        """Checkpoint ``state`` + ``meta`` as ``step_<step>``.

        Returns once the state is in host buffers; the commit runs on the
        commit thread (async) or before returning (sync). A still-running
        previous save is drained first, raising any error it hit.
        ``extra_files(path, host)`` runs in the commit on the snapshot's
        host tensors (``field path -> tensor``), never on the live state.
        """
        self.wait()
        self.saves += 1
        generation = f"{self.run_token}:{self.saves}"
        path = os.path.join(self.ckpt_dir, f"step_{int(step)}")
        os.makedirs(os.path.join(path, "state"), exist_ok=True)
        meta = dict(meta)
        meta.setdefault("saved_at_unix", time.time())
        t_snap = time.perf_counter()
        snap = self._snapshot(state, streams)
        self._wait_snapshot(snap)
        snap_ms = (time.perf_counter() - t_snap) * 1e3
        self.snapshot_log.append({"ms": snap_ms, "alloc_ms": self.buffers.alloc_ms,
                                  "bytes": self.buffers.nbytes})
        metrics.emit("ckpt_saves_total", 1)
        metrics.emit("ckpt_snapshot_ms", snap_ms)
        if self.tracer is not None:
            self.tracer.complete_event("ckpt/snapshot", snap_ms, cat="ckpt",
                                       args={"path": path})
        args = (path, snap, meta, extra_files, rank_meta, generation)
        if not self.async_save:
            self._commit(*args)
            err, self._error = self._error, None
            if err is not None:
                raise err
        else:
            self._pending = threading.Thread(target=self._commit, args=args,
                                             name="acco-ckpt-finalize", daemon=True)
            self._pending.start()
        return path

    def _commit(self, path: str, snap: ckpt.Snapshot, meta: dict, extra_files,
                rank_meta, generation: str) -> None:
        t_commit = time.perf_counter()
        try:
            extra = None
            if extra_files is not None:
                def extra(p: str) -> None:
                    extra_files(p, snap.host)
            ckpt.commit(path, snap, meta, rank=self.rank, world_size=self.world_size,
                        extra_files=extra, rank_meta=rank_meta, generation=generation)
            if self.rank == 0:
                ckpt.apply_retention(self.ckpt_dir, self.keep_last, self.keep_every_s,
                                     self.log)
        except BaseException as exc:  # noqa: BLE001 — must cross the thread
            self._error = exc
            self.log.error("checkpoint %s failed: %s", path, exc)
        finally:
            commit_ms = (time.perf_counter() - t_commit) * 1e3
            self.commit_log.append(commit_ms)
            metrics.emit("ckpt_commit_ms", commit_ms)
            if self.tracer is not None:
                # recorded from THIS thread: a sync save lands on the
                # loop's track, an async commit on the commit thread's
                self.tracer.complete_event("ckpt/commit", commit_ms, cat="ckpt",
                                           args={"path": path})

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Drain the in-flight save (if any); re-raise its failure on the
        caller. With a ``timeout``, returns False (the save still
        pending) if the commit is still running when it expires."""
        pending = self._pending
        if pending is not None:
            pending.join(timeout)
            if pending.is_alive():
                return False
            self._pending = None
        err, self._error = self._error, None
        if err is not None:
            raise err
        return True

    def close(self, timeout: float = 600.0, raise_errors: bool = True) -> None:
        """Drain on the way out. ``raise_errors=False`` (an exit path
        that is already unwinding an exception) logs a commit failure
        instead of masking the original exception; a commit still running
        after ``timeout`` is left to its daemon thread, with a warning."""
        try:
            if not self.wait(timeout):
                self.log.warning("in-flight checkpoint still committing after %.0f s; "
                                 "abandoning it to its daemon thread", timeout)
                self._pending = None
        except Exception as exc:
            if raise_errors:
                raise
            self.log.error("in-flight checkpoint failed during close: %s", exc)

    @property
    def in_flight(self) -> bool:
        return self._pending is not None and self._pending.is_alive()
