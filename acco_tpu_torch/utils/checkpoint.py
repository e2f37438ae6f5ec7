"""Torch-native checkpoints with exact resume, retention and startup GC.

Counterpart of ``acco_tpu/utils/checkpoint.py`` (all of it but Orbax)
and of the retention and startup GC of ``acco_tpu/resilience/manager.py``.
Layout::

    <ckpt_dir>/step_<n>/state/rank_<r>.pt   (each rank's state, torch.save)
    <ckpt_dir>/step_<n>/params.npz          (final saves: rank 0's dense
                                             float32 params, key flat_params)
    <ckpt_dir>/step_<n>/meta.json

Each rank writes its own view of the train state (``AccoState``,
``DDPState``: its working params, its ZeRO-1 shard and moments, its
pending grads and count, the round counter, the health counters) as a
plain dict of host tensors, keyed by the state's field path
(``zero1/opt/mu``), with the rank's own entries of the meta (its
loader's position: ranks hold shards of their own length, so their
epochs need not turn together; ``meta.json`` records rank 0's, as JAX's
does). Rank 0 waits until every rank's file is on disk (a file gate, no
collective: the commit may run on a thread of its own while the loop's
thread uses the process group), then writes ``meta.json`` LAST and
atomically (tmp + rename), with a manifest of every file's size
(:func:`finalize_meta`): its presence marks the checkpoint committed,
and a torn write is detectable without loading anything
(:func:`validate_checkpoint`). :func:`latest_checkpoint` walks the step
dirs newest first and returns the newest that validates.

A save is split at its seam, as JAX's ``resilience/manager.py`` splits
it: :func:`snapshot` copies the state into host buffers (pinned, and
reused from one save to the next, on a card) on a copy stream of its
own, and the caller waits only for that copy; :func:`commit` writes the
files from the snapshot, on the caller's thread or on a background one
(``resilience/manager.py``). :func:`save_checkpoint` runs both in turn.

A JAX step dir holds an Orbax ``state/`` tree and no ``rank_*.pt``: it
validates (the completeness contract is the same), but only its
``params.npz`` is portable (:func:`load_flat_params`);
:func:`restore_checkpoint` refuses it. The legacy-layout Orbax restores
of the JAX module have no counterpart: they read trees the port never
wrote.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Iterator, NamedTuple, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_RANK_RE = re.compile(r"^rank_(\d+)\.pt$")
MANIFEST_KEY = "state_manifest"

_module_log = logging.getLogger(__name__)


def state_manifest(path: str) -> dict:
    """Relative path -> byte size for every file under a ``step_*`` dir
    (``meta.json`` and its tmp excluded: the manifest is computed at
    commit time, before meta.json exists)."""
    manifest = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            if rel in ("meta.json", "meta.json.tmp"):
                continue
            manifest[rel] = os.path.getsize(full)
    return manifest


def finalize_meta(path: str, meta: dict) -> None:
    """Commit a ``step_*`` dir: write ``meta.json`` (with the state
    manifest folded in) atomically, LAST — its appearance is the commit
    point, and the tmp+rename means no reader can ever see a torn one."""
    meta = dict(meta)
    meta[MANIFEST_KEY] = state_manifest(path)
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(path, "meta.json"))


def _is_state(value) -> bool:
    return isinstance(value, tuple) and hasattr(value, "_fields")


def state_to_host(state, prefix: str = "") -> dict:
    """``{field path: host tensor}`` for a NamedTuple train state: every
    leaf copied to the CPU (a copy even of a CPU leaf, so the dict does
    not alias a buffer a later round may reuse)."""
    return {key: value.to(torch.device("cpu"), copy=True)
            for key, value in state_leaves(state, prefix).items()}


def state_from_host(template, tensors: dict, prefix: str = "", in_place: bool = False):
    """The inverse of :func:`state_to_host` onto ``template``'s structure,
    devices, shapes and dtypes; a leaf that is missing or differs in
    shape or dtype raises. ``in_place`` copies into the template's own
    tensors (no second device copy of the state) and returns it."""
    fields = []
    for name, tmpl in zip(template._fields, template):
        key = prefix + name
        if _is_state(tmpl):
            fields.append(state_from_host(tmpl, tensors, key + "/", in_place))
            continue
        if key not in tensors:
            raise ValueError(
                f"checkpoint has no leaf {key!r} (it holds {sorted(tensors)}): a state of "
                f"another method than {type(template).__name__}'s?"
            )
        saved = tensors[key]
        if saved.shape != tmpl.shape or saved.dtype != tmpl.dtype:
            raise ValueError(
                f"checkpoint leaf {key!r} is {tuple(saved.shape)} {saved.dtype}, the run "
                f"needs {tuple(tmpl.shape)} {tmpl.dtype}"
            )
        fields.append(tmpl.copy_(saved) if in_place else saved.to(tmpl.device))
    return type(template)(*fields)


class SnapshotBuffers:
    """Host buffers for :func:`snapshot`, one per state leaf, made at the
    first save and reused by every later one (a leaf whose shape or dtype
    changed gets a new buffer). Pinned where the leaf is on a card, so
    that the device-to-host copies run asynchronously, at the link's
    rate; plain CPU tensors for CPU leaves. ``alloc_ms`` is the time the
    last :meth:`take` spent allocating (0 once every buffer exists)."""

    def __init__(self) -> None:
        self._buffers: dict = {}
        self.alloc_ms = 0.0
        self.nbytes = 0

    def take(self, leaves: dict) -> dict:
        t0 = time.perf_counter()
        made = False
        for key, value in leaves.items():
            buf = self._buffers.get(key)
            if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
                self._buffers[key] = torch.empty(value.shape, dtype=value.dtype,
                                                 pin_memory=value.is_cuda)
                made = True
        self.alloc_ms = (time.perf_counter() - t0) * 1e3 if made else 0.0
        self.nbytes = sum(b.numel() * b.element_size() for b in self._buffers.values())
        return {key: self._buffers[key] for key in leaves}


def state_leaves(state, prefix: str = "") -> dict:
    """``{field path: tensor}`` for a NamedTuple train state (the
    tensors themselves, detached, no copy)."""
    out = {}
    for name, value in zip(state._fields, state):
        key = prefix + name
        if _is_state(value):
            out.update(state_leaves(value, key + "/"))
        else:
            out[key] = value.detach()
    return out


class Snapshot(NamedTuple):
    """A state copied to host buffers: ``host`` (field path -> host
    tensor) and ``done``, the CUDA event after the copies (None when the
    state was on the CPU: the copies were done on return)."""

    host: dict
    done: Any

    def wait(self) -> None:
        """Block the calling thread until the copies are done."""
        if self.done is not None:
            self.done.synchronize()


def snapshot(state, buffers: Optional[SnapshotBuffers] = None, *, copy_stream=None,
             streams=(), wait: bool = True) -> Snapshot:
    """Copy ``state`` into host buffers (``buffers``' reused ones, else
    new ones). On a card the copies run on ``copy_stream`` (by default a
    new stream), which first waits for the current stream and for each
    of ``streams`` (ACCO's comm stream, which writes the shard) — events
    recorded now, so the copies see every write enqueued before the
    call — and an event is recorded after them. With ``wait`` (the
    default) the caller blocks on that event before returning: once it
    returns no later round can write into what is being saved, since the
    copies are done. Without it the caller must call
    :meth:`Snapshot.wait` before anything on another stream may reuse
    the state's memory (the state's tensors are not marked as in use by
    the copy stream)."""
    leaves = state_leaves(state)
    host = (buffers or SnapshotBuffers()).take(leaves)
    cuda = [t for t in leaves.values() if t.is_cuda]
    if not cuda:
        for key, value in leaves.items():
            host[key].copy_(value)
        return Snapshot(host, None)
    device = cuda[0].device
    if copy_stream is None:
        copy_stream = torch.cuda.Stream(device)
    for stream in (torch.cuda.current_stream(device), *streams):
        ready = torch.cuda.Event()
        ready.record(stream)
        copy_stream.wait_event(ready)
    with torch.cuda.stream(copy_stream):
        for key, value in leaves.items():
            host[key].copy_(value, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
    snap = Snapshot(host, done)
    if wait:
        snap.wait()
    return snap


# how long rank 0's commit waits for the other ranks' files (their
# snapshots are taken at the same boundary; their writes may lag by a
# whole commit when their disks are slower)
GATE_TIMEOUT_S = 600.0


def wait_for_rank_files(path: str, world_size: int, timeout: float = GATE_TIMEOUT_S,
                        poll_s: float = 0.05) -> None:
    """Block until ``rank_0.pt`` .. ``rank_<world_size - 1>.pt`` all exist
    under ``path/state`` (each appears by an atomic rename, so existing
    means complete); raise TimeoutError naming the missing ranks after
    ``timeout`` seconds. The commit's gate before ``meta.json``: files,
    not a collective, so a commit thread never touches the process
    group the loop's thread is using."""
    state_dir = os.path.join(path, "state")
    deadline = time.monotonic() + timeout
    while True:
        missing = [r for r in range(world_size)
                   if not os.path.exists(os.path.join(state_dir, f"rank_{r}.pt"))]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint {path}: no state file from rank(s) {missing} after {timeout:.0f} s; "
                "meta.json not written (the step stays uncommitted)"
            )
        time.sleep(poll_s)


def commit(path: str, snap: Snapshot, meta: dict, *, rank: int = 0, world_size: int = 1,
           extra_files=None, rank_meta: Optional[dict] = None) -> str:
    """Write a snapshot as this rank's part of ``path`` (a ``step_*``
    dir): its rank file (``torch.save`` to a tmp, then an atomic rename),
    then, on rank 0, ``extra_files(path)`` (built from the snapshot, e.g.
    the ``params.npz`` export), the file gate over every rank's file and
    ``meta.json`` last. Waits for the snapshot's copies first. Runs on
    any thread; issues no collective."""
    snap.wait()
    state_dir = os.path.join(path, "state")
    os.makedirs(state_dir, exist_ok=True)
    final = os.path.join(state_dir, f"rank_{rank}.pt")
    tmp = final + ".tmp"
    torch.save({"rank": rank, "state": snap.host, "meta": dict(rank_meta or {})}, tmp)
    os.replace(tmp, final)
    if rank == 0:
        if extra_files is not None:
            extra_files(path)
        wait_for_rank_files(path, world_size)
        finalize_meta(path, meta)
    return path


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Any,
    meta: dict,
    *,
    rank: int = 0,
    world_size: int = 1,
    extra_files=None,
    rank_meta: Optional[dict] = None,
) -> str:
    """A synchronous save: :func:`snapshot` then :func:`commit` of this
    rank's ``state`` (and ``rank_meta``) under ``ckpt_dir/step_<step>``;
    rank 0 commits ``meta`` once all ``world_size`` rank files exist.
    Every rank must call this; returns the step dir."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    return commit(path, snapshot(state), meta, rank=rank, world_size=world_size,
                  extra_files=extra_files, rank_meta=rank_meta)


def checkpoint_candidates(ckpt_dir: str) -> Iterator[str]:
    """``step_*`` dirs under ``ckpt_dir``, newest step first, complete or
    not — validity is the caller's question (validate_checkpoint)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    for _, path in sorted(steps, reverse=True):
        yield path


def validate_checkpoint(path: str) -> Optional[str]:
    """None if ``path`` is a committed, intact ``step_*`` dir; otherwise a
    human-readable reason it must be skipped: no meta.json (the save died
    before its commit), an unparseable meta.json, no state dir, an empty
    manifest, or a manifest size mismatch (a truncated or missing file).
    A checkpoint without a manifest validates on the meta.json and
    state-dir checks alone. Stat calls only; nothing is loaded."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return "incomplete: no meta.json (save died before commit)"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError(f"expected a dict, got {type(meta).__name__}")
    except Exception as exc:
        return f"corrupt meta.json ({exc})"
    if not os.path.isdir(os.path.join(path, "state")):
        return "state dir missing"
    manifest = meta.get(MANIFEST_KEY)
    if not isinstance(manifest, dict):
        return None  # pre-manifest checkpoint: complete as far as we can tell
    if not manifest:
        # a manifest naming no file: the commit raced an empty state dir
        return "state manifest empty (commit recorded no state files)"
    for rel, size in manifest.items():
        full = os.path.join(path, rel)
        try:
            actual = os.path.getsize(full)
        except OSError:
            return f"state file missing: {rel}"
        if actual != int(size):
            return f"state file truncated: {rel} ({actual} != {size} bytes)"
    return None


def latest_checkpoint(ckpt_dir: str, log=None) -> Optional[str]:
    """Newest *valid* ``step_*`` dir under ``ckpt_dir`` (fallback chain:
    incomplete and corrupt/truncated dirs are skipped and reported, and
    the next-newest complete step wins), or None."""
    log = log or _module_log
    for path in checkpoint_candidates(ckpt_dir):
        reason = validate_checkpoint(path)
        if reason is None:
            return path
        log.warning("skipping checkpoint %s: %s", path, reason)
    return None


def resolve_resume(resume_from: str, log=None) -> str:
    """``train.resume_from`` as JAX's trainer reads it: a ``step_*`` dir
    must validate (else ValueError: the user named it); any other path is
    a checkpoint root whose newest complete step wins
    (FileNotFoundError when it has none)."""
    if os.path.basename(os.path.normpath(resume_from)).startswith("step_"):
        reason = validate_checkpoint(resume_from)
        if reason is not None:
            raise ValueError(
                f"explicitly requested checkpoint {resume_from!r} is not restorable "
                f"({reason}); point resume_from at the checkpoint ROOT to fall back to "
                "the newest complete step instead"
            )
        return resume_from
    path = latest_checkpoint(resume_from, log=log)
    if path is None:
        raise FileNotFoundError(f"No checkpoint under {resume_from!r}")
    return path


def _rank_files(state_dir: str) -> list:
    if not os.path.isdir(state_dir):
        return []
    return sorted(n for n in os.listdir(state_dir) if _RANK_RE.match(n))


def restore_checkpoint(path: str, template: Any, *, rank: int = 0,
                       mesh: Optional[dict] = None, in_place: bool = False) -> tuple[Any, dict]:
    """``(state, meta)`` from a ``step_*`` dir: this rank's file onto
    ``template``'s structure and devices (e.g. ``step.init_state(...)``;
    with ``in_place``, into its tensors), and ``meta.json`` with the
    rank's own entries over it.
    ``mesh`` (``{'dp': N, 'sp': M}``, with ``'tp'`` under tensor
    parallelism, ``'pp'`` under pipeline parallelism, both under tp x pp)
    must equal the mesh that saved the checkpoint, as JAX restores onto a
    mesh of the same shape only; a JAX step dir (an Orbax ``state/`` tree,
    no ``rank_*.pt``) raises. Under a model axis, ``rank`` is the rank's
    file index, ``model_index * dp * sp + shard`` (the model index the tp
    index, the pp index, or ``pp_index * tp + tp_index``)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state_dir = os.path.join(path, "state")
    if not _rank_files(state_dir):
        raise ValueError(
            f"{path} holds no rank_*.pt state: it is not a checkpoint of this port (a JAX "
            "Orbax state?). Only its params.npz is portable: load it with "
            "acco_tpu_torch.utils.checkpoint.load_flat_params"
        )
    if mesh is not None and meta.get("mesh") != dict(mesh):
        raise ValueError(
            f"checkpoint {path} was saved on mesh {meta.get('mesh')}, this run's mesh is "
            f"{dict(mesh)}: a restore needs a mesh of the same shape"
        )
    saved = torch.load(os.path.join(state_dir, f"rank_{rank}.pt"), map_location="cpu",
                       weights_only=True)
    meta.update(saved.get("meta", {}))
    return state_from_host(template, saved["state"], in_place=in_place), meta


# -- retention and startup GC (acco_tpu/resilience/manager.py) --------------


def gc_incomplete(ckpt_dir: str, log=None) -> list:
    """Remove the ``step_*`` dirs a killed saver left without a committed
    meta.json; returns the removed paths. Call on rank 0, before the
    run's own saves start. The decision is structural: a dir with a
    meta.json (even a corrupt one) is kept, and a committed-but-truncated
    dir stays for forensics (``latest_checkpoint`` skips it)."""
    log = log or _module_log
    removed = []
    for path in checkpoint_candidates(ckpt_dir):
        if os.path.exists(os.path.join(path, "meta.json")):
            continue
        reason = validate_checkpoint(path) or "uncommitted"
        try:
            shutil.rmtree(path)
        except OSError as exc:
            log.warning("could not GC %s: %s", path, exc)
            continue
        removed.append(path)
        log.warning("GC dropped %s (%s)", path, reason)
    return removed


def _saved_at(path: str) -> float:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return float(json.load(f)["saved_at_unix"])
    except Exception:
        try:  # no stamp: fall back to the commit's mtime
            return os.path.getmtime(os.path.join(path, "meta.json"))
        except OSError:
            return 0.0


def apply_retention(ckpt_dir: str, keep_last: int, keep_every_s: float = 0.0,
                    log=None) -> list:
    """``ckpt_keep_last`` / ``ckpt_keep_every_s`` over the *complete*
    checkpoints: keep the newest ``keep_last`` (0 keeps everything) plus,
    when ``keep_every_s > 0``, an archive of older ones at least that many
    seconds apart by their ``saved_at_unix`` stamp. Returns the dropped
    paths; a failed delete is logged, never raised."""
    log = log or _module_log
    if keep_last <= 0:
        return []
    complete = [p for p in checkpoint_candidates(ckpt_dir) if validate_checkpoint(p) is None]
    keep = set(complete[:keep_last])
    if keep_every_s > 0:
        last_kept_ts = None
        for path in reversed(complete):  # oldest -> newest
            ts = _saved_at(path)
            if last_kept_ts is None or ts - last_kept_ts >= keep_every_s:
                keep.add(path)
                last_kept_ts = ts
    dropped = []
    for path in complete:
        if path in keep:
            continue
        try:
            shutil.rmtree(path)
            log.info("retention dropped %s", path)
            dropped.append(path)
        except OSError as exc:
            log.warning("retention could not drop %s: %s", path, exc)
    return dropped


# -- serving-side loading (perplexity_eval) ---------------------------------


def resolve_serving_checkpoint(path: str, log=None) -> str:
    """Resolve ``path`` to a usable ``step_*`` dir for inference: a
    ``step_*`` dir is validated (a hard error if unusable: the user named
    it), any other path is a checkpoint root that goes through the
    :func:`latest_checkpoint` fallback chain."""
    log = log or _module_log
    path = os.path.abspath(os.path.expanduser(path))
    if _STEP_RE.match(os.path.basename(path)):
        reason = validate_checkpoint(path)
        if reason is not None:
            raise FileNotFoundError(f"checkpoint {path} unusable: {reason}")
        return path
    found = latest_checkpoint(path, log=log)
    if found is None:
        raise FileNotFoundError(
            f"no valid step_* checkpoint under {path} (is it a checkpoint "
            "dir, or did every save die before commit?)"
        )
    return found


def load_flat_params(step_dir: str, n_params: int, log=None):
    """Portable float32 flat parameter vector (numpy) from a ``step_*``
    dir: its ``params.npz`` (key ``flat_params``; written by a final save
    of this port or of the JAX package), else rank 0's state file of a
    periodic save of this port. A JAX periodic save (an Orbax tree, no
    ``params.npz``) raises. ZeRO alignment padding past ``n_params`` is
    trimmed."""
    import numpy as np

    log = log or _module_log
    npz_path = os.path.join(step_dir, "params.npz")
    if os.path.exists(npz_path):
        flat = np.load(npz_path)["flat_params"]
        source = "params.npz"
    elif _rank_files(os.path.join(step_dir, "state")):
        meta_path = os.path.join(step_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved_mesh = json.load(f).get("mesh") or {}
            for axis, what in (("tp", "tensor-parallel run (tp"), ("pp", "pipeline run (pp")):
                size = int(saved_mesh.get(axis, 1))
                if size > 1:
                    raise ValueError(
                        f"{step_dir} is a periodic save of a {what} {size}): each rank file "
                        f"holds one {axis} index's parameters and there is no params.npz; "
                        "resume the run, or load a final save's params.npz")
        saved = torch.load(os.path.join(step_dir, "state", "rank_0.pt"), map_location="cpu",
                           weights_only=True)
        flat = saved["state"]["flat_params"].float().numpy()
        source = "state/rank_0.pt (no params.npz: a periodic save)"
    else:
        raise ValueError(
            f"{step_dir} has no params.npz and no rank_*.pt state: a periodic save of the "
            "JAX package (an Orbax tree) holds no portable params"
        )
    flat = np.asarray(flat, dtype=np.float32).reshape(-1)
    if flat.size < n_params:
        raise ValueError(
            f"checkpoint {step_dir} holds {flat.size} params but the model "
            f"needs {n_params} — wrong model config for this checkpoint?"
        )
    if flat.size > n_params:
        log.info("trimming %d padding params (ZeRO alignment) from %s",
                 flat.size - n_params, source)
        flat = flat[:n_params]
    log.info("loaded %d params from %s (%s)", flat.size, step_dir, source)
    return flat
