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
does). After a barrier over the world group, rank 0 writes
``meta.json`` LAST and atomically (tmp + rename), with a manifest of
every file's size (:func:`finalize_meta`): its presence marks the
checkpoint committed, and a torn write is detectable without loading
anything (:func:`validate_checkpoint`). :func:`latest_checkpoint` walks
the step dirs newest first and returns the newest that validates.

The save is synchronous. JAX's ``ckpt_async`` commits on a background
thread; that changes when the commit happens, not what it holds.

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
from typing import Any, Iterator, Optional

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
    out = {}
    for name, value in zip(state._fields, state):
        key = prefix + name
        if _is_state(value):
            out.update(state_to_host(value, key + "/"))
        else:
            out[key] = value.detach().to(torch.device("cpu"), copy=True)
    return out


def state_from_host(template, tensors: dict, prefix: str = ""):
    """The inverse of :func:`state_to_host` onto ``template``'s structure,
    devices, shapes and dtypes; a leaf that is missing or differs in
    shape or dtype raises."""
    fields = []
    for name, tmpl in zip(template._fields, template):
        key = prefix + name
        if _is_state(tmpl):
            fields.append(state_from_host(tmpl, tensors, key + "/"))
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
        fields.append(saved.to(tmpl.device))
    return type(template)(*fields)


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Any,
    meta: dict,
    *,
    rank: int = 0,
    group=None,
    extra_files=None,
    rank_meta: Optional[dict] = None,
) -> str:
    """Write this rank's ``state`` (and ``rank_meta``, the entries of the
    meta that are this rank's own) under ``ckpt_dir/step_<step>/state/
    rank_<rank>.pt`` and, on rank 0, ``extra_files(path)`` (the
    ``params.npz`` export); then, after a barrier over ``group`` (the
    world group; None at one rank), rank 0 commits ``meta`` (with the
    manifest), and a second barrier holds every rank until the commit is
    on disk. Every rank must call this; returns the step dir."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    state_dir = os.path.join(path, "state")
    os.makedirs(state_dir, exist_ok=True)
    host = state_to_host(state)
    final = os.path.join(state_dir, f"rank_{rank}.pt")
    tmp = final + ".tmp"
    torch.save({"rank": rank, "state": host, "meta": dict(rank_meta or {})}, tmp)
    os.replace(tmp, final)
    if rank == 0 and extra_files is not None:
        extra_files(path)
    _barrier(group)  # every rank's file is on disk before the commit
    if rank == 0:
        finalize_meta(path, meta)
    _barrier(group)  # no rank goes on (to a restore, say) before the commit
    return path


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
                       mesh: Optional[dict] = None) -> tuple[Any, dict]:
    """``(state, meta)`` from a ``step_*`` dir: this rank's file onto
    ``template``'s structure and devices (e.g. ``step.init_state(...)``),
    and ``meta.json`` with the rank's own entries over it.
    ``mesh`` (``{'dp': N, 'sp': M}``) must equal the mesh that saved the
    checkpoint, as JAX restores onto a mesh of the same shape only; a
    JAX step dir (an Orbax ``state/`` tree, no ``rank_*.pt``) raises."""
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
    return state_from_host(template, saved["state"]), meta


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
