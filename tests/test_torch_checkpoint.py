"""The port's checkpoints (``acco_tpu_torch/utils/checkpoint.py``) against
the JAX package's ``acco_tpu/utils/checkpoint.py``.

- Validators: on a committed step dir and on each torn variant (no
  ``meta.json``, a corrupt one, no ``state/``, an empty manifest, a
  truncated rank file, a missing rank file), the port's
  ``validate_checkpoint`` / ``latest_checkpoint`` give the verdict and the
  reason JAX's give on the same directory tree.
- ``params.npz``: the port's final save loads through JAX's
  ``load_flat_params`` (trimmed to ``n_params``), equal to the port's own.
- The state round trip is exact (bf16 and int leaves included); a state
  of another method, a changed shape, another mesh, and a JAX Orbax step
  dir are refused.
- Retention keeps the newest ``ckpt_keep_last`` (and a ``keep_every_s``
  archive) as JAX's ``CheckpointManager._retention``; ``gc_incomplete``
  removes only uncommitted dirs.
"""

import json
import os
import shutil
from typing import NamedTuple

import numpy as np
import pytest
import torch

from acco_tpu.utils import checkpoint as jax_ckpt
from acco_tpu_torch.utils import checkpoint as ckpt
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored


class Inner(NamedTuple):
    mu: torch.Tensor
    count: torch.Tensor


class State(NamedTuple):
    flat_params: torch.Tensor
    inner: Inner


class OtherState(NamedTuple):
    flat_params: torch.Tensor
    pending_grads: torch.Tensor


def _state(seed=0, n=40):
    g = torch.Generator().manual_seed(seed)
    return State(flat_params=torch.randn(n, generator=g).to(torch.bfloat16),
                 inner=Inner(mu=torch.randn(n, generator=g),
                             count=torch.tensor(seed, dtype=torch.int32)))


def _save(root, step, state=None, mesh=None, npz=None):
    meta = {"count_grad_tot": step, "mesh": mesh or {"dp": 1, "sp": 1},
            "saved_at_unix": 1000.0 + step}
    extra = None
    if npz is not None:
        def extra(path):
            np.savez(os.path.join(path, "params.npz"), flat_params=npz)
    return ckpt.save_checkpoint(str(root), step, state if state is not None else _state(step),
                                meta, extra_files=extra)


def _torn(kind):
    def no_meta(p):
        os.remove(os.path.join(p, "meta.json"))

    def corrupt_meta(p):
        with open(os.path.join(p, "meta.json"), "w") as f:
            f.write('{"count_grad_tot": 3, "state_man')

    def no_state(p):
        shutil.rmtree(os.path.join(p, "state"))

    def empty_manifest(p):
        meta = json.load(open(os.path.join(p, "meta.json")))
        meta[ckpt.MANIFEST_KEY] = {}
        json.dump(meta, open(os.path.join(p, "meta.json"), "w"))

    def truncated_rank(p):
        f = os.path.join(p, "state", "rank_0.pt")
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)

    def missing_rank(p):
        os.remove(os.path.join(p, "state", "rank_1.pt"))

    return {"no_meta": no_meta, "corrupt_meta": corrupt_meta, "no_state": no_state,
            "empty_manifest": empty_manifest, "truncated_rank": truncated_rank,
            "missing_rank": missing_rank}[kind]


@pytest.mark.parametrize("kind", [None, "no_meta", "corrupt_meta", "no_state",
                                  "empty_manifest", "truncated_rank", "missing_rank"])
def test_validators_agree_with_jax(tmp_path, kind, caplog):
    """A two-rank step dir (each rank's file, then rank 0's commit) over an
    older complete one: both packages give one verdict on the newest and
    fall back to the same step."""
    root = tmp_path / "ckpts"
    _save(root, 1)
    path = os.path.join(str(root), "step_2")
    os.makedirs(os.path.join(path, "state"))
    torch.save({"rank": 1, "state": ckpt.state_to_host(_state(5))},
               os.path.join(path, "state", "rank_1.pt"))
    ckpt.save_checkpoint(str(root), 2, _state(2), {"count_grad_tot": 2})
    if kind is not None:
        _torn(kind)(path)
    reason = ckpt.validate_checkpoint(path)
    assert reason == jax_ckpt.validate_checkpoint(path)
    assert (reason is None) == (kind is None)
    want = path if kind is None else os.path.join(str(root), "step_1")
    assert ckpt.latest_checkpoint(str(root)) == jax_ckpt.latest_checkpoint(str(root)) == want
    assert list(ckpt.checkpoint_candidates(str(root))) == list(
        jax_ckpt.checkpoint_candidates(str(root)))


def test_manifest_and_commit_as_jax(tmp_path):
    """The manifest lists every file but meta.json, with its size;
    ``finalize_meta`` writes the same meta.json bytes as JAX's."""
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        os.makedirs(d / "state")
        (d / "state" / "rank_0.pt").write_bytes(b"x" * 123)
        (d / "params.npz").write_bytes(b"y" * 7)
    ckpt.finalize_meta(str(a), {"count_grad_tot": 4, "loader": {"epoch": 0, "batch_pos": 3}})
    jax_ckpt.finalize_meta(str(b), {"count_grad_tot": 4, "loader": {"epoch": 0, "batch_pos": 3}})
    assert (a / "meta.json").read_bytes() == (b / "meta.json").read_bytes()
    assert ckpt.state_manifest(str(a)) == {"state/rank_0.pt": 123, "params.npz": 7}


def test_state_round_trip_is_exact(tmp_path):
    state = _state(3)
    path = _save(tmp_path, 7, state)
    template = _state(9)
    back, meta = ckpt.restore_checkpoint(path, template, mesh={"dp": 1, "sp": 1})
    assert meta["count_grad_tot"] == 7
    for got, want in ((back.flat_params, state.flat_params), (back.inner.mu, state.inner.mu),
                      (back.inner.count, state.inner.count)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_restore_refusals(tmp_path):
    path = _save(tmp_path, 2)
    with pytest.raises(ValueError, match=r"saved on mesh \{'dp': 1, 'sp': 1\}.*same shape"):
        ckpt.restore_checkpoint(path, _state(0), mesh={"dp": 2, "sp": 1})
    other = OtherState(torch.zeros(40, dtype=torch.bfloat16), torch.zeros(40))
    with pytest.raises(ValueError, match="no leaf 'pending_grads'"):
        ckpt.restore_checkpoint(path, other)
    with pytest.raises(ValueError, match=r"is \(40,\) torch.bfloat16, the run needs \(41,\)"):
        ckpt.restore_checkpoint(path, _state(0, n=41))
    # a JAX step dir: an Orbax state tree, no rank_*.pt
    jax_dir = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 3,
                                       {"w": np.zeros(4, np.float32)}, {"count_grad_tot": 3})
    assert ckpt.validate_checkpoint(jax_dir) is None
    with pytest.raises(ValueError, match="Only its params.npz is portable"):
        ckpt.restore_checkpoint(jax_dir, _state(0))
    with pytest.raises(ValueError, match="holds no portable params"):
        ckpt.load_flat_params(jax_dir, 4)


def test_resolve_resume_and_serving(tmp_path):
    root = tmp_path / "ckpts"
    _save(root, 1)
    torn = _save(root, 2)
    _torn("truncated_rank")(torn)
    assert ckpt.resolve_resume(str(root)) == os.path.join(str(root), "step_1")
    assert ckpt.resolve_serving_checkpoint(str(root)) == jax_ckpt.resolve_serving_checkpoint(
        str(root))
    with pytest.raises(ValueError, match="not restorable.*truncated"):
        ckpt.resolve_resume(torn)
    with pytest.raises(FileNotFoundError, match="truncated"):
        ckpt.resolve_serving_checkpoint(torn)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve_resume(str(tmp_path / "empty"))


def test_params_npz_loads_through_jax(tmp_path):
    """A final save's ``params.npz`` (padded past n_params, as ZeRO pads)
    gives JAX's ``load_flat_params`` and the port's the same trimmed
    vector; a periodic save (no npz) falls back to rank 0's state."""
    flat = np.random.default_rng(0).standard_normal(45).astype(np.float32)
    path = _save(tmp_path, 3, npz=flat)
    np.testing.assert_array_equal(jax_ckpt.load_flat_params(path, 40), flat[:40])
    np.testing.assert_array_equal(ckpt.load_flat_params(path, 40), flat[:40])
    state = _state(4)
    periodic = _save(tmp_path, 4, state)
    np.testing.assert_array_equal(ckpt.load_flat_params(periodic, 40),
                                  state.flat_params.float().numpy())
    with pytest.raises(ValueError, match="wrong model config"):
        ckpt.load_flat_params(path, 46)


def _jax_manager(root, **kw):
    from acco_tpu.resilience import CheckpointManager

    return CheckpointManager(str(root), async_save=False, gc_on_init=False, **kw)


@pytest.mark.parametrize("keep_last, keep_every_s", [(2, 0.0), (1, 2.5), (0, 0.0)])
def test_retention_as_jax(tmp_path, keep_last, keep_every_s):
    """Six complete checkpoints 1 s apart (and a torn one, which retention
    leaves to the fallback chain): the port drops what JAX's
    ``_retention`` drops on a copy of the same tree."""
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    for step in range(1, 7):
        _save(port_root, step)
    torn = _save(port_root, 7)
    _torn("truncated_rank")(torn)
    shutil.copytree(port_root, jax_root)
    ckpt.apply_retention(str(port_root), keep_last, keep_every_s)
    _jax_manager(jax_root, keep_last=keep_last, keep_every_s=keep_every_s)._retention()
    assert sorted(os.listdir(port_root)) == sorted(os.listdir(jax_root))
    if keep_last:
        assert "step_6" in os.listdir(port_root) and "step_7" in os.listdir(port_root)


def test_gc_removes_only_uncommitted(tmp_path):
    root = tmp_path / "ckpts"
    _save(root, 1)
    corrupt = _save(root, 2)
    _torn("corrupt_meta")(corrupt)
    uncommitted = _save(root, 3)
    _torn("no_meta")(uncommitted)
    jax_root = tmp_path / "jax"
    shutil.copytree(root, jax_root)
    removed = ckpt.gc_incomplete(str(root))
    assert removed == [uncommitted]
    _jax_manager(jax_root).gc_incomplete()
    assert sorted(os.listdir(root)) == sorted(os.listdir(jax_root)) == ["step_1", "step_2"]
