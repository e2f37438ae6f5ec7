"""The port's eval loop, run records, perplexity and ``params.npz``
against the JAX package, float32 on the CPU.

- Eval loss: ``Trainer.evaluate`` equals, at rtol 1e-5, the JAX trainer's
  eval body (``acco_tpu/trainer.py:1930-1944``: per batch JAX's
  ``model_ce`` masked nll sum over the target count, the mean over the
  whole batches) on the same flat params and eval texts, prepared by
  JAX's packing and its unshuffled, ragged-kept loader. Llama (tiny128)
  and a GPT-Neo of hidden 128, materialized and ``fused_loss=pallas``
  (the port's K3 plain version; JAX's Pallas kernel in interpret mode),
  and Llama on two gloo ranks: at dp 2 (each rank its dp index's texts,
  the sums over both) and at sp 2 (the zig-zag ring, each rank its chunk
  of the sequence).
- Records: the TensorBoard calls (a recording writer) and the
  ``results.csv`` bytes equal what ``acco_tpu.utils.logs`` gives for the
  same inputs; a trainer run logs its eval losses under JAX's names.
- Perplexity: ``acco_tpu_torch.perplexity_eval.compute`` equals
  ``perplexity_eval.compute`` at rtol 1e-5.
- ``params.npz`` both ways: the port's final save, read by JAX's
  ``load_flat_params``, gives JAX's models the port's logits, and a
  ``params.npz`` the JAX trainer wrote (its own ``_save`` /
  ``_export_flat_host``) gives the port JAX's logits, at rtol 1e-5.
"""

import collections
import csv
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from acco_tpu.data import loader as jax_loader
from acco_tpu.data import tokenize as jax_tokenize
from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.losses import IGNORE_INDEX
from acco_tpu.ops.losses import model_ce as jax_model_ce
from acco_tpu.utils import checkpoint as jax_ckpt
from acco_tpu.utils import logs as jax_logs
from acco_tpu_torch import perplexity_eval as port_ppl
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.trainer import Trainer
from acco_tpu_torch.utils import checkpoint as ckpt
from acco_tpu_torch.utils import logs
import torch_ranks
from torch_ranks import run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY128 = os.path.join(REPO, "config", "model", "tiny128.json")
NEO128 = dict(vocab_size=257, hidden_size=128, num_layers=2, num_heads=2,
              max_position_embeddings=64, window_size=16,
              attention_layers=("global", "local"))
SEQ, BATCH = 64, 2
LOSS_TOL = dict(rtol=1e-5)
TRAIN = ["".join(np.random.default_rng(i).choice(list("abcdefgh "), 127)) for i in range(8)]
# 11 rows of 64 packed: 5 whole batches of 2 and a ragged one (dp 1)
EVAL = ["".join(np.random.default_rng(100 + i).choice(list("abcdefgh "), 87)) for i in range(8)]


def _models(family):
    if family == "llama":
        cfg = LlamaConfig.from_json(TINY128)
        jax_model = JaxLlamaModel(JaxLlamaConfig.from_json(TINY128), param_dtype=jnp.float32)
        return cfg, LlamaModel(cfg, dtype=torch.float32), jax_model
    cfg = GPTNeoConfig(**NEO128)
    jax_model = JaxGPTNeoModel(JaxGPTNeoConfig(**NEO128), param_dtype=jnp.float32)
    return cfg, GPTNeoModel(cfg, dtype=torch.float32), jax_model


def _args(**over):
    base = dict(method_name="acco", batch_size=BATCH, max_length=SEQ, nb_steps_tot=2,
                const_len_batch=True, scheduler_name="constant", learning_rate=1e-3,
                eval=True, eval_step=2, save=False, ckpt_async=False, fused_loss=False,
                delta_step_for_log=1)
    base.update(over)
    return ConfigNode.wrap(base)


def _jax_eval(jax_model, params, rank_rows, fused):
    """JAX's eval body on the concatenation of the ranks' batches: per
    batch the masked nll sum over the target count, then the mean."""
    tok = load_tokenizer("byte")
    loaders = [iter(jax_loader.ShardedBatchIterator(
        [{"input_ids": r} for r in rows], batch_size=BATCH, max_length=SEQ,
        pad_token_id=tok.pad_token_id, shuffle=False, drop_last=False)) for rows in rank_rows]
    n_batches = min(len(rows) // BATCH for rows in rank_rows)

    @jax.jit
    def body(params, ids, labels):
        nll_sum = jax_model_ce(jax_model, params, ids, None, labels, label_smoothing=0.0,
                               fused=fused, num_valid=jnp.float32(1.0))
        count = (labels[:, 1:] != IGNORE_INDEX).sum().astype(jnp.float32)
        return nll_sum / jnp.maximum(count, 1.0)

    losses = []
    for _ in range(n_batches):
        parts = [next(it) for it in loaders]
        ids = jnp.asarray(np.concatenate([p["input_ids"] for p in parts]))
        labels = jnp.asarray(np.concatenate([p["labels"] for p in parts]))
        losses.append(float(body(params, ids, labels)))
    return float(np.mean(losses))


def _packed(texts, dp=1, index=0):
    tok = load_tokenizer("byte")
    texts = jax_loader.shard_dataset(texts, dp, index) if dp > 1 else texts
    return list(jax_tokenize.pack_const_len(tok(texts)["input_ids"], tok.eos_token_id, SEQ))


@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
@pytest.mark.parametrize("fused", [False, "pallas"])
def test_eval_loss_matches_jax(family, fused, tmp_path, monkeypatch):
    monkeypatch.setenv("ACCO_FUSED_CE_INTERPRET", "1")
    cfg, model, jax_model = _models(family)
    params = jax_model.init(jax.random.PRNGKey(2))
    flat = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    trainer = Trainer(model, load_tokenizer("byte"), TRAIN, EVAL, _args(fused_loss=fused),
                      run_dir=str(tmp_path))
    assert trainer.step.value_and_grad.fused_loss == fused
    assert len(trainer.eval_rows) == 11 and len(trainer.eval_loader) == 6
    got = trainer.evaluate(flat)
    want = _jax_eval(jax_model, params, [_packed(EVAL)], fused)
    np.testing.assert_allclose(got, want, **LOSS_TOL)


EVAL_WORKER = """
import json
import numpy as np
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel.mesh import Mesh, RankGroups
from acco_tpu_torch.trainer import Trainer

spec = json.load(open(os.path.join(WORKDIR, "spec.json")))
flat = torch.from_numpy(np.load(os.path.join(WORKDIR, "flat.npy")))
for dp, sp in spec["meshes"]:  # one world, a mesh of groups each
    groups, sg = RankGroups.build(dp, sp, RANK)
    mesh = Mesh(dp=dp, sp=sp, rank=RANK, device=torch.device("cpu"), sequence_group=sg,
                groups=groups)
    kw = dict(attention="ring", sequence_group=sg, zigzag=True) if sg else {}
    model = LlamaModel(LlamaConfig.from_json(spec["config"]), dtype=torch.float32, **kw)
    trainer = Trainer(model, load_tokenizer("byte"), spec["train"], spec["eval"],
                      ConfigNode.wrap(spec["args"]), mesh=mesh, run_dir=WORKDIR)
    loss = trainer.evaluate(flat)
    json.dump({"loss": loss, "rows": len(trainer.eval_rows)},
              open(os.path.join(WORKDIR, f"out{RANK}_dp{dp}_sp{sp}.json"), "w"))
"""
RANK_MESHES = [(2, 1), (1, 2)]
RANK_TEXTS = EVAL + EVAL[:1]


@pytest.fixture(scope="module")
def rank_evals(tmp_path_factory):
    """One world of two gloo ranks evaluates the same flat params at dp 2
    and at sp 2; returns the params' JAX model and params, and the work
    dir with each rank's results."""
    workdir = tmp_path_factory.mktemp("rank_evals")
    cfg, _, jax_model = _models("llama")
    params = jax_model.init(jax.random.PRNGKey(3))
    flat = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    np.save(workdir / "flat.npy", flat.numpy())
    spec = dict(config=TINY128, train=TRAIN, eval=RANK_TEXTS, args=_args().to_container(),
                meshes=RANK_MESHES)
    with open(workdir / "spec.json", "w") as f:
        json.dump(spec, f)
    run_ranks(EVAL_WORKER, 2, workdir, timeout=120)
    return jax_model, params, workdir


@pytest.mark.parametrize("dp, sp", RANK_MESHES, ids=["dp2", "sp2"])
def test_eval_loss_matches_jax_on_ranks(rank_evals, dp, sp):
    """Two gloo ranks. dp 2: each rank its dp index's eval texts (6 and 5
    rows), the least whole-batch count (2), each batch's nll sum and count
    summed over the ranks. sp 2 (context parallelism, the zig-zag ring):
    each rank its chunk of every row, the labels shifted on the global
    sequence; the loss equals JAX's dense eval, as JAX's CP eval body
    (trainer.py:1888-1901) does."""
    jax_model, params, workdir = rank_evals
    outs = [json.load(open(workdir / f"out{r}_dp{dp}_sp{sp}.json")) for r in range(2)]
    rank_rows = [_packed(RANK_TEXTS, dp, r) for r in range(dp)]
    want_rows = [6, 5] if dp == 2 else [12, 12]
    assert [o["rows"] for o in outs] == [len(rank_rows[r // sp]) for r in range(2)] == want_rows
    want = _jax_eval(jax_model, params, rank_rows, False)
    for out in outs:
        np.testing.assert_allclose(out["loss"], want, **LOSS_TOL)


class Recorder:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("add_scalar", tag, value, step))

    def add_scalars(self, tag, values, step):
        self.calls.append(("add_scalars", tag, dict(values), step))

    def flush(self):
        self.calls.append(("flush",))

    def close(self):
        self.calls.append(("close",))


def test_records_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    recs = []
    for module in (logs, jax_logs):
        rec = Recorder()
        module.log_to_tensorboard(rec, 8, 16, 0, 2.5, None, 990.0, 1, -1)
        module.log_to_tensorboard(rec, 10, 20, 1, 2.25, 3.125, 990.0, 1, -1)
        module.log_to_tensorboard(rec, 12, 24, 0, 2.0, 3.0, 990.0, 10, 5)  # gated out
        module.log_health_to_tensorboard(rec, 10, 0.5, 1, 0, 0)
        recs.append(rec.calls)
    assert recs[0] == recs[1] and len(recs[0]) == 13
    for module, name in ((logs, "port.csv"), (jax_logs, "jax.csv")):
        path = str(tmp_path / name)
        row = module.create_dict_result({"method_name": "acco", "batch_size": 2}, 2, 1, "gpu",
                                        125.5, "2026_1_1_0_0_0_7", 2.5)
        module.save_result(path, row)
        module.save_result(path, dict(row, skipped_rounds=0, rollbacks=0))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert logs.platform_name(torch.device("cpu")) == "cpu"
    assert logs.platform_name(torch.device("cuda", 0)) == "gpu"


def test_logs_import_and_writer_leave_sys_modules(tmp_path):
    """Importing ``acco_tpu_torch.utils.logs`` (in a fresh interpreter)
    adds to ``sys.modules`` only the port's modules and the standard
    library's it imports; ``make_summary_writer`` writes an event file and
    takes TensorBoard's TF-free switch (``tensorboard.compat.notf``) out
    of ``sys.modules`` again."""
    import subprocess
    import sys

    code = (
        "import sys; before = set(sys.modules); import acco_tpu_torch.utils.logs; "
        "new = sorted(set(sys.modules) - before); print(new); "
        "assert all(n.startswith('acco_tpu_torch') or n.split('.')[0].lstrip('_') in "
        "sys.stdlib_module_names or n.split('.')[0] in sys.stdlib_module_names "
        "for n in new), new"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=60, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "logs" in out.stdout and "tensorboard" not in out.stdout
    switch = "tensorboard.compat.notf"
    had = switch in sys.modules
    writer = logs.make_summary_writer(str(tmp_path))
    writer.add_scalar("loss", 1.0, 1)
    writer.close()
    assert (switch in sys.modules) == had
    assert type(writer).__name__ == "SummaryWriter" and os.listdir(tmp_path)


def test_trainer_records(tmp_path, monkeypatch):
    """A run's scalars through a recording writer: the eval losses under
    ``eval_loss_step`` at their grad counts; its ``results.csv`` row has
    JAX's columns (those of ``create_dict_result`` for the same args, the
    health columns, ``provenance``); ``grad_counts/`` holds its rounds."""
    rec = Recorder()
    monkeypatch.setattr(logs, "make_summary_writer", lambda log_dir: rec)
    cfg, model, _ = _models("llama")
    args = _args(nb_steps_tot=4)
    summary = Trainer(model, load_tokenizer("byte"), TRAIN, EVAL, args,
                      run_dir=str(tmp_path)).train()
    evals = [(c[3], c[2]["0"]) for c in rec.calls if c[:2] == ("add_scalars", "eval_loss_step")]
    assert evals == [(e["count_grad_tot"], e["eval_loss"]) for e in summary["eval_log"]]
    assert [e["count_grad_tot"] for e in summary["eval_log"]] == [2, 4]
    assert rec.calls[-2:] == [("flush",), ("close",)]
    with open(tmp_path / "results.csv") as f:
        rows = list(csv.DictReader(f))
    want = jax_logs.create_dict_result(args.to_container(), 1, 1, "cpu", 0.0, "x", 0.0)
    assert set(rows[0]) == set(want) | {"skipped_rounds", "grad_norm_spikes", "grad_norm_drifts",
                                        "rollbacks", "provenance"}
    assert rows[0]["device"] == "cpu" and rows[0]["provenance"] == "measured"
    assert float(rows[0]["Loss_final"]) == summary["final_loss"]
    (counts,) = os.listdir(tmp_path / "grad_counts")
    assert "[1, 1, 1, 1]" in (tmp_path / "grad_counts" / counts).read_text()


def test_perplexity_matches_jax():
    """The port's ``compute`` against ``perplexity_eval.compute`` (the
    tests/test_cli.py::test_perplexity_eval_compute pattern), BOS
    prepended and not."""
    import perplexity_eval as jax_ppl

    from acco_tpu.data.tokenizer import ByteTokenizer

    jcfg = JaxLlamaConfig(vocab_size=257, hidden_size=32, intermediate_size=64, num_layers=1,
                          num_heads=2, num_kv_heads=2, max_position_embeddings=64)
    jax_model = JaxLlamaModel(jcfg, param_dtype=jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(0))
    cfg = LlamaConfig(**{k: getattr(jcfg, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
        "num_kv_heads", "max_position_embeddings")})
    model = LlamaModel(cfg, dtype=torch.float32)
    flat = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    texts = ["hello world this is a test", "another longer document goes here", "x"]
    for bos in (True, False):
        want = jax_ppl.compute(jax_model, params, ByteTokenizer(), texts, batch_size=2,
                               max_length=32, add_start_token=bos)
        got = port_ppl.compute(model, flat, load_tokenizer("byte"), texts, batch_size=2,
                               max_length=32, add_start_token=bos)
        np.testing.assert_allclose(got["perplexities"], want["perplexities"], rtol=1e-5)
        np.testing.assert_allclose(got["mean_perplexity"], want["mean_perplexity"], rtol=1e-5)


def test_perplexity_cli_refusals():
    # --hf-checkpoint is ported (HF loading): a checkpoint that is not
    # there raises, naming the missing download
    with pytest.raises(FileNotFoundError, match="no network egress"):
        port_ppl.main(["--device", "cpu", "--hf-checkpoint", "/models/x"])
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        port_ppl.main(["--device", "cpu", "--engine", "serve"])


def test_perplexity_cli_reads_a_checkpoint(tmp_path, monkeypatch):
    """``python -m acco_tpu_torch.perplexity_eval --device cpu --model
    tiny128 --checkpoint <root>`` scores the newest step's ``params.npz``
    as ``compute`` does on the same params; without ``--device cpu`` and
    with no card it raises instead of falling back to the CPU."""
    from acco_tpu_torch.data.datasets import load_text_dataset

    model, _ = port_ppl.build("tiny128")
    flat = np.random.default_rng(4).normal(0, 0.02, model.n_params).astype(np.float32)

    def extra(path):
        np.savez(os.path.join(path, "params.npz"), flat_params=flat)

    root = str(tmp_path / "ckpts")
    state = collections.namedtuple("State", "flat_params")(torch.from_numpy(flat))
    ckpt.save_checkpoint(root, 3, state, {"count_grad_tot": 3}, extra_files=extra)
    argv = ["--model", "tiny128", "--checkpoint", root, "--n-samples", "4", "--max-length", "64"]
    got = port_ppl.main(["--device", "cpu", *argv])
    texts = load_text_dataset({"path": "synthetic"}, test_size=0.01)[0][:4]
    want = port_ppl.compute(model, torch.from_numpy(flat),
                            load_tokenizer("byte"), texts, max_length=64)
    assert got["n"] == 4
    np.testing.assert_allclose(got["mean_perplexity"], want["mean_perplexity"], rtol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ppl.main(argv)


def _port_logits(model, flat, ids):
    model.load_flat(torch.as_tensor(flat, dtype=torch.float32))
    with torch.no_grad():
        return model.apply(torch.as_tensor(ids, dtype=torch.long)).numpy()


@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
def test_port_params_npz_loads_into_jax(family, tmp_path):
    """The port's final ``params.npz`` through JAX's ``load_flat_params``
    and ``ravel_pytree``'s unravel: JAX's logits equal the port's."""
    cfg, model, jax_model = _models(family)
    summary = Trainer(model, load_tokenizer("byte"), TRAIN, None,
                      _args(eval=False, save=True, nb_steps_tot=2),
                      run_dir=str(tmp_path)).train()
    flat = jax_ckpt.load_flat_params(summary["checkpoint"], model.n_params)
    _, unravel = ravel_pytree(jax_model.init(jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(0, 257, (2, SEQ)).astype(np.int32)
    want = _port_logits(model, ckpt.load_flat_params(summary["checkpoint"], model.n_params), ids)
    got = np.asarray(jax.jit(jax_model.apply)(unravel(jnp.asarray(flat)), jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A ``params.npz`` written once by the JAX trainer's own ``_save``
    (and ``_export_flat_host``) from a train state of tiny128."""
    from acco_tpu.configuration import config_from_dict
    from acco_tpu.data.tokenizer import ByteTokenizer
    from acco_tpu.parallel.mesh import make_mesh
    from acco_tpu.trainer import DecoupledTrainer

    run_dir = str(tmp_path_factory.mktemp("jax_run"))
    jax_model = JaxLlamaModel(JaxLlamaConfig.from_json(TINY128), param_dtype=jnp.float32)
    rows = [{"input_ids": r.tolist()} for r in _packed(TRAIN)]
    args = config_from_dict(dict(method_name="acco", batch_size=2, max_length=SEQ,
                                 nb_steps_tot=2, save=True, ckpt_async=False,
                                 use_mixed_precision=False,
                                 warmup_compile=False, prefetch=False, run_name="jax",
                                 compile_cache_dir="", telemetry={"enabled": False}))
    trainer = DecoupledTrainer(jax_model, ByteTokenizer(), rows, None, args, seed=0,
                               run_dir=run_dir, mesh=make_mesh({"dp": 1},
                                                               devices=jax.devices()[:1]))
    params = jax_model.init(jax.random.PRNGKey(5))
    trainer.step_obj = trainer._make_step("acco")
    state = trainer.step_obj.init_state(params)
    trainer._save(state, 0, 0, time.time())
    trainer.ckpt_manager.wait()
    return jax_model, params, os.path.join(run_dir, "checkpoints", "jax")


def test_jax_params_npz_loads_into_port(jax_checkpoint):
    """The JAX trainer's ``params.npz`` through the port's
    ``resolve_serving_checkpoint`` and ``load_flat_params``: the port's
    logits equal JAX's; its Orbax state is refused by name."""
    jax_model, params, root = jax_checkpoint
    step = ckpt.resolve_serving_checkpoint(root)
    cfg = LlamaConfig.from_json(TINY128)
    model = LlamaModel(cfg, dtype=torch.float32)
    flat = ckpt.load_flat_params(step, model.n_params)
    np.testing.assert_array_equal(flat, np.asarray(ravel_pytree(params)[0]))
    ids = np.random.default_rng(1).integers(0, 257, (2, SEQ)).astype(np.int32)
    want = np.asarray(jax.jit(jax_model.apply)(params, jnp.asarray(ids)))
    np.testing.assert_allclose(_port_logits(model, flat, ids), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Only its params.npz is portable"):
        ckpt.restore_checkpoint(step, None)
