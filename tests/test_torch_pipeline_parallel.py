"""The port's pipeline parallelism against the JAX package.

- Tables and layout: the pp rule tables and ``model_split_specs(...,
  'pp')`` equal JAX's for tied and untied Llama and for GPT-Neo;
  ``TpLayout`` over the pp specs (``stack_flat``, ``gather_params``,
  ``n_repl``) is bit-equal to JAX's on the same numpy params, vocab 63
  padded to 64; a stage's init is its slice of the dense init.
- ``stage_blocks``: the stages' layers in sequence equal the dense
  model's and JAX's ``hidden``, for GPT-Neo stages whose window patterns
  differ.
- Rounds: the seed round and ACCO, DPU and DDP rounds at {dp: 2, pp: 2}
  and {dp: 1, pp: 4} on gloo ranks, both families, n_acc 4, against JAX's
  dp run on the same blocks: the losses at rtol 1e-5 / atol 1e-6, each
  rank's local flat parameters and its ZeRO-1 master, m and v against
  JAX's dense state re-laid by JAX's ``TpLayout`` over JAX's pp specs at
  rtol 1e-4 / atol 1e-5 (tests/test_context_parallel.py:67,73); one case
  under ``fused_loss=pallas`` (K3's vocab-parallel wrapper, its plain
  path here) and one with n_acc < pp.
- The pp eval (``parallel/pp.eval_block`` through the pipelined loss)
  against the dense nll sum.
- ``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
  "train.mesh_shape={dp: 2, pp: 2}"``, both families: its ``params.npz``
  is the dense unpadded model's layout, and a resume from its checkpoint
  is bit-exact.
- The refusals: pp not dividing ``num_layers``, ``const_len_batch``
  false; pp with tp or sp builds (ROADMAP item 9.4 ported them:
  tests/test_torch_compositions.py).

No JAX pp scan runs in this process: the reference is JAX's dp path.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu import sharding as jax_sharding
from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel import tp as jax_tp
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.ddp import DDPTrainStep as JaxDDPTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.models.convert import dense_from_rank_flats, params_from_jax, params_to_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.layers import TensorGroup
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel.mesh import check_mesh
from acco_tpu_torch.sharding import check_pipeline, model_split_specs, param_table
import torch_ranks
from torch_ranks import REPO, start_training

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

N_ACC, BATCH, SEQ = 4, 2, 16
ARCH = dict(vocab_size=63, hidden_size=32, intermediate_size=64, num_layers=4,
            num_heads=4, num_kv_heads=2, max_position_embeddings=SEQ)
# the stages' window patterns differ at pp 2 and at pp 4
NEO_ARCH = dict(vocab_size=63, hidden_size=32, num_layers=4, num_heads=4,
                max_position_embeddings=SEQ, window_size=4,
                attention_layers=["global", "local", "local", "global"])
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PAD_TO = 64  # vocab 63 padded to 64, divisible by pp 2 and 4
RANKS_TIMEOUT = 60.0  # a deadlocked schedule fails fast


def _arch(family, tied=True, **over):
    if family == "llama":
        return dict(ARCH, tie_word_embeddings=tied, **over)
    return dict(NEO_ARCH, **over)


def _port_model(family, tied=True, pg=None, pad_to=PAD_TO, **over):
    if family == "llama":
        return LlamaModel(LlamaConfig(**_arch(family, tied, **over)), dtype=torch.float32,
                          pipeline_group=pg, vocab_pad_to=pad_to)
    arch = _arch(family, **over)
    arch["attention_layers"] = tuple(arch["attention_layers"])
    return GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, pipeline_group=pg,
                       vocab_pad_to=pad_to)


def _jax_model(family, tied=True, pad_to=PAD_TO, **over):
    kw = dict(param_dtype=jnp.float32, vocab_pad_to=pad_to)
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**_arch(family, tied, **over)), **kw)
    return JaxGPTNeoModel(JaxGPTNeoConfig(**_arch(family, **over)), **kw)


def _stage(family, pp, stage, tied=True, **over):
    """A port stage on a stand-in pipeline group (no collective runs: the
    layout, the init and the stage's layers only)."""
    return _port_model(family, tied, TensorGroup(group=None, size=pp, rank=stage), **over)


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- tables and layout ----------------------------------------------------------


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
def test_pp_tables_match_jax(family, tied):
    """The pp rule table equals JAX's rule for rule and covers the dense
    tree; ``model_split_specs(..., 'pp')`` and the models'
    ``pp_param_specs`` equal JAX's ``pp_param_specs`` leaf for leaf."""
    mine = param_table(family, "pp", tied=tied)
    theirs = jax_sharding.param_table(family, "pp", tied=tied)
    assert mine.name == theirs.name == f"params:{family}:pp"
    assert [(r.pattern, tuple(r.spec)) for r in mine.rules] == \
        [(r.pattern, tuple(r.spec)) for r in theirs.rules]
    model = _port_model(family, tied)
    assert mine.coverage(model.dense_shapes()).ok
    want = _jax_model(family, tied).pp_param_specs()
    assert model_split_specs(model.family, model.dense_shapes(), "pp") == want
    assert model.pp_param_specs() == want
    dims = model.pp_param_specs()
    assert dims["wte"] == 0 and all(d == 0 for d in dims["layers"].values())
    if family == "llama":
        assert dims["final_norm"] is None and (dims.get("lm_head") == 1) == (not tied)
    else:
        assert (dims["wpe"], dims["lnf_scale"], dims["lnf_bias"]) == (None, None, None)


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
@pytest.mark.parametrize("pp", [2, 4])
def test_pp_layout_matches_jax(family, tied, pp):
    """``TpLayout`` over the pp specs: ``stack_flat`` bit-equal to JAX's on
    the same numpy params (vocab 63 padded to 64), ``gather_params`` its
    inverse and JAX's, the same ``n_local``/``n_repl``; each stage model
    holds ``num_layers / pp`` layers and its row's parameters, and its
    init is its slice of the dense init."""
    jmodel = _jax_model(family, tied)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(1)))
    jl = jax_tp.TpLayout(params, jmodel.pp_param_specs(), pp)
    stages = [_stage(family, pp, s, tied) for s in range(pp)]
    pl = stages[1].tp_layout
    assert (pl.n_local, pl.n_repl) == (jl.n_local, jl.n_repl)
    assert all(m.n_params == pl.n_local and len(m.layers) == 4 // pp for m in stages)
    rows = pl.stack_flat(params)
    np.testing.assert_array_equal(rows, jl.stack_flat(params))
    _leaves_equal(pl.gather_params(rows), jl.gather_params(rows))
    _leaves_equal(dense_from_rank_flats(list(rows), stages[0]), params)
    stages[1].load_flat(torch.from_numpy(rows[1].copy()))
    local = jax.tree.map(np.asarray, jl.unravel_local(jnp.asarray(rows[1])))
    assert np.array_equal(stages[1].wte.detach().numpy(), local["wte"])
    leaf = "w_up" if family == "llama" else "w_fc"
    assert np.array_equal(getattr(stages[1].layers[-1], leaf).detach().numpy(),
                          local["layers"][leaf][-1])
    dense = _port_model(family, tied)
    want = params_to_jax(dense.init_flat(torch.Generator().manual_seed(3)), dense.config,
                         vocab=PAD_TO)
    got = [m.init_flat(torch.Generator().manual_seed(3)) for m in stages]
    _leaves_equal(dense_from_rank_flats(got, stages[0]), want)


# -- the stages' layers in sequence ------------------------------------------------


@pytest.mark.parametrize("family, n_layers, pp, pattern", [
    ("llama", 4, 2, None),
    ("gpt_neo", 4, 4, ["global", "local", "local", "global"]),
    ("gpt_neo", 6, 2, ["global", "global", "local", "local", "global", "local"]),
], ids=["llama-4@2", "neo-4@4", "neo-6@2"])
def test_stage_blocks_in_sequence_match_dense_and_jax(family, n_layers, pp, pattern):
    """The embedding, the stages' ``stage_blocks`` one after another and
    ``finalize`` equal the dense model's ``hidden`` and JAX's on the same
    params; under GPT-Neo the stages' window patterns differ (window 4 <
    L 16), so a stage that took stage 0's pattern would differ. JAX's own
    ``stage_blocks`` over the stages' layer slices agrees too."""
    over = dict(num_layers=n_layers)
    if pattern is not None:
        over["attention_layers"] = pattern
    jmodel = _jax_model(family, **over)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(4)))
    dense = _port_model(family, **over)
    dense.load_flat(params_from_jax(params, dense.config, vocab=PAD_TO))
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 63, (2, SEQ)))
    rows = jax_tp.TpLayout(params, jmodel.pp_param_specs(), pp).stack_flat(params)
    with torch.no_grad():
        x = dense.pp_embed(ids)
        xj = jnp.asarray(x.numpy())
        per = n_layers // pp
        for s in range(pp):
            stage = _stage(family, pp, s, **over)
            stage.load_flat(torch.from_numpy(rows[s].copy()))
            x = stage.stage_blocks(x, stage_index=s)
            layers = jax.tree.map(lambda a: a[s * per:(s + 1) * per], params["layers"])
            xj = jmodel.stage_blocks(layers, xj, stage_index=s, pp=pp)
        got = dense.finalize(x).numpy()
        want_port = dense.hidden(ids).numpy()
    want_jax = np.asarray(jmodel.hidden(params, jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(got, want_port, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(jmodel.finalize(params, xj)), want_jax,
                               rtol=1e-5, atol=2e-6)


# -- rounds on gloo ranks against JAX's dp run ----------------------------------------


def _blocks(n, dp, n_acc, seed=0):
    """``n`` global blocks: [n_acc, dp * BATCH, SEQ] ids over the real vocab."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 63, (n_acc, dp * BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((n_acc, dp), np.float32)})
    return out


REF_DP = 2  # JAX's dp run: the global block's rows over 2 data-parallel devices


def _jax_dp_run(spec, params, blocks):
    """JAX's dp rounds (or DDP steps) on ``REF_DP`` virtual devices: per
    round the loss and the state, the step (its ``unravel``) and the
    model."""
    mesh = make_mesh({"dp": REF_DP}, devices=jax.devices()[:REF_DP])
    model = _jax_model(spec["family"], spec["tied"], spec["vocab_pad_to"], **spec["over"])
    kw = dict(param_dtype=jnp.float32, const_len_batch=True, **spec["opt"])
    sched = jax_get_schedule(*spec["sched"])
    if spec["method"] == "ddp":
        step = JaxDDPTrainStep(model, mesh, sched, **kw)
    else:
        step = JaxAccoTrainStep(model, mesh, sched, mode=spec["method"], **kw)
    state = step.init_state(jax.tree.map(jnp.asarray, params))
    put = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    out = {"losses": [], "states": []}
    if spec["method"] == "ddp":
        fn, todo = step.step_fn(), blocks
    else:
        state, loss = step.seed_fn()(state, put(blocks[0]))
        out["losses"].append(float(loss))
        fn, todo = step.round_fn(), blocks[1:]
    for b in todo:
        state, m = fn(state, put(b))
        out["losses"].append(float(m.loss))
        out["states"].append(jax.tree.map(np.asarray, state))
    return out, step, model


def _relaid(step, jmodel, vec, pp):
    """A dense flat vector of JAX's dp state (params, master, m or v) as
    the [pp, n_local] rows of JAX's ``TpLayout`` over its pp specs."""
    tree = _numpy_tree(step.unravel(jnp.asarray(np.asarray(vec)[:step.geom.n_params])))
    return jax_tp.TpLayout(tree, jmodel.pp_param_specs(), pp).stack_flat(tree)


def _spec(family, method, tied=True, over=None, pad_to=PAD_TO, n_acc=N_ACC, **extra):
    over = over or {}
    return dict(family=family, tied=tied, over=over, arch=_arch(family, tied, **over), sp=1,
                vocab_pad_to=pad_to, zigzag=False, method=method, sched=SCHED, opt=OPT,
                rounds=2 if method == "acco" else 1, n_acc=n_acc, lr_grad_accounting=False,
                **extra)


def _check_rounds(spec, meshes, tmp_path):
    """The port's rounds on each ``(dp, pp)`` mesh's gloo ranks (the meshes
    at once, each rank taking its dp index's rows of the same global
    blocks of ``REF_DP * BATCH`` rows) against one JAX dp run on those
    blocks. A dp of 1 runs all the rows on one pipeline: the same
    microbatch losses (equal token counts a row) and gradients, its count
    half JAX's."""
    family, pad = spec["family"], spec["vocab_pad_to"]
    n_rounds = spec["rounds"] + (0 if spec["method"] == "ddp" else 1)
    jmodel = _jax_model(family, spec["tied"], pad, **spec["over"])
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(2)))
    dense = _port_model(family, spec["tied"], pad_to=pad, **spec["over"])
    flat = params_from_jax(params, dense.config, vocab=pad).numpy()
    blocks = _blocks(n_rounds, REF_DP, spec["n_acc"])
    runs = []
    for dp, pp in meshes:
        work = tmp_path / f"dp{dp}-pp{pp}"
        work.mkdir()
        runs.append(start_training(dict(spec, dp=dp, pp=pp, batch=REF_DP * BATCH // dp), flat,
                                   blocks, work, timeout=RANKS_TIMEOUT))
    want, step, jm = _jax_dp_run(spec, params, blocks)
    final = want["states"][-1]
    for (dp, pp), run in zip(meshes, runs):
        relaid = [_relaid(step, jm, s.flat_params, pp) for s in want["states"]]
        opt = {name: _relaid(step, jm, getattr(final.zero1.opt, name), pp)
               for name in ("params", "mu", "nu")}
        for r, got in enumerate(run()):
            d, s = divmod(r, pp)
            what = (f"rank {r} (dp {d}, stage {s}) of {{dp: {dp}, pp: {pp}}} {family} "
                    f"{spec['method']}")
            np.testing.assert_allclose(got["losses"], want["losses"], err_msg=what, **LOSS_TOL)
            for i, row in enumerate(relaid):
                np.testing.assert_allclose(got["flats"][1 + i][:row.shape[1]], row[s],
                                           err_msg=f"{what}: params after round {i}",
                                           **PARAM_TOL)
            S = got["opt_params"].shape[-1]
            for name, row in opt.items():
                shard = np.pad(row[s], (0, S * dp - row.shape[1]))[d * S:(d + 1) * S]
                key = "opt_params" if name == "params" else name
                np.testing.assert_allclose(got[key][-1], shard, err_msg=f"{what}: {name} shard",
                                           **PARAM_TOL)
            assert got["sched"][-1] == int(final.zero1.sched_grads), what
            assert got["committed"][-1] * REF_DP / dp == float(final.zero1.grads_committed), what


@pytest.mark.parametrize("method", ["acco", "dpu", "ddp"])
@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
def test_pp_rounds_match_jax_dp(family, method, tmp_path):
    """The seed round and ACCO's two rounds (speculative, then committed),
    one DPU round or one DDP step at {dp: 2, pp: 2} and {dp: 1, pp: 4} on
    gloo ranks (both meshes at once), n_acc 4, against JAX's dp run on the
    same blocks: the losses, every rank's local flat parameters (JAX's
    dense state re-laid by JAX's pp ``TpLayout``, the row of its stage)
    and its ZeRO-1 master, m and v shards."""
    _check_rounds(_spec(family, method), [(2, 2), (1, 4)], tmp_path)


def test_pp_rounds_fused_loss_untied(tmp_path):
    """``fused_loss=pallas`` at {dp: 2, pp: 2}: K3's vocab-parallel wrapper
    over the pipeline group (its plain path on the CPU), on an untied
    Llama of hidden 128 whose per-stage vocab (511 padded to 512, 256 a
    stage) is inside K3's envelope, against JAX's dp run (the materialized
    CE: the same function)."""
    over = dict(vocab_size=511, hidden_size=128, intermediate_size=128)
    _check_rounds(_spec("llama", "acco", tied=False, over=over, pad_to=512,
                        fused_loss="pallas"), [(2, 2)], tmp_path)


def test_pp_rounds_n_acc_below_pp(tmp_path):
    """n_acc 2 < pp 4 (the bubble dominates; the trainer warns) still
    trains as JAX's dp run does: GPT-Neo, ACCO, {dp: 1, pp: 4}."""
    _check_rounds(_spec("gpt_neo", "acco", n_acc=2), [(1, 4)], tmp_path)


# -- the eval through the pipeline ---------------------------------------------------

EVAL_WORKER = """
import numpy as np
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.parallel.mesh import RankGroups
from acco_tpu_torch.parallel.pp import eval_block, make_pp_loss_fn

cfg = dict(np.load(os.path.join(WORKDIR, "in.npz")))
g, _ = RankGroups.build({{"pp": WS}}, RANK)
arch = {ARCH!r}
arch["attention_layers"] = tuple(arch["attention_layers"])
model = GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32,
                    pipeline_group=g.pipeline_group(), vocab_pad_to={pad})
loss_fn = make_pp_loss_fn(model)
ids, labels = torch.tensor(cfg["ids"]), torch.tensor(cfg["labels"])
block, _ = eval_block(ids, torch.ones_like(ids), labels, WS)
with torch.no_grad():
    nll, count = loss_fn(torch.tensor(cfg["rows"][RANK]), block)
np.savez(os.path.join(WORKDIR, f"eval{{RANK}}.npz"), nll=nll.numpy(), count=count.numpy(),
         m=block.input_ids.shape[0])
"""


def test_pp_eval_matches_dense(tmp_path):
    """The eval through the pipeline (``eval_block``: a batch of 6 rows in
    3 microbatches at pp 4, each weighted by its target count, some
    labels ignored) gives the dense nll sum and target count on every
    stage."""
    from acco_tpu_torch.ops.losses import model_ce

    jmodel = _jax_model("gpt_neo")
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(6)))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 63, (6, SEQ))
    labels = ids.copy()
    labels[1, 4:9] = labels[4, 2] = -100
    rows = jax_tp.TpLayout(params, jmodel.pp_param_specs(), 4).stack_flat(params)
    np.savez(tmp_path / "in.npz", ids=ids, labels=labels, rows=rows)
    script = EVAL_WORKER.format(ARCH=NEO_ARCH, pad=PAD_TO)
    ranks = torch_ranks.Ranks(script, 4, tmp_path, timeout=RANKS_TIMEOUT)
    dense = _port_model("gpt_neo")
    dense.load_flat(params_from_jax(params, dense.config, vocab=PAD_TO))
    with torch.no_grad():
        nll = model_ce(dense, torch.from_numpy(ids), None, torch.from_numpy(labels),
                       label_smoothing=0.0, fused=False, real_vocab=63,
                       num_valid=torch.ones(()))
    count = (labels[:, 1:] != -100).sum()
    ranks.join()
    for r in range(4):
        got = np.load(tmp_path / f"eval{r}.npz")
        assert int(got["m"]) == 3
        np.testing.assert_allclose(got["nll"], float(nll), **LOSS_TOL)
        assert float(got["count"]) == count


# -- the entry point under torchrun ---------------------------------------------------


def _cli_args(*overrides, nb):
    return ["--device", "cpu", "data=synthetic", "data.synthetic_num_docs=64",
            "train.max_length=64", "train.batch_size=2", "train.n_grad_accumulation=2",
            f"train.nb_steps_tot={nb}", "train.mesh_shape={dp: 2, pp: 2}", "train.save=true",
            *overrides]


def _torchrun(tmp, *overrides, nb):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         "-m", "acco_tpu_torch", *_cli_args(*overrides, nb=nb)],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summaries = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1, out.stdout[-2000:]
    return json.loads(summaries[0])


@pytest.mark.parametrize("model, method", [("tiny128", "acco"), ("tiny_neo", "ddp")])
def test_torchrun_cli_runs_pp_on_cpu(model, method, tmp_path):
    """``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
    train.mesh_shape={dp: 2, pp: 2}`` trains to its summary (the eval
    through the pipeline included) and a final save whose ``params.npz``
    is the dense, unpadded model (JAX's layout: the plain config's leaf
    shapes, equal to the rank files' stages gathered and unpadded). For
    ACCO, the entry point's trainer resumed on the same mesh from the
    periodic save at 8 grads ends on the same ``params.npz``, bit for
    bit, and the same losses."""
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.parallel.tp import host_ravel

    args = (f"train={method}", f"model={model}", "train.checkpoint_every_s=0",
            "+train.delta_step_for_log=4")
    summary = _torchrun(tmp_path / "a", *args, "train.eval=true", "train.eval_step=8",
                        f"hydra.run.dir={tmp_path / 'a'}", nb=16)
    assert summary["mesh"] == {"dp": 2, "sp": 1, "pp": 2} and summary["count_grad_tot"] == 16
    assert summary["skipped_rounds"] == 0 and np.isfinite(summary["eval_loss"])
    cfg = {"config_path": f"/config/model/{model}.json"}
    dense = build_model(cfg, repo_root=REPO, dtype=torch.float32)
    stage = build_model(cfg, repo_root=REPO, dtype=torch.float32,
                        pipeline_group=TensorGroup(None, 2, 0), vocab_pad_multiple=2)
    assert summary["n_params"] == stage.n_params
    steps = tmp_path / "a" / "checkpoints" / method
    flat = np.load(steps / "step_16" / "params.npz")["flat_params"]
    assert flat.shape == (dense.n_params,)
    rows = [torch.load(steps / "step_16" / "state" / f"rank_{r}.pt", weights_only=True)
            for r in (0, 2)]
    assert [f["meta"]["pp_index"] for f in rows] == [0, 1]  # files: pp index, then dp shard
    gathered = stage.unpad_vocab(stage.tp_layout.gather_params(
        [f["state"]["flat_params"][:stage.n_params].float().numpy() for f in rows]))
    np.testing.assert_array_equal(host_ravel(gathered, np.float32), flat)
    assert jax.tree.map(np.shape, params_to_jax(torch.from_numpy(flat), dense.config)) == \
        jax.tree.map(np.shape, gathered)
    if method != "acco":
        return
    (tmp_path / "c").mkdir()  # the entry point's trainer on forked ranks, as torchrun starts it
    resumed = torch_ranks.start_cli(_cli_args(*args, f"hydra.run.dir={tmp_path / 'c'}",
                                              f"train.resume_from={steps / 'step_8'}", nb=16),
                                    4, tmp_path / "c")()
    assert resumed["seed_loss"] is None and resumed["count_grad_tot"] == 16
    losses = [r["loss"] for r in summary["round_log"]]
    assert len(resumed["round_log"]) == 2  # the rounds after the save at 8 grads
    assert [r["loss"] for r in resumed["round_log"]] == losses[-2:]
    again = np.load(tmp_path / "c" / "checkpoints" / method / "step_16" / "params.npz")
    np.testing.assert_array_equal(again["flat_params"], flat)


# -- refusals ---------------------------------------------------------------------------


def test_pp_refusals():
    """pp not dividing ``num_layers``, ``const_len_batch`` false, a
    staged model's dense forward and its serving (single-replica, as JAX's). pp with tp or
    sp, once refused (item 9.4), passes the mesh check, and its models
    build: a tp x pp stage needs the combined (pp, tp) vocab group, a
    pp x sp stage runs the ring."""
    from acco_tpu_torch.ops.schedules import get_schedule
    from acco_tpu_torch.parallel.ddp import DDPTrainStep
    from acco_tpu_torch.parallel.mesh import RankGroups

    assert check_mesh({"dp": 2, "pp": 2})["pp"] == 2
    for shape in ({"pp": 2, "tp": 2}, {"dp": 2, "pp": 2, "sp": 2}, {"tp": 2, "pp": 4}):
        assert check_mesh(shape)["pp"] == shape["pp"]
    with pytest.raises(ValueError, match="must divide num_layers=4"):
        _stage("llama", 3, 0, pad_to=66)
    with pytest.raises(ValueError, match="must divide num_layers=4"):
        check_pipeline(8, num_layers=4)
    with pytest.raises(ValueError, match="combined"):
        LlamaModel(LlamaConfig(**ARCH), tensor_group=TensorGroup(None, 2, 0),
                   pipeline_group=TensorGroup(None, 2, 0), vocab_pad_to=PAD_TO)
    both = LlamaModel(LlamaConfig(**ARCH), tensor_group=TensorGroup(None, 2, 1),
                      pipeline_group=TensorGroup(None, 2, 1),
                      model_group=TensorGroup(None, 4, 3), vocab_pad_to=PAD_TO)
    assert (len(both.layers), both.n_heads, both.wte.shape[0]) == (2, 2, PAD_TO // 4)
    ring = GPTNeoModel(GPTNeoConfig(**dict(NEO_ARCH, attention_layers=tuple(
        NEO_ARCH["attention_layers"]))), attention="ring", sequence_group=object(),
        pipeline_group=TensorGroup(None, 2, 0), vocab_pad_to=PAD_TO)
    assert len(ring.layers) == 2 and ring.sequence_group is not None
    group = object()  # a stand-in: the refusal comes before any collective
    stage = _port_model("gpt_neo", pg=TensorGroup(group, 2, 1))
    groups = RankGroups(dp=1, sp=1, dp_index=0, sp_index=0, n_model=2, model_index=1, tensor=group,
                        model_axis="pp")
    with pytest.raises(ValueError, match="const_len_batch"):
        DDPTrainStep(stage, get_schedule(*SCHED), groups=groups, const_len_batch=False, **OPT)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="pipeline stage 1 of 2"):
        stage.hidden(ids)
    with pytest.raises(ValueError, match="single-replica: this model is pipeline stage 1 of 2"):
        stage.prefill(ids)

