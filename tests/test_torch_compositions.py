"""The port's compositions of the model axes against the JAX package.

- Layout: ``ComposedLayout`` (tp x pp) against JAX's on the same numpy
  params, for tied and untied Llama and for GPT-Neo, vocab 63 padded to
  64: ``n_repl_both``, ``n_repl``, ``n_local``, every ``stack_flat`` row
  bit-equal, the ``gather_params`` round trip; a stage's tp shard model
  holds its row, and its init is its slice of the dense init.
- The groups: on 8 gloo ranks, meshes in several key orders (the
  preset's {dp, pp, tp}, JAX's four-axis {dp, pp, tp, sp}, a tp-major
  and an sp-major one): each rank's place and every group's ranks, in
  their order, against JAX's ``make_mesh`` device grid of the same key
  order.
- Rounds: the seed round and ACCO's speculative and committed rounds,
  one DPU round and one DDP step on {dp: 2, pp: 2, tp: 2}, {dp: 1, pp: 2,
  sp: 2}, {dp: 1, sp: 2, tp: 2} and {dp: 1, pp: 2, tp: 2, sp: 2} (the
  meshes of a test at once) against one JAX dp run per test on the same
  blocks, as tests/test_torch_pipeline_parallel.py does: the losses at
  rtol 1e-5 / atol 1e-6, every rank's local flat parameters and its
  ZeRO-1 master, m and v shards against JAX's dense state re-laid by
  JAX's ``ComposedLayout`` or ``TpLayout`` at rtol 1e-4 / atol 1e-5;
  Llama for every mode, GPT-Neo for ACCO (with a position table long
  enough that the replicated prefix crosses the dp shard boundary).
- The eval through the pipeline under sp ({pp: 2, sp: 2}) against JAX's
  dense nll sum and the target count.
- ``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
  "train.mesh_shape={dp: 1, pp: 2, tp: 2}"``: its ``params.npz`` is the
  dense, unpadded model gathered from the rank files and the dense run's
  at the dp bars, and a resume from its periodic save ends on the same
  bits.
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

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.losses import causal_lm_loss as jax_causal_lm_loss
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel import tp as jax_tp
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.ddp import DDPTrainStep as JaxDDPTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.models.convert import (
    dense_from_rank_flats,
    params_from_jax,
    params_to_jax,
    rank_flat_from_jax,
)
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.layers import TensorGroup
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
import torch_ranks
from torch_ranks import REPO, run_ranks, start_training

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

N_ACC, BATCH, SEQ = 2, 2, 16
ARCH = dict(vocab_size=63, hidden_size=32, intermediate_size=64, num_layers=4,
            num_heads=4, num_kv_heads=2, max_position_embeddings=SEQ)
# the stages' window patterns differ; the position table's 1024 rows make
# the prefix replicated on both axes longer than a dp shard of the
# composed local vector, so ZeRO-1's shard 1 holds both prefix segments
NEO_ARCH = dict(vocab_size=63, hidden_size=32, num_layers=4, num_heads=4,
                max_position_embeddings=1024, window_size=4,
                attention_layers=["global", "local", "local", "global"])
# the rounds' models: a layer a stage at pp 2 (the rank tests' collectives
# are what takes their time); GPT-Neo's stages still differ in window
ROUND_LAYERS = {"llama": dict(num_layers=2),
                "gpt_neo": dict(num_layers=2, attention_layers=["global", "local"])}
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PAD_TO = 64  # vocab 63 padded to 64, divisible by pp x tp
RANKS_TIMEOUT = 90.0  # a deadlocked schedule fails fast
REF_DP = 2  # JAX's dp run: the global block's rows over 2 data-parallel devices
MESHES = ({"dp": 2, "pp": 2, "tp": 2}, {"dp": 1, "pp": 2, "sp": 2},
          {"dp": 1, "sp": 2, "tp": 2}, {"dp": 1, "pp": 2, "tp": 2, "sp": 2})


def _arch(family, tied=True, **over):
    if family == "llama":
        return dict(ARCH, tie_word_embeddings=tied, **over)
    return dict(NEO_ARCH, **over)


def _port_model(family, tied=True, over=None, **groups):
    arch = _arch(family, tied, **(over or {}))
    if family == "llama":
        return LlamaModel(LlamaConfig(**arch), dtype=torch.float32, vocab_pad_to=PAD_TO,
                          **groups)
    arch["attention_layers"] = tuple(arch["attention_layers"])
    return GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, vocab_pad_to=PAD_TO,
                       **groups)


def _jax_model(family, tied=True, over=None):
    kw = dict(param_dtype=jnp.float32, vocab_pad_to=PAD_TO)
    arch = _arch(family, tied, **(over or {}))
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**arch), **kw)
    return JaxGPTNeoModel(JaxGPTNeoConfig(**arch), **kw)


def _shard(family, pp, tp, index, tied=True):
    """A port model of row ``index`` (stage ``index // tp``'s tp shard
    ``index % tp``) on stand-in groups (no collective runs)."""
    stage, shard = divmod(index, tp)
    return _port_model(family, tied, tensor_group=TensorGroup(None, tp, shard),
                       pipeline_group=TensorGroup(None, pp, stage),
                       model_group=TensorGroup(None, pp * tp, index))


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _jax_layout(jmodel, tree, mesh):
    """JAX's layout of a mesh's model axes over ``tree``: ``ComposedLayout``
    under tp x pp, ``TpLayout`` over the one model axis's specs, else None."""
    tp, pp = mesh.get("tp", 1), mesh.get("pp", 1)
    if tp > 1 and pp > 1:
        return jax_tp.ComposedLayout(tree, jmodel.pp_param_specs(), pp,
                                     jmodel.tp_param_specs(), tp)
    if tp > 1 or pp > 1:
        specs = jmodel.tp_param_specs() if tp > 1 else jmodel.pp_param_specs()
        return jax_tp.TpLayout(tree, specs, tp * pp)
    return None


# -- the layout ---------------------------------------------------------------------


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
@pytest.mark.parametrize("pp, tp", [(2, 2), (4, 2)])
def test_composed_layout_matches_jax(family, tied, pp, tp):
    """``ComposedLayout`` over the pp and tp tables: the three segment
    boundaries, every ``stack_flat`` row bit-equal to JAX's on the same
    numpy params, ``gather_params`` its inverse and JAX's; the model of a
    row holds it leaf by leaf as JAX's ``unravel_local``, its rank flat is
    the row, and the rows' inits are the dense init's slices."""
    jmodel = _jax_model(family, tied)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(1)))
    jl = jax_tp.ComposedLayout(params, jmodel.pp_param_specs(), pp, jmodel.tp_param_specs(), tp)
    models = [_shard(family, pp, tp, m, tied) for m in range(pp * tp)]
    pl = models[0].tp_layout
    assert (pl.n_repl_both, pl.n_repl, pl.n_local) == (jl.n_repl_both, jl.n_repl, jl.n_local)
    assert 0 < pl.n_repl_both < pl.n_repl < pl.n_local
    assert all(m.n_params == pl.n_local and len(m.layers) == 4 // pp for m in models)
    rows = pl.stack_flat(params)
    np.testing.assert_array_equal(rows, jl.stack_flat(params))
    _leaves_equal(pl.gather_params(rows), jl.gather_params(rows))
    _leaves_equal(pl.gather_params(rows), params)
    _leaves_equal(dense_from_rank_flats(list(rows), models[0]), params)
    last = pp * tp - 1
    np.testing.assert_array_equal(rank_flat_from_jax(params, models[last]).numpy(), rows[last])
    models[last].load_flat(torch.from_numpy(rows[last].copy()))
    local = jax.tree.map(np.asarray, jl.unravel_local(jnp.asarray(rows[last])))
    assert np.array_equal(models[last].wte.detach().numpy(), local["wte"])
    leaf = "wq" if family == "llama" else "w_qkv"
    assert np.array_equal(getattr(models[last].layers[-1], leaf).detach().numpy(),
                          local["layers"][leaf][-1])
    dense = _port_model(family, tied)
    want = params_to_jax(dense.init_flat(torch.Generator().manual_seed(3)), dense.config,
                         vocab=PAD_TO)
    got = [m.init_flat(torch.Generator().manual_seed(3)) for m in models]
    _leaves_equal(dense_from_rank_flats(got, models[0]), want)


# -- the groups, rank for rank against JAX's mesh -----------------------------------

GROUPS_WORKER = """
import json
from acco_tpu_torch.parallel.mesh import RankGroups

def order(g):
    return None if g is None else [dist.get_global_rank(g, i) for i in range(dist.get_world_size(g))]

out = []
for mesh in json.load(open(os.path.join(WORKDIR, "meshes.json"))):
    g, sg = RankGroups.build(mesh, RANK)
    tg, pg, vg = g.tensor_group(), g.pipeline_group(), g.model_group()
    out.append({
        "dp": g.dp_index, "sp": g.sp_index, "model": g.model_indices(), "shard": g.shard_index,
        "data": order(g.data), "comm_data": order(g.comm_data), "world": order(g.world),
        "comm_world": order(g.comm_world), "seq": None if sg is None else order(sg.group),
        "sg_rank": None if sg is None else sg.rank,
        "tensor": None if tg is None else order(tg.group), "tg_rank": None if tg is None else tg.rank,
        "pipe": None if pg is None else order(pg.group), "pg_rank": None if pg is None else pg.rank,
        "vocab": order(vg.group), "vg_rank": vg.rank, "comm_model": order(g.comm_tensor),
        "comm_inner": order(g.comm_inner), "all": order(g.all), "comm_all": order(g.comm_all),
        "twins": [g.data is not g.comm_data or g.data is None, g.world is not g.comm_world,
                  g.tensor is not g.comm_tensor, g.inner is not g.comm_inner or g.inner is None]})
json.dump(out, open(os.path.join(WORKDIR, f"g{RANK}.json"), "w"))
"""

GROUP_MESHES = ({"dp": 2, "pp": 2, "tp": 2}, {"dp": 1, "pp": 2, "tp": 2, "sp": 2},
                {"tp": 2, "pp": 2, "dp": 2}, {"sp": 2, "dp": 2, "tp": 2},
                {"dp": 2, "sp": 2, "pp": 2})


def test_mesh_groups_match_jax_make_mesh(tmp_path):
    """Each mesh's groups on 8 gloo ranks against JAX's ``make_mesh`` grid
    of the same key order: the rank's place; the dp, sequence, tensor and
    pipeline groups (the ranks that differ only on that axis); ZeRO-1's
    world in ``dp_index * sp + sp_index`` order; the model group, the
    combined (pp, tp) one in ``pp_index * tp + tp_index`` order (the
    vocab's) where both are on; the comm twins groups of their own over
    the same ranks."""
    (tmp_path / "meshes.json").write_text(json.dumps(GROUP_MESHES))
    run_ranks(GROUPS_WORKER, 8, tmp_path, timeout=RANKS_TIMEOUT)
    got = [json.loads((tmp_path / f"g{r}.json").read_text()) for r in range(8)]
    for k, mesh in enumerate(GROUP_MESHES):
        names = list(mesh)
        ids = np.vectorize(lambda d: d.id)(np.asarray(make_mesh(mesh, jax.devices()[:8]).devices))
        sizes = {a: mesh.get(a, 1) for a in ("dp", "sp", "tp", "pp")}

        def ranks(at, axes):
            """The ranks over ``axes`` (major to minor), the other indices ``at``'s."""
            out = []
            for idx in np.ndindex(*(sizes[a] for a in axes)):
                c = dict(at, **dict(zip(axes, idx)))
                out.append(int(ids[tuple(c[a] for a in names)]))
            return out

        for r in range(8):
            g = got[r][k]
            at = {a: int(i) for a, i in zip(names, np.argwhere(ids == r)[0])}
            at.update({a: 0 for a in sizes if a not in at})
            what = f"rank {r} of {mesh}"
            assert (g["dp"], g["sp"]) == (at["dp"], at["sp"]), what
            assert g["shard"] == at["dp"] * sizes["sp"] + at["sp"], what
            assert g["world"] == g["comm_world"] == ranks(at, ("dp", "sp")), what
            assert g["data"] == g["comm_data"] == (ranks(at, ("dp",)) if sizes["dp"] > 1
                                                   else None), what
            if sizes["sp"] > 1:
                assert g["seq"] == ranks(at, ("sp",)) and g["sg_rank"] == at["sp"], what
            model = [a for a in ("pp", "tp") if sizes[a] > 1]
            assert g["vocab"] == g["comm_model"] == ranks(at, tuple(model)), what
            assert g["vg_rank"] == at["pp"] * sizes["tp"] + at["tp"], what
            assert g["model"] == {f"{a}_index": at[a] for a in model}, what
            assert g["tensor"] == (ranks(at, ("tp",)) if sizes["tp"] > 1 else None), what
            assert g["pipe"] == (ranks(at, ("pp",)) if sizes["pp"] > 1 else None), what
            if sizes["tp"] > 1:
                assert g["tg_rank"] == at["tp"], what
            if sizes["pp"] > 1:
                assert g["pg_rank"] == at["pp"], what
            if len(model) == 2:
                assert g["comm_inner"] == g["tensor"], what
            assert g["all"] == g["comm_all"] == list(range(8)) and all(g["twins"]), what


# -- rounds on gloo ranks against JAX's dp run ----------------------------------------


def _blocks(n):
    """``n`` global blocks: [N_ACC, REF_DP * BATCH, SEQ] ids over the real vocab."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 63, (N_ACC, REF_DP * BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((N_ACC, REF_DP), np.float32)})
    return out


def _jax_dp_run(spec, params, blocks):
    """JAX's dp rounds (or DDP steps) on ``REF_DP`` virtual devices: per
    round the loss and the state, and the step."""
    mesh = make_mesh({"dp": REF_DP}, devices=jax.devices()[:REF_DP])
    model = _jax_model(spec["family"], over=ROUND_LAYERS[spec["family"]])
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
    return out, step


def _relaid(step, jmodel, vec, mesh):
    """A dense flat vector of JAX's dp state as the [model index, n_local]
    rows of JAX's layout of ``mesh``'s model axes."""
    tree = _numpy_tree(step.unravel(jnp.asarray(np.asarray(vec)[:step.geom.n_params])))
    return _jax_layout(jmodel, tree, mesh).stack_flat(tree)


def _coords(mesh, rank):
    """``rank``'s index on every axis of ``mesh`` (row-major, key order)."""
    out, rest = {}, rank
    for axis in reversed(list(mesh)):
        rest, out[axis] = divmod(rest, mesh[axis])
    return {a: out.get(a, 0) for a in ("dp", "sp", "tp", "pp")}


def _round_inputs(family, method):
    """A rounds test's spec, JAX model, dense params (numpy), the port's
    dense flat vector and the global blocks."""
    rounds = 2 if method == "acco" else 1
    over = ROUND_LAYERS[family]
    spec = dict(family=family, arch=_arch(family, **over), vocab_pad_to=PAD_TO, method=method,
                sched=SCHED, opt=OPT, rounds=rounds, lr_grad_accounting=False)
    jmodel = _jax_model(family, over=over)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(2)))
    flat = params_from_jax(params, _port_model(family, over=over).config, vocab=PAD_TO).numpy()
    blocks = _blocks(rounds + (0 if method == "ddp" else 1))
    return spec, jmodel, params, flat, blocks


@pytest.mark.parametrize("family, method", [("llama", "acco"), ("llama", "dpu"),
                                            ("llama", "ddp"), ("gpt_neo", "acco")])
def test_composed_rounds_match_jax_dp(family, method, tmp_path):
    """The seed round and ACCO's speculative and committed rounds, one DPU
    round or one DDP step on the four composed meshes at once on gloo
    ranks, against JAX's dp run on the same blocks: the losses, every
    rank's local flat parameters (its row of JAX's dense state re-laid by
    JAX's layout of the mesh) and its ZeRO-1 master, m and v shards, the
    schedule's counter and the committed count."""
    spec, jmodel, params, flat, blocks = _round_inputs(family, method)
    runs = []
    for k, mesh in enumerate(MESHES):
        work = tmp_path / f"mesh{k}"
        work.mkdir()
        dp, sp = mesh.get("dp", 1), mesh.get("sp", 1)
        runs.append(start_training(  # the zig-zag ring beside tp, the contiguous on pp x sp
            dict(spec, mesh=mesh, dp=dp, sp=sp, batch=REF_DP * BATCH // dp,
                 zigzag="tp" in mesh), flat, blocks, work, timeout=RANKS_TIMEOUT))
    want, step = _jax_dp_run(spec, params, blocks)
    final = want["states"][-1]
    for mesh, run in zip(MESHES, runs):
        relaid = [_relaid(step, jmodel, s.flat_params, mesh) for s in want["states"]]
        opt = {name: _relaid(step, jmodel, getattr(final.zero1.opt, name), mesh)
               for name in ("params", "mu", "nu")}
        layout = _jax_layout(jmodel, params, mesh)
        dp, sp = mesh.get("dp", 1), mesh.get("sp", 1)
        if family == "gpt_neo" and dp * sp > 1:  # the prefix crosses ZeRO-1's shards
            S = -(-layout.n_local // (dp * sp))
            nb = getattr(layout, "n_repl_both", layout.n_repl)
            assert S < nb <= layout.n_repl < layout.n_local, mesh
        for r, got in enumerate(run()):
            c = _coords(mesh, r)
            m, shard = c["pp"] * mesh.get("tp", 1) + c["tp"], c["dp"] * sp + c["sp"]
            what = f"rank {r} {c} of {mesh} {family} {method}"
            np.testing.assert_allclose(got["losses"], want["losses"], err_msg=what, **LOSS_TOL)
            for i, row in enumerate(relaid):
                np.testing.assert_allclose(got["flats"][1 + i][:row.shape[1]], row[m],
                                           err_msg=f"{what}: params after round {i}",
                                           **PARAM_TOL)
            S = got["opt_params"].shape[-1]
            for name, row in opt.items():
                want_shard = np.pad(row[m], (0, S * dp * sp - row.shape[1]))
                key = "opt_params" if name == "params" else name
                np.testing.assert_allclose(got[key][-1], want_shard[shard * S:(shard + 1) * S],
                                           err_msg=f"{what}: {name} shard", **PARAM_TOL)
            assert got["sched"][-1] == int(final.zero1.sched_grads), what
            assert got["committed"][-1] * REF_DP / dp == float(final.zero1.grads_committed), what


# -- the eval through the pipeline under sp -------------------------------------------

EVAL_WORKER = """
import numpy as np
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.parallel.common import MicrobatchBlock, prep_cp_leaves
from acco_tpu_torch.parallel.mesh import RankGroups
from acco_tpu_torch.parallel.pp import eval_block, make_pp_loss_fn

cfg = dict(np.load(os.path.join(WORKDIR, "in.npz")))
g, sg = RankGroups.build({{"pp": 2, "sp": 2}}, RANK)
arch = {ARCH!r}
arch["attention_layers"] = tuple(arch["attention_layers"])
pg = g.pipeline_group()
model = GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, attention="ring",
                    sequence_group=sg, zigzag=True, pipeline_group=pg, vocab_pad_to={pad})
ids, labels = torch.tensor(cfg["ids"]), torch.tensor(cfg["labels"])
blk = prep_cp_leaves(MicrobatchBlock(ids, torch.ones_like(ids), labels, torch.ones(1)), sg, True)
block, count = eval_block(blk.input_ids, blk.attention_mask, blk.labels, 2, sg)
with torch.no_grad():
    nll, _ = make_pp_loss_fn(model)(torch.tensor(cfg["rows"][pg.rank]), block)
sums = torch.stack([nll.float(), count])
dist.all_reduce(sums, group=g.world)
np.savez(os.path.join(WORKDIR, f"eval{{RANK}}.npz"), sums=sums.numpy(),
         m=block.input_ids.shape[0])
"""


def test_pp_sp_eval_matches_dense(tmp_path):
    """The eval through the pipeline on {pp: 2, sp: 2} (the trainer's
    ``_pp_eval_sums``: each rank's zig-zag chunk with globally shifted
    labels, ``eval_block`` weighting each of the 2 microbatches by its
    target count summed over sp, the sums over the world): every rank
    holds JAX's dense nll sum (its model's ``apply`` and
    ``causal_lm_loss``) and the target count of a batch of 6 rows with
    some labels ignored."""
    over = ROUND_LAYERS["gpt_neo"]
    jmodel = _jax_model("gpt_neo", over=over)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(6)))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 63, (6, SEQ))
    labels = ids.copy()
    labels[1, 4:9] = labels[4, 2] = -100
    rows = jax_tp.TpLayout(params, jmodel.pp_param_specs(), 2).stack_flat(params)
    np.savez(tmp_path / "in.npz", ids=ids, labels=labels, rows=rows)
    ranks = torch_ranks.Ranks(EVAL_WORKER.format(ARCH=_arch("gpt_neo", **over), pad=PAD_TO), 4,
                              tmp_path, timeout=RANKS_TIMEOUT)
    nll = jax.jit(lambda p: jax_causal_lm_loss(jmodel.apply(p, jnp.asarray(ids)),
                                               jnp.asarray(labels), num_valid=1.0,
                                               real_vocab=63))(params)
    count = (labels[:, 1:] != -100).sum()
    ranks.join()
    for r in range(4):
        got = np.load(tmp_path / f"eval{r}.npz")
        assert int(got["m"]) == 2
        np.testing.assert_allclose(got["sums"][0], float(nll), **LOSS_TOL)
        assert float(got["sums"][1]) == count


# -- the entry point under torchrun ---------------------------------------------------

CLI_ARGS = ["--device", "cpu", "train=acco", "model=tiny128", "data=synthetic",
            "data.synthetic_num_docs=32", "train.max_length=64", "train.batch_size=2",
            "train.n_grad_accumulation=2", "train.nb_steps_tot=8",
            "train.use_mixed_precision=false", "train.save=true", "train.checkpoint_every_s=0",
            "+train.delta_step_for_log=4"]
CLI_MESH = "train.mesh_shape={dp: 1, pp: 2, tp: 2}"


def _cli_ranks(work, ws, *overrides):
    """The entry point's trainer on ``ws`` forked ranks with the test's
    arguments and ``overrides``, its run dir ``work/run``."""
    work.mkdir()
    return torch_ranks.start_cli([*CLI_ARGS, f"hydra.run.dir={work / 'run'}", *overrides], ws,
                                 work, timeout=RANKS_TIMEOUT)


def _params_npz(run):
    return np.load(run / "checkpoints" / "acco" / "step_8" / "params.npz")["flat_params"]


def test_torchrun_cli_runs_tp_pp_on_cpu(tmp_path):
    """``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
    train.mesh_shape={dp: 1, pp: 2, tp: 2}``: ACCO to 8 grads in float32
    with a periodic save at 4; the final ``params.npz`` is the dense,
    unpadded model (the plain config's leaf shapes), equal to the four
    rank files' rows gathered by ``ComposedLayout`` and unpadded, the
    files carrying both indices, and to the dense run's (the same
    arguments on one rank, no mesh) at the dp bars, its losses too; the
    entry point's trainer on the same mesh resumed from the save at 4
    grads ends on the same losses and the same ``params.npz``, bit for
    bit."""
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.parallel.tp import host_ravel

    dense_run = _cli_ranks(tmp_path / "dense", 1)  # beside the torchrun
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         "-m", "acco_tpu_torch", *CLI_ARGS, CLI_MESH, f"hydra.run.dir={tmp_path / 'a'}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out.stdout[-2000:]
    summary = json.loads(lines[0])
    steps = tmp_path / "a" / "checkpoints" / "acco"
    resumed_run = _cli_ranks(tmp_path / "c", 4, CLI_MESH, f"train.resume_from={steps / 'step_4'}")
    assert summary["mesh"] == {"dp": 1, "sp": 1, "pp": 2, "tp": 2}
    assert summary["count_grad_tot"] == 8 and summary["skipped_rounds"] == 0
    cfg = {"config_path": "/config/model/tiny128.json"}
    dense = build_model(cfg, repo_root=REPO, dtype=torch.float32)
    shard = build_model(cfg, repo_root=REPO, dtype=torch.float32,
                        tensor_group=TensorGroup(None, 2, 0),
                        pipeline_group=TensorGroup(None, 2, 0),
                        model_group=TensorGroup(None, 4, 0), vocab_pad_multiple=4)
    assert summary["n_params"] == shard.n_params
    flat = _params_npz(tmp_path / "a")
    assert flat.shape == (dense.n_params,)
    files = [torch.load(steps / "step_8" / "state" / f"rank_{r}.pt", weights_only=True)
             for r in range(4)]
    assert [(f["meta"]["pp_index"], f["meta"]["tp_index"]) for f in files] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    gathered = shard.unpad_vocab(shard.tp_layout.gather_params(
        [f["state"]["flat_params"][:shard.n_params].float().numpy() for f in files]))
    np.testing.assert_array_equal(host_ravel(gathered, np.float32), flat)
    assert jax.tree.map(np.shape, params_to_jax(torch.from_numpy(flat), dense.config)) == \
        jax.tree.map(np.shape, gathered)
    losses = [r["loss"] for r in summary["round_log"]]
    want = dense_run()
    np.testing.assert_allclose(losses, [r["loss"] for r in want["round_log"]], **LOSS_TOL)
    np.testing.assert_allclose(flat, _params_npz(tmp_path / "dense" / "run"), **PARAM_TOL)
    resumed = resumed_run()
    assert resumed["seed_loss"] is None and resumed["count_grad_tot"] == 8
    n = len(resumed["round_log"])  # the rounds after the last save at 4 committed grads
    assert 0 < n < len(losses) and [r["loss"] for r in resumed["round_log"]] == losses[-n:]
    np.testing.assert_array_equal(_params_npz(tmp_path / "c" / "run"), flat)
