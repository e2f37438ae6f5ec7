"""The port's state tables, dtype policy and memory sieve against the JAX
package's, and the census on 2 gloo ranks.

- State tables: ``sharding/tables.py``'s ``train_state_table`` (acco, dpu,
  ddp), ``eval_state_table`` and ``serve_state_table`` give, for every
  leaf of the port's states, the spec JAX's give, over dp, dp x sp,
  dp x tp, dp x pp and dp x pp x tp (exact). The train step's
  ``shard_axes``/``model_axis`` name each mesh as JAX's step does.
- dtypes: JAX's policy on JAX's state and the port's on the port's, both
  from one seeded init (converted by ``models/convert.py``), give the same
  verdict: conformant, and with a bf16 Adam moment the same violation.
- Memory: the sieve's per-leaf bytes equal ``tools/hbm_check.py``
  ``sweep_report``'s for the same presets on 8 ranks (every mesh JAX
  lists), and its serve replica ``serve_report``'s, transients included
  (exact); the tool is imported by path.
- Census: one ACCO round on 2 gloo ranks moves the analytic bytes within
  JAX's 10%; one extra all-reduce of the flat gradient fails the gate.
"""

import contextlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.analysis.dtypes import check_dtype_policy as jax_check_dtype_policy
from acco_tpu.analysis.dtypes import train_state_rules as jax_train_state_rules
from acco_tpu.sharding import tables as jax_tables
from acco_tpu_torch.analysis.dtypes import check_dtype_policy, train_state_rules
from acco_tpu_torch.sharding import tables
from acco_tpu_torch.utils.checkpoint import state_leaves
import torch_ranks
from torch_ranks import REPO, run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

# (shard_axes, model_axis) of each mesh, as both train steps name them
MESHES = {
    "dp": ("dp", None),
    "dp x sp": (("dp", "sp"), None),
    "dp x tp": ("dp", "tp"),
    "dp x pp": ("dp", "pp"),
    "dp x pp x tp": ("dp", ("pp", "tp")),
}
ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, max_position_embeddings=16)
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)


def _norm(spec):
    """A spec's entries, a one-axis tuple as its axis (JAX keeps ('dp',))."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _port_state(mode, dtype=torch.bfloat16):
    from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from acco_tpu_torch.ops.schedules import get_schedule
    from acco_tpu_torch.parallel.acco import AccoTrainStep
    from acco_tpu_torch.parallel.ddp import DDPTrainStep

    model = LlamaModel(LlamaConfig(**ARCH), dtype=dtype)
    cls = DDPTrainStep if mode == "ddp" else AccoTrainStep
    kw = {} if mode == "ddp" else {"mode": mode}
    step = cls(model, get_schedule(*SCHED), **kw, **OPT)
    return step, step.init_state(model.init_flat(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["acco", "dpu", "ddp"])
def test_train_and_eval_state_tables_match_jax(mode, mesh):
    shard_axes, model_axis = MESHES[mesh]
    _, state = _port_state(mode)
    port = tables.train_state_table(mode, shard_axes, model_axis)
    want = jax_tables.train_state_table(mode, shard_axes, model_axis)
    assert port.name == want.name
    paths = list(state_leaves(state))
    assert len(paths) == (10 if mode == "ddp" else 13)
    for path in paths:
        assert _norm(port.match(path)) == _norm(want.match(path)), path
        assert len(port.matching_rules(path)) == 1, path
    ev, jev = (tables.eval_state_table(shard_axes, model_axis),
               jax_tables.eval_state_table(shard_axes, model_axis))
    assert _norm(ev.match("flat_params")) == _norm(jev.match("flat_params"))


def test_serve_state_table_and_step_axes_match_jax():
    """The serve table over the engine's abstract state (params, pools) as
    JAX's; the train step names each mesh's axes as JAX's steps do."""
    import types

    from acco_tpu_torch.parallel.common import FlatTrainStep
    from acco_tpu_torch.serve.engine import ServeEngine

    step, _ = _port_state("acco", torch.float32)
    engine = ServeEngine(step.model, page_size=4, num_pages=8, max_pages_per_seq=2, max_slots=1)
    for family in ("llama", "gpt_neo"):
        port, want = tables.serve_state_table(family), jax_tables.serve_state_table(family)
        for path in ("k_pages", "v_pages", "params/wte", "params/layers/wq"):
            assert _norm(port.match(path)) == _norm(want.match(path)) == (), path
    state = engine.abstract_state()
    assert engine.rule_table().coverage(state).ok
    assert all(t.device.type == "meta" for t in (state["k_pages"], *state["params"].values())
               if torch.is_tensor(t))
    assert _norm(engine.spec.pool_specs()[0]) == _norm(
        jax_tables.serve_state_table().match("k_pages"))
    assert (step.shard_axes, step.model_axis) == ("dp", None)
    for axis, composed, want in (("tp", False, "tp"), ("pp", False, "pp"),
                                 ("pp,tp", True, ("pp", "tp"))):
        ns = types.SimpleNamespace(groups=types.SimpleNamespace(
            tensor=object(), composed=composed, model_axis=axis), sequence_group=object())
        assert FlatTrainStep.model_axis.fget(ns) == want
        assert FlatTrainStep.shard_axes.fget(ns) == ("dp", "sp")


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_dtype_policy_verdicts_match_jax(moment):
    """One seeded init, JAX's state (bf16 working params on a one-device
    mesh) and the port's from the converted params: the same verdict, and
    with Adam's mu in bf16 the same violating path."""
    from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
    from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
    from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
    from acco_tpu.parallel.mesh import make_mesh
    from acco_tpu_torch.models.convert import params_from_jax

    jmodel = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(0))
    jstep = JaxAccoTrainStep(jmodel, make_mesh(devices=jax.devices()[:1]),
                             jax_get_schedule(*SCHED), param_dtype=jnp.bfloat16, **OPT)
    jstate = jstep.abstract_state()
    step, state = _port_state("acco")
    state = step.init_state(params_from_jax(jax.tree.map(np.asarray, params), step.model.config))
    if moment == "bfloat16":
        jopt = jstate.zero1.opt._replace(mu=jax.ShapeDtypeStruct(jstate.zero1.opt.mu.shape,
                                                                 jnp.bfloat16))
        jstate = jstate._replace(zero1=jstate.zero1._replace(opt=jopt))
        opt = state.zero1.opt._replace(mu=state.zero1.opt.mu.bfloat16())
        state = state._replace(zero1=state.zero1._replace(opt=opt))
    want = jax_check_dtype_policy(jstate, jax_train_state_rules(jnp.bfloat16))
    got = check_dtype_policy(state, train_state_rules(torch.bfloat16))
    assert (got.ok, got.checked) == (want.ok, want.checked) == (moment == "float32", 13)
    assert [(v.path, v.dtype) for v in got.violations] == \
        [(v.path, v.dtype) for v in want.violations]


def _hbm_check():
    spec = importlib.util.spec_from_file_location("hbm_check",
                                                  os.path.join(REPO, "tools", "hbm_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_memory_sieve_matches_hbm_check():
    """Per leaf, every mesh JAX's sweep lists on 8 ranks (it leaves out tp x
    sp, which the port runs), both presets, train and serve, exact; and
    the Llama-3-8B serving replica, params, pool and transients, exact."""
    from acco_tpu_torch.analysis.memory import serve_report, sweep_report

    tool = _hbm_check()
    with contextlib.redirect_stdout(io.StringIO()):
        want = tool.sweep_report(8, 80.0)
        want_serve = tool.serve_report(os.path.join(REPO, "config/serve/llama3-8b.yaml"), 80.0)
    got = sweep_report(8, 80.0, out=None)
    key = lambda r: (r["preset"], r.get("serve"), r.get("dp"), r.get("tp"), r.get("pp"),  # noqa: E731
                     r.get("sp"))
    mine = {key(r): r for r in got}
    for row in want:
        ours = mine[key(row)]
        assert ours["total"] == row["total"], key(row)
        if not row.get("serve"):
            assert ours["per_leaf"] == row["per_leaf"], key(row)
    assert len(got) > len(want)  # the tp x sp meshes
    serve = serve_report(os.path.join(REPO, "config/serve/llama3-8b.yaml"), 80.0, out=None)
    assert serve == want_serve


CENSUS_WORKER = """
import json
from acco_tpu_torch.analysis.census import check_census, ring_comm_bytes
from acco_tpu_torch.analysis.programs import SEQ, tiny_block, tiny_model, _train_step
from acco_tpu_torch.analysis.trace import CollectiveRecorder
from acco_tpu_torch.parallel.mesh import RankGroups

groups, _ = RankGroups.build({"dp": 2}, RANK)
model, flat = tiny_model("cpu")
step = _train_step("acco", model, groups)
state, block = step.init_state(flat), tiny_block("cpu", seed=RANK)
model_bytes = ring_comm_bytes(step.geom.padded_size, 2, 2)
out = {}
for extra in (False, True):
    if extra:  # one more all-reduce of the flat gradient before the update
        update = step.update
        def with_extra(flat_grads, *a, **k):
            dist.all_reduce(flat_grads.clone(), group=groups.comm_world)
            return update(flat_grads, *a, **k)
        step.update = with_extra
    with CollectiveRecorder() as rec:
        step.round(state, block, False)
    rep = check_census(rec.calls, model_bytes, small_elems=512)
    out[str(extra)] = [rep.ok, rep.measured_bytes, model_bytes, rep.summary()]
json.dump(out, open(os.path.join(WORKDIR, f"out{RANK}.json"), "w"))
"""


def test_census_on_two_gloo_ranks(tmp_path):
    """An ACCO round (odd: it commits) on 2 gloo ranks: its reduce-scatter
    and all-gather move (ns-1)/ns · Pp · (4 + 2) bytes, within JAX's 10%
    (exactly); an extra all-reduce of the flat gradient fails."""
    run_ranks(CENSUS_WORKER, 2, tmp_path, timeout=120)
    for r in range(2):
        out = json.load(open(tmp_path / f"out{r}.json"))
        ok, measured, model, summary = out["False"]
        assert ok and measured == model, summary
        ok, measured, model, summary = out["True"]
        # the extra all-reduce: 2 (ns-1)/ns · Pp · 4 = 4/3 of the model on top of it
        assert not ok and measured == pytest.approx(model * 7 / 3), summary


def test_memory_sieve_flags_what_does_not_fit():
    """Seeded violations of the sieve: Llama-3-8B's ACCO state on one rank
    (18 bytes a parameter, ~135 GiB) is over 80 GB where 16 ranks of pp
    x dp bring it under, and a state leaf no rule covers cannot be priced
    (closed world)."""
    from acco_tpu_torch.analysis.memory import abstract_train_state, price_tree, sweep_report
    from acco_tpu_torch.sharding.rules import ShardingRuleError

    one = {r["preset"]: r for r in sweep_report(1, 80.0, presets=("meta-llama/Meta-Llama-3-8B",),
                                                out=None) if not r.get("serve")}
    assert not one["meta-llama/Meta-Llama-3-8B"]["fits"]
    sixteen = sweep_report(16, 80.0, presets=("meta-llama/Meta-Llama-3-8B",), out=None)
    assert any(r["fits"] and r.get("pp", 1) > 1 for r in sixteen if not r.get("serve"))
    state = abstract_train_state("ddp", 1000)
    with pytest.raises(ShardingRuleError, match="no rule matches leaf 'mystery'"):
        price_tree({**state._asdict(), "mystery": state.flat_params},
                   tables.train_state_table("ddp", "dp"), {"dp": 1})
