"""The port's tensor parallelism against the JAX package.

- Layout: ``pad_vocab`` and ``TpLayout`` (``stack_flat``,
  ``gather_params``, ``n_repl``) bit-equal to JAX's on the same numpy
  params, for both families (tied and untied Llama, vocab 63 padded to
  64); the model's local flat layout is JAX's row; its init at tp 1 is
  the dense init; the weight carry-across by rank.
- The vocab-parallel losses: ``vocab_parallel_causal_lm_loss`` and the
  plain path of ``vocab_parallel_fused_ce_loss`` on 2 and 4 gloo ranks
  against JAX's two functions under ``shard_map`` on the virtual CPU
  devices, vocab 63 padded to 64, smoothing 0 and 0.1: the loss and
  each rank's gradients of its head slice and of the hidden states.
- Rounds: the seed round and ACCO, DPU and DDP rounds at {dp: 2, tp: 2}
  and {dp: 1, tp: 4}, both families, against JAX's tp run: the losses at
  rtol 1e-5 / atol 1e-6, each rank's local flat parameters and ZeRO-1
  shards at rtol 1e-4 / atol 1e-5 (tests/test_context_parallel.py:67,73).
- ``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
  "train.mesh_shape={dp: 2, tp: 2}"``: its dense ``params.npz`` is the
  unpadded model's layout; the rank layout follows mesh_shape's key
  order; ``tp`` with ``sp``, and ``pp`` with ``tp`` or ``sp``, raise by
  their item.
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
from jax.sharding import PartitionSpec as JP

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.fused_ce import vocab_parallel_fused_ce_loss as jax_vp_fused
from acco_tpu.ops.losses import vocab_parallel_causal_lm_loss as jax_vp_ce
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
from acco_tpu_torch.parallel import tp as port_tp
from acco_tpu_torch.parallel.mesh import check_mesh
import torch_ranks
from torch_ranks import REPO, run_ranks, start_training

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

N_ACC, BATCH, SEQ = 1, 2, 16
ARCH = dict(vocab_size=63, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=4, max_position_embeddings=SEQ)
NEO_ARCH = dict(vocab_size=63, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=SEQ, window_size=8,
                attention_layers=["global", "local"])
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _arch(family, tied=True):
    if family == "llama":
        return dict(ARCH, tie_word_embeddings=tied)
    return NEO_ARCH


def _port_config(family, tied=True):
    if family == "llama":
        return LlamaConfig(**_arch(family, tied))
    return GPTNeoConfig(**dict(NEO_ARCH, attention_layers=tuple(NEO_ARCH["attention_layers"])))


def _jax_model(family, tied=True, tp_axis=None, pad_to=None):
    kw = dict(param_dtype=jnp.float32, tensor_axis=tp_axis, vocab_pad_to=pad_to)
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**_arch(family, tied)), **kw)
    return JaxGPTNeoModel(JaxGPTNeoConfig(**NEO_ARCH), **kw)


PAD_TO = 64  # vocab 63 padded to 64, as JAX's padded-vocab test (pad_vocab would give 128)


def _local_model(family, tp, rank, tied=True):
    """A port model on a stand-in tensor group (no collective runs: the
    layout and the init only)."""
    cls = LlamaModel if family == "llama" else GPTNeoModel
    tg = TensorGroup(group=None, size=tp, rank=rank)
    return cls(_port_config(family, tied), dtype=torch.float32, tensor_group=tg,
               vocab_pad_to=PAD_TO)


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- layout ------------------------------------------------------------------


@pytest.mark.parametrize("vocab, tp", [(50257, 1), (50257, 2), (50257, 4), (50304, 4),
                                       (128256, 2), (63, 2), (63, 4), (64, 2)])
def test_pad_vocab_matches_jax(vocab, tp):
    assert port_tp.pad_vocab(vocab, tp) == jax_tp.pad_vocab(vocab, tp)
    assert port_tp.pad_vocab(50257, 2) == port_tp.pad_vocab(50257, 4) == 50304
    assert port_tp.pad_vocab(50257, 1) == 50257 and port_tp.pad_vocab(128256, 4) == 128256


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_layout_matches_jax(family, tied, tp):
    """``stack_flat`` bit-equal to JAX's on the same numpy params (vocab 63
    padded to 64), ``gather_params`` its inverse and JAX's, the same
    ``n_local``/``n_repl``, the model's local layout the row's, and the
    carry-across by rank."""
    jmodel = _jax_model(family, tied, "tp", PAD_TO)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(1)))
    jl = jax_tp.TpLayout(params, jmodel.tp_param_specs(), tp)
    model = _local_model(family, tp, 1, tied)
    pl = model.tp_layout
    assert (pl.n_local, pl.n_repl) == (jl.n_local, jl.n_repl)
    assert model.n_params == pl.n_local
    rows = pl.stack_flat(params)
    np.testing.assert_array_equal(rows, jl.stack_flat(params))
    _leaves_equal(pl.gather_params(rows), jl.gather_params(rows))
    _leaves_equal(pl.gather_params(rows), params)
    np.testing.assert_array_equal(rank_flat_from_jax(params, model).numpy(), rows[1])
    _leaves_equal(dense_from_rank_flats(list(rows), model), params)
    # the model's parameters are views into the row, leaf by leaf as JAX's unravel
    model.load_flat(torch.from_numpy(rows[1].copy()))
    local = jax.tree.map(np.asarray, jl.unravel_local(jnp.asarray(rows[1])))
    assert np.array_equal(model.wte.detach().numpy(), local["wte"])
    assert np.array_equal(model.layers[1].w_up.detach().numpy() if family == "llama"
                          else model.layers[1].w_fc.detach().numpy(),
                          local["layers"]["w_up" if family == "llama" else "w_fc"][1])


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
def test_tp_init_is_the_dense_init(family, tied):
    """Each rank's init is its slice of the dense init of the padded model
    (the same generator, leaf by leaf in the dense order), at tp 1 the
    dense init itself."""
    cls = LlamaModel if family == "llama" else GPTNeoModel
    dense = cls(_port_config(family, tied), dtype=torch.float32, vocab_pad_to=64)
    want = params_to_jax(dense.init_flat(torch.Generator().manual_seed(3)),
                         dense.config, vocab=64)
    rows = [_local_model(family, 2, r, tied).init_flat(torch.Generator().manual_seed(3))
            for r in range(2)]
    _leaves_equal(dense_from_rank_flats(rows, _local_model(family, 2, 0, tied)), want)
    one = cls(_port_config(family, tied), dtype=torch.float32,
              tensor_group=TensorGroup(None, 1, 0))
    plain = cls(_port_config(family, tied), dtype=torch.float32)
    got = dense_from_rank_flats([one.init_flat(torch.Generator().manual_seed(3))], one)
    _leaves_equal(got, params_to_jax(plain.init_flat(torch.Generator().manual_seed(3)),
                                     plain.config))


def test_meshes_raise_by_item():
    """tp, pp and their compositions with each other and with sp pass the
    mesh check (item 9.4 ported them; the groups, rank for rank against
    JAX's mesh: tests/test_torch_compositions.py); a tp model on the ring
    (tp x sp) holds its shard's heads; serving under tp raises JAX's
    single-replica ValueError."""
    assert check_mesh({"dp": 2, "tp": 2})["tp"] == 2
    assert check_mesh({"dp": 2, "pp": 2})["pp"] == 2
    for shape in ({"sp": 2, "tp": 2}, {"pp": 2, "tp": 2}, {"pp": 2, "sp": 2}):
        sizes = check_mesh(shape)
        assert all(sizes[a] == n for a, n in shape.items())
    ring = LlamaModel(_port_config("llama"), attention="ring", sequence_group=object(),
                      tensor_group=TensorGroup(None, 2, 0), vocab_pad_to=PAD_TO)
    assert (ring.n_heads, ring.n_kv_heads) == (2, 2) and ring.sequence_group is not None
    model = _local_model("llama", 2, 0)
    with pytest.raises(ValueError, match="the serving decode path is single-replica"):
        model.prefill(torch.zeros((1, 4), dtype=torch.long))


# -- the vocab-parallel losses on gloo ranks against JAX's under shard_map -----

LOSS_WORKER = """
import numpy as np
from acco_tpu_torch.models.layers import TensorGroup
from acco_tpu_torch.ops.fused_ce import vocab_parallel_fused_ce_loss
from acco_tpu_torch.ops.losses import vocab_parallel_causal_lm_loss

cfg = dict(np.load(os.path.join(WORKDIR, "in.npz")))
tg = TensorGroup.of()
out = {}
for form in cfg["forms"]:  # every (head, smoothing) form on these ranks, one after another
    get = lambda key: cfg[f"{form}/{key}"]
    vl = get("w").shape[1] // WS
    h = torch.tensor(get("h"), requires_grad=True)
    w = torch.tensor(get("w")[:, RANK * vl:(RANK + 1) * vl].copy(), requires_grad=True)
    labels = torch.tensor(get("labels")).long()
    kw = dict(label_smoothing=float(get("smoothing")), real_vocab=int(get("real")))
    for name, fn in (("ce", lambda: vocab_parallel_causal_lm_loss(h @ w, labels, tg, **kw)),
                     ("fused", lambda: vocab_parallel_fused_ce_loss(h, w, labels, tg, **kw))):
        if name == "fused" and not int(get("fused")):
            continue
        loss = fn()
        dh, dw = torch.autograd.grad(loss, [h, w])
        out.update({f"{form}/{name}": loss.detach().numpy(), f"{form}/{name}_dh": dh.numpy(),
                    f"{form}/{name}_dw": dw.numpy()})
np.savez(os.path.join(WORKDIR, f"loss{RANK}.npz"), **out)
"""

VP_HEADS = {"v63": (63, 64, 32), "v511": (511, 512, 128)}  # vocab, padded, hidden
VP_SMOOTHING = (0.0, 0.1)


def _vp_inputs(tp, vocab, padded, hidden):
    """One head's inputs at ``tp`` (seeded by tp, as one case's were):
    hidden states, a padded head with random padding columns, labels
    over the real vocab with two ignored."""
    rng = np.random.default_rng(tp)
    h = rng.normal(size=(2, SEQ, hidden)).astype(np.float32)
    w = (rng.normal(size=(hidden, padded)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, SEQ)).astype(np.int32)
    labels[0, 3] = labels[1, 9] = -100
    return h, w, labels


def _write_forms(path, tp, forms):
    """``in.npz`` for :data:`LOSS_WORKER`: ``forms`` maps a form's name to
    ``(head name, smoothing)``."""
    arrays = {"forms": np.array(list(forms))}
    for form, (head, smoothing) in forms.items():
        vocab, padded, hidden = VP_HEADS[head]
        h, w, labels = _vp_inputs(tp, vocab, padded, hidden)
        arrays.update({f"{form}/h": h, f"{form}/w": w, f"{form}/labels": labels,
                       f"{form}/smoothing": smoothing, f"{form}/real": vocab,
                       f"{form}/fused": int(padded // tp >= 128)})
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def vp_ranks(tmp_path_factory):
    """``get(tp)``: every (head, smoothing) form's outputs on ``tp`` gloo
    ranks, one rank set a tp size for all its forms (started once a test
    process, at its first use)."""
    done = {}

    def get(tp):
        if tp not in done:
            work = tmp_path_factory.mktemp(f"vp{tp}")
            forms = {f"{head}-{smoothing}": (head, smoothing)
                     for head in VP_HEADS for smoothing in VP_SMOOTHING}
            _write_forms(work / "in.npz", tp, forms)
            run_ranks(LOSS_WORKER, tp, work)
            done[tp] = [dict(np.load(work / f"loss{r}.npz")) for r in range(tp)]
        return done[tp]

    return get


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("vocab, padded, hidden", [(63, 64, 32), (511, 512, 128)],
                         ids=["v63", "v511"])
def test_vocab_parallel_losses_match_jax(vocab, padded, hidden, tp, smoothing, vp_ranks):
    """On ``tp`` gloo ranks, each holding its slice of a padded head with
    random padding columns: ``vocab_parallel_causal_lm_loss`` on the local
    logits and the plain path of ``vocab_parallel_fused_ce_loss`` (where
    its per-shard vocab is inside K3's envelope, V/tp >= 128 and D a
    multiple of 128: vocab 511 padded to 512) against JAX's
    ``vocab_parallel_causal_lm_loss`` under ``shard_map`` on ``tp``
    virtual devices: the loss on every rank, each rank's gradient of its
    head slice, and the sum over the ranks of their hidden-state
    gradients (each covers its own slice) against the dense loss's. The
    port's per-rank gradients carry the factor tp that JAX's gradients
    carry inside a ``shard_map(check_vma=False)`` body (what the rounds
    below hold), so they are held against tp times the true gradient
    that ``jax.grad`` gives outside it. One rank set a tp size computes
    every form (the ``vp_ranks`` fixture); JAX's two functions run under
    ``jax.jit``, one compile each. JAX's fused wrapper itself needs the
    Pallas interpreter: the slow test below."""
    from jax import shard_map

    from acco_tpu.ops.losses import causal_lm_loss as jax_causal_lm_loss

    h, w, labels = _vp_inputs(tp, vocab, padded, hidden)
    fused = padded // tp >= 128
    mesh = make_mesh({"tp": tp}, devices=jax.devices()[:tp])

    def sharded(h_, w_):
        fn = shard_map(
            lambda hh, ww, ll: jax_vp_ce(hh @ ww, ll, "tp", smoothing, real_vocab=vocab),
            mesh=mesh, in_specs=(JP(), JP(None, "tp"), JP()), out_specs=JP(), check_vma=False)
        return fn(h_, w_, jnp.asarray(labels))

    loss_j, dw_j = jax.jit(jax.value_and_grad(sharded, argnums=1))(jnp.asarray(h),
                                                                   jnp.asarray(w))
    dh_dense = jax.jit(jax.grad(lambda hh: jax_causal_lm_loss(
        hh @ jnp.asarray(w), jnp.asarray(labels), smoothing, real_vocab=vocab)))(jnp.asarray(h))
    outs = vp_ranks(tp)
    vl = padded // tp
    key = f"{'v63' if vocab == 63 else 'v511'}-{smoothing}"
    for form in ("ce", "fused") if fused else ("ce",):
        name = f"{key}/{form}"
        for r, got in enumerate(outs):
            np.testing.assert_allclose(got[name], float(loss_j), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{form} loss, rank {r}")
            np.testing.assert_allclose(got[name + "_dw"],
                                       tp * np.asarray(dw_j)[:, r * vl:(r + 1) * vl],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{form} dW, rank {r}")
        np.testing.assert_allclose(sum(o[name + "_dh"] for o in outs), tp * np.asarray(dh_dense),
                                   rtol=1e-4, atol=1e-6, err_msg=f"{form} summed dH")


@pytest.mark.slow  # JAX's wrapper runs its Pallas kernel in the interpreter: ~45 s
def test_vocab_parallel_fused_matches_jax_interpreted(tmp_path):
    """The wrapper's plain path on 2 gloo ranks against JAX's
    ``vocab_parallel_fused_ce_loss`` itself (its Pallas kernel
    interpreted) under ``shard_map``, vocab 511 padded to 512, smoothing
    0.1: the loss."""
    from jax import shard_map

    tp, vocab, smoothing = 2, 511, 0.1
    _write_forms(tmp_path / "in.npz", tp, {"f": ("v511", smoothing)})
    h, w, labels = _vp_inputs(tp, *VP_HEADS["v511"])
    ranks = torch_ranks.Ranks(LOSS_WORKER, tp, tmp_path)
    mesh = make_mesh({"tp": tp}, devices=jax.devices()[:tp])
    fn = shard_map(
        lambda hh, ww, ll: jax_vp_fused(hh, ww, ll, "tp", smoothing, real_vocab=vocab,
                                        interpret=True),
        mesh=mesh, in_specs=(JP(), JP(None, "tp"), JP()), out_specs=JP(), check_vma=False)
    loss_f = fn(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels))
    ranks.join()
    for r in range(tp):
        got = np.load(tmp_path / f"loss{r}.npz")
        np.testing.assert_allclose(got["f/fused"], float(loss_f), rtol=1e-5, atol=1e-6)


# -- rounds on gloo ranks against JAX's tp run ---------------------------------


def _blocks(n, dp, seed=0):
    """``n`` global blocks: [n_acc, dp * BATCH, SEQ] ids over the real vocab."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 63, (N_ACC, dp * BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((N_ACC, dp), np.float32)})
    return out


def _jax_tp_run(spec, params, blocks):
    """JAX's tp rounds (or DDP steps) on {dp, tp} virtual devices: per round
    the loss and the state."""
    dp, tp = spec["dp"], spec["tp"]
    mesh = make_mesh({"dp": dp, "tp": tp}, devices=jax.devices()[:dp * tp])
    model = _jax_model(spec["family"], True, "tp", PAD_TO)
    kw = dict(param_dtype=jnp.float32, tensor_axis="tp", **spec["opt"])
    sched = jax_get_schedule(*spec["sched"])
    if spec["method"] == "ddp":
        step = JaxDDPTrainStep(model, mesh, sched, **kw)
    else:
        step = JaxAccoTrainStep(model, mesh, sched, mode=spec["method"], **kw)
    state = step.init_state(jax.tree.map(jnp.asarray, params))
    put = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    out = {"losses": [], "states": []}
    if spec["method"] == "ddp":
        fn = step.step_fn()
        todo = blocks
    else:
        state, loss = step.seed_fn()(state, put(blocks[0]))
        out["losses"].append(float(loss))
        fn, todo = step.round_fn(), blocks[1:]
    for b in todo:
        state, m = fn(state, put(b))
        out["losses"].append(float(m.loss))
        out["states"].append(jax.tree.map(np.asarray, state))
    return out, step.geom.padded_size


@pytest.mark.parametrize("method", ["acco", "dpu", "ddp"])
@pytest.mark.parametrize("dp, tp", [(2, 2), (1, 4)], ids=["dp2-tp2", "dp1-tp4"])
@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
def test_tp_rounds_match_jax(family, dp, tp, method, tmp_path):
    """The seed round and ACCO's two rounds (speculative, then committed),
    one DPU round or one DDP step on dp x tp gloo ranks, vocab 63 padded to
    64, against JAX's tp run: the losses, every rank's local flat
    parameters (JAX's row for its tp index) and its ZeRO-1 shards."""
    rounds = 2 if method == "acco" else 1
    spec = dict(family=family, arch=_arch(family), dp=dp, sp=1, tp=tp, vocab_pad_to=PAD_TO,
                zigzag=False, method=method, sched=SCHED, opt=OPT, rounds=rounds, batch=BATCH,
                lr_grad_accounting=False)
    params = _numpy_tree(_jax_model(family, True, "tp", PAD_TO).init(jax.random.PRNGKey(2)))
    cls = LlamaModel if family == "llama" else GPTNeoModel
    dense = cls(_port_config(family), dtype=torch.float32, vocab_pad_to=PAD_TO)
    blocks = _blocks(rounds + (0 if method == "ddp" else 1), dp)
    ranks = start_training(spec, params_from_jax(params, dense.config, vocab=PAD_TO).numpy(),
                           blocks, tmp_path)
    want, Pp = _jax_tp_run(spec, params, blocks)
    ranks = ranks()
    for r, got in enumerate(ranks):
        d, t = divmod(r, tp)
        what = f"rank {r} (dp {d}, tp {t}) of {{dp: {dp}, tp: {tp}}} {family} {method}"
        np.testing.assert_allclose(got["losses"], want["losses"], err_msg=what, **LOSS_TOL)
        S = got["opt_params"].shape[-1]
        first = 1  # the records after the seed round (or the initial state for DDP)
        for i, jstate in enumerate(want["states"]):
            row = jstate.flat_params[t * Pp:(t + 1) * Pp]
            np.testing.assert_allclose(got["flats"][first + i], row,
                                       err_msg=f"{what}: params after round {i}", **PARAM_TOL)
        final = want["states"][-1]
        for name in ("params", "mu", "nu"):
            leaf = getattr(final.zero1.opt, name)[t * Pp + d * S:t * Pp + (d + 1) * S]
            key = "opt_params" if name == "params" else name
            np.testing.assert_allclose(got[key][-1], leaf, err_msg=f"{what}: {name} shard",
                                       **PARAM_TOL)
        assert got["sched"][-1] == int(final.zero1.sched_grads), what


# -- the rank layout and the entry point ------------------------------------------

TP_LAYOUT_WORKER = """
import json
from acco_tpu_torch.parallel.mesh import RankGroups
ranks = dist.get_process_group_ranks
out = {}
for dp_major in (True, False):
    g, _ = RankGroups.build({"dp": 2, "tp": 2} if dp_major else {"tp": 2, "dp": 2}, RANK)
    out[str(dp_major)] = {
        "dp_index": g.dp_index, "tp_index": g.model_index, "shard": g.shard_index,
        "data": ranks(g.data), "comm_data": ranks(g.comm_data), "tensor": ranks(g.tensor),
        "comm_tensor": ranks(g.comm_tensor), "all": ranks(g.all),
        "distinct": g.tensor is not g.comm_tensor and g.data is not g.comm_data,
        "tg": [g.tensor_group().size, g.tensor_group().rank]}
json.dump(out, open(os.path.join(WORKDIR, f"l{RANK}.json"), "w"))
"""


def test_tp_rank_layout_follows_mesh_key_order(tmp_path):
    """{dp: 2, tp: 2} and {tp: 2, dp: 2} on 4 ranks: each rank's (dp, tp)
    place is its device's place in JAX's mesh of the same key order; the
    dp groups share a tp index, the tensor groups a dp index, ZeRO-1's
    shard is the dp index, and the comm twins are groups of their own."""
    run_ranks(TP_LAYOUT_WORKER, 4, tmp_path)
    for dp_major, shape in ((True, {"dp": 2, "tp": 2}), (False, {"tp": 2, "dp": 2})):
        grid = np.asarray(make_mesh(shape, devices=jax.devices()[:4]).devices)
        for r in range(4):
            got = json.loads((tmp_path / f"l{r}.json").read_text())[str(dp_major)]
            d, t = got["dp_index"], got["tp_index"]
            assert (grid[d, t] if dp_major else grid[t, d]).id == r
            assert got["shard"] == d and got["tg"] == [2, t]
            peers = lambda index, axis: sorted(  # noqa: E731
                (grid[i, index] if dp_major == (axis == "dp") else grid[index, i]).id
                for i in range(2))
            assert got["data"] == got["comm_data"] == peers(t, "dp")
            assert got["tensor"] == got["comm_tensor"] == peers(d, "tp")
            assert got["all"] == [0, 1, 2, 3] and got["distinct"]


@pytest.mark.parametrize("model, method", [("tiny128", "acco"), ("tiny_neo", "ddp")])
def test_torchrun_cli_runs_tp_on_cpu(model, method, tmp_path):
    """``torchrun --nproc_per_node 4 -m acco_tpu_torch --device cpu ...
    train.mesh_shape={dp: 2, tp: 2}`` trains to its summary and a final
    save whose ``params.npz`` is the dense, unpadded model (JAX's layout:
    its length and leaf shapes are the plain config's, and it equals the
    rank files' shards gathered and unpadded)."""
    from acco_tpu_torch.models.registry import build_model
    from acco_tpu_torch.parallel.tp import host_ravel

    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         "-m", "acco_tpu_torch", "--device", "cpu", f"train={method}", f"model={model}",
         "data=synthetic", "train.max_length=64", "train.batch_size=2",
         "train.nb_steps_tot=4", "train.mesh_shape={dp: 2, tp: 2}", "train.save=true",
         f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summaries = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1, out.stdout[-2000:]
    summary = json.loads(summaries[0])
    assert summary["mesh"] == {"dp": 2, "sp": 1, "tp": 2} and summary["count_grad_tot"] == 4
    assert summary["skipped_rounds"] == 0
    dense = build_model({"config_path": f"/config/model/{model}.json"}, repo_root=REPO,
                        dtype=torch.float32)
    local = build_model({"config_path": f"/config/model/{model}.json"}, repo_root=REPO,
                        dtype=torch.float32, tensor_group=TensorGroup(None, 2, 0),
                        vocab_pad_multiple=2)
    assert summary["n_params"] == local.n_params
    step = tmp_path / "checkpoints" / method / "step_4"
    flat = np.load(step / "params.npz")["flat_params"]
    assert flat.shape == (dense.n_params,)
    tree = params_to_jax(torch.from_numpy(flat), dense.config)
    rows = [torch.load(step / "state" / f"rank_{r}.pt", weights_only=True) for r in (0, 2)]
    assert [f["meta"]["tp_index"] for f in rows] == [0, 1]  # files: tp index, then dp shard
    gathered = local.unpad_vocab(local.tp_layout.gather_params(
        [f["state"]["flat_params"][:local.n_params].float().numpy() for f in rows]))
    np.testing.assert_array_equal(host_ravel(gathered, np.float32), flat)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, gathered)
