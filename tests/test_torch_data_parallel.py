"""The port's data parallelism on gloo ranks against the JAX package.

- Rounds: the seed round and 4 ACCO or DPU rounds at {dp: 2}, {dp: 4} and
  {dp: 2, sp: 2} (a tiny Llama with GQA; GPT-Neo at {dp: 2}), against
  JAX's ``AccoTrainStep`` on as many virtual CPU devices. JAX takes the
  global block (the ranks' blocks concatenated on the batch axis); each
  port rank takes its dp index's rows (tests/torch_ranks.py
  ``TRAIN_WORKER``). Bars: the loss at rtol 1e-5 / atol 1e-6, the
  parameters and each rank's optimizer shard at rtol 1e-4 / atol 1e-5
  (tests/test_context_parallel.py:67,73). One case adds a
  ``microbatch_mask`` and ``lr_grad_accounting``: JAX's counts, LR and
  ``grads_committed``.
- The simulator: tests/test_acco.py's numpy ``_Sim`` (its trajectory,
  rollback and heterogeneous-count cases) against the port's rounds at
  rtol 2e-4 / atol 2e-6, with a mask that zeroes a rank's microbatch.
- The loader: each dp index's blocks bit-identical to JAX's
  ``shard_dataset`` + packing + ``ShardedBatchIterator``, also after
  ``set_state``; the mask's column and its errors.
- The rank layout (row-major, dp outer), SLURM rendezvous and the
  hostlist copy; ``torchrun ... "train.mesh_shape={dp: 2}"`` end to end.
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

from acco_tpu.data import loader as jax_loader
from acco_tpu.data import tokenize as jax_tokenize
from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu.utils import hostlist as jax_hostlist
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.convert import params_to_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.parallel import mesh as port_mesh
from acco_tpu_torch.parallel.common import make_flat_loss_fn
from acco_tpu_torch.parallel.mesh import Mesh, RankGroups
from acco_tpu_torch.utils import hostlist
from test_acco import B1, B2, EPS, LR, WD, _Sim
import torch_ranks
from torch_ranks import REPO, run_ranks, start_training

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

N_ACC, BATCH, SEQ, ROUNDS = 2, 2, 32, 4
ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_position_embeddings=SEQ)
NEO_ARCH = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=SEQ, window_size=8,
                attention_layers=["global", "local"])
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
SIM_TOL = dict(rtol=2e-4, atol=2e-6)  # tests/test_acco.py's trajectory bar


def _blocks(n, dp, seed=0, mask=None):
    """``n`` global blocks: [n_acc, dp * BATCH, SEQ] ids and valid [n_acc, dp]."""
    rng = np.random.default_rng(seed)
    valid = np.ones((N_ACC, dp), np.float32) if mask is None else np.asarray(mask, np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, ARCH["vocab_size"], (N_ACC, dp * BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": valid.copy()})
    return out


def _port_config(family):
    if family == "llama":
        return LlamaConfig(**ARCH)
    return GPTNeoConfig(**dict(NEO_ARCH, attention_layers=tuple(NEO_ARCH["attention_layers"])))


def _port_model(family):
    cls = LlamaModel if family == "llama" else GPTNeoModel
    return cls(_port_config(family), dtype=torch.float32)


def _jax_model(family, sp, zigzag):
    kw = dict(attention="ring", sequence_axis="sp", zigzag=zigzag) if sp > 1 else {}
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32, **kw)
    return JaxGPTNeoModel(JaxGPTNeoConfig(**NEO_ARCH), param_dtype=jnp.float32, **kw)


def _jax_mesh(dp, sp):
    shape = {"dp": dp, "sp": sp} if sp > 1 else {"dp": dp}
    return make_mesh(shape, devices=jax.devices()[:dp * sp])


def _jax_block(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _jax_acco(spec, flat, blocks):
    """JAX's rounds on the spec's mesh from the port's parameters: per
    round the loss, LR, real flag, count and state."""
    sp = spec["sp"]
    step = JaxAccoTrainStep(
        _jax_model(spec["family"], sp, spec["zigzag"]), _jax_mesh(spec["dp"], sp),
        jax_get_schedule(*spec["sched"]), param_dtype=jnp.float32, mode=spec["method"],
        seq_axis="sp" if sp > 1 else None, lr_grad_accounting=spec["lr_grad_accounting"],
        **spec["opt"])
    state = step.init_state(params_to_jax(flat, _port_config(spec["family"])))
    state, loss = step.seed_fn()(state, _jax_block(blocks[0]))
    out = {"losses": [float(loss)], "lrs": [], "real": [], "round_grads": [], "states": []}
    round_fn = step.round_fn()  # one program, the parity traced from round_idx
    for r in range(spec["rounds"]):
        state, m = round_fn(state, _jax_block(blocks[r + 1]))
        out["losses"].append(float(m.loss))
        out["lrs"].append(float(m.lr))
        out["real"].append(bool(m.is_real_update))
        out["round_grads"].append(float(m.round_grads))
        out["states"].append(jax.tree.map(np.asarray, state))
    return out


def _spec(family, dp, sp, method, zigzag=True, accounting=False, rounds=ROUNDS,
          sched=SCHED):
    return dict(family=family, arch=ARCH if family == "llama" else NEO_ARCH, dp=dp, sp=sp,
                zigzag=zigzag, method=method, sched=sched, opt=OPT, rounds=rounds,
                batch=BATCH, lr_grad_accounting=accounting)


@pytest.mark.parametrize(
    "family, dp, sp, method, mask",
    [
        pytest.param("llama", 2, 1, "acco", None, id="dp2-acco"),
        pytest.param("llama", 2, 1, "dpu", None, id="dp2-dpu"),
        pytest.param("llama", 4, 1, "acco", None, id="dp4-acco"),
        pytest.param("llama", 4, 1, "dpu", None, id="dp4-dpu"),
        pytest.param("llama", 2, 2, "acco", None, id="dp2-sp2-acco"),
        pytest.param("llama", 2, 2, "dpu", None, id="dp2-sp2-dpu"),
        pytest.param("gpt_neo", 2, 1, "acco", None, id="gpt_neo-dp2-acco"),
        # rank 1 sits out its second microbatch; the schedule counts grads
        pytest.param("llama", 2, 1, "acco", [[1, 1], [1, 0]], id="dp2-acco-mask-accounting"),
    ],
)
def test_dp_rounds_match_jax(family, dp, sp, method, mask, tmp_path):
    spec = _spec(family, dp, sp, method, accounting=mask is not None)
    blocks = _blocks(ROUNDS + 1, dp, mask=mask)
    flat = _port_model(family).init_flat(torch.Generator().manual_seed(0))
    ranks = start_training(spec, flat.numpy(), blocks, tmp_path)  # beside JAX's rounds
    want = _jax_acco(spec, flat, blocks)
    ranks = ranks()

    n, final = flat.numel(), want["states"][-1]
    S = ranks[0]["opt_params"].shape[-1]
    for r, got in enumerate(ranks):
        what = f"rank {r} of {{dp: {dp}, sp: {sp}}} {method}"
        np.testing.assert_allclose(got["losses"], want["losses"], err_msg=what, **LOSS_TOL)
        np.testing.assert_allclose(got["lrs"], want["lrs"], rtol=1e-6, err_msg=what)
        assert list(got["real"]) == want["real"], what
        assert list(got["round_grads"]) == want["round_grads"], what
        for i, jstate in enumerate(want["states"]):
            np.testing.assert_allclose(got["flats"][i + 1][:n], jstate.flat_params[:n],
                                       err_msg=f"{what}: params after round {i}", **PARAM_TOL)
        # rank r holds shard r = dp_index * sp + sp_index of JAX's (dp, sp) layout
        for name, leaf in (("opt_params", final.zero1.opt.params), ("mu", final.zero1.opt.mu),
                           ("nu", final.zero1.opt.nu)):
            np.testing.assert_allclose(got[name][-1], leaf[r * S:(r + 1) * S],
                                       err_msg=f"{what}: {name} shard", **PARAM_TOL)
        assert got["committed"][-1] == float(final.zero1.grads_committed), what
        assert got["sched"][-1] == int(final.zero1.sched_grads), what
    if mask is not None:  # each round consumes the mask's sum (twice: the carry-in)
        assert want["round_grads"] == [3.0, 6.0, 3.0, 6.0]
        assert int(final.zero1.sched_grads) == 6 + 6  # counts, not updates


def _sim_grad_fn(geom):
    """The oracle's per-microbatch gradient: the port's flat loss at one
    rank, float32, on the simulator's (float64, padded) parameters."""
    model = _port_model("llama")
    value_and_grad = make_flat_loss_fn(model, const_len=True)
    slices = model.flat_slices()

    def grad_fn(flat_padded, mb):
        flat = torch.tensor(np.asarray(flat_padded[:geom.n_params], np.float32))
        batch = {k: torch.as_tensor(v).long() for k, v in mb.items()}
        _, grads = value_and_grad(flat, batch)
        out = np.zeros(geom.padded_size, np.float64)
        for (_, offset, numel), g in zip(slices, grads):
            out[offset:offset + numel] = g.reshape(-1).double().numpy()
        return out

    return grad_fn


def _sim_micros(block, dp):
    """The block's valid (rank, microbatch) pairs, in the simulator's form."""
    out = []
    for a in range(N_ACC):
        for d in range(dp):
            if block["valid"][a, d]:
                rows = slice(d * BATCH, (d + 1) * BATCH)
                out.append({k: block[k][a, rows] for k in ("input_ids", "attention_mask",
                                                           "labels")})
    return out


@pytest.mark.parametrize("dp, method", [(2, "acco"), (2, "dpu"), (4, "acco")],
                         ids=["dp2-acco", "dp2-dpu", "dp4-acco"])
def test_rounds_match_the_simulator(dp, method, tmp_path):
    """tests/test_acco.py's ``_Sim`` (speculative even / real odd rounds,
    accumulation across half-rounds, count-weighted averaging) over 6
    rounds: the working parameters after the seed and each round, the
    speculative rounds' rollback of the optimizer shard (bit for bit),
    and the heterogeneous counts (rank dp-1 sits out its second microbatch
    in every block: each round's count is the mask's sum)."""
    from acco_tpu_torch.parallel.zero1 import ShardGeometry

    rounds = 6
    mask = np.ones((N_ACC, dp), np.float32)
    mask[1, dp - 1] = 0.0
    spec = _spec("llama", dp, 1, method, rounds=rounds, sched=("constant", LR, 0, 1000))
    spec["opt"] = dict(weight_decay=WD, beta1=B1, beta2=B2, eps=EPS)
    blocks = _blocks(rounds + 1, dp, seed=1, mask=mask)
    flat = _port_model("llama").init_flat(torch.Generator().manual_seed(0))
    ranks = start_training(spec, flat.numpy(), blocks, tmp_path)  # beside the simulator

    geom = ShardGeometry(flat.numel(), dp)
    sim = _Sim(geom.pad_flat(flat.double()).numpy(), _sim_grad_fn(geom), geom, method)
    sim.seed(_sim_micros(blocks[0], dp))
    counts, sim_params = [], []
    for r in range(rounds):
        counts.append(sim.pending_count)
        sim.round(_sim_micros(blocks[r + 1], dp))
        sim_params.append(np.array(sim.params))
    ranks = ranks()
    for r in range(rounds):
        for d, got in enumerate(ranks):
            np.testing.assert_allclose(got["flats"][r + 1], sim_params[r],
                                       err_msg=f"rank {d}, round {r} ({method})", **SIM_TOL)
    per_round = float(mask.sum())
    for got in ranks:
        assert list(got["round_grads"]) == counts
        assert counts == [(2 if method == "acco" and r % 2 else 1) * per_round
                          for r in range(rounds)]
        assert list(got["real"]) == [r % 2 == 1 or method == "dpu" for r in range(rounds)]
        for r in range(rounds):  # a speculative round leaves the shard as it was
            if method == "acco" and r % 2 == 0:
                np.testing.assert_array_equal(got["opt_params"][r + 1], got["opt_params"][r])
                np.testing.assert_array_equal(got["mu"][r + 1], got["mu"][r])
            else:
                assert not np.array_equal(got["opt_params"][r + 1], got["opt_params"][r])


TEXTS = [f"document {i} " + "word " * (i % 37) for i in range(240)]


def _trainer(dp, dp_index, run_dir, mask=None, n_acc=N_ACC):
    """A Trainer for dp index ``dp_index`` of ``dp``, built on this process
    (its construction runs no collective), its records under ``run_dir``."""
    from acco_tpu_torch.configuration import ConfigNode
    from acco_tpu_torch.trainer import Trainer

    args = ConfigNode.wrap(dict(method_name="acco", batch_size=BATCH, max_length=SEQ,
                                nb_steps_tot=2, const_len_batch=True, n_grad_accumulation=n_acc,
                                microbatch_mask=mask))
    groups = RankGroups(dp=dp, sp=1, dp_index=dp_index, sp_index=0)
    mesh = Mesh(dp=dp, sp=1, rank=dp_index, device=torch.device("cpu"), groups=groups)
    return Trainer(_port_model("llama"), load_tokenizer("byte"), TEXTS, None, args, seed=7,
                   mesh=mesh, run_dir=str(run_dir))


@pytest.mark.parametrize("dp, dp_index", [(2, 0), (2, 1), (3, 2)])
def test_rank_blocks_match_jax_loader(dp, dp_index, tmp_path):
    """The trainer's blocks for one dp index, bit for bit: JAX's list
    ``shard_dataset`` of the raw texts, packing, ``ShardedBatchIterator``
    and ``stack_microbatches``; then the position saved after 5 blocks
    restores the same stream in a fresh iterator on both sides."""
    from acco_tpu_torch.data import loader

    trainer = _trainer(dp, dp_index, tmp_path)
    tok = load_tokenizer("byte")
    texts = jax_loader.shard_dataset(TEXTS, dp, dp_index)
    rows = jax_tokenize.pack_const_len(tok(texts)["input_ids"], tok.eos_token_id, SEQ)
    kw = dict(batch_size=BATCH, max_length=SEQ, pad_token_id=tok.pad_token_id, seed=7)
    jit = jax_loader.ShardedBatchIterator([{"input_ids": r} for r in rows], **kw)
    it_t, it_j = loader.infinite_batches(trainer.loader), jax_loader.infinite_batches(jit)

    def same(a, b):
        for _ in range(5):
            got, want = loader.stack_microbatches(a, N_ACC), jax_loader.stack_microbatches(b, N_ACC)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got["valid"], np.ones(N_ACC, np.float32))

    same(it_t, it_j)
    assert trainer.loader.iter_state() == jit.iter_state()
    resumed_t = loader.ShardedBatchIterator(trainer.loader.rows, **kw)
    resumed_j = jax_loader.ShardedBatchIterator([{"input_ids": r} for r in rows], **kw)
    resumed_t.set_state(trainer.loader.iter_state())
    resumed_j.set_state(jit.iter_state())
    same(loader.infinite_batches(resumed_t), loader.infinite_batches(resumed_j))


def test_microbatch_mask_column_and_errors(tmp_path):
    """Each rank's ``valid`` is its dp index's column of the mask; the
    round's count is the mask's sum; JAX's shape and all-zero errors."""
    mask = [[1, 0], [1, 1]]
    for d in range(2):
        trainer = _trainer(2, d, tmp_path, mask=mask)
        np.testing.assert_array_equal(trainer.valid, np.asarray(mask, np.float32)[:, d])
        assert trainer.grads_per_round == 3.0
    assert _trainer(2, 0, tmp_path).grads_per_round == 2 * N_ACC
    with pytest.raises(ValueError, match=r"\[n_grad_accumulation=2\]\[world_size=2\], got \(2,\)"):
        _trainer(2, 0, tmp_path, mask=[1, 0])
    with pytest.raises(ValueError, match="masks out every microbatch"):
        _trainer(2, 1, tmp_path, mask=[[0, 0], [0, 0]])


LAYOUT_WORKER = """
import json
from acco_tpu_torch.parallel.mesh import RankGroups
groups, sg = RankGroups.build({"dp": 2, "sp": 2}, RANK)
ranks = dist.get_process_group_ranks
json.dump({"dp_index": groups.dp_index, "sp_index": groups.sp_index,
           "shard": groups.shard_index, "data": ranks(groups.data),
           "comm_data": ranks(groups.comm_data), "seq": ranks(sg.group), "sg_rank": sg.rank,
           "world": ranks(groups.world), "comm_world": ranks(groups.comm_world),
           "distinct": groups.data is not groups.comm_data
                       and groups.world is not groups.comm_world},
          open(os.path.join(WORKDIR, f"l{RANK}.json"), "w"))
"""


def test_rank_layout_is_row_major(tmp_path):
    """{dp: 2, sp: 2} on 4 ranks: rank r = dp_index * 2 + sp_index as on
    JAX's mesh, the dp groups share an sp index, the sp groups a dp index,
    ZeRO-1's shard is the rank, and the comm branch's groups are groups of
    their own over the same ranks."""
    run_ranks(LAYOUT_WORKER, 4, tmp_path)
    mesh = np.asarray(_jax_mesh(2, 2).devices)
    ids = [[d.id for d in row] for row in mesh]  # JAX: the (dp, sp) grid of devices
    for r in range(4):
        got = json.loads((tmp_path / f"l{r}.json").read_text())
        d, s = divmod(r, 2)
        assert ids[d][s] == r and (got["dp_index"], got["sp_index"], got["shard"]) == (d, s, r)
        assert got["data"] == got["comm_data"] == [s, 2 + s]
        assert got["seq"] == [2 * d, 2 * d + 1] and got["sg_rank"] == s
        assert got["world"] == got["comm_world"] == [0, 1, 2, 3] and got["distinct"]


def test_slurm_rendezvous(monkeypatch):
    """Without torchrun's variables, SLURM's give the world, the rank and
    JAX's coordinator: the first host of the node list, port
    ACCO_COORD_PORT or 12346."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_JOB_NODELIST", "gpu[08-09],login1")
    monkeypatch.delenv("ACCO_COORD_PORT", raising=False)
    assert port_mesh._launch_env() == (4, 3, 1, "tcp://gpu08:12346")
    monkeypatch.setenv("ACCO_COORD_PORT", "23456")
    assert port_mesh._launch_env()[3] == "tcp://gpu08:23456"
    monkeypatch.setenv("RANK", "0")  # torchrun's variables win
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert port_mesh._launch_env() == (2, 0, 0, "env://")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("SLURM_NTASKS", "1")  # one task: one rank, no rendezvous
    assert port_mesh._launch_env() == (1, 0, 0, None)


@pytest.mark.parametrize("nodelist", [
    "n1", "n[9-11,14]", "n[08-10]", "a[1-2]b[3-4]", "gpu[08-09],login1,x[1,3-4]",
    "rack1-n[001-003]", "node-[7-8],node-10",
])
def test_expand_hostlist_matches_jax(nodelist):
    assert hostlist.expand_hostlist(nodelist) == jax_hostlist.expand_hostlist(nodelist)
    hosts = hostlist.expand_hostlist(nodelist)
    assert hostlist.collect_hostlist(hosts) == jax_hostlist.collect_hostlist(hosts)


def test_torchrun_cli_runs_dp_on_cpu(tmp_path):
    """``torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu ...
    train.mesh_shape={dp: 2}`` trains to its summary, which rank 0 alone
    prints: each round commits the two ranks' micro-grads."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "acco_tpu_torch", "--device", "cpu", "train=acco", "model=tiny128",
         "data=synthetic", "train.max_length=128", "train.batch_size=2",
         "train.nb_steps_tot=8", "train.mesh_shape={dp: 2}", f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summaries = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1, out.stdout[-2000:]
    summary = json.loads(summaries[0])
    assert summary["mesh"] == {"dp": 2, "sp": 1} and summary["attention"] == "xla"
    assert summary["count_grad_tot"] == 8 and summary["skipped_rounds"] == 0
    assert [r["is_real_update"] for r in summary["round_log"]] == [False, True, False, True]
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(abs(x) < 100 for x in losses)


def test_comm_stream_only_on_a_card(tmp_path):
    """On the CPU (and gloo) the comm branch runs in line, with no stream,
    whatever stream a caller hands in, and so does the trainer's step."""
    from acco_tpu_torch.ops.schedules import get_schedule
    from acco_tpu_torch.parallel.acco import AccoTrainStep

    model = _port_model("llama")
    for stream in (None, object()):
        step = AccoTrainStep(model, get_schedule(*SCHED), comm_stream=stream, **OPT)
        assert step.comm_stream is None
    assert _trainer(1, 0, tmp_path).step.comm_stream is None
