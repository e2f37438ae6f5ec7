"""The port's context parallelism at {dp: 1, sp: 2} on gloo ranks against
the JAX package's CP step on as many virtual CPU devices, and against the
port at one rank.

Both packages start from the same parameters (the port's init, carried
over by ``models/convert.py``) and take the same microbatch blocks (numpy,
seeded): the seed round and 4 ACCO or DPU rounds, in float32, for a tiny
Llama (GQA) in the zig-zag and contiguous layouts and for a tiny GPT-Neo
(one global and one local layer) through the windowed ring. Each rank is
a process of its own (tests/torch_ranks.py) that runs the port's
``AccoTrainStep`` on its sequence chunk (``prep_cp_leaves``) with ZeRO-1
sharded over the two ranks.

Tolerances are tests/test_context_parallel.py's (:67, :73): the loss at
rtol 1e-5 / atol 1e-6, the parameters at rtol 1e-4 / atol 1e-5. The
multi-rank ZeRO-1 step is held to the one-rank step bit for bit. Also:
``torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu`` end to
end, and the refusals (padded batches under CP, a length the zig-zag
layout cannot split, the tp and pp axes).
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
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.models.convert import params_to_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops.ring_attention import SequenceGroup
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel import zero1
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy
from acco_tpu_torch.parallel.mesh import Mesh, check_mesh
import torch_ranks
from torch_ranks import REPO, Ranks, run_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

SP, N_ACC, BATCH, SEQ, ROUNDS = 2, 2, 2, 32, 4
ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, max_position_embeddings=SEQ)
NEO_ARCH = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_position_embeddings=SEQ, window_size=8,
                attention_layers=["global", "local"])
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)

WORKER = """
import json
import numpy as np
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops.ring_attention import SequenceGroup
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy, prep_cp_leaves

spec = json.load(open(os.path.join(WORKDIR, "spec.json")))
sg = SequenceGroup.of()
if spec["family"] == "llama":
    model = LlamaModel(LlamaConfig(**spec["arch"]), dtype=torch.float32, attention="ring",
                       sequence_group=sg, zigzag=spec["zigzag"])
else:
    arch = dict(spec["arch"], attention_layers=tuple(spec["arch"]["attention_layers"]))
    model = GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, attention="ring",
                        sequence_group=sg, zigzag=spec["zigzag"])
step = AccoTrainStep(model, get_schedule(*spec["sched"]), mode=spec["mode"],
                     const_len_batch=True, sequence_group=sg, **spec["opt"])
state = step.init_state(torch.tensor(np.load(os.path.join(WORKDIR, "flat.npy"))))
data = np.load(os.path.join(WORKDIR, "blocks.npz"))

def block(i):
    raw = {k: data[f"{i}/{k}"] for k in ("input_ids", "attention_mask", "labels", "valid")}
    return prep_cp_leaves(block_from_numpy(raw, "cpu"), sg, spec["zigzag"])

state, loss = step.seed(state, block(0))
losses, real = [float(loss)], []
for r in range(spec["rounds"]):
    state, m = step.round(state, block(r + 1), parity=r % 2 == 0)
    losses.append(float(m.loss))
    real.append(bool(m.is_real_update))
np.savez(os.path.join(WORKDIR, f"out{RANK}.npz"), losses=np.array(losses),
         real=np.array(real), flat=state.flat_params.numpy(),
         opt_params=state.zero1.opt.params.numpy(), mu=state.zero1.opt.mu.numpy(),
         committed=float(state.zero1.grads_committed))
"""


def _blocks(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, ARCH["vocab_size"], (N_ACC, BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((N_ACC,), np.float32)})
    return out


def _port_model(family, **kw):
    if family == "llama":
        return LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32, **kw)
    arch = dict(NEO_ARCH, attention_layers=tuple(NEO_ARCH["attention_layers"]))
    return GPTNeoModel(GPTNeoConfig(**arch), dtype=torch.float32, **kw)


def _jax_run(family, mode, zigzag, flat, blocks):
    """JAX's CP step on {dp: 1, sp: 2} from the port's flat parameters:
    the losses and the final state."""
    if family == "llama":
        ring = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32, attention="ring",
                             sequence_axis="sp", zigzag=zigzag)
    else:
        ring = JaxGPTNeoModel(JaxGPTNeoConfig(**NEO_ARCH), param_dtype=jnp.float32,
                              attention="ring", sequence_axis="sp", zigzag=zigzag)
    params = params_to_jax(flat, _port_model(family).config)
    mesh = make_mesh({"dp": 1, "sp": SP}, devices=jax.devices()[:SP])
    step = JaxAccoTrainStep(ring, mesh, jax_get_schedule(*SCHED), param_dtype=jnp.float32,
                            mode=mode, seq_axis="sp", **OPT)
    state = step.init_state(params)

    def jblock(b):
        out = {k: jnp.asarray(v) for k, v in b.items()}
        out["valid"] = out["valid"][:, None]
        return out

    state, loss = step.seed_fn()(state, jblock(blocks[0]))
    losses = [float(loss)]
    round_fn = step.round_fn()  # one program, the parity traced from round_idx
    for r in range(ROUNDS):
        state, m = round_fn(state, jblock(blocks[r + 1]))
        losses.append(float(m.loss))
    return losses, state


def _port_one_rank(family, mode, flat, blocks):
    model = _port_model(family, attention="xla")
    step = AccoTrainStep(model, get_schedule(*SCHED), mode=mode, const_len_batch=True, **OPT)
    state = step.init_state(flat)
    state, loss = step.seed(state, block_from_numpy(blocks[0], "cpu"))
    losses = [float(loss)]
    for r in range(ROUNDS):
        state, m = step.round(state, block_from_numpy(blocks[r + 1], "cpu"), r % 2 == 0)
        losses.append(float(m.loss))
    return losses, state


@pytest.mark.parametrize(
    "family, mode, zigzag",
    [
        pytest.param("llama", "acco", True, id="llama-acco-zigzag"),
        pytest.param("llama", "acco", False, id="llama-acco-contiguous"),
        pytest.param("llama", "dpu", True, id="llama-dpu-zigzag"),
        pytest.param("gpt_neo", "acco", True, id="gpt_neo-acco-zigzag"),
    ],
)
def test_cp_rounds_match_jax_and_one_rank(family, mode, zigzag, tmp_path):
    blocks = _blocks(ROUNDS + 1)
    model = _port_model(family)
    flat = model.init_flat(torch.Generator().manual_seed(0))
    np.save(tmp_path / "flat.npy", flat.numpy())
    np.savez(tmp_path / "blocks.npz",
             **{f"{i}/{k}": v for i, b in enumerate(blocks) for k, v in b.items()})
    arch = ARCH if family == "llama" else NEO_ARCH
    (tmp_path / "spec.json").write_text(json.dumps(dict(
        family=family, arch=arch, zigzag=zigzag, mode=mode, sched=SCHED, opt=OPT,
        rounds=ROUNDS)))
    ranks = Ranks(WORKER, SP, tmp_path)  # beside JAX's rounds and the one-rank port
    jax_losses, jstate = _jax_run(family, mode, zigzag, flat, blocks)
    one_losses, one_state = _port_one_rank(family, mode, flat, blocks)
    ranks.join()
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(SP)]

    n = flat.numel()
    for r, out in enumerate(ranks):  # the replicated leaves agree on every rank
        np.testing.assert_allclose(out["losses"], jax_losses, err_msg=f"rank {r} loss vs JAX",
                                   **LOSS_TOL)
        np.testing.assert_allclose(out["losses"], one_losses, err_msg=f"rank {r} loss vs sp 1",
                                   **LOSS_TOL)
        np.testing.assert_allclose(out["flat"][:n], np.asarray(jstate.flat_params)[:n],
                                   err_msg=f"rank {r} params vs JAX", **PARAM_TOL)
        np.testing.assert_allclose(out["flat"][:n], one_state.flat_params.numpy()[:n],  # lint: host-sync-ok: a CPU tensor read in an assertion loop
                                   err_msg=f"rank {r} params vs sp 1", **PARAM_TOL)
        assert out["committed"] == float(jstate.zero1.grads_committed)
        assert list(out["real"]) == [
            (i % 2 == 1) if mode == "acco" else True for i in range(ROUNDS)]
    # ZeRO-1 shards: rank r holds shard r of the master params and moments
    for name, jax_leaf in (("opt_params", jstate.zero1.opt.params), ("mu", jstate.zero1.opt.mu)):
        joined = np.concatenate([out[name] for out in ranks])
        np.testing.assert_allclose(joined[:n], np.asarray(jax_leaf)[:n], err_msg=name,
                                   **PARAM_TOL)


ZERO1_WORKER = """
import numpy as np
from acco_tpu_torch.ops.adamw import init_adamw_state
from acco_tpu_torch.parallel import zero1

d = np.load(os.path.join(WORKDIR, "zero1.npz"))
geom = zero1.ShardGeometry(int(d["n"]), WS)
S = geom.shard_size
opt = init_adamw_state(torch.tensor(d["params"][RANK * S:(RANK + 1) * S]))
opt = opt._replace(mu=opt.mu + 0.1, count=opt.count + 3)
out = zero1.zero1_update_shard(
    torch.tensor(d["grads"][RANK]), opt, torch.tensor(2.0), torch.tensor(1e-3), geom,
    0.1, 0.9, 0.95, with_health=True, group=dist.group.WORLD,
)
new_flat, new_opt, health = out
np.savez(os.path.join(WORKDIR, f"z{RANK}.npz"), flat=new_flat.float().numpy(),
         params=new_opt.params.numpy(), mu=new_opt.mu.numpy(), nu=new_opt.nu.numpy(),
         norm=float(health.grad_norm), ok=bool(health.ok))
"""


def test_multi_rank_zero1_step_is_the_one_rank_step(tmp_path):
    """Two ranks, each with its partial gradient: reduce-scatter, AdamW on
    each shard, all-gather. Every element of the new flat parameters, of
    the master shard and of the moments equals the one-rank step on the
    summed gradient bit for bit (a sum of two float32 terms has one
    result in either order); the padded master parameter stays 0."""
    from acco_tpu_torch.ops.adamw import init_adamw_state

    rng = np.random.default_rng(7)
    n = 1001  # odd: the second shard carries one padded element
    geom2, geom1 = zero1.ShardGeometry(n, 2), zero1.ShardGeometry(n, 1)
    params = rng.standard_normal(geom2.padded_size).astype(np.float32)
    params[n:] = 0.0
    grads = rng.standard_normal((2, geom2.padded_size)).astype(np.float32)
    np.savez(tmp_path / "zero1.npz", n=n, params=params, grads=grads)
    run_ranks(ZERO1_WORKER, 2, tmp_path)
    parts = [np.load(tmp_path / f"z{r}.npz") for r in range(2)]

    opt = init_adamw_state(torch.tensor(params[:n]))
    opt = opt._replace(mu=opt.mu + 0.1, count=opt.count + 3)
    whole = torch.tensor(grads[0] + grads[1])[:n]
    new_flat, new_opt, health = zero1.zero1_update_shard(
        whole, opt, torch.tensor(2.0), torch.tensor(1e-3), geom1, 0.1, 0.9, 0.95,
        with_health=True,
    )
    for p in parts:
        np.testing.assert_array_equal(p["flat"][:n], new_flat.float().numpy())  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        assert p["flat"][n:].tolist() == [0.0] * (geom2.padded_size - n)  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        assert bool(p["ok"]) and bool(health.ok)
        np.testing.assert_allclose(p["norm"], float(health.grad_norm), rtol=1e-6)
    for name in ("mu", "nu", "params"):
        joined = np.concatenate([p[name] for p in parts])
        np.testing.assert_array_equal(joined[:n], getattr(new_opt, name).numpy(), err_msg=name)  # lint: host-sync-ok: a CPU tensor read in an assertion loop
    assert joined[n:].tolist() == [0.0] * (geom2.padded_size - n)  # the padded master param


def test_torchrun_cli_runs_cp_on_cpu(tmp_path):
    """``torchrun --nproc_per_node 2 -m acco_tpu_torch --device cpu ...
    train.mesh_shape={dp: 1, sp: 2}`` trains to its summary, which rank 0
    alone prints: the ring, the mesh and the committed count."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "acco_tpu_torch", "--device", "cpu", "train=acco", "model=tiny128",
         "data=synthetic", "train.max_length=128", "train.batch_size=2",
         "train.nb_steps_tot=4", "train.mesh_shape={dp: 1, sp: 2}",
         f"hydra.run.dir={tmp_path}"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    summaries = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(summaries) == 1, out.stdout[-2000:]
    summary = json.loads(summaries[0])
    assert summary["attention"] == "ring" and summary["mesh"] == {"dp": 1, "sp": 2}
    assert summary["count_grad_tot"] == 4 and summary["skipped_rounds"] == 0
    assert [r["is_real_update"] for r in summary["round_log"]] == [False, True, False, True]
    losses = [summary["seed_loss"]] + [r["loss"] for r in summary["round_log"]]
    assert all(abs(x) < 100 for x in losses)


def _cp_trainer(run_dir, **overrides):
    """A Trainer on a two-rank sequence group, constructed on this process
    (the checks run before any collective), its records under ``run_dir``."""
    from acco_tpu_torch.configuration import ConfigNode
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.trainer import Trainer

    sg = SequenceGroup(group=None, size=2, rank=0)
    model = LlamaModel(LlamaConfig(**dict(ARCH, max_position_embeddings=128)),
                       dtype=torch.float32, attention="ring", sequence_group=sg, zigzag=True)
    args = ConfigNode.wrap(dict(dict(method_name="acco", batch_size=2, max_length=32,
                                     nb_steps_tot=2, const_len_batch=True), **overrides))
    mesh = Mesh(dp=1, sp=2, rank=0, device=torch.device("cpu"), sequence_group=sg)
    return Trainer(model, load_tokenizer("byte"), ["a b c d " * 40] * 8, None, args, mesh=mesh,
                   run_dir=str(run_dir))


@pytest.mark.parametrize(
    "overrides, match",
    [
        pytest.param(dict(const_len_batch=False), "requires const_len_batch", id="padded"),
        pytest.param(dict(max_length=34), "divisible by 4", id="zigzag-length"),
        pytest.param(dict(max_length=33), "divide evenly over the sp axis", id="sp-length"),
    ],
)
def test_cp_refusals(overrides, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        _cp_trainer(tmp_path, **overrides)


def test_cp_trainer_takes_the_ring(tmp_path):
    trainer = _cp_trainer(tmp_path)
    assert trainer.attention == "ring" and trainer.sequence_group.size == 2


def test_one_process_makes_no_process_group(monkeypatch):
    """A world of one rank (no torchrun) initialises no process group: the
    one-rank paths run no collective."""
    import torch.distributed as dist

    from acco_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = init_distributed({"dp": 1, "sp": 1}, "cpu")
    assert (mesh.dp, mesh.sp, mesh.sequence_group) == (1, 1, None)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 4 processes"):
        init_distributed({"sp": 4}, "cpu")


@pytest.mark.parametrize(
    "mesh_shape, item",
    [({"dp": 2}, None), ({"dp": 2, "sp": 2}, None), ({"sp": 2, "tp": 2}, "item 9"),
     ({"pp": 2, "sp": 2}, "item 9")],
)
def test_meshes_other_than_sp_raise_by_item(mesh_shape, item):
    """sp composed with tp or with pp, which once raised by their item
    (``item``: 9, the compositions, ported in 9.4), now passes the check
    as the dp meshes (item None) do, and at one process every such mesh
    asks for its ranks (tests/test_torch_compositions.py runs them)."""
    from acco_tpu_torch.parallel.mesh import init_distributed

    sizes = check_mesh(mesh_shape)
    assert (sizes["dp"], sizes["sp"]) == (mesh_shape.get("dp", 1), mesh_shape.get("sp", 1))
    assert (sizes["tp"], sizes["pp"]) == (mesh_shape.get("tp", 1), mesh_shape.get("pp", 1))
    n = sizes["dp"] * sizes["sp"] * sizes["tp"] * sizes["pp"]
    with pytest.raises(ValueError, match=f"needs {n} processes"):
        init_distributed(mesh_shape, "cpu")


def test_ring_needs_a_sequence_group_and_no_pad_mask():
    with pytest.raises(ValueError, match="requires a sequence group"):
        LlamaModel(LlamaConfig(**ARCH), attention="ring")
    with pytest.raises(ValueError, match="a sequence group attention='ring'"):
        LlamaModel(LlamaConfig(**ARCH), sequence_group=SequenceGroup(None, 2, 0))
    with pytest.raises(ValueError, match="ring-attention model"):  # JAX's step check
        AccoTrainStep(LlamaModel(LlamaConfig(**ARCH)), get_schedule(*SCHED),
                      sequence_group=SequenceGroup(None, 2, 0), **OPT)
    with pytest.raises(ValueError, match="requires a sequence group"):
        GPTNeoModel(GPTNeoConfig(**dict(NEO_ARCH, attention_layers=("global", "local"))),
                    attention="ring")
    sg = SequenceGroup(group=None, size=1, rank=0)
    model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32, attention="ring",
                       sequence_group=sg)
    model.load_flat(torch.zeros(model.n_params))
    ids = torch.zeros((1, 16), dtype=torch.long)
    with pytest.raises(ValueError, match="padding masks"):
        model.hidden(ids, torch.ones_like(ids))
    long_model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32, attention="ring",
                            sequence_group=SequenceGroup(group=None, size=4, rank=0))
    long_model.load_flat(torch.zeros(long_model.n_params))
    with pytest.raises(ValueError, match="sequence length 64 exceeds"):  # the global length
        long_model.hidden(torch.zeros((1, 16), dtype=torch.long))
