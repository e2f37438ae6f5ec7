"""The port's ``compile/``: the rounds over two buffer sets, the launch
counters' replay arithmetic, the kernel libraries' cache key, the
background builds, and the profile reader under graph replay.

On the CPU nothing is captured: the same buffer-set code
(``compile.graphs.RoundPrograms``: the carry A -> B -> A, the static
block, the metric slots) runs uncaptured every round. It is held

- against JAX's ``AccoTrainStep`` (acco, dpu) and ``DDPTrainStep`` (ddp)
  on a tiny Llama over a seed round and 7 rounds, a NaN microbatch weight
  in one block so that the guard skips a round, at the bars of
  ``tests/test_torch_acco.py::test_rounds_match_jax`` (rtol 2e-4 / atol
  2e-6; the loss at rtol 1e-5) and ``tests/test_torch_ddp.py`` (the loss
  at rtol 1e-5 / atol 1e-6, the parameters at rtol 1e-4 / atol 1e-5), and
  bit for bit against the port's own eager rounds;
- through the trainer: a drill, a rollback and a SIGTERM resume with the
  buffer sets equal bit for bit to the eager trainer's, and the round log
  read back at a cadence of 3 equal to the eager one.

Everything is float32 with TF32 off (``torch_ranks.torch_settings``).
No test here runs a Pallas interpreter or spawns a rank.
"""

import contextlib
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.schedules import get_schedule as jax_get_schedule
from acco_tpu.parallel.acco import AccoTrainStep as JaxAccoTrainStep
from acco_tpu.parallel.ddp import DDPTrainStep as JaxDDPTrainStep
from acco_tpu.parallel.mesh import make_mesh
from acco_tpu_torch.compile import cache, graphs, warmup
from acco_tpu_torch.configuration import ConfigNode
from acco_tpu_torch.data.tokenizer import load_tokenizer
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops import fused_attention
from acco_tpu_torch.ops.schedules import get_schedule
from acco_tpu_torch.parallel.acco import AccoTrainStep
from acco_tpu_torch.parallel.common import block_from_numpy
from acco_tpu_torch.parallel.ddp import DDPTrainStep
from acco_tpu_torch.resilience.faults import ShutdownAfterRounds
from acco_tpu_torch.telemetry import profile
from acco_tpu_torch.trainer import Trainer
from acco_tpu_torch.utils import cuda_build
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

ARCH = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=2, num_kv_heads=1, max_position_embeddings=16)
N_ACC, BATCH, SEQ, ROUNDS = 2, 2, 16, 7
OPT = dict(weight_decay=0.1, beta1=0.9, beta2=0.95)
SCHED = ("cosine", 3e-3, 2, 20)
TOL = dict(rtol=2e-4, atol=2e-6)
DDP_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
POISONED = 3  # the block of round 2 (block 0 is the seed round's)


def _blocks(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, ARCH["vocab_size"], (N_ACC, BATCH, SEQ)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
                    "valid": np.ones((N_ACC,), np.float32)})
    out[POISONED]["valid"] = np.array([np.nan, 1.0], np.float32)
    return out


def _jax_block(block):
    b = {k: jnp.asarray(v) for k, v in block.items()}
    b["valid"] = b["valid"][:, None]  # [n_acc, world_size]
    return b


def _setup(method):
    jmodel = JaxLlamaModel(JaxLlamaConfig(**ARCH), param_dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0))
    mesh = make_mesh(devices=jax.devices()[:1])
    if method == "ddp":
        jstep = JaxDDPTrainStep(jmodel, mesh, jax_get_schedule(*SCHED), param_dtype=jnp.float32,
                                **OPT)
    else:
        jstep = JaxAccoTrainStep(jmodel, mesh, jax_get_schedule(*SCHED), param_dtype=jnp.float32,
                                 mode=method, **OPT)
    flat = params_from_jax(jax.tree.map(np.asarray, params), LlamaConfig(**ARCH))

    def port():
        model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32, device="cpu")
        if method == "ddp":
            step = DDPTrainStep(model, get_schedule(*SCHED), **OPT)
        else:
            step = AccoTrainStep(model, get_schedule(*SCHED), mode=method, **OPT)
        return step, step.init_state(flat)

    return jstep, jstep.init_state(params), port


def _assert_close_to_jax(jstate, state, what, tol):
    for name, a, b in (("flat_params", jstate.flat_params, state.flat_params),
                       ("opt.params", jstate.zero1.opt.params, state.zero1.opt.params),
                       ("opt.mu", jstate.zero1.opt.mu, state.zero1.opt.mu),
                       ("opt.nu", jstate.zero1.opt.nu, state.zero1.opt.nu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=f"{what}: {name}", **tol)  # lint: host-sync-ok: a CPU tensor read in an assertion loop


def _bits(t):
    """The tensor's bits as integers (NaN equals NaN of the same bits)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _assert_bit_equal(got, want, what):
    for i, (a, b) in enumerate(zip(graphs.flatten(got), graphs.flatten(want))):
        assert torch.equal(_bits(a), _bits(b)), f"{what}: leaf {i}"


@pytest.mark.parametrize("method", ["acco", "dpu", "ddp"])
def test_buffer_set_rounds_match_jax(method):
    """A seed round (into set A's pending buffer), 7 rounds through
    ``RoundPrograms`` (A -> B -> A ...; DDP over its one set, in place):
    JAX's rounds at their bars, the eager rounds bit for bit; the
    poisoned block's round is skipped and leaves the parameters and the
    optimizer shard bit-exact."""
    jstep, jstate, port = _setup(method)
    step, state = port()
    eager_step, eager = port()
    blocks = _blocks(ROUNDS + 1)
    tol = DDP_PARAM_TOL if method == "ddp" else TOL
    shapes = tuple(tuple(t.shape) for t in block_from_numpy(blocks[1], "cpu"))
    programs = graphs.RoundPrograms(step, state, shapes, capture=False)
    if method != "ddp":  # the seed into the live set's pending buffer
        jstate, _ = jstep.seed_fn()(jstate, _jax_block(blocks[0]))
        state, _ = step.seed(programs.state, block_from_numpy(blocks[0], "cpu"), in_place=True)
        eager, _ = eager_step.seed(eager, block_from_numpy(blocks[0], "cpu"))
        programs.adopt(state)
        assert state.pending_grads.data_ptr() == programs.sets[0][1].data_ptr()
    sets = [{t.data_ptr() for t in s} for s in programs.sets]
    skipped = []
    for r in range(ROUNDS):
        parity = r % 2 == 0
        block = block_from_numpy(blocks[r + 1] if method != "ddp" else blocks[r], "cpu")
        live = programs.state
        before = [t.clone() for t in (live.flat_params, *live.zero1.opt[:3])]
        state, m, real = programs.run(block, parity)
        if method == "ddp":
            jstate, jm = jstep.step_fn()(jstate, _jax_block(blocks[r]))
            eager, em = eager_step.step(eager, block)
        else:
            jstate, jm = jstep.round_fn(parity=parity)(jstate, _jax_block(blocks[r + 1]))
            eager, em = eager_step.round(eager, block, parity)
        what = f"{method} round {r}"
        if np.isfinite(float(jm.loss)):
            np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5, err_msg=what)
        assert bool(m.skipped) == bool(jm.skipped), what
        skipped.append(bool(m.skipped))
        _assert_close_to_jax(jstate, state, what, tol)
        # the eager rounds, bit for bit: the metrics and every state leaf
        for name, a, b in zip(m._fields, m, em):
            assert torch.equal(_bits(a), _bits(b.float())), f"{what}: {name}"
        _assert_bit_equal(state, eager, what)
        # the live leaves sit in the two sets; a skipped round leaves the
        # parameters and the optimizer shard bit-exact
        assert all(t.data_ptr() in sets[0] | sets[1] for t in graphs.flatten(state))
        if bool(m.skipped):
            after = (state.flat_params, *state.zero1.opt[:3])
            assert all(torch.equal(a, b) for a, b in zip(after, before)), what
        assert bool(real) == (not bool(m.skipped) and (method != "acco" or r % 2 == 1))
    # the poisoned block's grads are consumed by the next round (acco,
    # dpu: staged) or by its own step (ddp)
    assert skipped == [r == (POISONED if method != "ddp" else POISONED) for r in range(ROUNDS)]
    # ACCO: two parities x the shard's two phases; DPU: two phases; DDP
    # writes over its one set
    assert len(programs.programs) == {"acco": 4, "dpu": 2, "ddp": 1}[method]


@pytest.mark.parametrize("method", ["acco", "ddp"])
def test_buffer_sets_on_a_one_rank_group(method, tmp_path):
    """The dp code on a one-rank gloo group made in this process (the
    count all-reduce, ZeRO-1's reduce-scatter into the new shard's nu
    buffer and its all-gather into the new flat parameters, as on the
    card's one-rank NCCL group): the buffer-set rounds bit-equal to the
    eager ones over 5 rounds."""
    import torch.distributed as dist

    from acco_tpu_torch.parallel.mesh import RankGroups

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        groups, _ = RankGroups.around(data_group=dist.group.WORLD)
        flat = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32).init_flat(
            torch.Generator().manual_seed(0))

        def port():
            model = LlamaModel(LlamaConfig(**ARCH), dtype=torch.float32, device="cpu")
            cls = DDPTrainStep if method == "ddp" else AccoTrainStep
            kw = {} if method == "ddp" else {"mode": "acco"}
            step = cls(model, get_schedule(*SCHED), groups=groups, **kw, **OPT)
            return step, step.init_state(flat)

        (step, state), (eager_step, eager) = port(), port()
        blocks = [block_from_numpy(b, "cpu") for b in _blocks(6, seed=2)]
        blocks[POISONED] = blocks[POISONED]._replace(valid=torch.ones(N_ACC))
        shapes = tuple(tuple(t.shape) for t in blocks[0])
        programs = graphs.RoundPrograms(step, state, shapes, capture=False)
        if method != "ddp":
            state, _ = step.seed(programs.state, blocks[0], in_place=True)
            eager, _ = eager_step.seed(eager, blocks[0])
            programs.adopt(state)
        for r in range(5):
            state, m, _ = programs.run(blocks[r + 1], r % 2 == 0)
            if method == "ddp":
                eager, em = eager_step.step(eager, blocks[r + 1])
            else:
                eager, em = eager_step.round(eager, blocks[r + 1], r % 2 == 0)
            assert torch.equal(_bits(m.loss), _bits(em.loss.float()))
            _assert_bit_equal(state, eager, f"{method} round {r}")
    finally:
        dist.destroy_process_group()


def test_acco_cycle_keeps_the_shard_in_place():
    """ACCO's speculative round returns the optimizer shard unchanged:
    it stays in its set, so the cycle has four programs, and no
    shard-sized leaf is copied at the end of a round (only scalars)."""
    _, _, port = _setup("acco")
    step, state = port()
    blocks = _blocks(5, seed=1)
    shapes = tuple(tuple(t.shape) for t in block_from_numpy(blocks[0], "cpu"))
    programs = graphs.RoundPrograms(step, state, shapes, capture=False)
    copied = []
    original = torch.Tensor.copy_

    def spy(self, src, *a, **k):
        copied.append(self.numel())
        return original(self, src, *a, **k)

    n_params = state.flat_params.numel()
    for r in range(4):
        with _patched(torch.Tensor, "copy_", spy):
            programs.run(block_from_numpy(blocks[r], "cpu"), r % 2 == 0)
        assert max(n for n in copied if n != N_ACC * BATCH * SEQ) < n_params or r % 2 == 0
        copied.clear()
    names = [p.name for p in programs.programs.values()]
    assert [n.split("/")[0] for n in names] == ["acco_even", "acco_odd"] * 2
    assert len(set(names)) == 4


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


# -- through the trainer (the drills' setup of tests/test_torch_robustness.py)

TRAIN_ARCH = dict(vocab_size=257, hidden_size=32, intermediate_size=64, num_layers=2,
                  num_heads=4, num_kv_heads=2, max_position_embeddings=32)
TEXTS = ["".join(np.random.default_rng(i).choice(list("abcdefghij "), 63)) for i in range(7)]


def _trainer(method, nb, run_dir, eager, handler=None, **over):
    args = dict(method_name=method, batch_size=2, max_length=32, nb_steps_tot=nb,
                const_len_batch=True, scheduler_name="constant", learning_rate=3e-3,
                weight_decay=0.1, adam_beta1=0.9, adam_beta2=0.95, save=False,
                checkpoint_every_s=1e9, n_warmup_steps=0, run_name=method,
                delta_step_for_log=2, handle_signals=False)
    args.update(over)
    model = LlamaModel(LlamaConfig(**TRAIN_ARCH), dtype=torch.float32)
    return Trainer(model, load_tokenizer("byte"), TEXTS, TEXTS[:4], ConfigNode.wrap(args), seed=3,
                   run_dir=str(run_dir), shutdown_handler=handler, eager=eager)


def _losses(summary):
    return [(r["round"], r["loss"], r["lr"], r["is_real_update"]) for r in summary["round_log"]]


@pytest.mark.parametrize("scenario", ["drill", "rollback", "resume", "warmup_eval"])
def test_trainer_buffer_sets_equal_eager(tmp_path, scenario):
    """The trainer with the buffer sets against the eager trainer, bit for
    bit: ``nan_grads@3`` (the poisoned block written into the static
    block), ``corrupt_params`` with the watchdog's rollback (the poison
    written into the live set, the checkpoint restored into it), a
    SIGTERM stop resumed (the restored state becoming set A) against the
    uninterrupted eager run, and ACCO's two DPU warm-up rounds (over the
    sets, uncaptured) with the eval every 2 grads (the eval step's
    program on the live flat parameters)."""
    if scenario == "warmup_eval":
        kw = dict(method="acco", nb=8, n_warmup_steps=2, eval=True, eval_step=2)
    elif scenario == "drill":
        kw = dict(method="acco", nb=8, fault_injection="nan_grads@3", delta_step_for_log=1)
    elif scenario == "rollback":
        kw = dict(method="acco", nb=14, save=True, checkpoint_every_s=0,
                  rollback_after_skipped=2, ckpt_keep_last=0,
                  fault_injection=[{"kind": "corrupt_params", "round": 6, "n": 8}])
    else:
        kw = dict(method="dpu", nb=6)
    method, nb = kw.pop("method"), kw.pop("nb")
    a = _trainer(method, nb, tmp_path / "a", eager=True, **kw)
    sa = a.train()
    if scenario == "resume":
        b = _trainer(method, nb, tmp_path / "b", eager=False, handler=ShutdownAfterRounds(3),
                     save=True, handle_signals=True)
        sb = b.train()
        assert sb["interrupted"] and sb["rounds_as"] == "buffer_sets"
        c = _trainer(method, nb, tmp_path / "c", eager=False,
                     resume_from=str(tmp_path / "b" / "checkpoints" / method))
        sc = c.train()
        assert _losses(sb) + _losses(sc) == _losses(sa)
        _assert_bit_equal(c.final_state, a.final_state, scenario)
        return
    b = _trainer(method, nb, tmp_path / "b", eager=False, **kw)
    sb = b.train()
    assert (sa["rounds_as"], sb["rounds_as"]) == ("eager", "buffer_sets")
    assert sb["skipped_rounds"] == sa["skipped_rounds"] >= (scenario == "drill")
    assert sb["rollbacks"] == sa["rollbacks"] == (scenario == "rollback")
    assert str(_losses(sb)) == str(_losses(sa))  # NaN losses compare as text
    assert [e["eval_loss"] for e in sb["eval_log"]] == [e["eval_loss"] for e in sa["eval_log"]]
    assert sb["warmup_losses"] == sa["warmup_losses"]
    if scenario == "warmup_eval":
        assert len(sa["eval_log"]) >= 2 and len(sa["warmup_losses"]) == 2
    _assert_bit_equal(b.final_state, a.final_state, scenario)


def test_metric_slots_read_back_as_eager(tmp_path):
    """Read back every 3 grads, the buffer-set rounds' log (each round's
    slot, read at the boundary) equals the eager one; each slot is a
    copy, not the program's own vector, which the next round
    overwrites."""
    sa = _trainer("ddp", 7, tmp_path / "a", eager=True, delta_step_for_log=3).train()
    b = _trainer("ddp", 7, tmp_path / "b", eager=False, delta_step_for_log=3)
    sb = b.train()
    assert _losses(sb) == _losses(sa)
    assert len({r["loss"] for r in sb["round_log"]}) == len(sb["round_log"])
    vec = torch.arange(4.0)
    slot = b.programs.slot(vec)
    vec.fill_(-1)
    assert slot.tolist() == [0.0, 1.0, 2.0, 3.0]


# -- the launch counters' replay arithmetic, on a stub graph -------------------

class _StubGraph:
    replays = 0

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        _StubGraph.replays += 1


def test_replay_credits_what_the_capture_counted(monkeypatch):
    """A capture's launches are taken back and measured; each replay adds
    them (ops LAUNCHES and a registered counter alike); a warm-up's are
    taken back and reported."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    fused_attention.reset_launch_counts()
    extra = {"head": 0}

    def body():
        fused_attention.LAUNCHES["attn_fwd"] += 3
        fused_attention.LAUNCHES["attn_bwd_dq"] += 1
        extra["head"] += 2
        return "outputs"

    with graphs.counting(extra):
        prog = graphs.Program("stub", body)
        assert prog() == "outputs"  # uncaptured: a real launch, counted
        assert fused_attention.LAUNCHES["attn_fwd"] == 3 and extra["head"] == 2
        prog.capture(pool=None, stream=None)
        assert fused_attention.LAUNCHES["attn_fwd"] == 3 and extra["head"] == 2
        for _ in range(2):
            assert prog() == "outputs"
        assert fused_attention.LAUNCHES == {"attn_fwd": 9, "attn_bwd_delta": 0,
                                            "attn_bwd_dkdv": 0, "attn_bwd_dq": 3}
        assert extra["head"] == 6 and _StubGraph.replays == 2
        ms, counts = graphs._warm(body)
        assert counts == {"attn_fwd": 3, "attn_bwd_dq": 1, "head": 2} and ms >= 0
        assert fused_attention.LAUNCHES["attn_fwd"] == 9 and extra["head"] == 6
    assert extra not in graphs.counter_tables()
    fused_attention.reset_launch_counts()


# -- the build cache and the background builds ----------------------------------

def test_library_key_tracks_source_headers_and_flags(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.PACKAGE_DIR / "csrc", csrc)
    key = cache.library_key("fused_attention", csrc)
    assert key == cache.library_key("fused_attention", csrc) == cache.library_key(
        "fused_attention")
    assert len(key) == 16 and key != cache.library_key("fused_ce", csrc)
    # another library's source does not move this key
    (csrc / "fused_ce.cu").write_text((csrc / "fused_ce.cu").read_text() + "\n// edit\n")
    assert cache.library_key("fused_attention", csrc) == key
    (csrc / "fused_attention.cu").write_text(
        (csrc / "fused_attention.cu").read_text() + "\n// edit\n")
    edited = cache.library_key("fused_attention", csrc)
    assert edited != key
    (csrc / "tiles.cuh").write_text((csrc / "tiles.cuh").read_text() + "\n// edit\n")
    assert cache.library_key("fused_attention", csrc) not in (key, edited)
    assert cache.library_key("fused_attention", flags=("-O2",)) != key


@pytest.mark.parametrize("attention, fused, local, want", [
    ("fused", False, False, ["fused_attention"]),
    ("fused", False, True, ["fused_attention", "banded_attention"]),
    ("fused", "pallas", False, ["fused_attention", "fused_ce"]),
    ("flash", "pallas", False, ["flash_attention", "fused_ce"]),
    ("ring", "pallas", True, ["block_attention", "fused_ce"]),
    ("xla", "chunk", False, []),
])
def test_libraries_for(attention, fused, local, want):
    assert cache.libraries_for(attention, fused, local_layers=local) == want


def test_compile_warmup_report_and_failure_policy(tmp_path, monkeypatch, caplog):
    """Builds run on the pool; a failed one is recorded and logged, never
    raised by ``join``; at its first use the same build runs again and
    raises (no plain-version fallback)."""
    built = []

    def build(name):
        if name == "bad":
            raise RuntimeError("nvcc failed")
        built.append(name)

    with caplog.at_level(logging.INFO):
        w = warmup.CompileWarmup(["fused_attention", "bad", "fused_attention"], build=build)
        report = w.join()
    assert w.join() is report and built == ["fused_attention"]
    assert set(report.libraries) == {"fused_attention", "bad"}
    assert report.libraries["fused_attention"].ok and not report.ok
    assert "nvcc failed" in report.libraries["bad"].error
    assert any("builds again at first use" in r.message for r in caplog.records)
    d = report.as_dict()
    assert d["libraries"]["bad"]["error"] and d["join_ms"] >= 0 and d["wall_ms"] >= d["join_ms"]
    assert report.log_lines()[0].startswith("build[bad]: FAILED")
    # the first use: nothing in a fresh build dir, no nvcc -> the build raises
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_nvcc",
                        lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("fused_attention", {})
    assert cache.cache_stats()["builds"] >= 0


# -- the profile reader under replay ---------------------------------------------

def _dev(cat, name, stream, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def _probe(role, ts, corr):
    return [{"ph": "X", "cat": "user_annotation", "name": profile.PROBE + role, "pid": 9,
             "tid": 1, "ts": ts, "dur": 10, "args": {}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9, "tid": 1,
             "ts": ts + 2, "dur": 3, "args": {"correlation": corr}}]


def _replay(ts, compute, comm, corr):
    """One replayed round: a graph launch; the compute branch (one probe
    spin, then a GEMM of 800 us) on stream ``compute``, the comm branch
    (two probe spins, then 400 us of AdamW) on ``comm``."""
    return [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "pid": 9, "tid": 1,
         "ts": ts, "dur": 5, "args": {"correlation": corr}},
        _dev("kernel", "spin_kernel(long)", compute, ts + 10, 1, corr),
        _dev("kernel", "gemm", compute, ts + 11, 800, corr),
        _dev("kernel", "spin_kernel(long)", comm, ts + 10, 1, corr),
        _dev("kernel", "spin_kernel(long)", comm, ts + 11, 1, corr),
        _dev("kernel", "adamw", comm, ts + 200, 400, corr),
    ]


def test_profile_reader_names_a_replays_streams():
    """The eager probes name streams 7 (compute), 13 (comm) and 30
    (copy); two replayed rounds run their kernels on streams 40 and 41,
    which no eager probe named. Without the graphs' probes stream 40,
    another stream that computes, would be the comm side. With them each
    replay's branches are named by the probes at their heads: 40's
    segments compute (one spin), 41's comm (two), and the comm side's
    402 us a round lie wholly under compute."""
    events = (_probe("compute", 0, 1) + _probe("comm", 20, 2) + _probe("copy", 40, 3) + [
        _dev("kernel", "spin_kernel(long)", 7, 3, 0, 1),
        _dev("kernel", "spin_kernel(long)", 13, 23, 0, 2),
        _dev("kernel", "spin_kernel(long)", 30, 43, 0, 3),
    ] + _replay(1000, 40, 41, 50) + _replay(2000, 40, 41, 51))
    assert profile.stream_roles(events) == {7: "compute", 13: "comm", 30: "copy"}
    sides = profile.graph_sides(events)
    assert {events[i]["tid"]: side for i, side in sides.items()} == {40: "compute", 41: "comm"}
    got = profile.read_trace(events, wall_ms=2.0, rounds=2)
    assert got["compute_ms"] == pytest.approx(0.801)
    assert got["comm_ms"] == pytest.approx(0.402)
    assert got["measured_overlap_pct"] == pytest.approx(100.0)
    assert got["graph_launches"] == 1 and got["kernels"] == 5 + 1.5
    assert {"graph:40", "graph:41"} <= set(got["streams_ms"])
    # without the graphs' probes stream 40 goes unnamed: the comm side
    # (the compute branch's 800 us a round then count as the comm side)
    bare = [e for e in events if not (e["tid"] in (40, 41) and "spin" in e["name"])]
    assert profile.graph_sides(bare) == {}
    assert profile.read_trace(bare, wall_ms=2.0, rounds=2)["comm_ms"] == pytest.approx(0.8)
    # one stream carrying both branches in turn, the launching stream that
    # the eager probe named compute among them: each segment its own side
    turns = (_probe("compute", 0, 1) + [_dev("kernel", "spin_kernel(long)", 7, 3, 0, 1)]
             + _replay(1000, 40, 7, 50) + _replay(2000, 7, 42, 51))
    got = profile.read_trace(turns, wall_ms=2.0, rounds=2)
    assert got["compute_ms"] == pytest.approx(0.801)
    assert got["comm_ms"] == pytest.approx(0.402)
