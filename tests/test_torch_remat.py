"""The port's rematerialisation (``models/layers.wrap_remat``) against
remat off and against JAX's ``wrap_remat`` model, in float32 with TF32
off:

- every mode (True, 'dots', 'dots+probs') leaves the loss and gradients
  of both model families as remat off gives them, at
  ``tests/test_attention_impl.py:91-96``'s bars (loss rtol 1e-6,
  gradients rtol 1e-5 / atol 1e-5; on the CPU they come out bit-equal),
  through the plain path and through the kernels' plain versions
  (K1, K2);
- the port under each mode against JAX's model under the same mode, on
  the same parameters and tokens (the plain path; no Pallas interpreter);
- what each mode recomputes: 'dots' and 'dots+probs' never call K1's
  forward again in the backward (its O and LSE are saved through the
  ``acco_tpu_torch::attn_fwd`` op), True calls it once more a layer;
  'dots+probs' saves the plain path's probabilities, 'dots' recomputes
  them;
- 'auto' takes flash from L 2048 without remat and from L 4096 with it,
  as JAX's resolver does;
- the trainer's rounds under 'dots' equal remat off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu.ops.attention import resolve_attention_impl as jax_resolve
from acco_tpu_torch.models.convert import params_from_jax
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.ops import attention as attn
from acco_tpu_torch.ops import fused_attention
from acco_tpu_torch.ops.attention import resolve_attention_impl
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

MODES = [True, "dots", "dots+probs"]
LOSS_TOL = dict(rtol=1e-6)  # tests/test_attention_impl.py:91-93
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_attention_impl.py:94-96
LLAMA = dict(vocab_size=64, hidden_size=128, intermediate_size=96, num_layers=2, num_heads=2,
             num_kv_heads=1, max_position_embeddings=128)
NEO = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=256, window_size=64, attention_layers=("global", "local"))
B, L = 2, 128


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _ids(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, L)).astype(np.int64)


def _port(family, attention, remat):
    if family == "llama":
        return LlamaModel(LlamaConfig(**LLAMA), dtype=torch.float32, attention=attention,
                          remat=remat)
    return GPTNeoModel(GPTNeoConfig(**NEO), dtype=torch.float32, attention=attention,
                       remat=remat)


def _jax(family, remat):
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**LLAMA), param_dtype=jnp.float32, remat=remat)
    cfg = JaxNeoConfig(**{**NEO, "attention_layers": list(NEO["attention_layers"])})
    return JaxNeoModel(cfg, param_dtype=jnp.float32, remat=remat)


def _loss_and_grads(model, flat, ids, mask=None):
    model.load_flat(flat.clone())
    params = [p for p, _, _ in model.flat_slices()]
    logits = model.apply(torch.from_numpy(ids), mask)
    loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                             torch.from_numpy(ids[:, 1:]).reshape(-1))
    grads = torch.autograd.grad(loss, params)
    return loss.item(), torch.cat([g.reshape(-1) for g in grads]).numpy()


def _count_calls(monkeypatch, module, name):
    calls = {"fwd": 0}
    inner = getattr(module, name)

    def counting(*a, **k):
        calls["fwd"] += 1
        return inner(*a, **k)

    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("family, attention", [("llama", "xla"), ("llama", "fused"),
                                               ("gpt_neo", "xla"), ("gpt_neo", "fused")])
@pytest.mark.parametrize("remat", MODES, ids=str)
def test_modes_match_remat_off(family, attention, remat):
    ids = _ids(64)
    mask = None
    if family == "llama" and attention == "fused":  # K1 with a pad mask too
        mask = torch.ones(B, L, dtype=torch.int32)
        mask[1, :7] = 0
    base = _port(family, attention, False)
    flat = base.init_flat(torch.Generator().manual_seed(1))
    want = _loss_and_grads(base, flat, ids, mask)
    got = _loss_and_grads(_port(family, attention, remat), flat, ids, mask)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)


@pytest.mark.parametrize("family", ["llama", "gpt_neo"])
@pytest.mark.parametrize("remat", MODES, ids=str)
def test_modes_match_jax_wrap_remat(family, remat):
    """The port's model and JAX's, both under ``remat``, from the same
    parameters: the loss and the flat gradients."""
    ids = _ids(64, seed=2)
    jmodel = _jax(family, remat)
    params = jmodel.init(jax.random.PRNGKey(0))

    def jloss(p):
        logits = jmodel.apply(p, jnp.asarray(ids, jnp.int32), None).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        tgt = jnp.asarray(ids[:, 1:])
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    cfg = LlamaConfig(**LLAMA) if family == "llama" else GPTNeoConfig(**NEO)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    flat = params_from_jax(to_np(params), cfg)
    loss, grads = _loss_and_grads(_port(family, "xla", remat), flat, ids)
    np.testing.assert_allclose(loss, float(jl), **LOSS_TOL)
    np.testing.assert_allclose(grads, params_from_jax(to_np(jg), cfg).numpy(), **GRAD_TOL)


@pytest.mark.parametrize("remat, reruns", [(False, 0), (True, 2), ("dots", 0),
                                           ("dots+probs", 0)], ids=str)
def test_what_each_mode_recomputes(monkeypatch, remat, reruns):
    """K1's forward (both Llama layers, GPT-Neo's global layer): called
    once a layer in the forward, and again in the backward only under
    True. (On the CPU, K2's plain version is autograd of its plain
    forward, with no op to save; the card's K2 is counted by
    ``chip_smoke.py`` phase 9.)"""
    calls = _count_calls(monkeypatch, fused_attention, "attention_reference")
    for family, layers in (("llama", 2), ("gpt_neo", 1)):
        model = _port(family, "fused", remat)
        model.load_flat(model.init_flat(torch.Generator().manual_seed(3)))
        params = [p for p, _, _ in model.flat_slices()]
        calls["fwd"] = 0
        loss = model.apply(torch.from_numpy(_ids(64))).float().square().mean()
        assert calls["fwd"] == layers
        torch.autograd.grad(loss, params)
        assert calls["fwd"] == layers + reruns * layers // 2


@pytest.mark.parametrize("remat, saved", [("dots", False), ("dots+probs", True)])
def test_dots_probs_saves_the_probabilities(monkeypatch, remat, saved):
    """The plain path's ``attn_probs`` op: recomputed in the backward under
    'dots', saved under 'dots+probs' (JAX's ``attn_probs`` name)."""
    calls = {"n": 0}
    inner = attn._attn_probs

    def counting(p, dtype):
        calls["n"] += 1
        return inner(p, dtype)

    torch.library.register_kernel("acco_tpu_torch::attn_probs", "cpu", counting)
    try:
        model = _port("llama", "xla", remat)
        model.load_flat(model.init_flat(torch.Generator().manual_seed(4)))
        params = [p for p, _, _ in model.flat_slices()]
        loss = model.apply(torch.from_numpy(_ids(64))).float().square().mean()
        assert calls["n"] == 2
        torch.autograd.grad(loss, params)
        assert calls["n"] == (2 if saved else 4)
    finally:
        torch.library.register_kernel("acco_tpu_torch::attn_probs", "cpu", inner)


@pytest.mark.parametrize("seq_len", [1024, 2048, 4096, 8192])
@pytest.mark.parametrize("remat", [False, True, "dots"], ids=str)
def test_auto_flash_threshold_moves_under_remat(seq_len, remat):
    got = resolve_attention_impl("auto", seq_len, 128, "cuda", remat)
    threshold = 2048 if remat is False else 4096
    if seq_len >= threshold:
        assert got == "flash"
        assert jax_resolve("auto", seq_len, platform="tpu", remat=remat, head_dim=128) == "flash"
    else:
        assert got == "fused"  # the port's own choice below the threshold
    assert resolve_attention_impl("auto", seq_len, 128, "cpu", remat) == "xla"


def test_trainer_rounds_under_dots_equal_remat_off(tmp_path):
    """Three ACCO rounds through the ``Trainer``: the final state and the
    losses under 'dots' are remat off's."""
    from acco_tpu_torch.configuration import ConfigNode
    from acco_tpu_torch.data.tokenizer import load_tokenizer
    from acco_tpu_torch.trainer import Trainer

    texts = ["".join(np.random.default_rng(i).choice(list("abcdefgh "), 200)) for i in range(6)]
    arch = dict(LLAMA, vocab_size=257, max_position_embeddings=64)

    def run(remat, name):
        args = ConfigNode.wrap(dict(method_name="acco", batch_size=2, max_length=64,
                                    nb_steps_tot=4, scheduler_name="constant", save=False,
                                    learning_rate=1e-3, run_name=name))
        model = LlamaModel(LlamaConfig(**arch), dtype=torch.float32, remat=remat)
        t = Trainer(model, load_tokenizer("byte"), texts, None, args, seed=5,
                    run_dir=str(tmp_path / name))
        return t, t.train()

    a, sa = run(False, "off")
    b, sb = run("dots", "dots")
    assert [r["loss"] for r in sa["round_log"]] == [r["loss"] for r in sb["round_log"]]
    torch.testing.assert_close(b.final_state.flat_params, a.final_state.flat_params,
                               rtol=0, atol=0)
