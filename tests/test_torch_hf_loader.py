"""The port's pretrained-weight loading (``acco_tpu_torch/models/hf_loader.py``)
on tiny checkpoints that ``transformers`` writes here from a config (no
hub), the counterpart of ``tests/test_hf_loader.py``:

- the port's logits equal HF's ``*ForCausalLM`` and JAX's
  ``from_pretrained`` model's at rtol 1e-4 / atol 1e-4
  (``tests/test_hf_loader.py:79``), for GPT-Neo (its local window
  masking) and Llama (GQA, untied and tied heads);
- the flat vector equals JAX's ``from_pretrained`` pytree laid out by
  ``params_from_jax`` (bit for bit, in float32);
- the hand-written safetensors reader equals ``safetensors.numpy``
  (BF16, F16, F32), and ``model.safetensors``, the sharded index and
  ``pytorch_model.bin`` load the same weights;
- hub names resolve through ``ACCO_MODELS_ROOT``; a missing checkpoint
  raises naming the missing download; ``vocab_pad_multiple`` raises by
  its item;
- ``train=acco-ft`` starts from the checkpoint's weights (learning rate
  0: its final ``params.npz`` is the checkpoint), and the perplexity eval
  reads the directory.
"""

import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from acco_tpu.models.hf_loader import from_pretrained as jax_from_pretrained
from acco_tpu_torch.models import hf_loader
from acco_tpu_torch.models.convert import params_from_jax

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored
HF_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_hf_loader.py:79


@pytest.fixture(scope="module")
def tiny_gpt_neo(tmp_path_factory):
    cfg = transformers.GPTNeoConfig(
        vocab_size=320, hidden_size=32, num_layers=2, attention_types=[[["global", "local"], 1]],
        num_heads=4, window_size=8, max_position_embeddings=64, intermediate_size=None,
    )
    torch.manual_seed(0)
    model = transformers.GPTNeoForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("hf_gpt_neo")
    model.save_pretrained(path, safe_serialization=True)
    return model, str(path)


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    cfg = transformers.LlamaConfig(
        vocab_size=320, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, tie_word_embeddings=False, attn_implementation="eager",
    )
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("hf_llama")
    model.save_pretrained(path, safe_serialization=True)
    return model, str(path)


def _ids(vocab, shape=(2, 16), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


def _port_logits(model, flat, ids):
    model.load_flat(flat.to(model.dtype))
    with torch.no_grad():
        return model.apply(torch.from_numpy(ids)).numpy()


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(input_ids=torch.from_numpy(ids)).logits.numpy()


def _jax_logits(path, ids):
    model, params = jax_from_pretrained(path, param_dtype=jnp.float32)
    return np.asarray(model.apply(params, jnp.asarray(ids, jnp.int32), None)), model, params


@pytest.mark.parametrize("family, shape", [("gpt_neo", (2, 16)), ("gpt_neo", (1, 32)),
                                           ("llama", (2, 16))])
def test_logits_match_hf_and_jax(family, shape, tiny_gpt_neo, tiny_llama):
    """(1, 32) is long enough that GPT-Neo's local layer masks: a layer
    mapped onto the wrong attention kind fails it."""
    hf_model, path = tiny_gpt_neo if family == "gpt_neo" else tiny_llama
    model, flat = hf_loader.from_pretrained(path, dtype=torch.float32)
    ids = _ids(model.config.vocab_size, shape, seed=len(shape) + shape[1])
    ours = _port_logits(model, flat, ids)
    np.testing.assert_allclose(ours, _hf_logits(hf_model, ids), **HF_TOL)
    jax_out, jmodel, params = _jax_logits(path, ids)
    np.testing.assert_allclose(ours, jax_out, **HF_TOL)
    # the flat vector is JAX's pytree laid out in the port's order
    want = params_from_jax({k: np.asarray(v) if not isinstance(v, dict) else
                            {kk: np.asarray(vv) for kk, vv in v.items()}
                            for k, v in params.items()}, model.config)
    torch.testing.assert_close(flat, want, rtol=0, atol=0)
    if family == "llama":
        assert not model.config.tie_word_embeddings and model.config.num_kv_heads == 2


def test_llama_tied_head(tmp_path):
    """No ``lm_head.weight`` in the file: the head is ``wte``."""
    cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=32,
        tie_word_embeddings=True, attn_implementation="eager",
    )
    torch.manual_seed(2)
    hf_model = transformers.LlamaForCausalLM(cfg).eval()
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    assert "lm_head.weight" not in hf_loader.read_hf_state(str(tmp_path))
    model, flat = hf_loader.from_pretrained(str(tmp_path), dtype=torch.float32)
    assert model.config.tie_word_embeddings
    ids = _ids(64, seed=4)
    np.testing.assert_allclose(_port_logits(model, flat, ids), _hf_logits(hf_model, ids),
                               **HF_TOL)


def test_safetensors_reader_equals_the_library(tmp_path):
    """BF16, F16 and F32 tensors (and a 0-d one) as ``safetensors.numpy``
    reads them, widened to float32."""
    import safetensors.torch

    rng = np.random.default_rng(5)
    tensors = {
        "a.bf16": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).bfloat16(),
        "b.f16": torch.from_numpy(rng.normal(size=(7,)).astype(np.float16)),
        "c.f32": torch.from_numpy(rng.normal(size=(2, 2, 3)).astype(np.float32)),
        "d.scalar": torch.tensor(1.5),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = hf_loader.read_safetensors(path)
    assert got.keys() == tensors.keys()
    for name, t in tensors.items():
        np.testing.assert_array_equal(got[name], t.float().numpy())  # lint: host-sync-ok: a CPU tensor read in an assertion loop
        if t.dtype != torch.bfloat16:  # numpy has no bfloat16 of its own
            ref = safetensors_numpy.load_file(path)[name]
            np.testing.assert_array_equal(got[name], ref.astype(np.float32))
            assert got[name].shape == ref.shape


def test_sharded_and_bin_checkpoints_load_the_same(tmp_path, tiny_llama):
    hf_model, path = tiny_llama
    _, want = hf_loader.from_pretrained(path, dtype=torch.float32)
    sharded = tmp_path / "sharded"
    hf_model.save_pretrained(sharded, safe_serialization=True, max_shard_size="20KB")
    assert os.path.exists(sharded / "model.safetensors.index.json")
    assert len(glob.glob(str(sharded / "model-*.safetensors"))) > 1
    binary = tmp_path / "bin"
    hf_model.save_pretrained(binary, safe_serialization=False)
    assert os.path.exists(binary / "pytorch_model.bin")
    for d in (sharded, binary):
        _, got = hf_loader.from_pretrained(str(d), dtype=torch.float32)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_models_root_missing_and_pad_multiple(tiny_gpt_neo, monkeypatch, tmp_path):
    _, path = tiny_gpt_neo
    root = tmp_path / "models"
    shutil.copytree(path, root / "EleutherAI" / "gpt-neo-tiny")
    monkeypatch.setenv("ACCO_MODELS_ROOT", str(root))
    _, flat = hf_loader.from_pretrained("EleutherAI/gpt-neo-tiny", dtype=torch.float32)
    _, direct = hf_loader.from_pretrained(path, dtype=torch.float32)
    torch.testing.assert_close(flat, direct, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="no network egress"):
        hf_loader.from_pretrained("EleutherAI/not-here")
    # Megatron vocab padding (tensor parallelism): zero rows past the vocab
    model, padded = hf_loader.from_pretrained(path, dtype=torch.float32, vocab_pad_multiple=3)
    extra = model.padded_vocab - model.config.vocab_size
    assert model.padded_vocab % 3 == 0 and extra > 0
    assert padded.numel() == direct.numel() + extra * model.config.hidden_size
    model.load_flat(padded)
    assert not model.wte[model.config.vocab_size:].any()


def test_finetune_entry_point_starts_from_the_checkpoint(tiny_gpt_neo, tmp_path):
    """``train=acco-ft`` (truncated rows with pad masks, eval on) at a
    zero learning rate: the final ``params.npz`` is the checkpoint's
    weights in bf16, and the summary's eval ran."""
    from acco_tpu_torch.__main__ import main

    _, path = tiny_gpt_neo
    summary = main(["--device", "cpu", "train=acco-ft", "model=gptneo",
                    f"model.config_path={path}", "model.tokenizer=byte", "data=synthetic",
                    "train.max_length=32", "train.batch_size=2", "train.nb_steps_tot=4",
                    "train.learning_rate=0.0", "train.eval_step=2",
                    "+train.delta_step_for_log=2", "train.save=true",
                    f"hydra.run.dir={tmp_path / 'run'}"])
    assert summary["count_grad_tot"] == 4 and summary["eval_log"]
    _, flat = hf_loader.from_pretrained(path, dtype=torch.float32)
    saved = np.load(os.path.join(summary["checkpoint"], "params.npz"))["flat_params"]
    np.testing.assert_array_equal(saved, flat.bfloat16().float().numpy())


def test_perplexity_eval_reads_the_directory(tiny_llama, capsys):
    """``--hf-checkpoint``: the checkpoint's model and weights, scored as
    ``compute`` scores them."""
    from acco_tpu_torch import perplexity_eval as port_ppl
    from acco_tpu_torch.data.datasets import load_text_dataset
    from acco_tpu_torch.data.tokenizer import load_tokenizer

    _, path = tiny_llama
    got = port_ppl.main(["--device", "cpu", "--hf-checkpoint", path, "--n-samples", "3",
                         "--max-length", "32"])
    model, flat = hf_loader.from_pretrained(path)
    texts = load_text_dataset({"path": "synthetic"}, test_size=0.01)[0][:3]
    want = port_ppl.compute(model, flat, load_tokenizer("byte"), texts, max_length=32)
    assert got["n"] == 3
    np.testing.assert_allclose(got["mean_perplexity"], want["mean_perplexity"], rtol=1e-6)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got


def test_a_tokenizer_with_no_vocabulary_falls_back_to_bytes(monkeypatch, caplog):
    """A checkpoint directory without tokenizer files can give (with some
    ``transformers`` versions) a tokenizer that encodes every text to no
    ids, which would score every sample at perplexity 1: the loader takes
    the byte-level fallback instead, with its warning."""
    from acco_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer

    class NoVocabulary:
        pad_token = eos_token = None

        def __call__(self, text, **kwargs):
            return {"input_ids": []}

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *args, **kwargs: NoVocabulary())
    with caplog.at_level("WARNING"):
        tok = load_tokenizer("/models/a-checkpoint")
    assert isinstance(tok, ByteTokenizer)
    assert "encodes text to no ids" in caplog.text and "byte-level fallback" in caplog.text
