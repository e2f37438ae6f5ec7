"""The port's sharding rule engine and tp tables against the JAX package's.

The cases of tests/test_sharding_rules.py on the port's copy
(``acco_tpu_torch/sharding/``): first-match precedence, the closed world
(an unmatched leaf raises), coverage, the leaf-path convention (the
port's spec is a tuple of axis entries, as JAX's ``PartitionSpec``), and
the tp parameter tables over the real trees of both families: the port's
``model_split_specs`` (the models' ``tp_param_specs``) equal JAX's for
tied and untied Llama and for GPT-Neo, also for a model read from an HF
checkpoint; the pp tables equal JAX's (tests/test_torch_pipeline_parallel.py
holds them leaf for leaf), and pp composed with tp or sp raises.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import pytest
import torch

from acco_tpu import sharding as jax_sharding
from acco_tpu.models.gpt_neo import GPTNeoConfig as JaxGPTNeoConfig
from acco_tpu.models.gpt_neo import GPTNeoModel as JaxGPTNeoModel
from acco_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from acco_tpu.models.llama import LlamaModel as JaxLlamaModel
from acco_tpu_torch.models.gpt_neo import GPTNeoConfig, GPTNeoModel
from acco_tpu_torch.models.llama import LlamaConfig, LlamaModel
from acco_tpu_torch.sharding import (
    P,
    Rule,
    RuleTable,
    ShardingRuleError,
    leaf_paths,
    model_split_specs,
    param_table,
)
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

LLAMA = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2,
             num_kv_heads=2, max_position_embeddings=16)
NEO = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
           max_position_embeddings=16, attention_layers=["global", "global"])


def _port(family, tied=True):
    if family == "llama":
        return LlamaModel(LlamaConfig(**LLAMA, tie_word_embeddings=tied), dtype=torch.float32)
    return GPTNeoModel(GPTNeoConfig(**dict(NEO, attention_layers=tuple(NEO["attention_layers"]))),
                       dtype=torch.float32)


def _jax(family, tied=True):
    if family == "llama":
        return JaxLlamaModel(JaxLlamaConfig(**LLAMA, tie_word_embeddings=tied),
                             param_dtype=jnp.float32)
    return JaxGPTNeoModel(JaxGPTNeoConfig(**NEO), param_dtype=jnp.float32)


def _avals(model):
    return jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))


def test_first_match_wins_precedence():
    table = RuleTable("t", (Rule(r"^opt/mu$", P("dp"), why="specific first"),
                            Rule(r"^opt/", P(), why="catchall after")))
    assert table.match("opt/mu") == P("dp")
    assert table.match("opt/nu") == P()
    flipped = RuleTable("t", tuple(reversed(table.rules)))
    assert flipped.match("opt/mu") == P()


def test_unmatched_leaf_raises_listing_table():
    table = RuleTable("train:test", (Rule(r"^flat_params$", P()),))
    with pytest.raises(ShardingRuleError, match="no rule matches leaf 'zero1/opt/mu'"):
        table.match("zero1/opt/mu")


def test_coverage_reports_unmatched_and_ambiguous():
    table = RuleTable("t", (Rule(r"^opt/", P()), Rule(r"mu$", P("dp"))))
    report = table.coverage({"opt": {"mu": 0, "nu": 0}, "extra": 0})
    assert not report.ok
    assert report.unmatched == ("extra",)
    assert [path for path, _ in report.ambiguous] == ["opt/mu"]
    assert "unmatched: extra" in report.summary()


def test_leaf_paths_convention_matches_jax():
    """Slash-joined: NamedTuple field names, dict keys sorted, sequence
    indices, None subtrees skipped; the same paths as JAX's engine."""
    Pair = namedtuple("Pair", ["left", "right"])
    tree = {"b": Pair(left=1, right=[2, 3]), "a": 4, "skip": None}
    want = ["a", "b/left", "b/right/0", "b/right/1"]
    assert [p for p, _ in leaf_paths(tree)] == want
    assert [p for p, _ in jax_sharding.leaf_paths(tree)] == want


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
def test_param_tables_equal_jax_and_cover_the_trees(family, tied):
    """The family's tp table equals JAX's rule for rule, and covers both
    the port's dense tree and JAX's avals exactly once per leaf."""
    mine = param_table(family, "tp", tied=tied, axis="x")
    theirs = jax_sharding.param_table(family, "tp", tied=tied, axis="x")
    assert [(r.pattern, tuple(r.spec)) for r in mine.rules] == \
        [(r.pattern, tuple(r.spec)) for r in theirs.rules]
    model = _port(family, tied)
    report = param_table(model.family, tied=tied, axis="x").coverage(model.dense_shapes())
    assert report.ok, report.summary()
    assert mine.coverage(_avals(_jax(family, tied))).ok


@pytest.mark.parametrize("family, tied", [("llama", True), ("llama", False), ("gpt_neo", True)])
def test_split_dims_equal_jax(family, tied):
    """The port's split dims over the real tree (``tp_param_specs`` and
    ``model_split_specs``) equal JAX's ``model_split_specs``, leaf for
    leaf."""
    model = _port(family, tied)
    want = jax_sharding.model_split_specs(_jax(family, tied), "tp")
    assert model_split_specs(model.family, model.dense_shapes()) == want
    assert model.tp_param_specs() == want
    dims = model.tp_param_specs()
    if family == "llama":
        assert (dims["layers"]["wq"], dims["layers"]["wo"], dims["wte"]) == (2, 1, 0)
        assert dims["final_norm"] is None and (dims.get("lm_head") == 1) == (not tied)
    else:
        assert (dims["layers"]["w_qkv"], dims["layers"]["b_fc"], dims["wpe"]) == (3, 1, None)


def test_family_attribute_and_unknown_tables():
    """The models name their family; an unknown family or kind raises;
    the pp table is JAX's; a pipeline composes with tensor and context
    parallelism (item 9.4): ``check_pipeline`` asks only that pp divide
    the layers, ``check_pairing`` that the step's groups be the model's,
    and ``composed_split_specs`` gives the pp and tp tables' trees."""
    from acco_tpu_torch.parallel.mesh import RankGroups
    from acco_tpu_torch.sharding import check_pairing, check_pipeline, composed_split_specs

    assert (_port("llama").family, _port("gpt_neo").family) == ("llama", "gpt_neo")
    with pytest.raises(ShardingRuleError):
        param_table("llama", "fsdp", axis="x")
    with pytest.raises(ShardingRuleError):
        param_table("mystery", "tp")
    for family in ("llama", "gpt_neo"):
        mine, theirs = param_table(family, "pp"), jax_sharding.param_table(family, "pp")
        assert [(r.pattern, tuple(r.spec)) for r in mine.rules] == \
            [(r.pattern, tuple(r.spec)) for r in theirs.rules]
        assert model_split_specs(family, _port(family).dense_shapes(), "pp") == \
            jax_sharding.model_split_specs(_jax(family), "pp")
    assert check_pipeline(2, num_layers=2) == 1
    with pytest.raises(ValueError, match="must divide"):
        check_pipeline(2, num_layers=3)
    for family in ("llama", "gpt_neo"):
        shapes = _port(family).dense_shapes()
        assert composed_split_specs(family, shapes) == (
            jax_sharding.model_split_specs(_jax(family), "pp"),
            jax_sharding.model_split_specs(_jax(family), "tp"))
    model = _port("llama")
    check_pairing(model, None, None)
    for kw in ({"tensor": object()}, {"tensor": object(), "model_axis": "pp"}):
        groups = RankGroups(dp=1, sp=1, dp_index=0, sp_index=0, n_model=2, **kw)
        with pytest.raises(ValueError, match="group is not the groups'"):
            check_pairing(model, groups, None)
    with pytest.raises(ValueError, match="ring-attention model"):
        check_pairing(model, None, object())


def test_hf_import_is_covered_by_the_same_tables(tmp_path):
    """A model from ``hf_loader.from_pretrained`` (an untied Llama written
    as an HF checkpoint) goes through the same family and tables."""
    import json

    import numpy as np
    from safetensors.numpy import save_file

    from acco_tpu_torch.models.hf_loader import from_pretrained

    d, f, v = 16, 32, 64
    rng = np.random.default_rng(0)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    state = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": w(d),
             "lm_head.weight": w(v, d)}
    for i in range(2):
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = w(d)
        state[pre + "post_attention_layernorm.weight"] = w(d)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            state[pre + f"self_attn.{proj}.weight"] = w(d, d)
        state[pre + "mlp.gate_proj.weight"] = w(f, d)
        state[pre + "mlp.up_proj.weight"] = w(f, d)
        state[pre + "mlp.down_proj.weight"] = w(d, f)
    save_file(state, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": v, "hidden_size": d, "intermediate_size": f,
        "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
        "max_position_embeddings": 16, "tie_word_embeddings": False}))
    model, _ = from_pretrained(str(tmp_path), dtype=torch.float32)
    table = param_table(model.family, tied=False, axis="x")
    assert model.family == "llama" and table.coverage(model.dense_shapes()).ok
    assert table.match("lm_head") == P(None, "x")
    assert model.tp_param_specs()["layers"]["wq"] == 2
