"""The per-model-family tensor- and pipeline-parallel parameter tables.

Counterpart of the tp and pp rules of ``acco_tpu/sharding/tables.py``,
rule for rule: ``model_split_specs`` gives ``parallel/tp.TpLayout`` the
split dim of every leaf (the models' ``tp_param_specs`` and
``pp_param_specs``), and ``composed_split_specs`` the outer (pp) and
inner (tp) trees of ``parallel/tp.ComposedLayout`` (JAX:
``tables.py:257``). The train, eval and serve state tables come with
the serving-sharding item and the static gates (ROADMAP.md queue 1,
items 9.5 and 12).
"""

from __future__ import annotations

from typing import Any, Optional

from acco_tpu_torch.sharding.rules import P, Rule, RuleTable, ShardingRuleError, split_dims

TENSOR_AXIS = "tp"
PIPELINE_AXIS = "pp"

# The tp rules say which dim of each weight carries the tensor axis
# (Megatron column/row split).


def _llama_tp_rules(axis: str) -> tuple:
    return (
        Rule(r"^wte$", P(axis), "vocab-dim split embedding"),
        Rule(r"^layers/(attn_norm|mlp_norm)$", P(), "norm scales replicated"),
        Rule(r"^layers/(wq|wk|wv|w_gate|w_up)$", P(None, None, axis),
             "column-parallel: heads / ffn-in split on dim 2"),
        Rule(r"^layers/(wo|w_down)$", P(None, axis),
             "row-parallel: contraction dim split on dim 1"),
        Rule(r"^final_norm$", P(), "final norm replicated"),
        Rule(r"^lm_head$", P(None, axis), "untied head split on vocab dim"),
    )


def _gpt_neo_tp_rules(axis: str) -> tuple:
    return (
        Rule(r"^wte$", P(axis), "vocab-dim split embedding"),
        Rule(r"^wpe$", P(), "position embedding replicated"),
        Rule(r"^layers/(ln1_scale|ln1_bias|wo_bias|ln2_scale|ln2_bias|b_proj)$", P(),
             "norms and output biases replicated"),
        Rule(r"^layers/w_qkv$", P(None, None, None, axis), "fused qkv: head dim is dim 3"),
        Rule(r"^layers/(wo|w_proj)$", P(None, axis),
             "row-parallel: contraction dim split on dim 1"),
        Rule(r"^layers/w_fc$", P(None, None, axis), "ffn-in split on dim 2"),
        Rule(r"^layers/b_fc$", P(None, axis), "ffn-in bias split with w_fc"),
        Rule(r"^(lnf_scale|lnf_bias)$", P(), "final norm replicated"),
    )


# The pp rules split every stacked layer leaf on its layer dim (contiguous
# stages) and the embedding (and an untied head) on the vocab dim.


def _llama_pp_rules(axis: str) -> tuple:
    return (
        Rule(r"^wte$", P(axis), "embedding rows spread over stages"),
        Rule(r"^layers/", P(axis), "layer stack split on the layer dim"),
        Rule(r"^final_norm$", P(), "final norm replicated"),
        Rule(r"^lm_head$", P(None, axis), "untied head split on vocab dim"),
    )


def _gpt_neo_pp_rules(axis: str) -> tuple:
    return (
        Rule(r"^wte$", P(axis), "embedding rows spread over stages"),
        Rule(r"^wpe$", P(), "position embedding replicated"),
        Rule(r"^layers/", P(axis), "layer stack split on the layer dim"),
        Rule(r"^(lnf_scale|lnf_bias)$", P(), "final norm replicated"),
    )


_RULES = {
    ("llama", "tp"): _llama_tp_rules, ("gpt_neo", "tp"): _gpt_neo_tp_rules,
    ("llama", "pp"): _llama_pp_rules, ("gpt_neo", "pp"): _gpt_neo_pp_rules,
}
_DEFAULT_AXIS = {"tp": TENSOR_AXIS, "pp": PIPELINE_AXIS}


def param_table(family: str, kind: str = "tp", *, tied: bool = True,
                axis: Optional[str] = None) -> RuleTable:
    """Parameter rule table for ``family`` ('llama' | 'gpt_neo') and
    ``kind`` ('tp' | 'pp'), over ``axis`` (default the kind's own).
    ``tied`` drops Llama's ``lm_head`` rule when the head shares the
    embedding (GPT-Neo always ties)."""
    if (family, kind) not in _RULES:
        raise ShardingRuleError(f"no param table for family={family!r} kind={kind!r}")
    rules = _RULES[family, kind](axis or _DEFAULT_AXIS[kind])
    if family == "llama" and tied:
        rules = tuple(r for r in rules if "lm_head" not in r.pattern)
    return RuleTable(name=f"params:{family}:{kind}", rules=rules)


def model_split_specs(family: str, shapes: Any, axis: Optional[str] = None) -> Any:
    """Int/None split-dim tree for ``TpLayout`` over a dense parameter tree
    (``shapes``: a model's ``dense_shapes()``) of ``family`` (a model's
    ``family``): the pp table for ``axis='pp'``, else the tp table; the
    head is untied when the tree has an ``lm_head``."""
    axis = axis or TENSOR_AXIS
    kind = "pp" if axis == PIPELINE_AXIS else "tp"
    tied = "lm_head" not in shapes
    return split_dims(param_table(family, kind, tied=tied, axis=axis), shapes, axis)


def composed_split_specs(family: str, shapes: Any) -> tuple:
    """``(outer, inner)`` split-dim trees of a tp x pp model for
    ``ComposedLayout``: the pp table's (the stages) and the tp table's
    (the tensor shards of a stage), JAX's ``(model.pp_param_specs(),
    model.tp_param_specs())``."""
    return (model_split_specs(family, shapes, PIPELINE_AXIS),
            model_split_specs(family, shapes, TENSOR_AXIS))
