"""The rule tables: the train, eval and serve state tables and the
per-model-family tensor- and pipeline-parallel parameter tables.

Counterpart of ``acco_tpu/sharding/tables.py``, rule for rule. The state
tables (JAX: ``tables.py:34-139``) place every leaf of a train state
(``AccoState`` for acco and dpu, ``DDPState`` for ddp; the paths as
``utils/checkpoint.py`` ``state_leaves`` names them: ``zero1/opt/mu``,
``pending_grads``, ``health/pending_ok``, ...), of the eval program's
``{"flat_params"}`` and of the serve state (``params``, ``k_pages``,
``v_pages``). The flat ZeRO-1 vectors shard over the data axes (``dp``
or ``(dp, sp)``), with the model axis (``tp``, ``pp`` or ``(pp, tp)``)
first under a model axis; the flat params replicate over the data axes.
The port places nothing by these specs (each rank holds its own view):
the static gates (``analysis/rules.py``) audit the trees against them
and the memory sieve (``analysis/memory.py``) prices each leaf by them.

``model_split_specs`` gives ``parallel/tp.TpLayout`` the split dim of
every leaf (the models' ``tp_param_specs`` and ``pp_param_specs``), and
``composed_split_specs`` the outer (pp) and inner (tp) trees of
``parallel/tp.ComposedLayout`` (JAX: ``tables.py:257``).
"""

from __future__ import annotations

from typing import Any, Optional, Union

from acco_tpu_torch.sharding.rules import P, Rule, RuleTable, ShardingRuleError, split_dims

DATA_AXIS = "dp"
SEQ_AXIS = "sp"
TENSOR_AXIS = "tp"
PIPELINE_AXIS = "pp"

Axes = Union[str, tuple]


def _flat_specs(shard_axes: Axes, model_axis: Optional[Axes]) -> tuple:
    """(sharded, replicated-within-data) specs of the flat ZeRO-1 vectors:
    one leading dim over ``model axes + shard axes`` (resp. the model
    axes alone for the flat params)."""
    axes = (shard_axes,) if isinstance(shard_axes, str) else tuple(shard_axes)
    if model_axis:
        t = (model_axis,) if isinstance(model_axis, str) else tuple(model_axis)
        return P(t + axes), P(t)
    return P(shard_axes), P()


def flat_state_specs(shard_axes: Axes, tensor_axis: Optional[Axes] = None) -> tuple:
    """(shard, flat) specs straight from the table arithmetic."""
    return _flat_specs(shard_axes, tensor_axis)


def train_state_table(mode: str, shard_axes: Axes, model_axis: Optional[Axes] = None) -> RuleTable:
    """Rule table of a train state (``AccoState`` for acco and dpu,
    ``DDPState`` for ddp), for every mesh: the specs follow the step's
    ``shard_axes`` and ``model_axis``."""
    shard, flat = _flat_specs(shard_axes, model_axis)
    common = [
        Rule(r"^flat_params$", flat,
             "flat param vector: replicated within data axes, split over model axes"),
        Rule(r"^zero1/opt/(params|mu|nu)$", shard,
             "ZeRO-1 optimizer state: each data shard owns 1/num_shards"),
        Rule(r"^zero1/opt/count$", P(), "scalar step counter"),
        Rule(r"^zero1/(sched_grads|grads_committed)$", P(), "scalar schedule/commit counters"),
        Rule(r"^health/(skipped_rounds|consec_skipped|pending_ok)$", P(),
             "watchdog scalars, replicated"),
    ]
    if mode in ("acco", "dpu"):
        rules = common + [
            Rule(r"^pending_grads$", shard,
                 "delayed gradient buffer, sharded like the optimizer state"),
            Rule(r"^pending_count$", P(DATA_AXIS), "per-data-replica contribution counter"),
            Rule(r"^round_idx$", P(), "scalar round counter"),
        ]
    elif mode == "ddp":
        rules = common
    else:
        raise ShardingRuleError(f"unknown train mode {mode!r}")
    return RuleTable(name=f"train:{mode}", rules=tuple(rules))


def eval_state_table(shard_axes: Axes, model_axis: Optional[Axes] = None) -> RuleTable:
    """The eval program sees only ``{"flat_params": ...}``."""
    _, flat = _flat_specs(shard_axes, model_axis)
    return RuleTable(name="eval",
                     rules=(Rule(r"^flat_params$", flat, "eval reads the flat params"),))


def serve_state_table(family: str = "any") -> RuleTable:
    """Serving is single-replica, as JAX's: params and KV pools replicated
    (a fleet scales by replicas, each sized by ``analysis/memory.py``)."""
    return RuleTable(
        name=f"serve:{family}",
        rules=(
            Rule(r"^(k_pages|v_pages)$", P(), "paged KV pools, single replica"),
            Rule(r"^params(/|$)", P(), "serve params, single replica"),
        ),
    )


def model_family(model: Any) -> str:
    """'llama' or 'gpt_neo': the model's ``family``, else its class name
    (JAX: ``tables.py:235``)."""
    family = getattr(model, "family", None)
    if family in ("llama", "gpt_neo"):
        return family
    name = type(model).__name__.lower()
    if "llama" in name:
        return "llama"
    if "neo" in name or "gpt" in name:
        return "gpt_neo"
    raise ShardingRuleError(
        f"cannot infer model family from {type(model).__name__!r}; "
        "add it to acco_tpu_torch.sharding.tables.model_family"
    )

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
