"""Declarative sharding: rule tables from leaf names to partition specs.

Counterpart of ``acco_tpu/sharding/``: the matching engine
(:mod:`~acco_tpu_torch.sharding.rules`), the tensor- and
pipeline-parallel parameter tables (:mod:`~acco_tpu_torch.sharding.tables`)
and the mesh/model pairing checks (:mod:`~acco_tpu_torch.sharding.layout`).
It imports nothing of ``parallel/`` or ``models/``.
"""

from acco_tpu_torch.sharding.rules import (
    P,
    PartitionSpec,
    Rule,
    RuleTable,
    ShardingRuleError,
    leaf_paths,
    map_tree,
    split_dims,
)
from acco_tpu_torch.sharding.layout import check_pairing, check_pipeline
from acco_tpu_torch.sharding.tables import composed_split_specs, model_split_specs, param_table

__all__ = [
    "P",
    "PartitionSpec",
    "Rule",
    "RuleTable",
    "ShardingRuleError",
    "leaf_paths",
    "map_tree",
    "split_dims",
    "param_table",
    "model_split_specs",
    "composed_split_specs",
    "check_pipeline",
    "check_pairing",
]
