"""Regex partition-rule engine: leaf names -> partition specs.

Counterpart of ``acco_tpu/sharding/rules.py``. A :class:`RuleTable` is an
ordered list of ``(regex, PartitionSpec)`` rules matched against the
slash-joined path of every leaf in a tree (``zero1/opt/mu``,
``layers/wq``, ``wte``). Matching is **first-match-wins** (order the
specific rules above the general ones) and **closed-world**: a leaf no
rule matches raises :class:`ShardingRuleError` rather than silently
replicating. A leaf matched by more than one rule is legal at lookup
time (first wins) but reported by :meth:`RuleTable.coverage`.

Path convention (the same as JAX's, so the tables compare): NamedTuples
contribute their field names, dicts their keys (sorted), sequences their
indices; ``None`` subtrees are skipped. The port's parameter paths are
those of ``models/flat.py`` ``sorted_layout`` (``wte``, ``layers/wq``,
...), which equal JAX's.

JAX's version uses ``jax.sharding.PartitionSpec``; the port has its own
:class:`PartitionSpec`, a tuple of mesh-axis names (or tuples of them)
and ``None`` per dimension. The placement helpers that build JAX
shardings (``shardings_for_tree``, ``shard_tree``, ...) have no
counterpart: the port places nothing by spec, it reads split dims
(:func:`split_dims`) for ``parallel/tp.TpLayout``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``P('dp')``, ``P(None, 'tp')``, ``P()``
    (replicated), ``P(('tp', 'dp'))`` (one dim over two axes). Compares as
    the tuple of its entries; a one-axis tuple entry is that axis, as in
    JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec


class ShardingRuleError(ValueError):
    """A tree leaf that no rule (or that conflicting rules) covers."""


@dataclass(frozen=True)
class Rule:
    """One ``regex -> PartitionSpec`` entry; ``why`` documents intent."""

    pattern: str
    spec: PartitionSpec
    why: str = ""

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def _is_leaf(node: Any) -> bool:
    return node is not None and not isinstance(node, (dict, tuple, list))


def _children(node: Any):
    """``(segment, child)`` pairs of an interior node."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield str(key), node[key]
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            yield name, getattr(node, name)
    else:  # plain tuple / list
        for idx, child in enumerate(node):
            yield str(idx), child


def leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(slash/joined/path, leaf), ...]`` in deterministic order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix or "<root>", tree)]
    out: list[tuple[str, Any]] = []
    for segment, child in _children(tree):
        out.extend(leaf_paths(child, f"{prefix}/{segment}" if prefix else segment))
    return out


def map_tree(tree: Any, fn: Callable[[str, Any], Any], prefix: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, the path
    as :func:`leaf_paths` gives it; NamedTuples, dicts and lists are
    rebuilt as they were."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(prefix or "<root>", tree)
    items = [(seg, map_tree(child, fn, f"{prefix}/{seg}" if prefix else seg))
             for seg, child in _children(tree)]
    if isinstance(tree, dict):
        return dict(items)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**dict(items))
    if isinstance(tree, tuple):
        return tuple(val for _, val in items)
    return [val for _, val in items]


@dataclass(frozen=True)
class CoverageReport:
    """Outcome of matching a whole tree: the leaves no rule matched and
    the leaves more than one rule matched (``(path, patterns)``)."""

    checked: int
    unmatched: tuple = ()
    ambiguous: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.unmatched and not self.ambiguous

    def summary(self) -> str:
        if self.ok:
            return f"{self.checked} leaves, all matched exactly once"
        parts = [f"{self.checked} leaves"]
        if self.unmatched:
            parts.append("unmatched: " + ", ".join(self.unmatched[:4])
                         + ("..." if len(self.unmatched) > 4 else ""))
        if self.ambiguous:
            parts.append("ambiguous: " + ", ".join(p for p, _ in self.ambiguous[:4])
                         + ("..." if len(self.ambiguous) > 4 else ""))
        return "; ".join(parts)


@dataclass(frozen=True)
class RuleTable:
    """Ordered rules and a name for error messages."""

    name: str
    rules: tuple = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def matching_rules(self, path: str) -> list[Rule]:
        return [rule for rule in self.rules if rule.matches(path)]

    def match(self, path: str) -> PartitionSpec:
        """First-match-wins spec lookup; unmatched is an error."""
        for rule in self.rules:
            if rule.matches(path):
                return rule.spec
        raise ShardingRuleError(
            f"rule table {self.name!r}: no rule matches leaf {path!r} "
            f"(patterns: {[r.pattern for r in self.rules]})"
        )

    def coverage(self, tree: Any) -> CoverageReport:
        """Closed-world audit of ``tree``: every leaf must match exactly one rule."""
        unmatched, ambiguous, checked = [], [], 0
        for path, _ in leaf_paths(tree):
            checked += 1
            hits = self.matching_rules(path)
            if not hits:
                unmatched.append(path)
            elif len(hits) > 1:
                ambiguous.append((path, tuple(r.pattern for r in hits)))
        return CoverageReport(checked=checked, unmatched=tuple(unmatched),
                              ambiguous=tuple(ambiguous))


def _axis_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    """The dimension ``spec`` shards over mesh axis ``axis`` (tuple entries
    count), or None when the axis is absent."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None


def split_dims(table: RuleTable, tree: Any, axis: str) -> Any:
    """The int/None split-dim convention ``parallel/tp.TpLayout`` reads:
    for each leaf, the dimension its rule shards over ``axis`` (None:
    replicated along ``axis``)."""
    return map_tree(tree, lambda path, _leaf: _axis_dim(table.match(path), axis))
