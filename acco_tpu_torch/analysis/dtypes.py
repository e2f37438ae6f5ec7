"""Dtype policy: working params in the param dtype, float32 master and
Adam state, typed counters, over every state leaf, with no unmatched
leaf allowed.

Counterpart of ``acco_tpu/analysis/dtypes.py``, rule for rule, over the
port's ``AccoState``, ``DDPState`` (``parallel/acco.py``,
``parallel/ddp.py``) and the serve state (``serve/engine.py``
``abstract_state``). Gradients reduce in float32, AdamW runs on the
float32 master shard, and only the working copy is in the param dtype. A
leaf in the wrong dtype raises nothing: it trains worse (bf16 Adam
moments) or doubles memory (float32 working params). The closed world
(every leaf must match a rule) makes a new state leaf fail the gate
until its dtype is written down here.

Rules are ``(path-regex, allowed dtypes, why)`` matched against
dot-paths built from the NamedTuple field names (``.zero1.opt.mu``),
dict keys bracketed (``['k_pages']``); dtypes by name (``bfloat16``,
``float32``: a torch dtype without its ``torch.`` prefix, a numpy
dtype's name).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class DtypeRule:
    pattern: str
    allowed: tuple
    why: str

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclass
class DtypeViolation:
    path: str
    dtype: str
    rule: "str | None"  # None: no rule covers this leaf
    message: str


@dataclass
class DtypeReport:
    ok: bool
    checked: int
    violations: list = field(default_factory=list)

    def summary(self) -> str:
        if self.ok:
            return f"{self.checked} leaves match policy"
        return f"{len(self.violations)}/{self.checked} leaves violate policy: " + "; ".join(
            v.message for v in self.violations[:5])


def dtype_name(dtype) -> str:
    """'bfloat16' for ``torch.bfloat16``, ``np.dtype('float32')`` or the
    string itself."""
    return str(dtype).removeprefix("torch.")


def named_paths(tree, prefix: str = "") -> list:
    """(dot-path, leaf) pairs with NamedTuple FIELD NAMES in the path
    (``.zero1.opt.mu``), dict keys bracketed, sequences indexed."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out.extend(named_paths(getattr(tree, name), f"{prefix}.{name}"))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out.extend(named_paths(tree[k], f"{prefix}['{k}']"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(named_paths(v, f"{prefix}[{i}]"))
        return out
    if tree is None:
        return []
    return [(prefix or ".", tree)]


def check_dtype_policy(tree, rules: list) -> DtypeReport:
    """First matching rule wins; a leaf no rule covers is itself a
    violation (closed world)."""
    violations = []
    leaves = named_paths(tree)
    for path, leaf in leaves:
        dtype = dtype_name(getattr(leaf, "dtype", type(leaf).__name__))
        rule = next((r for r in rules if r.matches(path)), None)
        if rule is None:
            violations.append(DtypeViolation(
                path, dtype, None,
                f"{path}: {dtype} — no dtype-policy rule covers this leaf; declare one in "
                "acco_tpu_torch/analysis/dtypes.py"))
        elif dtype not in rule.allowed:
            violations.append(DtypeViolation(
                path, dtype, rule.pattern,
                f"{path}: {dtype}, policy requires {'/'.join(rule.allowed)} ({rule.why})"))
    return DtypeReport(ok=not violations, checked=len(leaves), violations=violations)


def train_state_rules(param_dtype) -> list:
    """The train-state policy of ``AccoState`` and ``DDPState`` (and the
    eval program's ``{"flat_params"}``): the working copy in
    ``param_dtype``, float32 master, moments and gradient accumulators,
    int32 counters."""
    pd = dtype_name(param_dtype)
    return [
        DtypeRule(r"\.flat_params$|\['flat_params'\]$", (pd,),
                  "working params are what the model consumes"),
        DtypeRule(r"\.pending_grads$", ("float32",), "gradients accumulate and reduce in fp32"),
        DtypeRule(r"\.pending_count$", ("float32",), "valid-microbatch counts average in fp32"),
        DtypeRule(r"\.zero1\.opt\.(params|mu|nu)$", ("float32",),
                  "fp32 master weights and Adam moments (ZeRO-1 shard)"),
        DtypeRule(r"\.zero1\.opt\.count$", ("int32",), "Adam step counter"),
        DtypeRule(r"\.zero1\.sched_grads$", ("int32",), "schedule step counter"),
        DtypeRule(r"\.zero1\.grads_committed$", ("float32",), "committed-grad running count"),
        DtypeRule(r"\.round_idx$", ("int32",), "round parity counter"),
        DtypeRule(r"\.health\.(skipped_rounds|consec_skipped)$", ("int32",),
                  "watchdog counters"),
        DtypeRule(r"\.health\.pending_ok$", ("float32",),
                  "staged-grad health verdict multiplies gradients"),
    ]


def serve_state_rules(param_dtype, cache_dtype) -> list:
    """Serve policy: params in the model's dtype, the KV pools in the
    ``CacheSpec`` dtype (chosen on its own: a narrower cache must not
    widen back to the param dtype)."""
    pd, cd = dtype_name(param_dtype), dtype_name(cache_dtype)
    return [
        DtypeRule(r"\['(k_pages|v_pages)'\]", (cd,), "paged KV pool carries CacheSpec.dtype"),
        DtypeRule(r"\['params'\]", (pd,), "serving params are the model's param dtype"),
    ]
