"""Sharding-rule coverage: every state leaf matches exactly one rule.

Counterpart of ``acco_tpu/analysis/rules.py``. The dtype walk
(:mod:`acco_tpu_torch.analysis.dtypes`) proves that every state leaf has
an intended dtype; this one proves that it has an intended placement: it
matches exactly one rule of its program's rule table
(``sharding/tables.py``). Both walk the same trees by name, so a leaf
added without a rule fails here, and one without a dtype rule there.

- **unmatched leaf**: a new state field nobody placed; the memory sieve
  (:mod:`acco_tpu_torch.analysis.memory`) could not price it and a rank
  would hold all of it.
- **ambiguous leaf**: two rules match; first-match-wins picks one, and
  a reordered table would flip the placement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from acco_tpu_torch.sharding.rules import RuleTable


@dataclass(frozen=True)
class RuleViolation:
    path: str
    kind: str  # "unmatched" | "ambiguous"
    message: str


@dataclass
class RuleCoverageReport:
    """Result of auditing one state tree against one rule table."""

    table: str
    checked: int = 0
    violations: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        if self.ok:
            return f"{self.checked} leaves matched exactly one rule ({self.table})"
        head = "; ".join(v.message for v in self.violations[:3])
        more = len(self.violations) - 3
        return (f"{len(self.violations)} violation(s) against {self.table}: {head}"
                + (f" (+{more} more)" if more > 0 else ""))


def check_rule_coverage(state_tree: Any, table: Optional[RuleTable]) -> RuleCoverageReport:
    """Audit ``state_tree`` against ``table``: every leaf must match
    exactly one rule. A missing table is itself a violation: a program
    without one has unreviewed placement."""
    if table is None:
        return RuleCoverageReport(table="<none>", violations=(RuleViolation(
            path="<root>", kind="unmatched",
            message="program has no sharding rule table attached"),))
    cov = table.coverage(state_tree)  # the engine's own closed-world walk
    violations = [RuleViolation(path, "unmatched", f"{path}: matched by no rule in {table.name!r}")
                  for path in cov.unmatched]
    violations += [RuleViolation(path, "ambiguous", f"{path}: matched by {len(patterns)} rules in "
                                 f"{table.name!r} ({list(patterns)})")
                   for path, patterns in cov.ambiguous]
    return RuleCoverageReport(table=table.name, checked=cov.checked, violations=tuple(violations))
