"""Metrics gate: every telemetry call site names a declared metric or span.

Counterpart of ``acco_tpu/analysis/metrics_gate.py``. The port's
registry and tracer are closed-world at run time
(``UndeclaredMetricError``, ``UndeclaredSpanError``), but a run-time
check fires only on paths a test runs; this AST walk over the sources
resolves every literal-named call against the declarations of
``acco_tpu_torch/telemetry``:

- ``*.emit("name", …)`` / ``emit("name", …)`` and every literal key of
  ``*.emit_many({"name": …})`` against
  :data:`acco_tpu_torch.telemetry.metrics.DECLARED`;
- ``*.span("name", …)`` / ``*.complete_event("name", …)`` /
  ``*.instant("name", …)`` against
  :data:`acco_tpu_torch.telemetry.trace.SPAN_NAMES`, unless the call's
  ``cat`` is one of :data:`~acco_tpu_torch.telemetry.trace.FREE_CATEGORIES`.

Dynamic names (a variable first argument) are left to the run-time
check.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from acco_tpu_torch.analysis.host_lint import DEFAULT_EXCLUDE_DIRS, Finding, python_files
from acco_tpu_torch.telemetry.metrics import REGISTRY
from acco_tpu_torch.telemetry.trace import FREE_CATEGORIES, SPAN_NAMES

METRIC_METHODS = {"emit"}
METRIC_MANY_METHODS = {"emit_many"}
SPAN_METHODS = {"span", "complete_event", "instant"}


@dataclass
class MetricsGateReport:
    findings: list = field(default_factory=list)
    checked: int = 0  # literal-named call sites resolved

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        if self.ok:
            return f"{self.checked} literal telemetry call sites, all names declared"
        return (f"{len(self.findings)} undeclared name(s) across {self.checked} literal "
                "call sites")


def _method_name(node: ast.Call) -> "str | None":
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _literal_str(node) -> "str | None":
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _span_cat(node: ast.Call) -> "str | None":
    """The call's ``cat`` when a literal: the keyword, or span()'s and
    instant()'s second positional argument."""
    for kw in node.keywords:
        if kw.arg == "cat":
            return _literal_str(kw.value)
    if _method_name(node) in ("span", "instant") and len(node.args) >= 2:
        return _literal_str(node.args[1])
    return None


class _TelemetryCallVisitor(ast.NodeVisitor):
    def __init__(self, path: str, declared: frozenset, report: MetricsGateReport) -> None:
        self.path = path
        self.declared = declared
        self.report = report

    def _check_metric(self, node: ast.Call, name: str) -> None:
        self.report.checked += 1
        if name not in self.declared:
            self.report.findings.append(Finding(
                self.path, node.lineno, "undeclared-metric",
                f"emit of {name!r}, which is not declared in "
                "acco_tpu_torch/telemetry/metrics.py DECLARED (closed world: add a "
                "MetricSpec or fix the spelling)"))

    def _check_span(self, node: ast.Call, name: str) -> None:
        self.report.checked += 1
        if name not in SPAN_NAMES:
            self.report.findings.append(Finding(
                self.path, node.lineno, "undeclared-span",
                f"span/event name {name!r} is not in telemetry.trace.SPAN_NAMES (closed "
                "world: declare it there or fix the spelling)"))

    def visit_Call(self, node: ast.Call) -> None:
        meth = _method_name(node)
        if meth in METRIC_METHODS and node.args:
            name = _literal_str(node.args[0])
            if name is not None:
                self._check_metric(node, name)
        elif meth in METRIC_MANY_METHODS and node.args and isinstance(node.args[0], ast.Dict):
            for key in node.args[0].keys:
                name = _literal_str(key)
                if name is not None:
                    self._check_metric(node, name)
        elif meth in SPAN_METHODS and node.args:
            name = _literal_str(node.args[0])
            if name is not None and _span_cat(node) not in FREE_CATEGORIES:
                self._check_span(node, name)
        self.generic_visit(node)


def check_file(path: str, source: "str | None" = None,
               report: "MetricsGateReport | None" = None) -> MetricsGateReport:
    report = report if report is not None else MetricsGateReport()
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        report.findings.append(Finding(path, exc.lineno or 0, "syntax-error", str(exc)))
        return report
    _TelemetryCallVisitor(path, frozenset(REGISTRY.declared_names()), report).visit(tree)
    return report


def check_paths(paths: list, exclude_dirs: tuple = DEFAULT_EXCLUDE_DIRS) -> MetricsGateReport:
    """Resolve every literal-named telemetry call site under ``paths``."""
    report = MetricsGateReport()
    for path in python_files(paths, exclude_dirs):
        check_file(path, report=report)
    return report
