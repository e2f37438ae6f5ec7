"""Host-side AST lint: the hazards the program gates cannot see.

Counterpart of ``acco_tpu/analysis/host_lint.py``, with the port's sync
calls:

- **host-sync-in-loop**: a device-to-host sync inside a ``for``/``while``
  body: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` (no
  arguments), ``torch.cuda.synchronize()``, ``Event.synchronize()``,
  ``Stream.synchronize()`` (any ``.synchronize(...)``). Each one stalls
  the host until the device drains, and inside the round loop it
  serializes rounds the async design exists to overlap. Deliberate
  logging-boundary syncs are annotated ``# lint: host-sync-ok`` on the
  line, with the reason beside it.
- **thread-without-join**: ``threading.Thread(...)`` in a module with no
  ``.join(`` call: a worker with no shutdown path outlives the
  preemption handler (``resilience/``). ``# lint: thread-ok`` for a
  daemon that is unjoinable by design.
- **unused-import**: module-level imports never referenced. ``__future__``
  imports and ``__init__.py`` re-export modules are exempt.

JAX's "jit without donation" rule has no torch form: the port's rounds
write their state into fixed buffers (``compile/graphs.py``), and
:mod:`acco_tpu_torch.analysis.donation` checks on the programs
themselves that every state leaf stays in them.

Pure stdlib (ast); runs in milliseconds over the package.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass

SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}  # no arguments
SYNC_ANY_ARITY = {"synchronize"}  # torch.cuda.synchronize(device), Event/Stream
SUPPRESS_SYNC = "lint: host-sync-ok"
SUPPRESS_THREAD = "lint: thread-ok"
RULES = ("host-sync-in-loop", "thread-without-join", "unused-import")


@dataclass
class Finding:
    file: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


def _suppressed(source_lines: list, lineno: int, marker: str) -> bool:
    if 1 <= lineno <= len(source_lines):
        return marker in source_lines[lineno - 1]
    return False


class _HostSyncVisitor(ast.NodeVisitor):
    def __init__(self, path: str, lines: list, findings: list):
        self.path = path
        self.lines = lines
        self.findings = findings
        self.loop_depth = 0

    def visit_For(self, node):
        self._loop(node)

    def visit_While(self, node):
        self._loop(node)

    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_FunctionDef(self, node):
        # a function defined inside a loop runs when called, not per pass
        depth, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = depth

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node: ast.Call):
        f = node.func
        if self.loop_depth > 0 and isinstance(f, ast.Attribute):
            hit = None
            if f.attr in SYNC_ANY_ARITY:
                hit = f".{f.attr}()"
            elif f.attr in SYNC_ATTRS and not node.args and not node.keywords:
                hit = f".{f.attr}()"  # dict.items() differs by name, np .item(i) by arity
            lines = range(node.lineno, (node.end_lineno or node.lineno) + 1)
            if hit and not any(_suppressed(self.lines, n, SUPPRESS_SYNC) for n in lines):
                self.findings.append(Finding(
                    self.path, node.lineno, "host-sync-in-loop",
                    f"{hit} inside a loop body is a device->host sync; hoist it past the "
                    f"loop or annotate the line '# {SUPPRESS_SYNC}' with the reason if it is "
                    "a deliberate boundary"))
        self.generic_visit(node)


def _check_threads(path: str, tree: ast.AST, lines: list, source: str, findings: list) -> None:
    has_join = ".join(" in source
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_thread = ((isinstance(f, ast.Name) and f.id == "Thread")
                     or (isinstance(f, ast.Attribute) and f.attr == "Thread"))
        if is_thread and not has_join and not _suppressed(lines, node.lineno, SUPPRESS_THREAD):
            findings.append(Finding(
                path, node.lineno, "thread-without-join",
                "Thread constructed in a module with no .join() call — no shutdown path; "
                "add a join (preemption handlers assume joinable workers) or annotate "
                f"'# {SUPPRESS_THREAD}'"))


def _check_unused_imports(path: str, tree: ast.AST, findings: list) -> None:
    if os.path.basename(path) == "__init__.py":
        return  # re-export idiom
    bound = []  # (name, lineno)
    for node in tree.body:  # module level only
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound.append((alias.asname or alias.name.split(".")[0], node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name != "*":
                    bound.append((alias.asname or alias.name, node.lineno))
    if not bound:
        return
    used = {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}
    for node in tree.body:  # __all__ entries count as usage
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            used.update(elt.value for elt in node.value.elts
                        if isinstance(elt, ast.Constant) and isinstance(elt.value, str))
    for name, lineno in bound:
        if name not in used:
            findings.append(Finding(path, lineno, "unused-import",
                                    f"'{name}' imported but never used"))


def lint_file(path: str, source: "str | None" = None, rules: "set | None" = None) -> list:
    """Run the host lints on one file. ``rules`` filters to a subset of
    :data:`RULES`; None = all."""
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, "syntax-error", str(exc))]
    lines = source.splitlines()
    findings: list = []

    def want(r: str) -> bool:
        return rules is None or r in rules

    if want("host-sync-in-loop"):
        _HostSyncVisitor(path, lines, findings).visit(tree)
    if want("thread-without-join"):
        _check_threads(path, tree, lines, source, findings)
    if want("unused-import"):
        _check_unused_imports(path, tree, findings)
    findings.sort(key=lambda f: (f.file, f.line))
    return findings


DEFAULT_EXCLUDE_DIRS = ("__pycache__", ".git", "outputs")


def python_files(roots: list, exclude_dirs: tuple = DEFAULT_EXCLUDE_DIRS) -> list:
    """Every ``.py`` under the given files and directories, pruning
    directory names in ``exclude_dirs``."""
    out = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in exclude_dirs)
            out.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                       if fn.endswith(".py"))
    return out


def lint_paths(roots: list, rules: "set | None" = None,
               exclude_dirs: tuple = DEFAULT_EXCLUDE_DIRS) -> list:
    """Lint every ``.py`` under the given files and directories."""
    return [f for path in python_files(roots, exclude_dirs) for f in lint_file(path, rules=rules)]
