"""The port's import boundary: no file of acco_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the acco_tpu package (whose
``__init__`` imports jax). An AST scan, so imports inside functions
count too."""

import ast
import glob
import os

import pytest
import torch_ranks

torch_settings = torch_ranks.torch_settings  # autouse: one torch thread, settings restored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "acco_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "acco_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("relpath", FILES)
def test_no_jax_or_acco_tpu_import(relpath):
    with open(os.path.join(REPO, relpath)) as f:
        tree = ast.parse(f.read(), relpath)
    bad = [
        m for m in _imported_modules(tree)
        if m.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{relpath} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 15
    for path in ("acco_tpu_torch/ops/fused_attention.py", "acco_tpu_torch/ops/block_attention.py",
                 "acco_tpu_torch/ops/ring_attention.py", "acco_tpu_torch/parallel/mesh.py"):
        assert path in FILES


@pytest.mark.parametrize("subpackage, modules", [
    ("telemetry", ("__init__", "metrics", "trace", "attribution", "profile")),
    ("resilience", ("__init__", "preemption", "watchdog", "manager", "faults")),
    ("compile", ("__init__", "cache", "warmup", "graphs")),
    ("sharding", ("__init__", "rules", "tables", "layout")),
])
def test_scan_sees_the_robustness_subpackages(subpackage, modules):
    """The scan covers the telemetry and resilience subpackages, the
    copies of JAX's framework-free modules among them: every module of
    each is scanned, none is missed by the glob."""
    found = {os.path.splitext(os.path.basename(p))[0] for p in FILES
             if p.startswith(f"acco_tpu_torch/{subpackage}/")}
    assert found == set(modules)


def test_scan_sees_tensor_parallelism():
    """The scan covers tensor parallelism's modules: the sharding rule
    engine's copy (JAX's imports ``jax.sharding``) and ``parallel/tp.py``."""
    for path in ("acco_tpu_torch/parallel/tp.py", "acco_tpu_torch/sharding/rules.py",
                 "acco_tpu_torch/sharding/tables.py"):
        assert path in FILES


def test_scan_sees_pipeline_parallelism():
    """The scan covers pipeline parallelism's modules: the GPipe loop
    (``parallel/pp.py``) and the pipeline's pairing checks (the copy of
    JAX's ``sharding/layout.py`` validation)."""
    for path in ("acco_tpu_torch/parallel/pp.py", "acco_tpu_torch/sharding/layout.py"):
        assert path in FILES
