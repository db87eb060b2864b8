"""What the benchmark may import and read: compared by whole top-level
module names (the part before the first dot), so ``grace_tpu_torch`` is
not ``grace_tpu``."""

import ast
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "grace_tpu"}
# The JAX package's benchmark and its records.
JAX_FILES = re.compile(r"\bbench(_all)?\.py\b|BENCH_\w*\.json|BENCH_\*")
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_every_module_is_walked():
    assert len(SOURCES) > 20
    assert BENCH / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert "grace_tpu_torch" not in top_level_imports(path)
    assert "grace_tpu_torch" not in path.read_text()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_benchmark_file_is_read(path):
    if path.name != "test_portbench_imports.py":
        assert not JAX_FILES.search(path.read_text())


def test_the_check_itself_sees_a_banned_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom grace_tpu.ops import x\n"
                 "import grace_tpu_torch\n")
    assert top_level_imports(p) == {"jax", "grace_tpu", "grace_tpu_torch"}


def test_run_refuses_a_process_with_jax_loaded(monkeypatch):
    import sys
    import types

    from portbench.harness import worker
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "grace_tpu_torchvision",
                        types.ModuleType("y"))
    assert worker.banned_modules() == ["flax.linen"]
