"""Nothing under the benchmark imports JAX, the JAX package or the JAX
package's benchmarks; the reference imports nothing of the program."""

from __future__ import annotations

import ast

import pytest

from portbench.bench.cells import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro_torch" not in path.read_text()


def test_whole_names_are_compared():
    from portbench import run
    assert "repro_torch" not in run.BANNED
    names = top_level_imports(ROOT / "bench" / "system.py")
    assert "repro_torch" in names and not names & BANNED
