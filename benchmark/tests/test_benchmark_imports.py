"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared
by whole top-level names (the port's name begins with the JAX
package's), and the references and step counts import nothing of the
program."""

import ast
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(run.BENCH)
FILES = sorted(p for p in BENCH.rglob("*.py") if "_cache" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax",
                                           "het_tpu"}


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.parent.name in ("reference", "costs")],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_references_and_counts_import_nothing_of_the_program(path):
    assert "het_tpu_torch" not in _top_level_imports(path)


def test_the_walk_sees_the_port():
    assert "het_tpu_torch" in _top_level_imports(BENCH / "run.py") | {
        n for p in FILES for n in _top_level_imports(p)}


def test_forbidden_modules_are_compared_whole():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "het_tpu")
    assert "het_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_a_loaded_jax_is_found(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.loaded_forbidden() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert run.loaded_forbidden() == []
