"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names are compared
whole, so rptree_tpu_torch is not rptree_tpu."""

import ast
import sys

import pytest

from benchmark import run, spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in
               p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.ROOT)))
def test_no_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "rptree_tpu"}


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    names = set(_imports(path))
    assert not names & {"rptree_tpu_torch", "benchmark"}
    assert names <= {"torch", "dataclasses", "typing", "__future__"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rptree_tpu_torch_fake", sys)
    assert "rptree_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
