"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program: every import's top-level name
(the part before the first dot) compared whole, since the program's name
``qbot_tpu_torch`` begins with the JAX package's ``qbot_tpu``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests._small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "qbot_tpu"}
SOURCES = sorted(run.PKG.rglob("*.py"))


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_scan_compares_whole_names():
    assert "qbot_tpu" not in {"qbot_tpu_torch"}
    assert top_level_imports(run.PKG / "entries" / "statevector.py") \
        >= {"qbot_tpu_torch", "torch", "portbench"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((run.PKG / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                       "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_a_run_loads_no_jax():
    """A whole small run, in a process where importing jax or qbot_tpu
    raises, ends with neither in ``sys.modules``."""
    code = """
import sys, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'qbot_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
from portbench.tests._small import small_spec, measure
from portbench import run
for w in ('sv26-grover', 'ens24-smc64'):
    assert measure(small_spec(w))['correct']
assert not run.forbidden_modules(), run.forbidden_modules()
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_the_harness_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
