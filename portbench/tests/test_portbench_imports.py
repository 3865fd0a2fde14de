"""Nothing the benchmark runs imports JAX, the JAX package or the old
benchmark folder, and the reference imports nothing of the program.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
import glob
import os

import pytest

from conftest import ROOT
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                           recursive=True))


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, ROOT) for p in MODULES])
def test_no_jax_no_reference_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        assert "repro_torch" not in _top_level_imports(path)
        assert _top_level_imports(path) <= {"__future__", "contextlib",
                                            "math", "typing", "torch"}


def test_the_command_runs_only_the_benchmark():
    command = harness.load_spec()["command"]
    assert command[0] == "python3"
    for word in command[1:]:
        assert word.startswith("portbench/")
    assert not _top_level_imports(os.path.join(ROOT, command[1])) & FORBIDDEN


def test_loaded_module_check_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()
