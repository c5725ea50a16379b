"""No file of the benchmark imports jax or the JAX package, and the plain
reference imports nothing of the port: each import's top-level name (the
part before the first dot) compared whole."""

import ast
import glob
import os
import sys

import pytest

from portbench import harness

FILES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                         recursive=True))
REFERENCE = [os.path.join(harness.HERE, "reference.py")]


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax(path):
    found = set(top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                            "platanus_b_tpu", "bench",
                                            "parity"}
    assert not found, found


@pytest.mark.parametrize("path", REFERENCE, ids=os.path.basename)
def test_reference_is_plain(path):
    assert set(top_level_imports(path)) <= {"__future__", "math", "numpy",
                                            "torch"}


def test_loaded_names_compared_whole(monkeypatch):
    # the port's name begins with the JAX package's, and is not it
    import types
    before = set(harness.forbidden_modules())
    for name in ("platanus_b_tpu_torch_x", "jaxlike", "jax_foo"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert set(harness.forbidden_modules()) == before | {"flax"}
