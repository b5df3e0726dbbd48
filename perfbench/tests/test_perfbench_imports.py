"""Nothing under perfbench imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared whole."""

import ast
import os
import sys

from perfbench.harness import bench
from perfbench.harness.names import BENCH_DIR

JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "d3net_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        bad = set(_imports(path)) & JAX
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        bad = set(_imports(path)) & (JAX | {"d3net_tpu_torch"})
        assert not bad, (path, bad)


def test_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "d3net_tpu_torch_like", sys)
    base = set(bench.forbidden_modules())
    assert "d3net_tpu" not in base
    monkeypatch.setitem(sys.modules, "d3net_tpu.models", sys)
    assert "d3net_tpu" in bench.forbidden_modules()
