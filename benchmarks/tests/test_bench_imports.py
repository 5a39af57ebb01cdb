"""What the benchmark may import: no module under ``benchmarks/`` imports
JAX, flax or the JAX package (top-level names compared whole; the port's
name starts with the JAX package's), and the reference imports nothing of
the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cervical_tpu"}


def _modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def _files():
    for d, _, fs in os.walk(BENCH):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), BENCH)


@pytest.mark.parametrize("rel", sorted(_files()))
def test_no_jax(rel):
    top = {m.split(".")[0] for m in _modules(os.path.join(BENCH, rel))}
    assert not top & FORBIDDEN, (rel, top & FORBIDDEN)


@pytest.mark.parametrize("rel", sorted(f for f in _files()
                                       if f.startswith("reference")))
def test_reference_is_independent_of_the_port(rel):
    top = {m.split(".")[0] for m in _modules(os.path.join(BENCH, rel))}
    assert "cervical_tpu_torch" not in top


def test_the_check_compares_whole_names():
    import benchmarks.run as run
    import sys
    sys.modules.setdefault("cervical_tpu_torch_like", None)
    try:
        assert "cervical_tpu_torch_like" not in run.forbidden_modules()
    finally:
        del sys.modules["cervical_tpu_torch_like"]
