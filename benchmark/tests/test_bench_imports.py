"""What the benchmark's files import: no JAX and not the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and in the reference nothing of the port either; nothing reads
the JAX-era scripts."""

from __future__ import annotations

import ast

import pytest

from benchmark import core

FILES = sorted(core.BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "vaesne_tpu"}
SCRIPTS = {"bench", "scripts", "chip_smoke", "chip_ab"}  # the JAX-era and smoke scripts


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(core.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & (JAX | SCRIPTS)


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((core.BENCH / "reference").rglob("*.py")):
        assert "vaesne_tpu_torch" not in top_level_imports(path), path
        assert "benchmark" not in top_level_imports(path), path


def test_top_level_names_are_compared_whole():
    import sys

    from benchmark.run import forbidden_modules

    before = dict(sys.modules)
    try:
        sys.modules["vaesne_tpu_torch_x"] = sys
        assert "vaesne_tpu" not in forbidden_modules()
        sys.modules["vaesne_tpu.ops"] = sys
        assert forbidden_modules() == ["vaesne_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
