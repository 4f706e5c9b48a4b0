"""No module of the benchmark imports JAX or the JAX package, by whole
top-level name (the program's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

from annbench import registry
from annbench.run import forbidden_modules

SOURCES = sorted(registry.ROOT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "ggnn_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports (any nesting)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(registry.ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = imported(registry.ROOT / "reference.py")
    assert names <= {"__future__", "contextlib", "numpy", "torch"}, names


def test_the_check_compares_whole_top_level_names():
    mods = ["ggnn_torch", "ggnn_torch.ops", "jaxtyping", "jax.numpy", "ggnn_tpu",
            "flaxen", "jaxlib.xla_client", "torch"]
    assert forbidden_modules(mods) == ["ggnn_tpu", "jax.numpy", "jaxlib.xla_client"]
