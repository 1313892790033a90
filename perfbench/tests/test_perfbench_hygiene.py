"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port either, compared by top-level
module name, whole (``repro_torch`` begins with ``repro``)."""

import ast
from pathlib import Path

import pytest

from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(BENCH.rglob("*.py"))
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def imported(path: Path) -> set:
    """Every module ``path`` imports, by its full dotted name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.add(node.module)
    return names


def tops(path: Path) -> set:
    return {name.split(".")[0] for name in imported(path)}


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in tops(path)
    for name in imported(path):
        assert name in ("torch", "numpy", "math") \
            or name.startswith("perfbench.reference"), name


def test_names_are_compared_whole():
    assert tops(BENCH / "entries" / "mantel.py") == {"repro_torch"}
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]
