"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: ``pqvector_tpu_torch`` is not ``pqvector_tpu``."""

import ast
from pathlib import Path

import pytest

from pqbench.harness import FORBIDDEN, forbidden_loaded

PKG = Path(__file__).resolve().parent.parent
MODULES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_pqbench_module_imports_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_pqbench_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (set(FORBIDDEN) | {"pqvector_tpu_torch"})


def test_pqbench_names_are_compared_whole():
    assert forbidden_loaded(["pqvector_tpu_torch", "pqvector_tpu_torch.kernels", "jaxtyping"]) == []
    assert forbidden_loaded(["jax.numpy", "pqvector_tpu.index", "numpy"]) == ["jax", "pqvector_tpu"]
