"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names; the plain references import nothing of the program."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import run

PKG = Path(__file__).resolve().parents[1]


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_tops(PKG / path) & set(run.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted(p.name for p in (PKG / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert imported_tops(PKG / "reference" / path) <= {"__future__", "math", "numpy", "torch",
                                                       "portbench"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("csof_tpu_torch", "csof_tpu_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "csof_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_loaded() == ["csof_tpu", "jaxlib"]


def test_a_tiny_run_loads_neither():
    from portbench.tests import tiny

    tiny.measure("unet2d-train-b40", seconds=0.2)
    assert run.forbidden_loaded() == []
