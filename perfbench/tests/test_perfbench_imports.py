"""The harness measures the port alone: nothing under perfbench/ imports
the JAX package or JAX, the plain reference imports nothing of the port,
and nothing reads the older benchmarks or the smoke script."""
import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PORT = "repro_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if p != Path(__file__).resolve())


def imported(path: Path):
    """Top-level names of every module the file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("repro")


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py"))
                         + sorted((HERE / "models").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)
    for mod in imported(path) - {"perfbench"}:
        assert mod in {"__future__", "dataclasses", "math", "typing", "torch",
                       "hashlib"}, mod


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_reads_no_older_benchmark(path):
    text = path.read_text()
    for name in ("chip_smoke", "BENCH_", "benchmarks/", "benchmarks."):
        assert name not in text, name


def test_a_loaded_jax_is_found_by_its_whole_name(monkeypatch):
    """What ``run.py`` checks once the window has closed, before it prints
    a result: the port's own name is not a forbidden one."""
    from types import ModuleType

    from perfbench import harness
    for name in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.core", ModuleType("jax.core"))
    assert harness.forbidden_modules() == ["jax"]
