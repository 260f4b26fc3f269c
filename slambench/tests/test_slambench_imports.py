"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference imports nothing of the program, and nothing reads the JAX
package's old benchmark files."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gaus_slam_tpu"}
OLD_FILES = ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE")


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    tops.add(a.value.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)
    if "reference" in path.parts:
        assert "gaus_slam_tpu_torch" not in _imports(path)
    text = path.read_text()
    assert not any(f in text for f in OLD_FILES)


def test_whole_names_are_compared():
    from slambench.harness import forbidden_modules

    assert "gaus_slam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax" not in forbidden_modules()
