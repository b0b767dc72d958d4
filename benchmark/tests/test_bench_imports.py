"""No module of the benchmark imports JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "zen_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert _imports(path) <= {"__future__", "math", "dataclasses", "numpy", "torch"}


def test_top_level_names_compared_whole():
    # the port's name begins with the JAX package's and is no match for it
    assert "zen_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "zen_tpu.ops".split(".")[0] in FORBIDDEN
