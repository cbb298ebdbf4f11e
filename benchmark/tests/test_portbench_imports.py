"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name is
compared whole (``ufvideo_tpu_torch`` begins with ``ufvideo_tpu``)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ufvideo_tpu"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "ufvideo_tpu_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path)  # its own folder only, relatively


def test_the_check_compares_whole_names():
    assert "ufvideo_tpu_torch" not in FORBIDDEN
    assert top_level_imports(BENCH / "port.py") & {"ufvideo_tpu_torch"}
