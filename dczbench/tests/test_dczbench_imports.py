"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Modules are compared by their
whole top-level name: ``datacomp_tpu_torch`` begins with ``datacomp_tpu``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "datacomp_tpu"}


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = _top_level_imports(path)
    assert "datacomp_tpu_torch" not in found
    assert "dczbench" not in found and "torch" not in found


def test_the_scan_compares_whole_names():
    assert "datacomp_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "datacomp_tpu.ops".split(".")[0] in FORBIDDEN
