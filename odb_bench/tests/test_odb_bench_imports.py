"""No file of the benchmark imports JAX, the JAX package or the old
benchmarks (top-level names compared whole: ``repro_torch`` starts with
``repro``), and the reference and the yardstick import nothing of the
program."""

import ast
import pathlib

import pytest

from odb_bench.tests.conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
PURE = ("reference", "generators", "flops", "bounds.py")
FILES = sorted((ROOT / "odb_bench").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_repro_or_old_benchmarks(path):
    assert not top_level_imports(path) & BANNED
    if path.name != pathlib.Path(__file__).name:  # this file names the folder to look for it
        strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        assert not [s for s in strings if "benchmarks/" in s or s.endswith("/benchmarks")]


@pytest.mark.parametrize("path", [p for p in FILES if p.relative_to(ROOT / "odb_bench").parts[0] in PURE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_the_walk_catches_a_banned_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\nimport repro_torch\n")
    assert top_level_imports(bad) == {"repro", "jax", "repro_torch"}
