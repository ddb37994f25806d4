"""Import isolation: nothing the benchmark runs may load JAX or the JAX
package, and the references load nothing of the program.

Names are compared whole by their top level (the part before the first
dot), so ``harp_tpu_torch`` is not ``harp_tpu``."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "harp_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else
                      node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["harp_tpu_torch", "harp_tpu_torchx",
                                  "numpy", "torch"])
def test_whole_name_comparison_passes_other_packages(name):
    src = f"import {name}.sub\nfrom {name} import x\n"
    tree = ast.parse(src)
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            got.add(node.module.split(".")[0])
    assert got == {name} and not got & FORBIDDEN


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom harp_tpu.models import kmeans\n")
    assert _top_level_imports(bad) & FORBIDDEN == {"harp_tpu"}


REFERENCES = sorted((PKG / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCES,
                         ids=[p.name for p in REFERENCES])
def test_references_import_nothing_of_the_program(path):
    assert "harp_tpu_torch" not in _top_level_imports(path)


_DRY = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.small import SMALL
for cell, ov in SMALL.items():
    harness.run_cell(cell, 7, 0.05, True, device="cpu", overrides=ov,
                     root=harness.ROOT)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_dry_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", _DRY.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "harp_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
