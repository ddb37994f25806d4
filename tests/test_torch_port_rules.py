"""The rules the port lives by: it never imports JAX or harp_tpu, its
entry points run on the card unless asked for the CPU, and nothing is
built or launched when a module is imported."""

import ast
import pathlib
import shutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.ops import build
from harp_tpu_torch.parallel import mesh as M

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "harp_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "torch_world.py"]
FORBIDDEN = {"jax", "jaxlib", "harp_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_harp_tpu(path):
    assert not FORBIDDEN & set(_imported_roots(path))


def _port_modules():
    mods = []
    for p in sorted((REPO / "harp_tpu_torch").rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_the_whole_port_loads_no_jax():
    mods = _port_modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'harp_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 10 and "harp_tpu_torch.ops.kmeans_kernel" in mods
    assert not build.BUILD_LOG  # importing built nothing


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")


def test_worker_mesh_without_a_device_raises_without_cuda():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.WorkerMesh()
    assert M.WorkerMesh("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["fit", "benchmark", "cli"])
def test_entry_points_without_a_device_raise_without_cuda(entry):
    _no_card()
    pts = np.zeros((16, 4), np.float32)
    with M.use_mesh(None), pytest.raises(RuntimeError, match="CUDA"):
        if entry == "fit":
            KM.fit(pts, k=2, iters=1)
        elif entry == "benchmark":
            KM.benchmark(n=16, d=4, k=2, iters=1)
        else:
            KM.main(["--n", "16", "--d", "4", "--k", "2", "--iters", "1"])


def test_mesh_and_device_must_agree():
    with pytest.raises(ValueError, match="disagrees"):
        KM.fit(np.zeros((8, 2), np.float32), k=2, iters=1,
               mesh=M.WorkerMesh("cpu"), device="meta")


def test_build_needs_nvcc_and_names_it(tmp_path, monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present here; the card's tests build for real")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["kmeans_partials"])


def test_library_names_follow_the_source_hash():
    assert build.sources() == ["kmeans_partials", "kmeans_partials_int8"]
    a = build.library_path("kmeans_partials")
    b = build.library_path("kmeans_partials_int8")
    assert a.parent == b.parent == build.BUILD_DIR and a != b
    assert a == build.library_path("kmeans_partials")  # stable
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_kernel_sources_ship_as_package_data_and_builds_are_ignored():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["harp_tpu_torch"]
    assert "csrc/*.cu" in data
    assert "torch" in cfg["project"]["optional-dependencies"]
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "harp_tpu_torch/_build/" in ignored
    assert "chiprun_out/" in ignored
