"""CPU dry runs: every cell at a small size through its driver, the
program's CPU path (the kernels' plain versions), the reference and the
metric readers, and the result line to the contract."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.small import SMALL

ROOT = harness.ROOT
SEED = 2**31 + 977
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu_with_the_contract_keys(cell, traced):
    r = harness.run_cell(cell, SEED, 0.05, traced, device="cpu",
                         overrides=SMALL[cell])
    keys = list(json.loads(json.dumps(r)))
    assert keys == KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    m = harness.load_manifest()
    e2e, layer = harness.cell_metrics(m, cell)
    if traced:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        # the CPU traces no device: device-trace metrics stay silent
        assert set(r["metrics"]) <= {x["name"] for x in layer}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {x["name"] for x in e2e}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_inputs_other_seed_other_inputs():
    from portbench import gen

    cfg = {**SMALL["mfsgd.ml20m.zipf"]["config"]}
    cfg = {**json.loads((ROOT / "portbench/configs/mfsgd-ml20m-r64.json")
                        .read_text()), **cfg}
    trf = {**json.loads((ROOT / "portbench/traffic/ml20m_zipf.json")
                        .read_text()), **SMALL["mfsgd.ml20m.zipf"]["traffic"]}
    a = gen.ratings(cfg, trf, SEED, "cpu")
    b = gen.ratings(cfg, trf, SEED, "cpu")
    c = gen.ratings(cfg, trf, SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    counts = torch.bincount(a[0], minlength=cfg["n_users"])
    assert int(counts.min()) >= trf["min_per_user"]
    assert a[0].numel() == cfg["nnz"]

    # every seed: the same ratings in each (user tile, item tile), so the
    # same entries and chains, under other names
    def per_tile(users, items):
        i_own = -(-cfg["n_items"] // cfg["rotate_chunks"])
        tile = ((users // cfg["u_tile"]) * cfg["n_items"]
                + (items // i_own) * i_own + (items % i_own) // cfg["i_tile"])
        return torch.bincount(tile)

    assert torch.equal(per_tile(*a[:2]), per_tile(*c[:2]))
    assert not torch.equal(a[1], c[1])


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "kmeans_stream.f32.n1e8", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


_FAKE_CARD = """
import sys, runpy, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ["run.py", "--workload", "kmeans_stream.f32.n1e8", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
runpy.run_path({run!r}, run_name="__main__")
"""


def test_run_refuses_where_the_program_is_not_in_the_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = _FAKE_CARD.format(run=str(tmp_path / "portbench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
    assert "program" in out.stderr or "harp_tpu_torch" in out.stderr
