"""The manifest's rules, and a cell added by files alone."""

from __future__ import annotations

import copy
import json
import shutil

import pytest

from portbench import harness
from portbench.tests.small import KMEANS

ROOT = harness.ROOT


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_committed_manifest_is_valid():
    m = harness.load_manifest()
    for w in m["workloads"]:
        cell, config, traffic = harness.resolve(m, ROOT, w["name"])
        assert set(traffic["limits"]) == {"loss_gap", "first_change_gap",
                                          "change_gap"}
        e2e, layer = harness.cell_metrics(m, w["name"])
        names = {x["name"] for x in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for x in layer:
            assert (ROOT / "portbench/metrics" / f"{x['name']}.py").exists()


@pytest.mark.parametrize("where,value", [
    ("workload", "kmeans stream"), ("workload", "k,means"),
    ("workload", "a/b"), ("workload", "é"), ("workload", "-lead"),
    ("unit", "tokens per second"), ("unit", "µs"), ("unit", ""),
    ("unit", "x" * 17), ("metric", "ttft p95"), ("metric", "x" * 65)])
def test_a_name_or_unit_outside_the_allowed_set_is_rejected(where, value):
    m = _manifest()
    if where == "workload":
        m["workloads"][0]["name"] = value
    elif where == "unit":
        m["end_to_end"][0]["unit"] = value
    else:
        m["per_layer"][0]["name"] = value
    with pytest.raises(harness.ManifestError):
        harness.validate(m)


@pytest.mark.parametrize("edit", ["better", "source", "moves", "config"])
def test_broken_references_are_rejected(edit):
    m = _manifest()
    if edit == "better":
        m["end_to_end"][0]["better"] = "up"
    elif edit == "source":
        m["end_to_end"][0]["source"] = "program_span"
    elif edit == "moves":
        m["per_layer"][0]["moves"] = "no_such_metric"
    else:
        m["workloads"][0]["config"] = "no_such_config"
    with pytest.raises(harness.ManifestError):
        harness.validate(m)


def test_a_cell_added_by_files_alone_is_picked_up(tmp_path):
    """A new configuration, mix and per-layer metric: new files and new
    entries in BENCHMARK.json, no existing file edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = _manifest()
    cfg = json.loads((ROOT / "portbench/configs/"
                      "kmeans-stream-d300-k1000.json").read_text())
    cfg.update(copy.deepcopy(KMEANS["config"]), name="kmeans-stream-d32-k8")
    (tmp_path / "portbench/configs/kmeans-stream-d32-k8.json").write_text(
        json.dumps(cfg))
    trf = json.loads((ROOT / "portbench/traffic/int8_n1e9.json").read_text())
    trf.update(KMEANS["traffic"])
    (tmp_path / "portbench/traffic/int8_small.json").write_text(
        json.dumps(trf))
    (tmp_path / "portbench/metrics/kmeans.chunks_traced.py").write_text(
        "def read(rec):\n    return rec['slice']['chunks']\n")
    m["configs"].append({"name": "kmeans-stream-d32-k8",
                         "source": "a test configuration",
                         "file": "portbench/configs/kmeans-stream-d32-k8.json",
                         "reduced": ["d", "k"], "why": "a test"})
    m["workloads"].append({"name": "kmeans_stream.int8.small",
                           "config": "kmeans-stream-d32-k8",
                           "traffic": "int8_small", "chips": 1,
                           "why": "a test"})
    m["end_to_end"][0]["workloads"].append("kmeans_stream.int8.small")
    m["per_layer"].append({"name": "kmeans.chunks_traced", "unit": "chunks",
                           "better": "higher", "source": "program_counter",
                           "layer": "loop", "moves": "kmeans_points_per_s",
                           "workloads": ["kmeans_stream.int8.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    r = harness.run_cell("kmeans_stream.int8.small", 11, 0.05, True,
                         root=tmp_path, device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["kmeans.chunks_traced"] == {"value": 2,
                                                    "unit": "chunks"}
    r = harness.run_cell("kmeans_stream.int8.small", 11, 0.05, False,
                         root=tmp_path, device="cpu")
    assert set(r["metrics"]) == {"kmeans_points_per_s", "setup_s"}
