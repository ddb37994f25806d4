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


#: the numbers each driver's cells are judged by
LIMITS = {"kmeans_stream": {"loss_gap", "first_change_gap", "change_gap"},
          "mfsgd": {"loss_gap", "first_change_gap", "change_gap"},
          "lda": {"count_gap", "prefix_mismatch", "rotate_mismatch",
                  "ll_gap"}}


def test_the_committed_manifest_is_valid():
    m = harness.load_manifest()
    for w in m["workloads"]:
        cell, config, traffic = harness.resolve(m, ROOT, w["name"])
        assert set(traffic["limits"]) == LIMITS[config["driver"]]
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


def test_the_lda_cell_and_its_metrics():
    m = harness.load_manifest()
    (cfg,) = [c for c in m["configs"] if c["name"] == "lda-enwiki1m-k1000"]
    assert cfg["reduced"] == ["n_docs"]
    config = json.loads((ROOT / cfg["file"]).read_text())
    assert config["name"] == cfg["name"] and config["driver"] == "lda"
    assert config["reduced"] == cfg["reduced"]
    assert (config["n_docs"], config["vocab_size"], config["n_topics"]) == (
        131_072, 1_000_000, 1000)
    # the published enwiki widths, and the cut of documents beside them
    pub = config["published"]
    assert (pub["n_docs"], pub["vocab_size"], pub["tokens"]) == (
        3_775_554, 1_000_000, 1_107_903_672)
    assert "3,775,554" in cfg["source"] and "1,107,903,672" in cfg["source"]
    assert set(config["why_reduced"]) == set(config["reduced"])
    traffic = json.loads((ROOT / "portbench/traffic/enwiki1m_zipf.json")
                         .read_text())
    assert traffic["doc_len_mean"] == pytest.approx(
        pub["tokens"] / pub["n_docs"], abs=0.01)
    assert set(config["assumed"]) >= {"doc_lengths", "word_law"}
    (cell,) = [w for w in m["workloads"] if w["name"] == "lda.enwiki1m.zipf"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "lda-enwiki1m-k1000", "enwiki1m_zipf", 1)
    e2e, layer = harness.cell_metrics(m, "lda.enwiki1m.zipf")
    assert {x["name"] for x in e2e} == {"lda_tokens_per_s", "setup_s"}
    assert {x["name"]: x["moves"] for x in layer} == {
        "k4.roofline": "lda_tokens_per_s", "lda.step_mfu": "lda_tokens_per_s",
        "lda.device_idle": "lda_tokens_per_s", "lda.prep_s": "setup_s"}
    (rate,) = [x for x in m["end_to_end"] if x["name"] == "lda_tokens_per_s"]
    assert (rate["unit"], rate["better"], rate["source"]) == (
        "tokens/s", "higher", "host_clock")
    # no other cell reports the LDA metrics, and LDA reports no other's
    for w in m["workloads"]:
        if w["name"] != "lda.enwiki1m.zipf":
            e2e, layer = harness.cell_metrics(m, w["name"])
            names = {x["name"] for x in e2e + layer}
            assert not names & {"lda_tokens_per_s", "k4.roofline",
                                "lda.step_mfu", "lda.device_idle",
                                "lda.prep_s"}


@pytest.mark.parametrize("cell", ["kmeans_stream.int8.n1e9",
                                  "kmeans_stream.f32.n1e8",
                                  "mfsgd.ml20m.zipf", "mfsgd.ml20m.uniform"])
def test_the_hook_leaves_the_other_cells_on_compare_numbers(cell,
                                                            monkeypatch):
    """Their drivers define no ``numbers``: run_cell judges them by
    ``compare.numbers``, as before the hook."""
    from portbench import compare
    from portbench.tests.small import SMALL

    m = harness.load_manifest()
    _, config, _ = harness.resolve(m, ROOT, cell)
    assert not hasattr(harness.load_driver(config["driver"]), "numbers")
    calls = []
    real = compare.numbers

    def spy(*args):
        calls.append(cell)
        return real(*args)

    monkeypatch.setattr(compare, "numbers", spy)
    r = harness.run_cell(cell, 13, 0.05, False, device="cpu",
                         overrides=SMALL[cell])
    assert calls == [cell] and r["correct"] is True
    assert set(r["checks"]) == {"loss_gap", "first_change_gap", "change_gap"}


def test_a_driver_with_numbers_supplies_its_own(monkeypatch):
    from portbench import compare
    from portbench.drivers import kmeans_stream
    from portbench.tests.small import SMALL

    seen = []

    def numbers(self, initial, prog, ref):
        seen.append((len(prog), len(ref)))
        return compare.numbers(initial, prog, ref) | {"loss_gap": 1.0}

    monkeypatch.setattr(kmeans_stream.Driver, "numbers", numbers,
                        raising=False)
    cell = "kmeans_stream.int8.n1e9"
    r = harness.run_cell(cell, 13, 0.05, False, device="cpu",
                         overrides=SMALL[cell])
    assert seen == [(2, 2)]
    assert r["checks"]["loss_gap"]["value"] == 1.0 and r["correct"] is False
