"""The manifest's rules, and a cell added by files alone."""

from __future__ import annotations

import copy
import importlib.util
import json
import multiprocessing
import shutil

import pytest

from portbench import harness
from portbench.tests import added, small
from portbench.tests.small import KMEANS

ROOT = harness.ROOT


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _driver_module(root, name):
    """``portbench/drivers/<name>.py`` under ``root``, for its ``LIMITS``
    and ``FAMILY``."""
    path = root / "portbench" / "drivers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _families(root, m) -> dict:
    """Each cell's family: its driver's ``FAMILY``."""
    out = {}
    for w in m["workloads"]:
        _, config, _ = harness.resolve(m, root, w["name"])
        out[w["name"]] = _driver_module(root, config["driver"]).FAMILY
    return out


def _check_cells(root):
    """Every cell's limits are its driver's ``LIMITS``; it reports
    ``setup_s``, another end-to-end metric and a per-layer metric, each
    with a reader."""
    m = harness.load_manifest(root)
    for w in m["workloads"]:
        cell, config, traffic = harness.resolve(m, root, w["name"])
        driver = _driver_module(root, config["driver"])
        assert set(traffic["limits"]) == set(driver.LIMITS)
        e2e, layer = harness.cell_metrics(m, w["name"])
        names = {x["name"] for x in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for x in layer:
            assert (root / "portbench/metrics" / f"{x['name']}.py").exists()


def _check_families(root):
    """A metric is listed only for cells of one family: a KMeans cell
    under an LDA metric fails, an LDA-family cell of any driver passes."""
    m = harness.load_manifest(root)
    family = _families(root, m)
    for x in m["end_to_end"] + m["per_layer"]:
        if "workloads" in x:
            kinds = {family[c] for c in x["workloads"]}
            assert len(kinds) == 1, (x["name"], kinds)


def test_the_committed_manifest_is_valid():
    _check_cells(ROOT)
    _check_families(ROOT)


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


@pytest.mark.parametrize("chips", [1, 4])
def test_a_cell_added_by_files_alone_is_picked_up(tmp_path, chips):
    """A new configuration, mix and per-layer metric: new files and new
    entries in BENCHMARK.json, no existing file edited.  On four chips: the
    world smoke's cell, its metrics and its ``small/`` file, run by four
    gloo workers."""
    if chips == 4:
        m = added.copy(tmp_path)
        added.write(tmp_path, added.add_world_cell(tmp_path, m, 4, 0.5))
        _check_families(tmp_path)
        ov = small.load(tmp_path)[added.WORLD_CELL]
        r = harness.run_cell(added.WORLD_CELL, 2**31 + 11, 0.05, False,
                             root=tmp_path, device="cpu", overrides=ov)
        assert list(r) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
        assert r["correct"] is True, r["checks"]
        assert r["attempted"] >= 1 and r["failed"] == 0
        assert r["device"]["count"] == 4
        assert set(r["metrics"]) == {"ring_hop_ms", "ring_hop_gb_per_s",
                                     "setup_s"}
        assert all(v["value"] > 0 for v in r["metrics"].values())
        assert set(r["checks"]) == {"allreduce_mismatch", "rotate_mismatch",
                                    "hop_mismatch"}
        assert multiprocessing.active_children() == []
        return
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
    # only cells of the LDA family report the LDA metrics (the cell's own
    # sets above: it reports no other's)
    family = _families(ROOT, m)
    assert family["lda.enwiki1m.zipf"] == "lda"
    for w in m["workloads"]:
        e2e, layer = harness.cell_metrics(m, w["name"])
        names = {x["name"] for x in e2e + layer}
        if names & {"lda_tokens_per_s", "k4.roofline", "lda.step_mfu",
                    "lda.device_idle", "lda.prep_s"}:
            assert family[w["name"]] == "lda", w["name"]


_LDA_METRICS = ("lda_tokens_per_s", "k4.roofline", "lda.step_mfu",
                "lda.device_idle", "lda.prep_s")


@pytest.mark.parametrize("case", ["new_lda_driver", "kmeans_under_lda"])
def test_a_metric_is_listed_for_one_family_only(tmp_path, case):
    """A four-card LDA-family cell of a new driver, appended under the LDA
    metrics by files alone, passes the manifest's checks; a KMeans cell
    listed there fails them."""
    m = added.copy(tmp_path)
    if case == "new_lda_driver":
        (tmp_path / "portbench/drivers/lda_world.py").write_text(
            '"""An LDA driver of a process world."""\n'
            "from portbench.drivers.lda import LIMITS, Driver  # noqa\n"
            'FAMILY = "lda"\n')
        cfg = json.loads((ROOT / "portbench/configs/"
                          "lda-enwiki1m-k1000.json").read_text())
        cfg.update(name="lda-world", driver="lda_world")
        trf = json.loads((ROOT / "portbench/traffic/enwiki1m_zipf.json")
                         .read_text())
        cell = "lda.world.rotate4"
        added.add_cell(tmp_path, m, cell, cfg, "enwiki1m_world", trf, 4,
                       small.LDA)
    else:
        cell = "kmeans_stream.int8.n1e9"
    for x in m["end_to_end"] + m["per_layer"]:
        if x["name"] in _LDA_METRICS:
            x["workloads"].append(cell)
    added.write(tmp_path, m)
    harness.load_manifest(tmp_path)
    if case == "new_lda_driver":
        _check_cells(tmp_path)
        _check_families(tmp_path)
        assert small.load(tmp_path)[cell] == small.LDA
    else:
        with pytest.raises(AssertionError):
            _check_families(tmp_path)


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
