"""The skew ledger (``harp_tpu_torch/utils/skew.py``), the sentinel's skew
trigger and the ported readers of ``fileformat`` against harp_tpu's.

- The ledger's summaries, imbalance model and rebalance plans (fractional
  and whole-unit) are bit-equal to the reference's on seeded loads; its
  hooks record nothing while telemetry is off; the skew trigger fires
  after the reference's K consecutive skewed records with the reference's
  inline plan.
- ``load_sharded_csv`` and ``load_sharded_triples`` return the reference's
  arrays and record the reference's skew rows; ``multi_file_splits``
  records its files as movable units.
- On a spawned 4-worker gloo world, the partition and execution records
  of MF-SGD (dense and scatter), LDA, RF, subgraph counting and KMeans
  are the reference's on four devices (the same per-worker work, padding
  and totals).
"""

import os

import jax
import numpy as np
import pytest

import harp_tpu.fileformat as JFF
from harp_tpu import health as JH
from harp_tpu.models import kmeans as JKM
from harp_tpu.models import lda as JL
from harp_tpu.models import mfsgd as JMF
from harp_tpu.models import rf as JRF
from harp_tpu.models import subgraph as JSG
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import skew as JS
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch import fileformat as FF
from harp_tpu_torch import health
from harp_tpu_torch.models import rf as RF
from harp_tpu_torch.utils import skew, telemetry
from torch_plane_world import (LDA_KW, WORLD, kmeans_points, run_skew_cases,
                               run_world, skewed_corpus, skewed_ratings,
                               time_limit)

#: the deterministic fields of a summary row (times out)
KEYS = ("source", "unit", "work", "total", "n_workers", "max_mean_ratio",
        "wasted_frac", "padding_frac", "runs")


def _fields(summary: dict) -> dict:
    return {ph: {k: r.get(k) for k in KEYS} for ph, r in summary.items()}


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(90):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("skew")
    return run_world(run_skew_cases, root, str(root))


@pytest.fixture(scope="module")
def ref():
    """The reference's records on four devices, on the world's inputs."""
    jm = JaxMesh(jax.devices()[:WORLD])
    out = {}
    u, i, v = skewed_ratings()
    for algo, kw in (("dense", {"u_tile": 8, "i_tile": 8, "entry_cap": 64}),
                     ("scatter", {"chunk": 64})):
        with JT.scope(True):
            m = JMF.MFSGD(64, 48, JMF.MFSGDConfig(rank=4, algo=algo, **kw),
                          jm, 0)
            m.set_ratings(u, i, v)
            m.train_epoch()
            out[f"mf-{algo}"] = JS.ledger.summary()
    d, w = skewed_corpus()
    with JT.scope(True):
        lda = JL.LDA(64, 64, JL.LDAConfig(**LDA_KW), jm, 0)
        lda.set_tokens(d, w)
        lda.sample_epoch()
        out["lda"] = JS.ledger.summary()
    x, y = RF.synthetic_classification(400, 8, seed=0)
    with JT.scope(True):
        JRF.RandomForest(JRF.RFConfig(n_trees=4, max_depth=2), jm).fit(x, y)
        out["rf"] = JS.ledger.summary()
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, 200, 600),
                      rng.integers(0, 200, 600)], 1)
    with JT.scope(True):
        JSG.count_template(edges, 200, JSG.SubgraphConfig(
            template="u3-path", n_trials=2, max_degree=4), jm)
        out["subgraph"] = JS.ledger.summary()
    with JT.scope(True):
        JKM.fit(kmeans_points(), k=8, iters=2, mesh=jm)
        out["kmeans"] = JS.ledger.summary()
    return out


# ---------------------------------------------------------------------------
# The ledger against the reference's
# ---------------------------------------------------------------------------

def _drive(led, rng):
    led.record_partition("ingest", rng.integers(1, 100, 5),
                         unit="rows", padded_total=600)
    for _ in range(3):
        led.record_execution("epochs", rng.integers(1, 100, 5),
                             unit="tokens", wall_s=0.5)
    led.record_execution("units", [9.0, 1.0, 1.0, 1.0], unit="u",
                         units=[[("a", 5.0), ("b", 4.0)], [("c", 1.0)],
                                [("d", 1.0)], [("e", 1.0)]])
    led.record_host("host", 2, 1.5, n_workers=4)
    led.record_host("host", 0, 0.5)
    led.record_execution("zero", [0, 0, 0], unit="u")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summaries_and_plans_are_the_references(seed):
    ours, theirs = skew.SkewLedger(), JS.SkewLedger()
    _drive(ours, np.random.default_rng(seed))
    _drive(theirs, np.random.default_rng(seed))
    assert ours.summary() == theirs.summary()
    for phase in ("ingest", "epochs", "units", "host", "zero", "missing"):
        assert ours.suggest_rebalance(phase) == \
            theirs.suggest_rebalance(phase), phase
    plan = ours.suggest_rebalance("units")
    assert plan["moves"] and all("id" in m for m in plan["moves"])
    assert ours._imbalance(ours._phases["epochs"]) == \
        JS.SkewLedger._imbalance(theirs._phases["epochs"])


def test_hooks_record_nothing_while_telemetry_is_off():
    assert not telemetry.enabled()
    skew.reset()
    skew.record_partition("p", [1, 2], unit="rows")
    skew.record_execution("p", [1, 2], unit="rows")
    skew.record_host("p", 0, 1.0)
    assert skew.ledger.summary() == {}


def test_the_skew_trigger_fires_with_the_references_plan():
    def fire(mod, hl, tel):
        with tel.scope(True):
            rows = []
            for _ in range(hl.TRIGGER_SUPERSTEPS):
                mod.record_execution("p", [10, 2, 2, 2], unit="u")
                rows.append(len(hl.monitor.findings()))
            row = dict(hl.monitor.findings()[0])
        row.pop("_seq", None)
        return rows, row

    ours, theirs = fire(skew, health, telemetry), fire(JS, JH, JT)
    assert ours == theirs
    assert ours[0] == [0, 0, 1]  # the K-th consecutive record fires
    assert ours[1]["detector"] == "skew_trigger"
    assert health.TRIGGER_SUPERSTEPS == JH.TRIGGER_SUPERSTEPS
    assert health.WASTED_FRAC_TRIGGER == JH.WASTED_FRAC_TRIGGER


#: rows whose route holds them to the same peak key in both packages
WASTE_ROWS = {
    "kmeans_int8": {"n": 1_000_000, "d": 300, "k": 100, "quantize": "int8",
                    "num_workers": 4, "iters_per_sec": 1140.88},
    "kmeans_f32_pallas": {"n": 1_000_000, "d": 300, "k": 100,
                          "use_pallas": True, "dtype": "float32",
                          "iters_per_sec": 1014.97},
    "kmeans_bf16": {"n": 1_000_000, "d": 300, "k": 100, "dtype": "bfloat16",
                    "num_workers": 1, "iters_per_sec": 300.0},
}


@pytest.mark.parametrize("what", sorted(WASTE_ROWS))
def test_waste_priced_against_the_same_peaks_is_the_references(
        what, monkeypatch):
    """Under the reference's peaks the waste is the reference's, scaled by
    the route's work: K1 and K2 count their own operations (2ndk + nd),
    the reference its one-hot sums matmul (4ndk); the bf16 matmul route
    counts as the reference does and gives its value exactly."""
    from harp_tpu.utils import roofline as JR
    from harp_tpu_torch.utils import roofline

    row = WASTE_ROWS[what]
    ratio = (roofline.WORK_MODELS["kmeans"](row)["flops"]
             / JR.WORK_MODELS["kmeans"](row)["flops"])
    with telemetry.scope(True), JT.scope(True):
        skew.record_execution("p", [10, 2, 2, 2], unit="u", wall_s=2.0)
        JS.record_execution("p", [10, 2, 2, 2], unit="u", wall_s=2.0)
        # on the card's own peaks: the route's percent of the H100 peak
        # times the phase's wasted fraction (0.6)
        pct = roofline.annotate("kmeans", row)["pct_peak_flops"]
        assert skew.wasted_pct_of_peak("kmeans", row, "p") == round(
            pct * 0.6, 3)
        theirs = JS.wasted_pct_of_peak("kmeans", row, "p")
        monkeypatch.setattr(roofline, "H100_PEAKS", dict(JR.V5E_PEAKS))
        ours = skew.wasted_pct_of_peak("kmeans", row, "p")
        assert ours > 0
        if what == "kmeans_bf16":
            assert ratio == 1.0 and ours == theirs
        else:
            assert ratio == pytest.approx(0.5 + 1 / 400)
            assert ours == pytest.approx(theirs * ratio, abs=2e-3)


def test_waste_of_an_lda_row_is_priced_on_the_f32_peak():
    """The reference's LDA case at 1e9 tokens/s, K = 100: 1.4e12 flop/s is
    2.0896 % of the H100's 67 TFLOP/s f32 peak (K4 runs on the CUDA
    cores), 60 % of it lost to the barrier; an unknown phase or a config
    without a work model gives None."""
    with telemetry.scope(True):
        skew.record_execution("p", [10, 2, 2, 2], unit="u", wall_s=2.0)
        pct = skew.wasted_pct_of_peak(
            "lda", {"n_topics": 100, "tokens_per_sec_per_chip": 1e9}, "p")
        assert pct == pytest.approx(1.4e12 / 67e12 * 100 * 0.6, abs=1e-3)
        assert skew.wasted_pct_of_peak("lda", {}, "nope") is None
        assert skew.wasted_pct_of_peak("no_model", {}, "p") is None


def test_export_rows_are_stamped(tmp_path):
    with telemetry.scope(True):
        skew.record_partition("p", [3, 1], unit="rows", padded_total=6)
        path = tmp_path / "s.jsonl"
        telemetry.export(str(path))
    (row,) = telemetry.load_rows(str(path))["skew"]
    assert row["phase"] == "p" and row["total"] == 4.0
    assert row["padding_frac"] == pytest.approx(1 / 3, abs=1e-6)
    assert row["backend"] == "cpu"


# ---------------------------------------------------------------------------
# fileformat's readers
# ---------------------------------------------------------------------------

@pytest.fixture
def csv_files(tmp_path):
    rng = np.random.default_rng(11)
    paths = []
    for j, rows in enumerate((40, 7, 13, 22, 3)):
        p = tmp_path / f"x{j}.csv"
        np.savetxt(p, rng.normal(size=(rows, 4)), delimiter=",", fmt="%.5f")
        paths.append(str(p))
    return paths


@pytest.fixture
def triple_files(tmp_path):
    rng = np.random.default_rng(12)
    paths = []
    for j, rows in enumerate((30, 5, 17)):
        p = tmp_path / f"t{j}.txt"
        a = np.stack([rng.integers(0, 50, rows), rng.integers(0, 20, rows),
                      rng.integers(1, 6, rows)], 1)
        np.savetxt(p, a, fmt="%d")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("pad_value", [0.0, -1.0])
def test_load_sharded_csv_is_the_references(csv_files, pad_value):
    loader = lambda p: np.loadtxt(p, delimiter=",", ndmin=2)  # noqa: E731
    with telemetry.scope(True):
        got, counts = FF.load_sharded_csv(csv_files, 3, loader=loader,
                                          pad_value=pad_value)
        ours = skew.ledger.summary()
    with JT.scope(True):
        want, jcounts = JFF.load_sharded_csv(csv_files, 3, loader=loader,
                                             pad_value=pad_value)
        theirs = JS.ledger.summary()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, jcounts)
    assert _fields(ours) == _fields(theirs)
    assert ours["fileformat.multi_file_splits"]["unit"] == "bytes"
    assert sum(ours["fileformat.load_sharded_csv"]["work"]) == 85


def test_load_sharded_triples_is_the_references(triple_files):
    with telemetry.scope(True):
        (u, i, v), counts = FF.load_sharded_triples(triple_files, 2)
        ours = skew.ledger.summary()
    with JT.scope(True):
        (ju, ji, jv), jcounts = JFF.load_sharded_triples(triple_files, 2)
        theirs = JS.ledger.summary()
    for a, b in ((u, ju), (i, ji), (v, jv), (counts, jcounts)):
        np.testing.assert_array_equal(a, b)
    assert _fields(ours) == _fields(theirs)
    assert (u == -1).sum() == (2 * counts.max() - counts.sum())


def test_the_readers_refuse_what_the_reference_refuses(tmp_path):
    with pytest.raises(FileNotFoundError):
        FF.load_sharded_csv(str(tmp_path / "none-*.csv"), 2)
    with pytest.raises(FileNotFoundError):
        FF.load_sharded_triples([], 2)


def test_multi_file_splits_records_whole_files(csv_files):
    from harp_tpu_torch import schedule

    with telemetry.scope(True):
        splits = FF.multi_file_splits(csv_files, 2)
        rec = skew.ledger._phases["fileformat.multi_file_splits"]
        plan = skew.suggest_rebalance("fileformat.multi_file_splits")
    assert splits == JFF.multi_file_splits(csv_files, 2)
    assert [sorted(p for p, _ in u) for u in rec["units"]] == splits
    assert sum(rec["work"]) == sum(os.path.getsize(p) for p in csv_files)
    moved = schedule.apply_rebalance(splits, plan)
    assert sorted(p for s in moved for p in s) == sorted(csv_files)


# ---------------------------------------------------------------------------
# The models' records on four workers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mf-dense", "mf-scatter", "lda", "rf",
                                  "subgraph", "kmeans"])
def test_the_models_records_are_the_references(world, ref, case):
    want = _fields(ref[case])
    for r in world:
        assert _fields(r[case]) == want


def test_the_models_records_cost_no_budget_drift(world):
    for r in world:
        assert r["rf_findings"] == []
        assert r["subgraph_dispatches"] >= 1
        assert r["kmeans"]["kmeans.fit"]["work"] == [
            len(kmeans_points()) / WORLD] * WORLD
