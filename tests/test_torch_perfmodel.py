"""``harp_tpu_torch.perfmodel`` and ``health.grade`` against harp_tpu's,
and the cost model against the port's own committed card rows.

- Shared algebra on the same inputs (numpy, from a seed): ``Price``'s
  terms, sum and ``bound``; ``spearman``; ``wire_cost_s`` on equal link
  rates; ``grade_bench_row``'s four verdicts with both models stubbed
  alike; ``grade_profile_row``'s drift findings.
- Hand-computed: every priced config's terms sum to ``predicted_s``;
  ``price_sheet`` prices every wire 0 on ``single_card``; the plain
  routes' launch and byte constants equal a fresh ``count_ops`` of the
  port's code; ``presize`` for K3 and K7 from their byte models (K1/K2's
  needs the card and says so); unknown kernels and configs raise.
- The committed ``H100_EVIDENCE.jsonl``: every row the card's, stamped
  with its name, power limit, commit and date; ``predict --grade`` passes
  on it with the KMeans, MF-SGD and LDA families priced and a graded pair
  each; an inverted model fails it; every calibrated constant is the
  evidence's.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from harp_tpu.health import grade as JHG
from harp_tpu.health import sentinel as JS
from harp_tpu.perfmodel import grade as JG
from harp_tpu.perfmodel import model as JM
from harp_tpu.plan import topology as JT
from harp_tpu_torch.health import grade as HG
from harp_tpu_torch.health import sentinel as PS
from harp_tpu_torch.perfmodel import cli as PCLI
from harp_tpu_torch.perfmodel import grade as G
from harp_tpu_torch.perfmodel import model as M
from harp_tpu_torch.plan import topology as T
from harp_tpu_torch.utils import flightrec as FR
from torch_world import time_limit

REPO = pathlib.Path(__file__).resolve().parent.parent
EVIDENCE = REPO / "H100_EVIDENCE.jsonl"


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


# ---- shared algebra ---------------------------------------------------------

def test_price_terms_and_bound_match_the_reference():
    rng = np.random.default_rng(0)
    assert M.BOUNDS == JM.BOUNDS and M.RATES_SOURCES == JM.RATES_SOURCES
    for _ in range(50):
        t = rng.exponential(size=4) * 10.0 ** rng.integers(-9, 0, 4)
        p, j = M.Price("c", "m", *t), JM.Price("c", "m", *t)
        assert (p.predicted_s, p.predicted_rate, p.bound, p.terms()) == (
            j.predicted_s, j.predicted_rate, j.bound, j.terms())


def test_spearman_matches_the_reference():
    rng = np.random.default_rng(1)
    for n in (1, 2, 3, 4, 7):
        xs, ys = rng.permutation(n * 10)[:n], rng.permutation(n * 10)[:n]
        assert G.spearman(xs.tolist(), ys.tolist()) == JG.spearman(
            xs.tolist(), ys.tolist())


def test_wire_cost_matches_the_reference_on_equal_rates():
    rng = np.random.default_rng(2)
    for n, g in ((1, 1), (8, 8), (32, 8), (16, 4)):
        pt, jt = (T.Topology("t", n, g, 30.0, 30.0),
                  JT.Topology("t", n, g, 30.0, 30.0))
        for prim in ("psum", "ppermute", "all_gather", "all_to_all"):
            for sched in ("keep", "hier_psum", "chunked_pipeline",
                          "wire_bf16", "wire_int8"):
                b = int(rng.integers(1, 1 << 30))
                assert M.wire_cost_s(pt, prim, sched, b) == \
                    JM.wire_cost_s(jt, prim, sched, b)


def _stub_models(monkeypatch, predicted: dict):
    """Both packages' model priced alike: config -> predicted seconds."""
    for mod, price_cls in ((M, M.Price), (JM, JM.Price)):
        monkeypatch.setattr(mod, "CONFIG_MODELS",
                            {c: ("x", {}) for c in predicted})
        monkeypatch.setattr(
            mod, "price", lambda cfg, row=None, topo=None, _p=price_cls:
            _p(cfg, "iters_per_sec", predicted[cfg], 0.0, 0.0, 0.0))
    for mod in (G, JG):
        monkeypatch.setattr(mod, "FAMILY_PAIRS",
                            {"cand": ("inc", "iters_per_sec", None)})


#: (measured, incumbent rate, stub predicted seconds of cand and inc)
BENCH_CASES = {
    "regressed": (80.0, {"other": 100.0}, {}),
    "improved": (120.0, {"other": 100.0}, {}),
    "confirmed": (105.0, {"other": 100.0}, {}),
    "magnitude": (100.0, {"cand": 100.0}, {"cand": 1.0, "inc": 1.0}),
    "direction": (200.0, {"cand": 200.0, "inc": 100.0},
                  {"cand": 0.02, "inc": 0.01}),
    "agrees": (200.0, {"cand": 200.0, "inc": 100.0},
               {"cand": 0.005, "inc": 0.01}),
    "nothing": (100.0, {}, {}),
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_grade_bench_row_verdicts_match_the_reference(case, monkeypatch):
    measured, incumbents, predicted = BENCH_CASES[case]
    _stub_models(monkeypatch, predicted)
    cfg = "other" if "other" in incumbents else "cand"
    out = {}
    for name, grade, sent, backend in (("port", HG, PS, "cuda"),
                                       ("ref", JHG, JS, "tpu")):
        sent.reset()
        bench = {c: {"config": c, "iters_per_sec": v, "backend": backend}
                 for c, v in incumbents.items()}
        row = {"config": cfg, "iters_per_sec": measured, "backend": backend}
        out[name] = grade.grade_bench_row(row, ".", bench=bench)
    assert out["port"] == out["ref"]
    want = {"regressed": "regressed", "improved": "improved",
            "confirmed": "confirmed", "magnitude": "model_invalidated",
            "direction": "model_invalidated", "agrees": "confirmed",
            "nothing": None}[case]
    assert (out["port"] or {}).get("verdict") == want


def test_grade_bench_row_skips_rows_not_of_the_card():
    for row in ({"config": "kmeans", "iters_per_sec": 1.0, "backend": "cpu"},
                {"config": "kmeans", "iters_per_sec": 1.0, "backend": "cuda",
                 "smoke": True},
                {"config": "kmeans", "iters_per_sec": 1.0, "backend": "cuda",
                 "error": "x"}):
        assert HG.grade_bench_row(row, ".", bench={}) is None


def _profile(app, wall, **terms):
    full = {f"{b}_s": 0.0 for b in ("mxu", "elementwise", "gather_dus",
                                     "scatter", "wire", "overhead")}
    full.update({f"{k}_s": v for k, v in terms.items()})
    return {"kind": "profile", "app": app, "wall_s": wall, "terms": full,
            "bound": max(full, key=full.get).removesuffix("_s"),
            "reconciled": True}


@pytest.mark.parametrize("fresh", [
    _profile("kmeans", 1.0, mxu=0.6, elementwise=0.4),      # no drift
    _profile("kmeans", 1.0, mxu=0.45, elementwise=0.55),    # bound flipped
    _profile("kmeans", 1.0, mxu=0.8, elementwise=0.05, overhead=0.15),
    _profile("svm", 1.0, mxu=1.0),                          # no baseline
    {**_profile("kmeans", 1.0, mxu=0.1), "reconciled": False}])
def test_grade_profile_row_matches_the_reference(fresh):
    committed = {"kmeans": _profile("kmeans", 2.0, mxu=1.2, elementwise=0.8)}
    PS.reset()
    JS.reset()
    assert HG.grade_profile_row(fresh, ".", committed=committed) == \
        JHG.grade_profile_row(fresh, ".", committed=committed)
    assert HG.PROFILE_SHARE_DRIFT == JHG.PROFILE_SHARE_DRIFT
    assert HG.REL_TOL == JHG.REL_TOL and HG.METRIC_KEYS == JHG.METRIC_KEYS


# ---- the model by hand ------------------------------------------------------

@pytest.mark.parametrize("cfg", sorted(M.CONFIG_MODELS))
def test_every_config_prices_terms_that_sum(cfg):
    for topo in (T.single_card(), T.h100_4x8()):
        p = M.price(cfg, None, topo)
        row = M.model_row(p, topo, config=cfg)
        assert sum(row["terms"].values()) == pytest.approx(
            row["predicted_s"], rel=1e-9)
        assert row["bound"] == p.bound and p.predicted_s > 0
        assert all(v >= 0 for v in p.terms().values())
    assert M.price(cfg).wire_s == 0.0          # one card: no wire


def test_unpriced_configs_raise_and_are_listed():
    with pytest.raises(KeyError, match="unpriced"):
        M.price("rf_hist_pallas")
    ranked, unpriced = PCLI.candidate_ranking(T.single_card())
    assert "rf_hist_pallas" in unpriced
    assert {c for c, _ in ranked} | set(unpriced) == set(G.FAMILY_PAIRS)


def test_price_sheet_is_free_of_wire_on_one_card():
    sheet = {"collectives": [
        {"primitive": p, "per_shard_bytes": b, "amplification": a}
        for p, b, a in (("psum", 1 << 20, 3), ("all_to_all", 4096, 2),
                        ("ppermute", 1 << 28, 1))]}
    one = M.price_sheet("x", sheet, T.single_card())
    assert (one.wire_s, one.compute_s, one.memory_s) == (0.0, 0.0, 0.0)
    assert one.overhead_s == FR.CALIBRATED_OVERHEADS["dispatch_s"] + \
        FR.CALIBRATED_OVERHEADS["readback_s"]
    ring = M.price_sheet("x", sheet, T.h100_4x8())
    assert ring.wire_s == pytest.approx(
        (2 * 31 / 32 * 3 * (1 << 20) + 31 / 32 * 2 * 4096 + (1 << 28))
        / 50e9)


def test_kmeans_f32_route_constants_are_the_counted_ones():
    """The f32 iteration's launches and bytes, counted again: ops less
    one_hot's CPU-only bounds check; bytes within the counter's over-count
    of one_hot's in-place scatter (it counts the whole [n, k] both
    ways)."""
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh

    g = torch.Generator().manual_seed(0)
    with use_mesh(WorkerMesh("cpu")):
        for n, d, k in ((4096, 32, 8), (8192, 64, 16)):
            x, c = torch.randn(n, d, generator=g), torch.randn(k, d,
                                                              generator=g)
            cfg = KM.KMeansConfig(k=k, iters=1)
            ops, nbytes, _ = M.count_ops(KM.kmeans_step, x, c, cfg)
            assert ops - 1 == M.KMEANS_F32_LAUNCHES
            model = (M.KMEANS_F32_NK_BYTES * n * k
                     + M.KMEANS_F32_ND_BYTES * n * d)
            assert model <= nbytes <= model + 24 * n * k + 250 * n


def test_dense_route_constants_are_the_counted_ones():
    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh

    mesh = WorkerMesh("cpu")
    with use_mesh(mesh):
        m = MF.MFSGD(1024, 256, MF.MFSGDConfig(
            rank=16, algo="dense", u_tile=64, i_tile=64), mesh=mesh)
        m.set_ratings(*MF.synthetic_ratings(1024, 256, 40_000, rank=4))
        m.train_epoch()
        ops, nbytes, _ = M.count_ops(m.train_epoch)
        levels = sum(s.n_levels for s in m._schedules)
        slots = sum(s.order.numel() for s in m._schedules) * \
            m._blocks[0].shape[-1]
        assert ops / levels == pytest.approx(
            M.MFSGD_DENSE_LAUNCHES_PER_LEVEL, abs=2)
        assert nbytes / (slots * 16) == pytest.approx(
            M.MFSGD_DENSE_BYTES_PER_SLOT_RANK, rel=0.15)
        model = LD.LDA(128, 64, LD.LDAConfig(
            n_topics=8, algo="dense", d_tile=16, w_tile=16, entry_cap=64),
            mesh, seed=0)
        model.set_tokens(*LD.benchmark_corpus(128, 64, 20, 0))
        model.sample_epoch()
        ops, nbytes, _ = M.count_ops(model.sample_epoch)
        ed = model._tokens[0]
        entries, C = ed.shape[0] * ed.shape[1], ed.shape[-1]
        assert ops / entries == pytest.approx(
            M.LDA_DENSE_LAUNCHES_PER_ENTRY, abs=2)
        assert nbytes / (entries * C * 8) == pytest.approx(
            M.LDA_DENSE_BYTES_PER_SLOT_TOPIC, rel=0.15)


def test_geometry_is_the_partition_s_on_the_benchmark_data():
    """The closed-form step geometry against the port's own partition of
    the benchmark's data at a small width: K3's entries and critical path
    (LevelSchedule), K4's chunks (EntryPlan)."""
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import mfsgd_kernel as K3

    shape = {"n_users": 4000, "n_items": 1000, "nnz": 400_000,
             "u_tile": 128, "i_tile": 128}
    geo = M.mfsgd_geometry(shape)
    u, i, v = MF.synthetic_ratings(4000, 1000, 400_000)
    eu, ei, ev, ou, oi, *_ = MF.partition_ratings_tiles(
        u, i, v, 4000, 1000, 1, 128, 128, 2048, n_slices=2)
    levels = [K3.entry_dependencies(eu[s], ou[s], oi[s], 128)[0].max() + 1
              for s in range(2)]
    entries = [int((eu[s] < 128).any(-1).sum()) for s in range(2)]
    assert max(levels) == geo["levels"]
    assert max(entries) == geo["entries"]
    assert eu.shape[-1] == pytest.approx(geo["slots"], rel=0.02)


def test_presize_k3_and_k7_from_their_byte_models():
    from harp_tpu_torch.ops import rf_kernel
    from harp_tpu_torch.ops.kernel_registry import H100_SMEM_OPTIN, H100_SMS
    from harp_tpu_torch.ops.mfsgd_kernel import CLUSTER, block_bytes

    k3 = M.presize("mfsgd.sgd_tile_update", rank=64)
    assert k3["tile"] in k3["fits"] and 1024 not in k3["fits"]
    for t in k3["fits"]:
        slots = M.mfsgd_geometry({"u_tile": t, "i_tile": t})["slots"]
        assert block_bytes(t, t, 64, slots, CLUSTER) <= H100_SMEM_OPTIN
    assert k3["smem_bytes"] == block_bytes(
        k3["tile"], k3["tile"], 64,
        M.mfsgd_geometry({"u_tile": k3["tile"],
                          "i_tile": k3["tile"]})["slots"], CLUSTER)
    assert M.presize("mfsgd.sgd_tile_update", rank=64, optin=1000)[
        "tile"] is None
    k7 = M.presize("rf.hist_bins")
    p = rf_kernel.plan(32, 200_000, 64, 32, 64, 1, H100_SMEM_OPTIN, H100_SMS)
    assert k7["plan"] == {"fs": p.fs, "tg": p.tg, "ns": p.ns,
                          "chunk": p.chunk, "nchunks": p.nchunks,
                          "smem": p.smem}
    assert M.presize("rf.hist_bins", n_node_classes=1 << 16)["plan"] is None
    with pytest.raises(RuntimeError, match="km::make_plan"):
        M.presize("kmeans.partials_int8", n=1_000_000, d=300, k=100,
                  device="cpu")
    with pytest.raises(KeyError, match="svm.kernel_row"):
        M.presize("svm.kernel_row", n=10, d=4)


# ---- the committed evidence -------------------------------------------------

def _evidence_rows():
    return [json.loads(ln) for ln in EVIDENCE.read_text().splitlines()
            if ln.strip()]


def test_every_evidence_row_is_the_card_s():
    rows = _evidence_rows()
    assert rows
    for r in rows:
        assert r["backend"] == "cuda", r
        assert r["device_name"].startswith("NVIDIA H100"), r
        assert r["power_limit_w"] and r["power_limit_w"] > 0, r
        assert r["commit"] and r["date"], r
    kinds = {r.get("kind") for r in rows}
    assert {None, "sweep", "overhead", "profile", "plan"} <= kinds


def test_predict_grade_passes_on_the_committed_evidence(capsys):
    assert PCLI.main(["--grade", "--repo", str(REPO)]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["ok"]
    agrees = {p["candidate"] for p in report["pairs"]
              if p["status"] in ("agrees", "too_close")}
    # the north star and Harp's two metrics: a graded pair each
    assert {"kmeans_int8", "mfsgd_pallas", "lda_pallas"} <= agrees
    assert {s["sweep"] for s in report["sweeps"]
            if s.get("rho") is not None} == set(G.SWEEPS)
    band = {m["config"] for m in report["magnitude"]}
    assert {"kmeans", "kmeans_int8", "kmeans_pallas", "mfsgd",
            "mfsgd_pallas", "lda", "lda_pallas"} <= band
    assert all(m["factor"] <= G.MAGNITUDE_TOL for m in report["magnitude"])


def test_an_inverted_model_fails_the_grade(monkeypatch, capsys):
    real = M.price

    def inverted(cfg, row=None, topo=None):
        p = real(cfg, row, topo)
        s = p.predicted_s
        return M.Price(cfg, p.metric, 0.0, 1.0 / (s * 1e6), 0.0, 0.0)

    monkeypatch.setattr(M, "price", inverted)
    assert PCLI.main(["--grade", "--repo", str(REPO)]) == 1
    err = capsys.readouterr().err
    assert "GRADE FAIL" in err and "candidate_terms" in err


def test_the_grade_fails_closed_without_evidence(tmp_path):
    report = G.grade(str(tmp_path))
    assert not report["ok"] and "no card bench rows" in \
        report["failures"][0]["what"]
    (tmp_path / G.EVIDENCE).write_text(json.dumps(
        {"config": "kmeans", "iters_per_sec": 1.0, "backend": "cpu"}) + "\n")
    assert not G.grade(str(tmp_path))["ok"]      # CPU rows never grade


def test_calibrated_constants_are_the_evidence_s():
    (probe,) = [r for r in _evidence_rows() if r.get("kind") == "overhead"]
    for key, v in FR.CALIBRATED_OVERHEADS.items():
        assert v == pytest.approx(probe[key], rel=0.01), key
    assert FR.calibrated_overheads() == FR.CALIBRATED_OVERHEADS
    assert FR.calibrated_overheads() is not FR.CALIBRATED_OVERHEADS


def test_provenance_reads_the_power_limit_or_none(monkeypatch):
    """``power_limit_w`` is nvidia-smi's ``power.limit`` once a process,
    and None (the row still made) when nvidia-smi is missing or fails."""
    import subprocess
    import types

    from harp_tpu_torch.utils import metrics

    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    for run, want in ((missing, None),
                      (lambda *a, **k: types.SimpleNamespace(
                          returncode=0, stdout="700.00\n"), 700.0),
                      (lambda *a, **k: types.SimpleNamespace(
                          returncode=9, stdout=""), None)):
        monkeypatch.setattr(metrics, "_POWER_LIMIT", [])
        monkeypatch.setattr(subprocess, "run", run)
        assert metrics.power_limit_w() == want
    assert "power_limit_w" not in metrics.provenance("cpu")
