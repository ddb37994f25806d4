"""Elastic training (``harp_tpu_torch/elastic``) against harp_tpu's.

- Packs, IdRemap, the survivors' repartition (``replay_repartition``) and
  the per-worker grains are bit-equal to the reference's on seeded
  inputs; the elastic ledger keeps the reference's vocabulary.
- The sentinel↔trainer handshake: a latched ``skew_trigger`` is taken
  exactly once, re-arms on recovery, and is a no-op with telemetry off;
  the fired plan is the reference's.
- On a spawned 4-worker gloo world, beside the reference's drills on four
  devices from the same initial factors:
  - the reshard-verb row move is bit-equal to the host gather;
  - the MF-SGD and LDA skew drills fire, are taken once, and rebalance
    below the trigger threshold; the elastic rows (loads before/after,
    wasted_frac, moves) are the reference's exactly; MF-SGD's factors are
    within rtol 1e-4 / atol 1e-5 of the reference's and its RMSE within
    1 % of the plain run; LDA's token counts are exact and its
    log-likelihood within 0.05 of the plain run (its generator is the
    port's own);
  - the worker-loss drills shrink 4 → 3 workers, the lost worker sits
    out, and the survivors resume bit-equal to a survivors-only run from
    the same checkpoint; MF-SGD's rows and factors agree with the
    reference's (rtol 1e-4 / atol 1e-5);
  - streaming KMeans's home layout is ``fit_streaming`` bit for bit, and
    an uneven layout and a worker loss keep its inertia within rel 1e-5.
"""

import json

import jax
import numpy as np
import pytest

from harp_tpu import health as JH
from harp_tpu.elastic import ledger as JEL
from harp_tpu.elastic import apps as JA
from harp_tpu.elastic.rebalance import IdRemap as JIdRemap
from harp_tpu.elastic.rebalance import Packs as JPacks
from harp_tpu.elastic.rebalance import pack_units as j_pack_units
from harp_tpu.elastic.rebalance import replay_repartition as j_replay
from harp_tpu.models.lda import LDAConfig as JLDAConfig
from harp_tpu.models.mfsgd import MFSGDConfig as JMFConfig
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import skew as JS
from harp_tpu.utils import telemetry as JT
from harp_tpu.utils.fault import FaultInjector as JFI
from harp_tpu_torch import health
from harp_tpu_torch import elastic as E
from harp_tpu_torch.elastic import ledger as eledger
from harp_tpu_torch.elastic.rebalance import (IdRemap, Packs, pack_units,
                                              replay_repartition, wasted_frac)
from harp_tpu_torch.utils import skew, telemetry
from torch_plane_world import (LDA_KW, LOSS_EPOCHS, LOST, MF_KW, SKEW_EPOCHS,
                               WORLD, ledger_fields, run_elastic_cases,
                               run_world, skewed_corpus, skewed_ratings,
                               stream_points, time_limit, uniform_ratings)

RTOL, ATOL = 1e-4, 1e-5
SUMMARY_KEYS = ("source", "unit", "work", "total", "n_workers",
                "max_mean_ratio", "wasted_frac", "runs")


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


def _copy(st: dict) -> dict:
    return {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in st.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's drills on four devices, and the initial canonical
    states the port's adapters start from."""
    root = tmp_path_factory.mktemp("elastic-ref")
    jm = JaxMesh(jax.devices()[:WORLD])
    cfg = JMFConfig(**MF_KW)
    out, starts = {}, {}
    u, i, v = skewed_ratings()
    with JT.scope(True):
        ad = JA.MFSGDElastic(64, 48, cfg, jm, 0, users=u, items=i, vals=v,
                             packs_per_worker=8)
        starts["mf_skew"] = _copy(ad.canonical_state())
        JA.elastic_fit(ad, SKEW_EPOCHS)
        out["mf_skew_rows"] = ledger_fields(JEL.ledger.rows)
        out["mf_skew_after"] = JS.ledger.summary()["mfsgd.epochs"]
        out["mf_skew_state"] = _copy(ad.canonical_state())
    d, w = skewed_corpus()
    with JT.scope(True):
        la = JA.LDAElastic(64, 64, JLDAConfig(**LDA_KW), jm, 0, doc_ids=d,
                           word_ids=w, packs_per_worker=8)
        JA.elastic_fit(la, SKEW_EPOCHS)
        out["lda_skew_rows"] = ledger_fields(JEL.ledger.rows)
        out["lda_skew_after"] = JS.ledger.summary()["lda.epochs"]
    lu, li, lv = uniform_ratings(1)
    with JT.scope(True):
        inj = JFI(seed=0, permanent={"dispatch": (2,)}, lost_worker=LOST)
        ad = JA.MFSGDElastic(64, 48, cfg, jm, 0, users=lu, items=li,
                             vals=lv, max_worker_loss=1)
        starts["mf_loss"] = _copy(ad.canonical_state())
        JA.elastic_fit(ad, LOSS_EPOCHS, str(root / "ck"), ckpt_every=1,
                       fault=inj, rebalance=False)
        out["mf_loss_rows"] = ledger_fields(JEL.ledger.rows)
        out["mf_loss_state"] = _copy(ad.canonical_state())
    inj = JFI(seed=0, permanent={"dispatch": (3,)}, lost_worker=2)
    kc = JA.KMeansStreamElastic(stream_points(), 4, jm, 0, max_worker_loss=1)
    JA.elastic_fit(kc, 3, str(root / "ck-ks"), fault=inj)
    out["ks_loss"] = kc.metric()
    return {"starts": starts, **out}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic-world")
    return run_world(run_elastic_cases, root, str(root), ref["starts"],
                     timeout=110)


# ---------------------------------------------------------------------------
# Packs / IdRemap / the survivors' repartition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_ids,n_home,per_worker",
                         [(64, 8, 2), (61, 8, 3), (100, 3, 4), (7, 4, 1)])
def test_packs_match_the_reference(n_ids, n_home, per_worker):
    a, b = Packs(n_ids, n_home, per_worker), JPacks(n_ids, n_home,
                                                    per_worker)
    assert a.ranges == b.ranges and a.n_packs == b.n_packs
    ids = np.random.default_rng(0).integers(0, n_ids, 500)
    np.testing.assert_array_equal(a.pack_of(ids), b.pack_of(ids))
    np.testing.assert_array_equal(a.loads(ids), b.loads(ids))
    np.testing.assert_array_equal(a.home_assignment(), b.home_assignment())
    rm = IdRemap(a, a.home_assignment(), n_home)
    if n_ids % n_home == 0 and (n_ids // n_home) % per_worker == 0:
        np.testing.assert_array_equal(rm.fwd, np.arange(n_ids))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idremap_and_replay_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    packs, jpacks = Packs(61, 8, 3), JPacks(61, 8, 3)
    asg = rng.integers(0, 5, packs.n_packs)
    rm, jrm = IdRemap(packs, asg, 5), JIdRemap(jpacks, asg, 5)
    np.testing.assert_array_equal(rm.fwd, jrm.fwd)
    np.testing.assert_array_equal(rm.inv, jrm.inv)
    assert (np.sort(rm.inv[rm.fwd]) == np.arange(61)).all()
    np.testing.assert_array_equal(rm.fwd // rm.bound,
                                  asg[packs.pack_of(np.arange(61))])
    loads = rng.integers(1, 50, packs.n_packs).astype(np.float64)
    got, plan = replay_repartition(packs, loads, asg, 3, "p")
    want, jplan = j_replay(jpacks, loads, asg, 3, "p")
    np.testing.assert_array_equal(got, want)
    assert plan == jplan
    assert pack_units(asg, loads, 5) == j_pack_units(asg, loads, 5)
    assert wasted_frac(loads) == pytest.approx(
        1 - loads.mean() / loads.max(), abs=0)


# ---------------------------------------------------------------------------
# The handshake and the ledger
# ---------------------------------------------------------------------------

def _fire(mod, phase="p", units=None):
    for _ in range(health.TRIGGER_SUPERSTEPS):
        mod.record_execution(phase, [10, 2, 2, 2], unit="u", units=units)


def test_consume_skew_trigger_exactly_once_then_rearms():
    with telemetry.scope(True):
        assert health.monitor.consume_skew_trigger("p") is None
        _fire(skew)
        row = health.monitor.consume_skew_trigger("p")
        assert row is not None and row["detector"] == "skew_trigger"
        assert row["consumed"] is True
        assert health.monitor.consume_skew_trigger("p") is None
        skew.record_execution("p", [10, 2, 2, 2], unit="u")
        assert health.monitor.consume_skew_trigger("p") is None
        skew.record_execution("p", [4, 4, 4, 4], unit="u")
        _fire(skew)
        assert health.monitor.consume_skew_trigger("p") is not None
        assert health.monitor.consume_skew_trigger("p") is None


def test_consume_skew_trigger_is_a_no_op_with_telemetry_off():
    with telemetry.scope(True):
        _fire(skew)
    assert not telemetry.enabled()
    assert health.monitor.consume_skew_trigger("p") is None


def test_whole_unit_trigger_plans_match_the_reference():
    units = [[("a", 6.0), ("b", 4.0)], [("c", 2.0)], [("d", 2.0)],
             [("e", 2.0)]]
    from harp_tpu_torch import schedule

    with telemetry.scope(True):
        _fire(skew, "pu", units=units)
        plan = health.monitor.consume_skew_trigger("pu")["plan"]
    with JT.scope(True):
        _fire(JS, "pu", units=units)
        jplan = JH.monitor.consume_skew_trigger("pu")["plan"]
    assert plan == jplan and all("id" in m for m in plan["moves"])
    new = schedule.apply_rebalance([["a", "b"], ["c"], ["d"], ["e"]], plan)
    assert sorted(x for lst in new for x in lst) == list("abcde")


def test_elastic_ledger_vocabulary_and_export(tmp_path):
    assert E.EVENTS == JEL.EVENTS
    eledger.ledger.reset()
    with pytest.raises(ValueError, match="event"):
        eledger.record("grow", "p")
    row = eledger.record("shrink", "p", lost_worker=1, site="dispatch",
                         ordinal=2, n_workers_before=8, n_workers_after=7,
                         capacity_frac=0.875)
    assert row["on_timeline"] is False
    with telemetry.scope(True):
        eledger.record("resume", "p", n_workers=3)
        path = tmp_path / "e.jsonl"
        telemetry.export(str(path))
    rows = telemetry.load_rows(str(path))["elastic"]
    assert [r["event"] for r in rows] == ["resume"]
    assert rows[0]["backend"] == "cpu"
    eledger.ledger.reset()


# ---------------------------------------------------------------------------
# On four workers
# ---------------------------------------------------------------------------

def test_regather_rows_is_the_host_gather(world):
    host = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    rows = np.array([5, -1, 0, 31, 7, 7, -1, 2] * 5, np.int64)
    want = np.where((rows >= 0)[:, None], host[np.maximum(rows, 0)], 0.0)
    for r in world:
        np.testing.assert_array_equal(r["regather"], want)
        assert r["regather_bytes"] > 0
        assert "multiple of 4" in r["regather_refused"]


def _state_close(got, want):
    for k in ("W", "H"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def test_mfsgd_skew_drill_rebalances_below_threshold(world, ref):
    for r in world:
        assert r["mf_wasted_home"] > health.WASTED_FRAC_TRIGGER
        assert r["mf_skew_rows"] == ref["mf_skew_rows"]
        (row,) = r["mf_skew_rows"]
        assert row["event"] == "rebalance"
        assert row["wasted_frac_after"] < health.WASTED_FRAC_TRIGGER
        assert sum(row["loads_after"]) == sum(row["loads_before"])
        after = r["mf_skew_after"]
        assert {k: after[k] for k in SUMMARY_KEYS} == {
            k: ref["mf_skew_after"][k] for k in SUMMARY_KEYS}
        assert after["wasted_frac"] < health.WASTED_FRAC_TRIGGER
        np.testing.assert_array_equal(r["mf_skew_state"]["assignment"],
                                      ref["mf_skew_state"]["assignment"])
        _state_close(r["mf_skew_state"], ref["mf_skew_state"])
        assert abs(r["mf_skew_rmse"] - r["mf_plain_rmse"]) \
            / r["mf_plain_rmse"] < 0.01


def test_lda_skew_drill_rebalances_below_threshold(world, ref):
    d, w = skewed_corpus()
    for r in world:
        assert r["lda_skew_rows"] == ref["lda_skew_rows"]
        assert r["lda_skew_rows"][0]["wasted_frac_after"] \
            < health.WASTED_FRAC_TRIGGER
        after = r["lda_skew_after"]
        assert {k: after[k] for k in SUMMARY_KEYS} == {
            k: ref["lda_skew_after"][k] for k in SUMMARY_KEYS}
        np.testing.assert_array_equal(r["lda_skew_counts"],
                                      np.bincount(d, minlength=64))
        np.testing.assert_array_equal(r["lda_skew_words"],
                                      np.bincount(w, minlength=64))
        assert abs(r["lda_skew_ll"] - r["lda_plain_ll"]) < 0.05


def test_rebalance_refused_when_packs_are_too_coarse(world):
    for r in world:
        assert r["coarse_plan"] is None and r["coarse_same"]
        assert r["coarse_rows"] == [] and r["coarse_again"] is None


def test_home_layout_is_the_plain_fit_bitwise(world):
    assert all(r["home_equal"] for r in world)


def test_mfsgd_worker_loss_drill_is_bit_equal_to_the_survivors_run(world,
                                                                   ref):
    assert [r["sat_out"] for r in world] == [w == LOST
                                             for w in range(WORLD)]
    for w, r in enumerate(world):
        assert r["mf_loss_fired"]
        assert r["mf_loss_rows"][0] == ref["mf_loss_rows"][0]  # the shrink
        if w == LOST:
            continue
        assert r["mf_loss_rows"] == ref["mf_loss_rows"]
        assert [x["event"] for x in r["mf_loss_rows"]] == ["shrink",
                                                           "resume"]
        assert r["mf_loss_n"] == WORLD - 1
        assert r["mf_loss_export"] == ["shrink", "resume"]
        assert r["mf_loss_bitequal"]
        _state_close(r["mf_loss_state"], ref["mf_loss_state"])


def test_lda_worker_loss_drill_is_bit_equal_to_the_survivors_run(world):
    from torch_plane_world import uniform_corpus

    d, w = uniform_corpus()
    for rank, r in enumerate(world):
        assert r["lda_loss_sat_out"] == (rank == 1)
        if rank == 1:
            continue
        assert r["lda_loss_n"] == WORLD - 1 and r["lda_loss_bitequal"]
        np.testing.assert_array_equal(r["lda_loss_docs"],
                                      np.bincount(d, minlength=48))
        np.testing.assert_array_equal(r["lda_loss_words"],
                                      np.bincount(w, minlength=48))


def test_loss_budget_and_fault_without_ckpt_fail_loudly(world):
    for r in world:
        assert "permanent loss of worker 0" in r["budget_exhausted"]
        assert "requires ckpt_dir" in r["fault_without_ckpt"]


def test_kmeans_stream_elastic_matches_plain_and_survives(world, ref):
    for rank, r in enumerate(world):
        got, want, same = r["ks_home"]
        assert same and got == want
        assert r["ks_uneven"] == pytest.approx(want, rel=1e-5)
        if rank == 2:
            assert r["ks_loss"] is None  # the lost worker sat out
            continue
        inertia, n = r["ks_loss"]
        assert n == WORLD - 1
        assert inertia == pytest.approx(want, rel=1e-5)
        assert inertia == pytest.approx(ref["ks_loss"], rel=1e-5)


def test_report_grows_an_elastic_section():
    from harp_tpu_torch import report

    with telemetry.scope(True):
        eledger.record("rebalance", "p", n_workers=4, moves=2,
                       loads_before=[9.0, 1.0, 1.0, 1.0],
                       loads_after=[3.0, 3.0, 3.0, 3.0], total=12.0,
                       wasted_frac_before=0.6667, wasted_frac_after=0.0,
                       trigger_supersteps=3)
        row, _ = report.live_report()
        assert row["elastic"]["by_event"] == {"rebalance": 1}
        text = report.render(row)
    assert "elastic (actions)" in text and "[rebalance]" in text
    eledger.ledger.reset()


@pytest.mark.parametrize("app,args", [
    ("mfsgd", ["--elastic", "--max-worker-loss", "1", "--users", "64",
               "--items", "32", "--nnz", "800", "--rank", "4", "--epochs",
               "2", "--u-tile", "16", "--i-tile", "16"]),
    ("lda", ["--elastic", "--docs", "32", "--vocab", "24", "--topics", "4",
             "--tokens-per-doc", "6", "--epochs", "2", "--algo", "dense",
             "--d-tile", "8", "--w-tile", "8", "--entry-cap", "16"]),
    ("kmeans-stream", ["--elastic", "--n", "512", "--d", "4", "--k", "2",
                       "--iters", "2"]),
])
def test_the_elastic_clis_run(app, args, tmp_path, capsys):
    from harp_tpu_torch import __main__ as cli

    argv = [app, *args, "--ckpt-dir", str(tmp_path / "ck"), "--device",
            "cpu"]
    assert (cli.main(argv) or 0) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["config"] == f"{app.replace('-', '_')}_elastic_cli"
    assert row["n_workers"] == 1 and row["worker_losses"] == 0
    assert row["backend"] == "cpu"
