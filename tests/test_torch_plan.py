"""``harp_tpu_torch.plan`` against harp_tpu's planner, and against the
runtime CommLedger it reads.

- ``Topology.wire_bytes``/``cost_s``/``hier_stage_cost_s`` and
  ``predicted_bytes`` are the reference's algebra: the same numbers on the
  same inputs (random from a seed), with equal link rates so the two
  vocabularies' topologies compare.
- The H100 vocabulary: four tags, declared NVLink/NDR rates, 80 GB a card,
  ``detect`` and ``probed`` on one worker.
- The sheet: each of the eleven driver programs run once under the ledger
  on 1 and on 4 gloo workers; every site's bytes are the ledger's (and
  hand-computed ones for KMeans, SVM and WDA-MDS); every decision is
  ``keep``; on ``single_card`` every wire prices 0; ``hier_psum`` is a
  candidate only across nodes (``h100_4x8``), never on one node.
- The CLI prints one stamped ``kind:"plan"`` row a program and exits 2 on
  an unknown one.
"""

import json

import numpy as np
import pytest

from harp_tpu.plan import planner as JP
from harp_tpu.plan import topology as JT
from harp_tpu_torch.plan import cli as PC
from harp_tpu_torch.plan import planner as P
from harp_tpu_torch.plan import topology as T
from harp_tpu_torch.parallel.mesh import WorkerMesh
from torch_plane_world import run_plan_cases, run_world, time_limit

PROGRAMS = ("kmeans.fit", "lda.epoch", "mfsgd.epoch", "rf.grow",
            "rf.grow_pallas", "serve.kmeans_assign", "subgraph.count",
            "svm.train", "svm.train_pallas", "wdamds.smacof",
            "wdamds.smacof_pallas")


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with time_limit(120):
        return run_world(run_plan_cases, tmp_path_factory.mktemp("plan"))


@pytest.fixture(scope="module")
def one():
    with time_limit(60):
        return run_plan_cases(0, 1)


def _pairs(n, g, rate):
    return (T.Topology("t", n, g, rate, rate),
            JT.Topology("t", n, g, rate, rate))


@pytest.mark.parametrize("n,g", [(1, 1), (4, 4), (8, 8), (8, 2), (32, 8)])
def test_topology_algebra_matches_the_reference(n, g):
    rng = np.random.default_rng(n * 100 + g)
    port, ref = _pairs(n, g, 45.0)
    for prim in ("psum", "pmax", "pmin", "all_gather", "all_to_all",
                 "ppermute", "reduce_scatter"):
        for b in rng.integers(1, 1 << 30, 8).tolist():
            amp = int(rng.integers(1, 5))
            assert port.wire_bytes(prim, b, amp) == ref.wire_bytes(prim, b,
                                                                   amp)
            assert port.cost_s(prim, b, amp) == ref.cost_s(prim, b, amp)
    for b in rng.integers(1, 1 << 30, 8).tolist():
        assert port.hier_stage_cost_s(b) == ref.hier_stage_cost_s(b)
    with pytest.raises(ValueError):
        port.wire_bytes("not_a_primitive", 8)


def test_predicted_bytes_match_the_reference():
    rng = np.random.default_rng(7)
    assert P.SCHEDULES == JP.SCHEDULES
    for s in P.SCHEDULES:
        for b in rng.integers(0, 1 << 40, 20).tolist():
            assert P.predicted_bytes(s, b) == JP.predicted_bytes(s, b)
    with pytest.raises(ValueError):
        P.predicted_bytes("nope", 1)


def test_the_h100_vocabulary():
    assert T.TOPOLOGY_NAMES == ("single_card", "sim_ring_8", "dgx_h100_8",
                                "h100_4x8")
    tops = {n: T.by_name(n) for n in T.TOPOLOGY_NAMES}
    assert {n: (t.n_workers, t.workers_per_host, t.hosts)
            for n, t in tops.items()} == {
        "single_card": (1, 1, 1), "sim_ring_8": (8, 8, 1),
        "dgx_h100_8": (8, 8, 1), "h100_4x8": (32, 8, 4)}
    # NVLink 4: 900 GB/s a card both ways; NDR: 400 Gb/s
    assert tops["dgx_h100_8"].intra_gbs == 450.0
    assert (tops["h100_4x8"].intra_gbs, tops["h100_4x8"].inter_gbs) == (
        450.0, 50.0)
    assert all(t.rates_source == "declared" for t in tops.values())
    assert all(T.hbm_bytes(n) == 80 * 10 ** 9 for n in T.TOPOLOGY_NAMES)
    assert T.hbm_bytes("sim_ring_4") == 80 * 10 ** 9
    # one ring step of 1 GB on one node: 1 GB / 450 GB/s; across nodes the
    # NDR link gates it
    assert tops["dgx_h100_8"].cost_s("ppermute", 10 ** 9) == 1 / 450.0
    assert tops["h100_4x8"].cost_s("ppermute", 10 ** 9) == 1 / 50.0
    assert tops["single_card"].cost_s("psum", 10 ** 9) == 0.0
    for tag in ("v4_32", "single_chip"):
        assert tag not in T.TOPOLOGY_NAMES


def test_detect_and_probed_on_one_worker():
    mesh = WorkerMesh("cpu")
    t = T.detect(mesh)
    assert t.name == "single_card"
    p = T.probed(t, mesh)
    assert (p.rates_source, p.intra_gbs) == ("declared", t.intra_gbs)
    assert "no link to probe" in p.note
    assert P.plan_sheet("x", {"collectives": []}, p).row()["note"] == p.note


def test_primitives_follow_the_reference_table():
    from harp_tpu.parallel.collective import PRIMITIVE_VERBS

    for verb, prim in P.VERB_PRIMITIVES.items():
        assert verb in PRIMITIVE_VERBS[prim], (verb, prim)
    assert P.primitive_of("allreduce", "max") == "pmax"
    assert P.primitive_of("allreduce", "multiply") == "all_gather"
    with pytest.raises(KeyError):
        P.primitive_of("teleport")


def _check_sheets(res, n_workers):
    for name in PROGRAMS:
        sheet = res["sheets"][name]
        ledger = {(tag, r["verb"], r["combiner"], r["wire_dtype"]):
                  r["payload_bytes"] for tag, rs in res["ledgers"][name].items()
                  for r in rs if r["calls"]}
        got = {(e["tag"], e["verb"], e["combiner"], e["wire_dtype"]):
               e["per_shard_bytes"] * e["amplification"]
               for e in sheet["collectives"]}
        assert got == pytest.approx(ledger), name
        plan = res["plans"][name]["single_card"]
        assert [s["sheet_bytes"] for s in plan["sites"]] == [
            e["payload_bytes"] for e in sheet["collectives"]]
        for topo, row in res["plans"][name].items():
            assert all(s["schedule"] == "keep" for s in row["sites"])
            assert row["predicted_bytes_total"] == sum(
                e["payload_bytes"] for e in sheet["collectives"])
        assert all(s["cost_s"] == 0.0 and not s["candidates"]
                   for s in plan["sites"]), name


def test_one_worker_sheets_are_the_ledgers(one):
    _check_sheets(one, 1)


def test_four_worker_sheets_are_the_ledgers(world):
    for res in world:
        _check_sheets(res, 4)
    assert not any(r["_jax_imported"] for r in world)


def _bytes(res, name, tag, verb):
    return [e for e in res["sheets"][name]["collectives"]
            if e["tag"] == tag and e["verb"] == verb]


@pytest.mark.parametrize("which", ["one", "world"])
def test_sheets_hold_hand_computed_bytes(which, request):
    res = request.getfixturevalue(which)
    res = res if which == "one" else res[0]
    # KMeans k=8, d=32: each Lloyd iteration allreduces the [8, 32] sums,
    # the 8 counts and the inertia, f32: 4 (256 + 8 + 1) = 1060 B, twice
    (km,) = _bytes(res, "kmeans.fit", "kmeans.fit", "allreduce")
    assert (km["calls"], km["per_shard_bytes"]) == (2, 1060.0)
    # WDA-MDS: each of 2 iterations reshards this worker's [4, 2] f32
    # coordinates (unweighted driver: 4 points a worker)
    (md,) = _bytes(res, "wdamds.smacof", "wdamds.mds", "reshard")
    assert (md["calls"], md["per_shard_bytes"]) == (2, 32.0)
    # the pallas driver: 16 points a worker
    (mp,) = _bytes(res, "wdamds.smacof_pallas", "wdamds.mds", "reshard")
    assert (mp["calls"], mp["per_shard_bytes"]) == (2, 128.0)
    # the serve step has no collective
    assert res["sheets"]["serve.kmeans_assign"]["collectives"] == []


def test_hier_psum_wins_only_across_nodes(world):
    res = world[0]
    sites = {t: res["plans"]["kmeans.fit"][t]["sites"][0]
             for t in ("sim_ring_8", "h100_4x8")}
    assert "hier_psum" not in sites["sim_ring_8"]["candidates"]
    assert sites["h100_4x8"]["candidates"]["hier_psum"] == \
        'psum_schedule="hier" on kmeans.fit'
    assert sites["h100_4x8"]["flip_candidate"] == \
        'psum_schedule="hier" on kmeans.fit'
    assert sites["h100_4x8"]["alternatives"]["hier_psum"] < \
        sites["h100_4x8"]["cost_s"]
    # rotation hops on 4 workers: MF-SGD and LDA move their chunks with
    # the rotation pipeline's reshard, and a narrow wire is a candidate
    for name, knob in (("mfsgd.epoch", 'rotate_wire="bf16" on '
                        "mfsgd.benchmark"),
                       ("lda.epoch", 'rotate_wire="bf16" on lda.benchmark')):
        (hop,) = [s for s in res["plans"][name]["sim_ring_8"]["sites"]
                  if s["verb"] == "reshard"]
        assert hop["primitive"] == "all_to_all" and hop["sheet_bytes"] > 0
        assert hop["candidates"]["wire_bf16"] == knob


def test_decide_site_matches_the_reference_on_a_shared_sheet():
    """The same sheet entry through both deciders on equal topologies:
    the same costs, alternatives and keep (the knobs differ by design)."""
    rng = np.random.default_rng(3)
    port, ref = _pairs(8, 4, 25.0)
    for verb, prim in (("allreduce", "psum"), ("rotate", "ppermute"),
                       ("regroup", "all_to_all"), ("push", "reduce_scatter"),
                       ("allgather", "all_gather")):
        b = int(rng.integers(1 << 10, 1 << 28))
        entry = {"site": "s", "primitive": prim, "verb": verb,
                 "per_shard_bytes": b, "amplification": 3}
        d = P.decide_site("x", entry, port)
        r = JP.decide_site("x", entry, ref)
        assert (d.sheet_bytes, d.schedule, d.predicted_bytes) == (
            r.sheet_bytes, r.schedule, r.predicted_bytes)
        assert d.cost_s == pytest.approx(r.cost_s, rel=1e-12)
        assert d.alternatives == pytest.approx(r.alternatives, rel=1e-12)


def test_cli_rows_and_unknown_program(capsys):
    assert PC.main(["kmeans.fit", "svm.train", "--device", "cpu",
                    "--json", "--topology", "h100_4x8"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["program"] for r in rows] == ["kmeans.fit", "svm.train"]
    assert all(r["kind"] == "plan" and r["backend"] == "cpu"
               and r["topology"] == "h100_4x8" and r["commit"] is not None
               for r in rows)
    assert PC.main(["nope", "--device", "cpu"]) == 2
