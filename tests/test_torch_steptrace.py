"""The superstep timeline (``harp_tpu_torch/utils/steptrace.py``) against
harp_tpu's.

- Its vocabularies, run/superstep/mark mechanics, ``summarize_rows`` and
  the Perfetto conversion are the reference's (the same rows give the same
  summary and trace events).
- ``fit_epochs`` with a ``ckpt_write`` fault gives the reference's
  timeline structure — runs, supersteps and their outcomes, the fault and
  checkpoint marks, the set of mark sources (times excluded) — in one
  process and on every rank of a spawned 4-worker gloo world.
- On that world KMeans's fit is one run of one superstep with one
  dispatch mark per its flight counters and a skew lane of each worker's
  points, as the reference's on four devices; MF-SGD's fit is a superstep
  an epoch; ``export_timeline`` merges the spines; nothing is observed and
  the result is bit-equal while telemetry is off.
- The ``timeline`` CLI exits 0 on a clean export, 1 on an unterminated
  run and 2 on an unreadable file.
"""

import json

import jax
import numpy as np
import pytest

from harp_tpu.models import kmeans as JKM
from harp_tpu.models import mfsgd as JMF
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import fault as JF
from harp_tpu.utils import steptrace as JST
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch.utils import fault, memrec, steptrace, telemetry
from torch_plane_world import (WORLD, kmeans_points, run_steptrace_cases,
                               run_world, steptrace_structure, time_limit,
                               toy_fit_epochs)


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(90):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("steptrace")
    return run_world(run_steptrace_cases, root, str(root))


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


def test_vocabularies_are_the_references():
    for name in ("OUTCOMES", "EVS", "SOURCES", "FLIGHT_KEYS"):
        assert getattr(steptrace, name) == getattr(JST, name), name


def _unit_rows(mod, tel):
    with tel.scope(True):
        with mod.run("unit.phase"):
            for i in range(3):
                with mod.superstep("unit.phase", i):
                    mod.tracer.mark("wire", "allreduce")
        try:
            with mod.run("unit.fail"):
                with mod.superstep("unit.fail", 0):
                    raise RuntimeError("boom")
        except RuntimeError:
            pass
        with mod.run("outer"):
            with mod.run("inner"):
                with mod.superstep("outer", 0):
                    with mod.superstep("inner", 99):
                        pass
        mod.tracer.on_elastic("resume", "outer")  # outside a run: dropped
        return mod.tracer.rows()


def _no_times(rows):
    return [{k: v for k, v in r.items() if k not in ("ts", "t0")}
            for r in rows]


def test_run_superstep_and_mark_rows_are_the_references():
    ours, theirs = _unit_rows(steptrace, telemetry), _unit_rows(JST, JT)
    assert _no_times(ours) == _no_times(theirs)
    assert [r["ts"] for r in ours] == sorted(r["ts"] for r in ours)
    assert steptrace.summarize_rows(ours) | {"step_p50_ms": 0} == \
        JST.summarize_rows(ours) | {"step_p50_ms": 0}
    spans = [r for r in ours if r["ev"] == "superstep"]
    assert [s["outcome"] for s in spans] == ["completed"] * 3 + [
        "faulted", "completed"]


def test_perfetto_is_the_references():
    rows = _unit_rows(steptrace, telemetry)
    assert steptrace.perfetto(rows) == JST.perfetto(rows)
    assert steptrace.perfetto([]) == JST.perfetto([])


def _reference_toy(tmp_path):
    with JT.scope(True):
        inj = JF.FaultInjector(fail={"ckpt_write": (2,)})
        with inj.arm():
            x = toy_fit_epochs(JF.fit_epochs, inj, str(tmp_path / "ref"))
        return x, steptrace_structure(JST.tracer.rows())


def test_fit_epochs_timeline_is_the_references(tmp_path, world):
    x_ref, ref = _reference_toy(tmp_path)
    with telemetry.scope(True):
        inj = fault.FaultInjector(fail={"ckpt_write": (2,)})
        with inj.arm():
            x = toy_fit_epochs(fault.fit_epochs, inj, str(tmp_path / "port"))
        ours = steptrace_structure(steptrace.tracer.rows())
    assert ours == ref
    np.testing.assert_array_equal(x, x_ref)
    assert ("fault", "injected_fail") in ours["marks"]
    assert ("ckpt", "restore") in ours["marks"]
    for r in world:  # every rank of the 4-worker world
        assert r["toy"] == ref
        np.testing.assert_array_equal(r["toy_x"], x_ref)
        # the fault hit the save after a completed epoch: that epoch runs
        # again, so five supersteps complete
        assert r["toy_summary"]["completed"] == 5
        assert not r["toy_summary"]["unterminated"]


def test_kmeans_fit_is_one_superstep_with_a_lane_per_worker(world, jmesh4):
    pts = kmeans_points()
    with JT.scope(True):
        JKM.fit(pts, k=8, iters=3, mesh=jmesh4)
        jrows = JST.tracer.rows()
    jsum = JST.summarize_rows(jrows)
    jlanes = [r["work"] for r in jrows if r.get("ev") == "lane"]
    for r in world:
        s = r["kmeans"]["summary"]
        for key in ("runs", "supersteps", "completed", "faulted",
                    "rebalanced", "resumed", "lanes"):
            assert s[key] == jsum[key], key
        assert s["dispatch_mismatch"] == [] and s["unterminated"] == []
        assert r["kmeans"]["lanes"] == jlanes
        assert r["kmeans"]["lanes"] == [[len(pts) / WORLD] * WORLD]
        assert r["kmeans"]["run"]["flight"]["dispatches"] == 1
        assert r["kmeans"]["run"]["flight"]["readbacks"] == 1
        assert r["timeline_kinds"] == ["steptrace", "trace"]


def test_mfsgd_fit_is_a_superstep_an_epoch(world, jmesh4):
    u, i, v = JMF.synthetic_ratings(64, 48, 900, rank=3, seed=0)
    with JT.scope(True):
        m = JMF.MFSGD(64, 48, JMF.MFSGDConfig(rank=4, algo="dense", u_tile=8,
                                               i_tile=8, entry_cap=16),
                      jmesh4, 0)
        m.set_ratings(u, i, v)
        m.fit(2)
        jsum = JST.summarize_rows(JST.tracer.rows())
    for r in world:
        s = r["mfsgd"]["summary"]
        for key in ("runs", "supersteps", "completed", "faulted", "lanes"):
            assert s[key] == jsum[key], key
        assert s["dispatch_mismatch"] == []
        assert r["mfsgd"]["flight"]["dispatches"] == 2
        assert r["mfsgd"]["flight"]["readbacks"] == 2


def test_nothing_is_observed_while_telemetry_is_off(world):
    for r in world:
        assert r["off"] == {"observers": 0, "open_run": False, "same": True}


def test_memory_marks_ride_the_superstep():
    with telemetry.scope(True):
        memrec.on_staged(1024, "x")
        with steptrace.run("p"):
            with steptrace.superstep("p", 0):
                memrec.on_staged(2048, "y")
        rows = steptrace.tracer.rows()
    marks = [r for r in rows if r["ev"] == "mark"]
    assert [(m["source"], m["name"]) for m in marks] == [
        ("memory", "superstep_peak")]
    assert marks[0]["peak_hbm_bytes"] == 3072


def test_the_timeline_cli(tmp_path, capsys):
    from harp_tpu_torch import __main__ as cli

    with telemetry.scope(True):
        _unit_rows(steptrace, telemetry)
        path = tmp_path / "run.jsonl"
        telemetry.export(str(path))
    out = tmp_path / "p.json"
    assert cli.main(["timeline", str(path), "--perfetto", str(out)]) == 0
    assert "== harp-tpu training timeline ==" in capsys.readouterr().out
    assert set(json.loads(out.read_text())) == {"traceEvents",
                                                 "displayTimeUnit"}
    assert cli.main(["timeline", str(path), "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    assert row["config"] == "timeline" and row["runs"] == 3
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "steptrace", "ev": "superstep",
                               "run": 9, "seq": 0, "step": 0,
                               "outcome": "completed", "t0": 0.0,
                               "ts": 1.0}) + "\n")
    assert cli.main(["timeline", str(bad)]) == 1
    assert cli.main(["timeline", str(tmp_path / "missing.jsonl")]) == 2
