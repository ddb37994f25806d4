"""The port's request tracer and streaming percentiles
(``utils/reqtrace.py``, ``utils/perfetto.py``) against harp_tpu's.

- ``LogHist`` and ``RollingWindow`` on one sample stream: the same
  quantiles and windowed snapshots, each quantile within the documented
  bucket error of the exact one.
- ``ReqTracer`` on one sequence of request and batch events: the same
  rows, the same Perfetto JSON, the same summary; the ``trace`` CLI.
- A continuous serving run with tracing on: every offered request ends in
  exactly one outcome, reconciled with the runner's counts.
"""

import json
import math

import numpy as np
import pytest

from harp_tpu.utils import reqtrace as JR
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.serve.engines import KMeansAssign
from harp_tpu_torch.serve.server import Server
from harp_tpu_torch.utils import reqtrace as PR
from harp_tpu_torch.utils import telemetry as PT
from torch_world import time_limit


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


def _samples(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.lognormal(0.0, 1.2, n),
                          np.zeros(20), [1e-4, 5e6]])
    t = np.sort(rng.uniform(0.0, 180.0, lat.size))
    return t, lat


def test_loghist_quantiles_match_the_reference_and_the_bound():
    t, lat = _samples()
    hj, hp = JR.LogHist(), PR.LogHist()
    for v in lat:
        hj.add(float(v))
        hp.add(float(v))
    assert hp.counts == hj.counts and hp.total == hj.total
    arr = np.sort(lat)
    for p in (1, 50, 90, 95, 99, 99.9):
        assert hp.quantile(p) == hj.quantile(p)
        exact = arr[max(1, math.ceil(p / 100 * arr.size)) - 1]
        if JR.LogHist().lo < exact < 1e3:
            assert abs(hp.quantile(p) - exact) <= \
                PR.QUANTILE_REL_ERR * exact * (1 + 1e-9)
    assert PR.QUANTILE_REL_ERR == JR.QUANTILE_REL_ERR
    assert PR.LogHist().quantile(50) is None


@pytest.mark.parametrize("window_s,sub", [(60.0, 6), (10.0, 4), (5.0, 1)])
def test_rolling_window_snapshots_match_the_reference(window_s, sub):
    t, lat = _samples(1, 3000)
    wj = JR.RollingWindow(window_s=window_s, subwindows=sub)
    wp = PR.RollingWindow(window_s=window_s, subwindows=sub)
    snaps = []
    for i, (ts, v) in enumerate(zip(t, lat)):
        for w in (wj, wp):
            w.add_latency(float(ts), float(v))
            w.add_qdepth(float(ts), float(i % 37))
        if i % 250 == 0:
            snaps.append((wj.snapshot(float(ts)), wp.snapshot(float(ts))))
    snaps.append((wj.snapshot(400.0), wp.snapshot(400.0)))  # all expired
    for a, b in snaps:
        assert a == b
    assert snaps[-1][1]["samples"] == 0 and snaps[-1][1]["p99_ms"] is None


def _trace(mod, tel):
    """One scripted timeline: arrivals, batches, every outcome, marks."""
    with tel.scope(True):
        tr = mod.tracer
        rids = [mod.arrive(0.001 * i, transport="tcp", seq=i)
                for i in range(6)]
        for i, r in enumerate(rids[:5]):
            tr.event(r, "admit", 0.001 * i + 0.0002, rows=i + 1)
        tr.batch(0, 0.004, rung=8, rows=6,
                 members=[(rids[0], 0, 1), (rids[1], 0, 2), (rids[2], 0, 3)])
        tr.batch_event(0, "retry", 0.0045, attempt=1, error="boom")
        tr.batch_event(0, "dispatch", 0.005)
        tr.batch(1, 0.006, rung=1, rows=1, members=[(rids[3], 0, 1)])
        tr.batch_event(1, "engine_failure", 0.007, error="dead")
        tr.end(rids[3], "failed", 0.007, reason="engine_failure")
        tr.batch_event(0, "readback", 0.008)
        for r in rids[:3]:
            tr.end(r, "served", 0.008, latency_ms=1.0)
            tr.event(r, "deliver", 0.0085)
        tr.end(rids[4], "shed", 0.009, reason="deadline")
        tr.end(rids[4], "served", 0.010)  # outcomes never flip
        tr.mark("fault", "injected_fail", 0.0045, site="dispatch",
                ordinal=1)
        rows = tr.rows()
        with pytest.raises(ValueError, match="outcome"):
            tr.end(rids[5], "lost", 0.02)
        return (rows, tr.summary(), tr.batch_event_count("retry"),
                mod.summarize_rows(rows), mod.perfetto(rows))


def test_request_trace_matches_the_reference():
    ref = _trace(JR, JT)
    got = _trace(PR, PT)
    assert got == ref
    rows, summary, retries, file_summary, pft = got
    assert summary == {"requests": 6, "open": 1, "batches": 2, "served": 3,
                       "shed": 1, "failed": 1}
    # the open span has a request row, with no outcome yet
    assert retries == 1 and file_summary["bad_outcomes"] == [6]
    assert [r["ts"] for r in rows] == sorted(r["ts"] for r in rows)
    assert {e["ph"] for e in pft["traceEvents"]} == {"M", "X", "i"}


def test_tracing_is_free_while_off():
    with PT.scope(False):
        assert PR.arrive(0.0) is None
        PR.tracer.batch(0, 0.0, rung=1, rows=1, members=[])
        PR.tracer.mark("fault", "x", 0.0)
    assert PR.tracer.rows() == []


def test_trace_cli_validates_an_export(tmp_path, capsys):
    with PT.scope(True):
        rid = PR.arrive(0.0)
        PR.tracer.end(rid, "served", 0.002)
        PT.export(str(tmp_path / "ok.jsonl"))
        PR.arrive(0.003)  # left open
        PT.export(str(tmp_path / "open.jsonl"))
    assert PR.main([str(tmp_path / "ok.jsonl"), "--perfetto",
                    str(tmp_path / "t.json"), "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["served"] == 1 and row["config"] == "trace"
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert PR.main([str(tmp_path / "open.jsonl")]) == 1
    assert "1 unknown outcome" in capsys.readouterr().err
    assert PR.main([str(tmp_path / "missing.jsonl")]) == 2


def test_a_traced_serving_run_reconciles_every_request():
    rng = np.random.default_rng(9)
    state = KMeansAssign.synthetic_state(rng, k=4, d=8)
    with PT.scope(True):
        srv = Server("kmeans", state, mesh=WorkerMesh("cpu"), ladder=(1, 8))
        srv.startup()
        runner = srv.make_runner(clock=lambda: 0.0, max_queue_rows=12,
                                 deadline_s=0.01)
        for i in range(20):
            runner.submit(i, srv.engine.synthetic_request(rng, 1 + i % 5),
                          now=0.001 * i)
            if i % 4 == 0:
                runner.step(0.001 * i)
        runner.drain(0.05)
        summary = PR.summarize_rows(PR.tracer.rows())
        counts = dict(PR.tracer.counts)
    assert summary["unterminated"] == [] and summary["requests"] == 20
    assert counts == {"served": runner.completed, "shed": runner.shed,
                      "failed": runner.failed}
    assert runner.shed > 0 and runner.completed > 0
