"""The port's health sentinel (``health/sentinel.py``) against harp_tpu's.

- ``SLOBurn`` on one outcome stream (a clean stretch, a cliff of sheds and
  failures, deadline misses, latency over the objective, recovery): the
  same burn rates, breaches, peaks, snapshots and findings.
- The monitor's budget-drift and memory-pressure detectors on the same
  observations: the same rows and summaries; the export's rows.
- The skew trigger and its handshake on the same records: the
  reference's finding and the row the elastic loop takes.
- The ``health`` CLI's summary of an export (exit 0 healthy, 1
  actionable, 2 unreadable) is the reference's.  Its grading: fresh bench
  and profile rows against the committed ``H100_EVIDENCE.jsonl``
  (``confirmed`` exits 0; ``regressed`` and ``model_invalidated`` exit 1;
  ``--no-grade-bench`` skips), the model gate (``--grade-model``: 0 on the
  committed evidence, 1 where ``--repo`` holds none the model agrees
  with).
"""

import io
import json

import numpy as np
import pytest

from harp_tpu import health as JH
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch import health as PH
from harp_tpu_torch.utils import telemetry as PT
from torch_world import time_limit


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


def _stream(seed=0):
    """(t, outcome, latency_ms, deadline_missed) over 12 s."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1200):
        t = i * 0.01
        if 4.0 <= t < 5.0:          # the cliff
            o = ("shed", "failed", "served")[i % 3]
        else:
            o = "served" if rng.random() > 0.004 else "shed"
        lat = float(rng.lognormal(1.0, 0.5))
        out.append((t, o, lat if o == "served" else None,
                    o == "served" and 6.0 <= t < 6.5))
    return out


def _burn_run(tel, health, **kw):
    with tel.scope(True):
        b = health.SLOBurn("serve.t", window_s=3.0, subwindows=6, **kw)
        snaps = []
        for i, (t, o, lat, missed) in enumerate(_stream()):
            b.observe(t, o, latency_ms=lat, deadline_missed=missed, rid=i)
            if i % 100 == 99:
                snaps.append((b.burn(t), b.snapshot(t)))
        rows = [{k: v for k, v in r.items() if k != "_seq"}
                for r in health.monitor.findings()]
        return (snaps, b.counts, b.breaches, b.peak_fast, b.peak_slow,
                [{k: (str(v) if k == "tag" else v) for k, v in r.items()}
                 for r in rows])


@pytest.mark.parametrize("kw", [{}, {"latency_slo_ms": 6.0},
                                {"error_budget": 0.2}])
def test_slo_burn_matches_the_reference(kw):
    ref = _burn_run(JT, JH, **kw)
    got = _burn_run(PT, PH, **kw)
    assert got == ref
    if not kw:
        assert got[2] >= 1 and got[5][0]["detector"] == "slo_burn"
        assert got[5][0]["severity"] == "page"


def test_slo_burn_is_free_while_off():
    b = PH.SLOBurn("x")
    with PT.scope(False):
        b.observe(0.0, "shed")
    assert b.counts["offered"] == 0 and not PH.monitor.findings()
    with pytest.raises(ValueError):
        PH.SLOBurn("x", subwindows=1)


def _monitor_run(tel, health):
    with tel.scope(True):
        m = health.monitor
        mark = m.mark()
        m.observe_budget("serve.a", [("h2d_calls", 2, 1)])
        m.observe_budget("serve.a", [("dispatches", 5, 1),
                                     ("readbacks", 2, 1)])
        m.observe_budget("bench.b", [("compiles", 1, 0)])
        m.observe_memory("run", 95, 100)
        m.observe_memory("run", 50, 100)              # no pressure
        m.observe_memory("grade", 60, 100, baseline_peak=50)
        m.observe_memory("none", 10, 0)
        new = m.since(mark)
        buf = io.StringIO()
        m.export_jsonl(buf)
        rows = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        return (len(new), m.summary(), rows,
                health.summarize_rows(rows))


def test_budget_drift_and_memory_pressure_match_the_reference():
    ref = _monitor_run(JT, JH)
    got = _monitor_run(PT, PH)
    assert got == ref
    n, summary, rows, s = got
    assert n == 4 and s["actionable"] == 4
    assert {r["detector"] for r in rows} == {"budget_drift",
                                              "memory_pressure"}
    assert rows[0]["violations"] == 2 and "dispatches" in rows[0]["worst"]


def test_vocabularies_match_the_reference():
    for name in ("DETECTORS", "SEVERITIES", "VERDICTS", "SLO_ERROR_BUDGET",
                 "FAST_BURN_MIN", "SLOW_BURN_MIN", "PAGE_BURN",
                 "WASTED_FRAC_TRIGGER", "TRIGGER_SUPERSTEPS"):
        assert getattr(PH, name) == getattr(JH, name)
    with PT.scope(True), pytest.raises(ValueError, match="detector"):
        PH.monitor.upsert("nope", "k")


def test_export_stamps_health_rows(tmp_path):
    with PT.scope(True):
        PH.monitor.observe_budget("t", [("readbacks", 3, 1)])
        PT.export(str(tmp_path / "h.jsonl"))
    (row,) = PT.load_rows(str(tmp_path / "h.jsonl"))["health"]
    assert row["detector"] == "budget_drift" and row["backend"] == "cpu"
    assert "_seq" not in row


@pytest.mark.parametrize("call", [
    lambda mon, led: mon.observe_skew("phase", led),
    lambda mon, led: mon.consume_skew_trigger("phase")])
def test_the_skew_detectors_wait_for_item_8(call):
    """Item 8 has ported them: free while off, and on the same records the
    reference's trigger row and handshake."""
    from harp_tpu.utils import skew as JS
    from harp_tpu_torch.utils import skew as PS

    assert call(PH.monitor, PS.ledger) is None  # telemetry off

    def drive(mod, hl, tel):
        with tel.scope(True):
            for _ in range(hl.TRIGGER_SUPERSTEPS):
                mod.record_execution("phase", [9, 1, 1, 1], unit="u")
            got = call(hl.monitor, mod.ledger)
            rows = [{k: v for k, v in r.items() if k != "_seq"}
                    for r in hl.monitor.findings()]
        if isinstance(got, dict):
            got = {k: v for k, v in got.items() if k != "_seq"}
        return got, rows

    ours, theirs = drive(PS, PH, PT), drive(JS, JH, JT)
    assert ours == theirs
    assert ours[1][0]["detector"] == "skew_trigger"


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows)
                    + "not json\n")


@pytest.mark.parametrize("rows,code", [
    ([], 0),
    ([{"kind": "health", "detector": "budget_drift", "severity": "info",
       "tag": "t", "violations": 1, "worst": "x"}], 0),
    ([{"kind": "health", "detector": "skew_trigger", "severity": "warn",
       "phase": "p", "wasted_frac": 0.5, "consecutive": 3,
       "plan": {"moves": [{"from": 0, "to": 1, "work": 1.0}],
                "ratio_before": 2.0, "ratio_after": 1.0}},
      {"kind": "span", "span": "x", "dur": 1.0}], 1),
    ([{"kind": "health", "detector": "slo_burn", "severity": "page",
       "tag": "serve", "fast_burn": 9.0, "slow_burn": 7.0, "offered": 10,
       "served": 5, "shed": 5, "failed": 0, "deadline_missed": 0}], 1),
])
def test_the_health_cli_summarizes_an_export_as_the_reference(tmp_path,
                                                              capsys, rows,
                                                              code):
    from harp_tpu.health import cli as JCLI
    from harp_tpu_torch.health import cli as PCLI

    path = tmp_path / "run.jsonl"
    _write(path, rows)
    assert PCLI.main([str(path)]) == code
    text = capsys.readouterr().out
    assert text.startswith("== harp-tpu health ==")
    assert PCLI.main([str(path), "--json"]) == code
    ours = json.loads(capsys.readouterr().out)
    assert JCLI.main([str(path), "--json", "--no-grade-bench"]) == code
    theirs = json.loads(capsys.readouterr().out)
    keys = ("findings", "by_detector", "worst_severity", "actionable",
            "graded_configs")
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["config"] == "health"


def test_the_health_cli_refuses_an_unreadable_file(tmp_path, capsys):
    from harp_tpu_torch.health import cli as PCLI

    assert PCLI.main([str(tmp_path / "missing.jsonl")]) == 2
    assert "cannot read" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--grade-model"],
                                  ["x.jsonl", "--grade-bench"]])
def test_the_health_cli_grading_waits_for_item_9(argv, capsys):
    """Item 9's grading landed: the model gate confirms the committed
    evidence (exit 0), and a missing file to grade is unreadable (2)."""
    from harp_tpu_torch.health import cli as PCLI

    code = PCLI.main(argv + ["--repo", str(REPO)])
    out = capsys.readouterr().out
    if argv == ["--grade-model"]:
        row = json.loads(out)
        assert code == 0 and row["verdict"] == "confirmed"
        assert row["detector"] == "evidence_regression"
    else:
        assert code == 2


REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _card_rows(config):
    rows = [json.loads(ln) for ln in (REPO / "H100_EVIDENCE.jsonl")
            .read_text().splitlines() if ln.strip()]
    return [r for r in rows if r.get("kind") is None
            and r.get("config") == config]


@pytest.mark.parametrize("scale,code,verdict", [
    (1.0, 0, "confirmed"), (0.5, 1, "regressed"), (1.5, 0, "improved"),
    (1e-4, 1, "model_invalidated")])
def test_the_health_cli_grades_fresh_bench_rows(tmp_path, capsys, scale,
                                                code, verdict):
    from harp_tpu_torch.health import cli as PCLI

    PH.reset()  # a fresh monitor, as a fresh CLI process has
    row = dict(_card_rows("kmeans_int8")[-1])
    row["iters_per_sec"] *= scale
    path = tmp_path / "fresh.jsonl"
    _write(path, [row, {"kind": "span", "span": "x", "dur": 1.0}])
    assert PCLI.main([str(path), "--json", "--repo", str(REPO)]) == code
    summary = json.loads(capsys.readouterr().out)
    assert summary["graded_configs"] == 1
    assert PCLI.main([str(path), "--repo", str(REPO)]) == code
    assert f"verdict {verdict}" in capsys.readouterr().out
    assert PCLI.main([str(path), "--no-grade-bench", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["graded_configs"] == 0


def test_the_health_cli_grades_a_drifted_profile(tmp_path, capsys):
    from harp_tpu_torch.health import cli as PCLI

    PH.reset()
    rows = [json.loads(ln) for ln in (REPO / "H100_EVIDENCE.jsonl")
            .read_text().splitlines() if ln.strip()]
    (base,) = [r for r in rows if r.get("kind") == "profile"
               and r.get("app") == "kmeans"][-1:]
    fresh = dict(base, reconciled=True,
                 terms={k: (base["wall_s"] if k == "wire_s" else 0.0)
                        for k in base["terms"]})
    path = tmp_path / "fresh.jsonl"
    _write(path, [fresh])
    assert PCLI.main([str(path), "--repo", str(REPO)]) == 1
    assert "profile_drift" in capsys.readouterr().out


def test_the_model_gate_reads_the_repo_it_is_given(tmp_path, capsys):
    from harp_tpu_torch.health import cli as PCLI

    PH.reset()
    assert PCLI.main(["--grade-model", "--repo", str(tmp_path)]) == 1
    row = json.loads(capsys.readouterr().out)
    assert row["verdict"] == "model_invalidated" and row["failures"] == 1
    rows = _card_rows("kmeans")
    _write(tmp_path / "H100_EVIDENCE.jsonl",
           [dict(rows[-1], iters_per_sec=rows[-1]["iters_per_sec"] * 1e4)])
    assert PCLI.main(["--grade-model", "--repo", str(tmp_path)]) == 1
    assert "magnitude" in json.loads(capsys.readouterr().out)["detail"][0]
    _write(tmp_path / "H100_EVIDENCE.jsonl", rows[-1:])
    assert PCLI.main(["--grade-model", "--repo", str(tmp_path)]) == 0
