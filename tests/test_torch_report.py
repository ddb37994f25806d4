"""The run report (``harp_tpu_torch/report.py``) against harp_tpu's.

- The summaries it rebuilds from exported rows (spans, compiles,
  transfers, skew) equal the reference's on the same rows, and every
  section outside the comm ledger renders the reference's lines.
- The comm figures are held to hand-computed byte sheets times calls (the
  port records a verb each call it runs; the reference's ledger records a
  call site once a trace): KMeans on a spawned 4-worker gloo world, both
  variants, from the shapes of what each verb moves.
- The CLI reads an export back to the same row; ``maybe_emit`` is silent
  while telemetry is off and ends every instrumented CLI (kmeans, mfsgd,
  lda, bench, serve) in the report while it is on.
"""

import json

import pytest

import harp_tpu.report as JR
from harp_tpu_torch import __main__ as cli
from harp_tpu_torch import report
from harp_tpu_torch.utils import telemetry
from torch_plane_world import (WORLD, kmeans_points, run_report_cases,
                               run_world, time_limit)

K, D, ITERS = 8, 8, 3

SPANS = [{"kind": "span", "span": "epoch", "path": "epoch", "t0": 0.0,
          "dur": 2.0, "depth": 0},
         {"kind": "span", "span": "ingest", "path": "epoch/ingest",
          "t0": 0.25, "dur": 0.5, "depth": 1}]
TRANSFERS = [{"kind": "transfer", "op": "h2d", "site": "m.py:1",
              "span": "epoch", "bytes": 4096, "calls": 2},
             {"kind": "transfer", "op": "readback", "site": "m.py:9",
              "span": "epoch", "bytes": 8, "calls": 1},
             {"kind": "transfer", "op": "dispatch", "site": "fit",
              "span": "epoch", "bytes": 0, "calls": 1}]
COMPILES = [{"kind": "compile", "dur": 1.5, "span": "epoch", "t": 0.1},
            {"kind": "compile", "dur": 0.5, "span": None, "t": 0.2}]
SKEW = [{"kind": "skew", "phase": "lda.epochs", "source": "execution",
         "unit": "tokens", "work": [300.0, 100.0, 100.0, 100.0],
         "total": 600.0, "n_workers": 4, "max_mean_ratio": 2.0,
         "wasted_frac": 0.5, "wasted_chip_s": 0.2, "wall_s": 0.1,
         "runs": 3},
        {"kind": "skew", "phase": "lda.partition", "source": "ingest",
         "unit": "tokens", "work": [150.0, 150.0, 150.0, 150.0],
         "total": 600.0, "n_workers": 4, "max_mean_ratio": 1.0,
         "wasted_frac": 0.0, "padding_frac": 0.25, "runs": 1}]
HEALTH = [{"kind": "health", "detector": "skew_trigger", "severity": "warn",
           "phase": "lda.epochs", "wasted_frac": 0.5,
           "plan": {"moves": [{"from": 0, "to": 1, "work": 100.0}]}},
          {"kind": "health", "detector": "budget_drift", "severity": "warn",
           "tag": "ingest", "violations": 2, "worst": "h2d_bytes used 9 > "
           "budget 8"}]
ELASTIC = [{"kind": "elastic", "event": "rebalance", "phase": "p",
            "wasted_frac_before": 0.5, "wasted_frac_after": 0.1,
            "moves": 2},
           {"kind": "elastic", "event": "shrink", "phase": "p",
            "lost_worker": 3, "site": "dispatch", "ordinal": 2,
            "n_workers_before": 4, "n_workers_after": 3,
            "capacity_frac": 0.75},
           {"kind": "elastic", "event": "resume", "phase": "p",
            "n_workers": 3, "wasted_frac": 0.0, "replayed_plan": True}]
METRICS = [{"t": 0.1, "step": 0, "loss": 2.0},
           {"t": 0.2, "step": 1, "loss": 1.0}]


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(90):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("report")
    return run_world(run_report_cases, root, str(root))


def test_summaries_from_rows_match_the_reference():
    assert report.span_summary_from_rows(SPANS) == \
        JR.span_summary_from_rows(SPANS)
    assert report.compile_summary_from_rows(COMPILES) == \
        JR.compile_summary_from_rows(COMPILES)
    assert report.transfer_summary_from_rows(TRANSFERS) == \
        JR.transfer_summary_from_rows(TRANSFERS)
    assert report.skew_summary_from_rows(SKEW) == \
        JR.skew_summary_from_rows(SKEW)
    assert report.compile_summary_from_rows([]) == {}


def _row(mod):
    from harp_tpu_torch import health

    return mod.build_row(
        {}, mod.span_summary_from_rows(SPANS), SPANS, METRICS,
        transfer_info=mod.transfer_summary_from_rows(TRANSFERS),
        skew_info=mod.skew_summary_from_rows(SKEW),
        health_info=health.summarize_rows(HEALTH) | {"rows": HEALTH},
        elastic_rows=ELASTIC)


def test_sections_outside_the_comm_ledger_render_the_references_lines():
    got, want = _row(report), _row(JR)
    assert got == want
    # the port states idle time in worker-seconds, not chip-seconds
    ours = report.render(got, SPANS).replace("worker-s)", "chip-s)")
    ours = ours.splitlines()
    theirs = JR.render(want, SPANS).splitlines()
    # the first line names the plane, the second the ledger's byte unit
    assert ours[0] == theirs[0] and ours[2:] == theirs[2:]
    text = "\n".join(ours)
    for section in ("spans (host phases):", "transfers (host<->device)",
                    "skew (per-worker load", "health (sentinel findings)",
                    "elastic (actions): 3", "metrics: 2 row(s)"):
        assert section in text, section


def _sheets(variant: str) -> dict:
    """Bytes a Lloyd iteration moves per worker, from the shapes of what
    each verb carries (f32, k x d centroids)."""
    f32 = 4
    if variant == "allreduce":  # (sums [k, d], counts [k], inertia [])
        return {"allreduce": (K * D + K + 1) * f32}
    kb = K // WORLD  # regroupallgather: push the partials, pull a block
    return {"push": (K * D + K) * f32, "pull": kb * D * f32,
            "allreduce": f32}


@pytest.mark.parametrize("variant", ["allreduce", "regroupallgather"])
def test_comm_figures_are_the_byte_sheets_times_calls(world, variant):
    sheet = _sheets(variant)
    for r in world:
        row = r[variant]["row"]
        assert row["comm_verbs"] == {v: b * ITERS for v, b in sheet.items()}
        assert row["comm_total_bytes"] == sum(sheet.values()) * ITERS
        tag = row["comm_tags"]["kmeans.fit"]
        assert tag["executions"] == ITERS
        assert tag["bytes_per_execution"] == sum(sheet.values())
        assert {v["verb"]: v["calls"] for v in tag["verbs"]} == {
            v: ITERS for v in sheet}
        assert row["transfer"]["dispatches"] == 1
        assert row["transfer"]["readbacks"] == 1
        n = kmeans_points().shape[0]
        assert row["skew"]["kmeans.fit"]["work"] == [n / WORLD] * WORLD
        assert "tag kmeans.fit: 3 execution(s)" in r[variant]["text"]


def test_the_cli_reads_an_export_back_to_the_live_row(world, capsys):
    r = world[0]
    assert cli.main(["report", "--telemetry", r["export"],
                     "--json-only"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    live = r["allreduce"]["row"]
    assert row["config"] == "report" and row["backend"] == "cpu"
    assert row["comm_verbs"] == live["comm_verbs"]
    assert row["comm_total_bytes"] == live["comm_total_bytes"]
    assert row["skew"]["kmeans.fit"]["work"] == \
        live["skew"]["kmeans.fit"]["work"]
    assert row["transfer"]["dispatches"] == 1
    assert cli.main(["report", "--telemetry", r["export"]]) == 0
    assert "== harp-tpu run report ==" in capsys.readouterr().out


def test_the_cli_merges_a_metrics_file(tmp_path, capsys):
    tele, metrics = tmp_path / "t.jsonl", tmp_path / "m.jsonl"
    tele.write_text("".join(json.dumps(r) + "\n" for r in SPANS + SKEW))
    metrics.write_text("".join(json.dumps(r) + "\n" for r in METRICS))
    assert report.main(["--telemetry", str(tele), "--metrics",
                        str(metrics)]) == 0
    out = capsys.readouterr().out
    assert 'last: {"t": 0.2, "step": 1, "loss": 1.0}' in out
    row = json.loads(out.strip().splitlines()[-1])
    assert row["metrics_rows"] == 2 and row["n_spans"] == 2


#: one capture's spans, (name, ts, dur) in µs on one device track, nested
#: as a TPU module span nests its fusions: the self times are 12, 4, 16
#: and 8 µs
FORGED = [("jit_run", 0, 40), ("while.1", 4, 20), ("fusion.1", 5, 8),
          ("fusion.1", 14, 8), ("fusion.2", 30, 8)]


def _forge_reference(root):
    """FORGED in the reference's layout: an XLA session's gzipped dump."""
    import gzip

    d = root / "plugins" / "profile" / "0001"
    d.mkdir(parents=True)
    events = [{"ph": "M", "name": "process_name", "pid": 7,
               "args": {"name": "/device:TPU:0"}},
              {"ph": "X", "pid": 1, "tid": 1, "name": "host_thing", "ts": 0,
               "dur": 999}]
    events += [{"ph": "X", "pid": 7, "tid": 1, "name": n, "ts": t, "dur": u}
               for n, t, u in FORGED]
    with gzip.open(d / "x.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def _forge_port(root):
    """FORGED in the port's layout: a torch.profiler Chrome trace, the
    spans as kernels of card 0 on one stream, a host op beside them."""
    root.mkdir()
    events = [{"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1,
               "name": "host_thing", "ts": 0, "dur": 999}]
    events += [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n,
                "ts": t, "dur": u, "args": {"device": 0, "stream": 7}}
               for n, t, u in FORGED]
    (root / "capture-00000000000000000001.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))


@pytest.mark.parametrize("top", [2, 10])
def test_trace_logdir_adds_the_references_top_ops(tmp_path, capsys, top):
    """The same export and the same capture, each in its package's trace
    layout, give the reference's top_ops rows and table lines."""
    export = tmp_path / "run.jsonl"
    export.write_text("".join(json.dumps(r) + "\n" for r in SPANS))
    _forge_reference(tmp_path / "ref")
    _forge_port(tmp_path / "port")
    outs = []
    for main, d in ((JR.main, "ref"), (report.main, "port")):
        assert main(["--telemetry", str(export), "--trace-logdir",
                     str(tmp_path / d), "--top", str(top)]) == 0
        text = capsys.readouterr().out
        row = json.loads(text.strip().splitlines()[-1])
        table = [ln for ln in text[text.index("top device ops"):]
                 .splitlines()[1:] if ln.startswith("  ")]
        outs.append((row["top_ops"], table))
    assert outs[0] == outs[1]
    assert [o["op"] for o in outs[1][0]] == ["fusion.1", "jit_run",
                                             "fusion.2", "while.1"][:top]
    assert outs[1][0][0]["sec"] == round(16e-6, 5)


def test_trace_logdir_of_a_real_capture_lists_its_ops(tmp_path, capsys):
    import torch

    from harp_tpu_torch.utils import profiling

    a = torch.ones((64, 64))
    with profiling.trace(str(tmp_path / "tr")) as d:
        for _ in range(3):
            torch.mm(a, a)
    assert report.main(["--trace-logdir", d, "--json-only"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "aten::mm" in [o["op"] for o in row["top_ops"]]
    with pytest.raises(FileNotFoundError):
        report.main(["--trace-logdir", str(tmp_path / "nope")])


def test_maybe_emit_is_silent_while_off_and_exports_while_on(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    import io

    out, err = io.StringIO(), io.StringIO()
    report.maybe_emit("x", out=out, err=err)
    assert out.getvalue() == err.getvalue() == ""
    path = tmp_path / "run.jsonl"
    monkeypatch.setenv("HARP_TELEMETRY_OUT", str(path))
    with telemetry.scope(True):
        with telemetry.span("epoch"):
            pass
        report.maybe_emit("x", out=out, err=err)
    row = json.loads(out.getvalue().strip())
    assert row["config"] == "x_telemetry" and row["spans"]["epoch"]["n"] == 1
    assert "== harp-tpu run report ==" in err.getvalue()
    assert telemetry.load_rows(str(path))["span"][0]["span"] == "epoch"


@pytest.mark.parametrize("app,args", [
    ("kmeans", ["--n", "512", "--d", "4", "--k", "2", "--iters", "2"]),
    ("kmeans", ["--bench", "--n", "512", "--d", "4", "--k", "2", "--iters",
                "1"]),
    ("mfsgd", ["--users", "64", "--items", "32", "--nnz", "800", "--rank",
               "4", "--epochs", "1", "--u-tile", "16", "--i-tile", "16"]),
    ("lda", ["--docs", "32", "--vocab", "24", "--topics", "4",
             "--tokens-per-doc", "6", "--epochs", "1", "--algo", "dense",
             "--d-tile", "8", "--w-tile", "8", "--entry-cap", "16"]),
    ("bench", ["--verbs", "allreduce", "--max-mb", "1", "--reps", "1"]),
    ("serve", ["kmeans", "--bench", "--requests", "8"]),
])
def test_instrumented_clis_end_in_the_report(app, args, capsys):
    with telemetry.scope(True):
        assert (cli.main([app, *args, "--device", "cpu"]) or 0) == 0
    cap = capsys.readouterr()
    row = json.loads(cap.out.strip().splitlines()[-1])
    assert row["config"].endswith("_telemetry"), row["config"]
    assert "== harp-tpu run report ==" in cap.err


def test_report_timeline_and_health_are_apps(capsys):
    assert cli.main(["--list"]) == 0
    listing = capsys.readouterr().out
    for app in ("report", "timeline", "health"):
        assert f"  {app} " in listing
