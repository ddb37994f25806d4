"""Run report: the telemetry spines' one merged view — the port of
``harp_tpu.report``.

It merges the comm ledger and the span tracer
(:mod:`harp_tpu_torch.utils.telemetry`), the flight recorder (kernel
builds, graph captures, transfers), the skew ledger, the request trace,
the health findings, the elastic actions, the memory ledger and a
:class:`~harp_tpu_torch.utils.metrics.MetricsLogger` file into one
human-readable report and one machine-readable JSON line (printed through
:func:`harp_tpu_torch.utils.metrics.benchmark_json`, so the provenance
stamp rides along).

The port's comm ledger records each verb call as it runs (PyTorch is
eager), so a verb row's ``payload_bytes`` is already the total over its
``calls``: the report states the bytes a verb moved as that total, the
per-call sheet times the calls.

Two entry points:

- ``python -m harp_tpu_torch report --telemetry run.jsonl [--metrics
  m.jsonl]``: post hoc, from the files a run exported
  (``HARP_TELEMETRY_OUT=run.jsonl`` makes an instrumented CLI write one);
- :func:`maybe_emit`: called by the instrumented app CLIs at exit; with
  telemetry on the report lands on stderr and the JSON line on stdout.

``--trace-logdir DIR`` adds the top-ops table (``--top`` rows) of the
newest ``utils.profiling.trace`` capture under ``DIR``: the device
kernels' self time on a card, the host ops' on the CPU.
"""

from __future__ import annotations

import json
import sys
from typing import Any, IO

from harp_tpu_torch.utils import telemetry


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (f"{n:.0f} {unit}" if unit == "B" else f"{n:.2f} {unit}")
        n /= 1024
    raise AssertionError


def comm_summary_from_rows(rows: list[dict]) -> dict:
    """Rebuild :meth:`CommLedger.summary`'s shape from exported comm rows
    (one row per tag and verb; ``payload_bytes`` is the total over the
    row's ``calls``)."""
    out: dict[str, dict] = {}
    for r in rows:
        t = out.setdefault(r["tag"], {"executions": r.get("executions", 0),
                                      "bytes_per_execution": 0,
                                      "total_bytes": 0, "verbs": []})
        verb = {k: r.get(k) for k in ("verb", "combiner", "wire_dtype",
                                      "payload_bytes", "calls", "leaves")}
        t["verbs"].append(verb)
        t["total_bytes"] += verb["payload_bytes"] or 0
    for t in out.values():
        t["bytes_per_execution"] = t["total_bytes"] // max(
            t["executions"], 1)
        t["verbs"].sort(key=lambda v: -(v["payload_bytes"] or 0))
    return out


def span_summary_from_rows(rows: list[dict]) -> dict:
    agg: dict[str, list[float]] = {}
    for r in rows:
        agg.setdefault(r["span"], []).append(float(r["dur"]))
    return {k: {"mean_s": sum(v) / len(v), "total_s": sum(v), "n": len(v)}
            for k, v in agg.items()}


def compile_summary_from_rows(rows: list[dict]) -> dict:
    """Rebuild :meth:`CompileWatch.summary`'s shape from exported compile
    rows (each row is one backend compile with ``dur`` + ``span``)."""
    if not rows:
        return {}
    by_span: dict[str, dict] = {}
    total = 0.0
    for r in rows:
        d = float(r.get("dur") or 0.0)
        total += d
        s = by_span.setdefault(r.get("span") or "(no span)",
                               {"count": 0, "total_s": 0.0})
        s["count"] += 1
        s["total_s"] = round(s["total_s"] + d, 6)
    return {"count": len(rows), "total_s": round(total, 6),
            "by_span": by_span}


def transfer_summary_from_rows(rows: list[dict]) -> dict:
    """Rebuild :meth:`TransferLedger.summary`'s shape from exported
    transfer rows (one row per (op, site, span))."""
    if not rows:
        return {}
    out: dict[str, Any] = {"h2d_bytes": 0, "h2d_calls": 0, "d2h_bytes": 0,
                           "readbacks": 0, "dispatches": 0,
                           "bucket_bytes": 0, "sites": []}
    for r in rows:
        op, b = r.get("op"), int(r.get("bytes") or 0)
        calls = int(r.get("calls") or 0)
        if op == "h2d":
            out["h2d_bytes"] += b
            out["h2d_calls"] += calls
        elif op == "readback":
            out["d2h_bytes"] += b
            out["readbacks"] += calls
        elif op == "dispatch":
            out["dispatches"] += calls
        elif op == "bucket":
            out["bucket_bytes"] += b
        out["sites"].append({k: r.get(k) for k in ("op", "site", "span",
                                                   "bytes", "calls")})
    out["sites"].sort(key=lambda s: (-(s["bytes"] or 0), s["op"] or "",
                                     s["site"] or ""))
    return out


def skew_summary_from_rows(rows: list[dict]) -> dict:
    """Rebuild :meth:`harp_tpu_torch.utils.skew.SkewLedger.summary`'s shape
    from exported ``kind: "skew"`` rows (one row per phase)."""
    out: dict[str, dict] = {}
    for r in rows:
        phase = r.get("phase", "?")
        out[phase] = {k: r.get(k) for k in (
            "source", "unit", "work", "total", "n_workers",
            "max_mean_ratio", "wasted_frac", "wasted_chip_s",
            "padding_frac", "wall_s", "runs") if r.get(k) is not None}
    return dict(sorted(out.items(),
                       key=lambda kv: -(kv[1].get("max_mean_ratio") or 0)))


def build_row(comm: dict, spans: dict, span_records: list[dict] | None = None,
              metrics_rows: list[dict] | None = None,
              top_ops: list | None = None,
              compile_info: dict | None = None,
              transfer_info: dict | None = None,
              skew_info: dict | None = None,
              trace_info: dict | None = None,
              health_info: dict | None = None,
              elastic_rows: list[dict] | None = None,
              memory_info: dict | None = None) -> dict:
    """The machine-readable merge (the dict behind the JSON line)."""
    row: dict[str, Any] = {
        "comm_total_bytes": sum(t["total_bytes"] for t in comm.values()),
        "comm_verbs": {},
        "comm_tags": comm,
        "spans": spans,
    }
    # each section only when the run recorded something for it
    if compile_info and compile_info.get("count"):
        row["compile"] = compile_info
    if transfer_info and (transfer_info.get("sites")
                          or any(v for k, v in transfer_info.items()
                                 if k != "sites")):
        row["transfer"] = transfer_info
    if skew_info:
        row["skew"] = skew_info
    if trace_info and trace_info.get("requests"):
        row["requests"] = trace_info
    if health_info and health_info.get("findings"):
        row["health"] = health_info
    if memory_info and (memory_info.get("events")
                        or memory_info.get("rows")):
        row["memory"] = memory_info
    if elastic_rows:
        by_event: dict[str, int] = {}
        for r in elastic_rows:
            by_event[r.get("event", "?")] = \
                by_event.get(r.get("event", "?"), 0) + 1
        row["elastic"] = {"events": len(elastic_rows),
                          "by_event": by_event, "rows": elastic_rows}
    for t in comm.values():
        for v in t["verbs"]:
            row["comm_verbs"][v["verb"]] = (row["comm_verbs"].get(
                v["verb"], 0) + (v["payload_bytes"] or 0))
    if span_records:
        row["n_spans"] = len(span_records)
    if metrics_rows is not None:
        row["metrics_rows"] = len(metrics_rows)
        if metrics_rows:
            row["metrics_last"] = metrics_rows[-1]
    if top_ops:
        row["top_ops"] = [{"op": n, "sec": round(s, 5)} for n, s in top_ops]
    return row


def render(row: dict, span_records: list[dict] | None = None) -> str:
    """The human-readable run report."""
    lines = ["== harp-tpu run report =="]
    comm = row.get("comm_tags", {})
    lines.append(f"comm volume (per-worker wire bytes): "
                 f"{_fmt_bytes(row.get('comm_total_bytes', 0))}")
    for verb, b in sorted(row.get("comm_verbs", {}).items(),
                          key=lambda kv: -kv[1]):
        lines.append(f"  by verb: {verb:<20s} {_fmt_bytes(b)}")
    for tag, t in sorted(comm.items()):
        lines.append(
            f"  tag {tag}: {t['executions']} execution(s) × "
            f"{_fmt_bytes(t['bytes_per_execution'])}/exec = "
            f"{_fmt_bytes(t['total_bytes'])}")
        for v in t["verbs"]:
            wire = f" wire={v['wire_dtype']}" if v.get("wire_dtype") else ""
            comb = f" op={v['combiner']}" if v.get("combiner") else ""
            lines.append(
                f"    {v['verb']:<20s} "
                f"{_fmt_bytes(v['payload_bytes'] or 0)} over "
                f"{v['calls']} call(s){comb}{wire}")
    spans = row.get("spans", {})
    if spans:
        lines.append("spans (host phases):")
        if span_records:
            for r in sorted(span_records, key=lambda r: r["t0"]):
                lines.append(f"  {'  ' * r['depth']}{r['span']:<24s} "
                             f"{r['dur']:.4f} s")
        else:
            for name, s in sorted(spans.items(),
                                  key=lambda kv: -kv[1]["total_s"]):
                lines.append(f"  {name:<26s} total {s['total_s']:.4f} s  "
                             f"n={s['n']}  mean {s['mean_s']:.4f} s")
    comp = row.get("compile")
    if comp:
        lines.append(f"compiles (kernel builds, graph captures): "
                     f"{comp['count']} in "
                     f"{comp['total_s']:.3f} s")
        for name, s in sorted(comp.get("by_span", {}).items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {name:<26s} {s['count']} compile(s)  "
                         f"total {s['total_s']:.3f} s")
    tr = row.get("transfer")
    if tr:
        lines.append(
            f"transfers (host<->device): "
            f"H2D {_fmt_bytes(tr.get('h2d_bytes', 0))} in "
            f"{tr.get('h2d_calls', 0)} call(s); "
            f"D2H {_fmt_bytes(tr.get('d2h_bytes', 0))} over "
            f"{tr.get('readbacks', 0)} readback(s); "
            f"{tr.get('dispatches', 0)} dispatch(es)")
        if tr.get("bucket_bytes"):
            lines.append(f"  staged exchange buffers (capacity slots): "
                         f"{_fmt_bytes(tr['bucket_bytes'])}")
        for s in tr.get("sites", []):
            span_note = f"  span={s['span']}" if s.get("span") else ""
            lines.append(
                f"  {s['op']:<9s} {s['site'] or '?':<24s} "
                f"{_fmt_bytes(s['bytes'] or 0)} × {s['calls']} call(s)"
                f"{span_note}")
    sk = row.get("skew")
    if sk:
        lines.append("skew (per-worker load; most imbalanced first):")
        for phase, s in sk.items():
            ratio = s.get("max_mean_ratio")
            head = (f"  {phase} [{s.get('unit', '?')}, "
                    f"{s.get('source', '?')}]: total {s.get('total', 0):g} "
                    f"over {s.get('n_workers', '?')} worker(s)")
            if ratio is not None:
                head += f", max/mean {ratio:.2f}x"
            if s.get("wasted_frac") is not None:
                head += f", est. waste {100.0 * s['wasted_frac']:.1f}%"
            if s.get("wasted_chip_s") is not None:
                head += f" (~{s['wasted_chip_s']:.4f} worker-s)"
            if s.get("padding_frac") is not None:
                head += f", padding {100.0 * s['padding_frac']:.1f}%"
            lines.append(head)
            work = s.get("work") or []
            if work and len(work) <= 16:
                mx = max(work) or 1.0
                for w, v in enumerate(work):
                    bar = "#" * max(1 if v > 0 else 0,
                                    round(24.0 * v / mx))
                    lines.append(f"    w{w:<3d} {bar:<24s} {v:g}")
            elif work:  # wide meshes: summarize instead of 100 bars
                arr = sorted(work)
                lines.append(
                    f"    min {arr[0]:g}  median {arr[len(arr) // 2]:g}  "
                    f"max {arr[-1]:g}")
    rq = row.get("requests")
    if rq:
        lines.append(
            f"requests (trace): {rq.get('requests', 0)} — "
            f"{rq.get('served', 0)} served / {rq.get('shed', 0)} shed / "
            f"{rq.get('failed', 0)} failed over "
            f"{rq.get('batches', 0)} batch(es)")
        if rq.get("served_p50_ms") is not None:
            lines.append(f"  served latency p50 {rq['served_p50_ms']} ms"
                         f"  p99 {rq['served_p99_ms']} ms")
        if rq.get("unterminated"):
            lines.append(f"  UNTERMINATED spans: {rq['unterminated']} "
                         "(every offered request must end served/shed/"
                         "failed — see python -m harp_tpu_torch trace)")
    hl = row.get("health")
    if hl:
        lines.append(
            f"health (sentinel findings): {hl.get('findings', 0)} — "
            f"{hl.get('actionable', 0)} actionable, worst severity "
            f"{hl.get('worst_severity')}")
        for r in hl.get("rows", []):
            who = r.get("tag") or r.get("phase") or r.get("config") or "?"
            extra = ""
            if r.get("detector") == "slo_burn":
                extra = (f"  burn {r.get('fast_burn')}/"
                         f"{r.get('slow_burn')}, "
                         f"{r.get('shed', 0)} shed / "
                         f"{r.get('failed', 0)} failed")
            elif r.get("detector") == "skew_trigger":
                extra = (f"  wasted {r.get('wasted_frac')}, plan: "
                         f"{len((r.get('plan') or {}).get('moves') or [])}"
                         " move(s)")
            elif r.get("detector") == "budget_drift":
                extra = (f"  {r.get('violations')}x, worst "
                         f"{r.get('worst')}")
            elif r.get("detector") == "evidence_regression":
                extra = f"  verdict {r.get('verdict')}"
            lines.append(f"  [{r.get('severity')}] "
                         f"{r.get('detector')} {who}{extra}")
    mem = row.get("memory")
    if mem:
        head = (f"memory (device ledger): peak "
                f"{_fmt_bytes(mem.get('peak_hbm_bytes', 0))} device")
        if mem.get("headroom_frac") is not None and mem.get("hbm_bytes"):
            head += (f"  (headroom {100.0 * mem['headroom_frac']:.1f}% "
                     f"of {_fmt_bytes(mem['hbm_bytes'])})")
        lines.append(head)
        lines.append(
            f"  staged {_fmt_bytes(mem.get('staged_bytes', 0))} / "
            f"donated {_fmt_bytes(mem.get('donated_bytes', 0))} / "
            f"freed {_fmt_bytes(mem.get('freed_bytes', 0))} / "
            f"live {_fmt_bytes(mem.get('live_hbm_bytes', 0))}")
        if mem.get("executables"):
            lines.append(
                f"  {mem['executables']} executable footprint(s), "
                f"{_fmt_bytes(mem.get('exec_hbm_bytes', 0))} static")
        for e in mem.get("errors", []):
            lines.append(f"  IRRECONCILED: {e}")
    el = row.get("elastic")
    if el:
        lines.append(f"elastic (actions): {el.get('events', 0)} — "
                     + ", ".join(f"{k}×{v}" for k, v in
                                 sorted(el.get("by_event", {}).items())))
        for r in el.get("rows", []):
            if r.get("event") == "rebalance":
                lines.append(
                    f"  [rebalance] {r.get('phase')}: wasted "
                    f"{r.get('wasted_frac_before')} -> "
                    f"{r.get('wasted_frac_after')} "
                    f"({r.get('moves')} move(s))")
            elif r.get("event") == "shrink":
                lines.append(
                    f"  [shrink] {r.get('phase')}: lost worker "
                    f"{r.get('lost_worker')} ({r.get('site')} #"
                    f"{r.get('ordinal')}), {r.get('n_workers_before')}"
                    f" -> {r.get('n_workers_after')} workers "
                    f"(capacity {r.get('capacity_frac')})")
            else:
                lines.append(
                    f"  [resume] {r.get('phase')}: {r.get('n_workers')}"
                    f" worker(s), wasted {r.get('wasted_frac')}"
                    + (", replayed repartition plan"
                       if r.get("replayed_plan") else ""))
    if "metrics_rows" in row:
        lines.append(f"metrics: {row['metrics_rows']} row(s)")
        if row.get("metrics_last"):
            lines.append(f"  last: {json.dumps(row['metrics_last'])}")
    if row.get("top_ops"):
        lines.append("top device ops (self time):")
        for o in row["top_ops"]:
            lines.append(f"  {o['op']:<40s} {o['sec']:.5f} s")
    return "\n".join(lines)


def live_report() -> tuple[dict, list[dict]]:
    """(machine row, span records) from the in-process collectors."""
    from harp_tpu_torch import elastic, health
    from harp_tpu_torch.utils import flightrec, memrec, reqtrace, skew

    comm = telemetry.ledger.summary()
    spans = telemetry.tracer.summary()
    return (build_row(comm, spans, telemetry.tracer.records,
                      compile_info=flightrec.compile_watch.summary(),
                      transfer_info=flightrec.transfers.summary(),
                      skew_info=skew.ledger.summary(),
                      trace_info=reqtrace.summarize_rows(
                          reqtrace.tracer.rows()),
                      health_info=health.monitor.summary(),
                      elastic_rows=list(elastic.ledger.ledger.rows),
                      memory_info=memrec.live_summary()),
            telemetry.tracer.records)


def _device() -> str:
    """The device this process measured on, for the provenance stamp."""
    import torch

    return "cuda" if torch.cuda.is_initialized() else "cpu"


def maybe_emit(config: str, *, out: IO | None = None,
               err: IO | None = None) -> None:
    """App-CLI exit hook: no-op unless telemetry is enabled.

    Prints the human report to ``err`` (stderr) and the provenance-stamped
    JSON line to ``out`` (stdout), and honors ``HARP_TELEMETRY_OUT`` by
    exporting the raw span+ledger JSONL for later ``report`` runs.
    """
    if not telemetry.enabled():
        return
    from harp_tpu_torch.utils.metrics import benchmark_json

    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    path = telemetry.out_path()
    if path:
        telemetry.export(path)
    row, span_records = live_report()
    print(render(row, span_records), file=err, flush=True)
    print(benchmark_json(f"{config}_telemetry", row, _device()), file=out,
          flush=True)


def main(argv=None) -> int:
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(prog="python -m harp_tpu_torch report",
        description="merge telemetry (comm ledger + spans) with metrics "
                    "JSONL into one run report")
    p.add_argument("--telemetry", metavar="FILE",
                   help="JSONL written by telemetry.export / "
                        "HARP_TELEMETRY_OUT")
    p.add_argument("--metrics", metavar="FILE",
                   help="MetricsLogger JSONL to merge")
    p.add_argument("--trace-logdir", metavar="DIR",
                   help="profiling.trace() logdir: adds the op_breakdown "
                        "top-ops table")
    p.add_argument("--top", type=int, default=10,
                   help="rows of the top-ops table (default 10)")
    p.add_argument("--json-only", action="store_true",
                   help="print only the machine-readable line")
    args = p.parse_args(argv)

    span_rows: list[dict] = []
    comm_rows: list[dict] = []
    compile_rows: list[dict] = []
    transfer_rows: list[dict] = []
    skew_rows: list[dict] = []
    trace_rows: list[dict] = []
    health_rows: list[dict] = []
    elastic_rows: list[dict] = []
    memory_rows: list[dict] = []
    if args.telemetry:
        kinds = telemetry.load_rows(args.telemetry)
        span_rows, comm_rows = kinds["span"], kinds["comm"]
        compile_rows, transfer_rows = kinds["compile"], kinds["transfer"]
        skew_rows = kinds["skew"]
        trace_rows = kinds["trace"]
        health_rows = kinds["health"]
        elastic_rows = kinds["elastic"]
        memory_rows = kinds["memory"]
    metrics_rows = None
    if args.metrics:
        metrics_rows = []
        with open(args.metrics) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    metrics_rows.append(json.loads(line))

    top_ops = None
    if args.trace_logdir:
        from harp_tpu_torch.utils.profiling import op_breakdown

        top_ops = op_breakdown(args.trace_logdir, top=args.top)

    from harp_tpu_torch import health as health_mod
    from harp_tpu_torch.utils import memrec
    from harp_tpu_torch.utils.reqtrace import summarize_rows as trace_summary

    row = build_row(comm_summary_from_rows(comm_rows),
                    span_summary_from_rows(span_rows),
                    span_rows, metrics_rows, top_ops,
                    compile_info=compile_summary_from_rows(compile_rows),
                    transfer_info=transfer_summary_from_rows(transfer_rows),
                    skew_info=skew_summary_from_rows(skew_rows),
                    trace_info=(trace_summary(trace_rows)
                                if trace_rows else None),
                    health_info=(health_mod.summarize_rows(health_rows)
                                 | {"rows": health_rows}
                                 if health_rows else None),
                    elastic_rows=elastic_rows,
                    memory_info=(memrec.summarize_rows(memory_rows)
                                 if memory_rows else None))
    if not args.json_only:
        print(render(row, span_rows))
    print(benchmark_json("report", row, "cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
