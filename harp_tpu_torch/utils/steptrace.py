"""Superstep timeline: one causal training-plane timeline — the port of
``harp_tpu.utils.steptrace``.

Harp's unit of execution is the Map-Collective superstep; the other
spines (flight recorder, comm ledger, skew ledger, health sentinel,
elastic ledger, checkpoints) each answer one aggregate question, none of
them "what happened during superstep 3".  This module is the training
plane's sibling of :mod:`harp_tpu_torch.utils.reqtrace`.

**StepTracer**: a ``run`` is opened per instrumented host loop
(``fault.fit_epochs``, ``elastic.apps.elastic_fit``, ``kmeans.fit`` and
its checkpointed form); every superstep inside it is a terminated span.
On one clock (the span tracer's, shared with compile records and fault
marks) the tracer threads:

- flight marks: dispatch, h2d and readback through the flight recorder's
  observer hooks (registered only while a run is open), and compiles —
  on the card a kernel build or a CUDA-graph capture — through
  :meth:`StepTracer.on_compile`;
- wire marks: each collective verb call;
- checkpoint writes (observer hook) and restores (the recovery loop's
  resume point);
- fault marks: every fired :class:`~harp_tpu_torch.utils.fault.
  FaultInjector` event;
- elastic actions (``rebalance``/``shrink``/``resume``), which also end
  the covering span ``rebalanced`` or flag the next one ``resumed``;
- health findings and the exactly-once ``consume_skew_trigger``
  handshake;
- per-worker skew lanes (``ev:"lane"``), one per
  ``skew.record_execution`` inside a span.

Every opened span terminates with an outcome in :data:`OUTCOMES`; the run
row carries its flight-counter delta and the per-span sums, and
:func:`summarize_rows` checks that a run's dispatch marks equal its
counter delta (the observer path against the transfer ledger).

Free while telemetry is off: :func:`run` yields at once, every hook
returns on ``tracer._run is None``, and nothing here adds a device op or a
readback, so the flight budgets of a run are the same with tracing on or
off.  Exported as provenance-stamped ``kind:"steptrace"`` rows through
``telemetry.export``; ``python -m harp_tpu_torch timeline run.jsonl
[--perfetto out.json] [--json]`` checks and summarizes them.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any

from harp_tpu_torch.utils import telemetry

#: terminal superstep outcomes (the reference's vocabulary)
OUTCOMES = ("completed", "faulted", "rebalanced", "resumed")

#: row event vocabulary
EVS = ("run", "superstep", "mark", "lane")

#: mark sources
SOURCES = ("flight", "wire", "ckpt", "fault", "elastic", "health",
           "memory")

#: the flight counters a run/span attributes (the integer ones of
#: flightrec._BUDGET_KEYS a superstep can own)
FLIGHT_KEYS = ("dispatches", "readbacks", "h2d_calls", "compiles")


class StepTracer:
    """Run/superstep span collector (see module docstring).

    One run may be open at a time; an inner :meth:`run` or
    :meth:`superstep` is a reentrant no-op (outermost wins), so calling
    layers can instrument defensively without double-counting.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._rows: list[dict] = []
        self._run: dict | None = None
        self._span: dict | None = None
        self._run_seq = 0

    def _now(self) -> float:
        # the SpanTracer clock: shared with compile records ("t") and
        # the fault-plane marks, so every source in an export_timeline
        # merge is causally comparable
        return round(time.perf_counter() - telemetry.tracer._t0, 6)

    # -- the spans -----------------------------------------------------------
    @contextlib.contextmanager
    def run(self, phase: str):
        """Mint a run id and walk the block as one training run."""
        if not telemetry.enabled() or self._run is not None:
            yield
            return
        from harp_tpu_torch.utils import flightrec

        self._run_seq += 1
        r = self._run = {
            "run": self._run_seq, "phase": phase, "t0": self._now(),
            "seq": 0, "supersteps": 0,
            "outcomes": {o: 0 for o in OUTCOMES},
            "span_flight": {k: 0 for k in FLIGHT_KEYS},
            "marks": 0, "lanes": 0,
            "base": flightrec.snapshot(), "resume_pending": False,
        }
        try:
            with flightrec.observe_dispatches(self._on_dispatch), \
                    flightrec.observe_h2d(self._on_h2d), \
                    flightrec.observe_readbacks(self._on_readback), \
                    flightrec.observe_ckpt_writes(self._on_ckpt_write):
                yield
        finally:
            delta = flightrec.delta_since(r["base"])
            self._run = None   # marks after this row would be orphans
            self._span = None
            self._rows.append({
                "kind": "steptrace", "ev": "run", "run": r["run"],
                "phase": r["phase"], "t0": r["t0"], "ts": self._now(),
                "supersteps": r["supersteps"], "outcomes": r["outcomes"],
                "flight": {k: int(delta[k]) for k in FLIGHT_KEYS},
                "span_flight": r["span_flight"],
                "marks": r["marks"], "lanes": r["lanes"]})

    @contextlib.contextmanager
    def superstep(self, phase: str, step: int | None = None):
        """One terminated superstep span inside the open run.

        ``step`` is the caller's loop index (repeats across a
        restart-and-replay; ``seq`` is the run-local span ordinal and
        strictly increases).  An exception terminates the span
        ``faulted`` and propagates; an elastic ``rebalance`` recorded
        mid-span terminates it ``rebalanced``; a span opened right
        after an elastic ``resume`` terminates ``resumed``.
        """
        r = self._run
        if r is None or self._span is not None:
            yield
            return
        from harp_tpu_torch.utils import flightrec

        sp = self._span = {
            "seq": r["seq"],
            "step": int(r["seq"] if step is None else step),
            "phase": phase, "t0": self._now(),
            "base": flightrec.snapshot(),
            "rebalanced": False, "resumed": r["resume_pending"],
        }
        r["resume_pending"] = False
        r["seq"] += 1
        from harp_tpu_torch.utils import memrec

        memrec.ledger.begin_window()
        outcome = "completed"
        try:
            yield
        except BaseException:
            outcome = "faulted"
            raise
        finally:
            delta = flightrec.delta_since(sp["base"])
            if outcome == "completed":
                if sp["rebalanced"]:
                    outcome = "rebalanced"
                elif sp["resumed"]:
                    outcome = "resumed"
            flight = {k: int(delta[k]) for k in FLIGHT_KEYS}
            for k in FLIGHT_KEYS:
                r["span_flight"][k] += flight[k]
            r["outcomes"][outcome] += 1
            r["supersteps"] += 1
            memrec.note_superstep(self)  # before the span closes: the
            self._span = None            # mark carries this seq/step
            self._rows.append({
                "kind": "steptrace", "ev": "superstep", "run": r["run"],
                "seq": sp["seq"], "step": sp["step"], "phase": phase,
                "outcome": outcome, "t0": sp["t0"], "ts": self._now(),
                "flight": flight})

    # -- marks ---------------------------------------------------------------
    def mark(self, source: str, name: str, **extra: Any) -> None:
        """One instant on the timeline (no-op outside an open run)."""
        r = self._run
        if r is None:
            return
        row = {"kind": "steptrace", "ev": "mark", "run": r["run"],
               "ts": self._now(), "source": source, "name": name}
        if self._span is not None:
            row["seq"] = self._span["seq"]
            row["step"] = self._span["step"]
        row.update(extra)
        self._rows.append(row)
        r["marks"] += 1

    # flightrec observer callbacks (registered only while a run is open;
    # a FaultInjector armed BEFORE the run registers first, so an
    # injected fault aborts the op before its mark lands — only
    # launched operations get flight marks, matching the counters)
    def _on_dispatch(self, label: str) -> None:
        self.mark("flight", "dispatch", label=label)

    def _on_h2d(self, nbytes: int, site: Any) -> None:
        self.mark("flight", "h2d", bytes=int(nbytes))

    def _on_readback(self, x: Any) -> None:
        self.mark("flight", "readback")

    def _on_ckpt_write(self, path: str) -> None:
        self.mark("ckpt", "write")

    # cross-spine hooks (each spine calls its module-level shim below)
    def on_compile(self, dur: float, event: str | None = None,
                   name: str | None = None) -> None:
        """A kernel build or a graph capture (the flight recorder's
        CompileWatch calls this)."""
        self.mark("flight", "compile", dur=round(float(dur), 6),
                  event=event, target=name)

    def on_comm(self, verb: str) -> None:
        self.mark("wire", verb)

    def on_fault(self, site: str, ordinal: int, action: str) -> None:
        self.mark("fault", f"injected_{action}", site=site,
                  ordinal=int(ordinal))

    def on_elastic(self, event: str, phase: str,
                   row: dict | None = None) -> None:
        r = self._run
        if r is None:
            return
        if event == "rebalance" and self._span is not None:
            self._span["rebalanced"] = True
        if event == "resume":
            if self._span is None:
                r["resume_pending"] = True   # the NEXT span is the replay
            else:
                self._span["resumed"] = True
        extra = {}
        if row:
            for k in ("lost_worker", "n_workers", "n_workers_before",
                      "n_workers_after", "wasted_frac_after",
                      "from_step", "replayed_plan"):
                if k in row:
                    extra[k] = row[k]
        self.mark("elastic", event, phase=phase, **extra)

    def on_health(self, detector: str, key: Any) -> None:
        self.mark("health", detector, key=str(key))

    def on_skew_consume(self, phase: str) -> None:
        self.mark("health", "consume_skew_trigger", phase=phase)

    def note_restore(self, step: int) -> None:
        """``run_with_recovery`` restored a checkpoint (any restart, not
        just elastic) — a ``ckpt:restore`` mark, not an outcome."""
        self.mark("ckpt", "restore", step=int(step))

    def on_execution(self, phase: str, work, *, unit: str,
                     wall_s: float | None = None) -> None:
        """Per-worker skew lane for the open span (skew spine hook)."""
        r, sp = self._run, self._span
        if r is None or sp is None:
            return
        import numpy as np

        row = {"kind": "steptrace", "ev": "lane", "run": r["run"],
               "seq": sp["seq"], "step": sp["step"], "phase": phase,
               "ts": self._now(), "unit": unit,
               "work": [round(float(w), 6)
                        for w in np.asarray(work).reshape(-1)]}
        if wall_s is not None:
            row["wall_s"] = round(float(wall_s), 6)
        self._rows.append(row)
        r["lanes"] += 1

    # -- reading -------------------------------------------------------------
    def rows(self) -> list[dict]:
        """Completed rows, in timeline order (runs close after their
        spans, so the list is ts-monotone by construction)."""
        return list(self._rows)

    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        for row in self._rows:
            fh.write(json.dumps({**row, **(stamp or {})}) + "\n")


# ---------------------------------------------------------------------------
# Module singleton + the spines' shims
# ---------------------------------------------------------------------------

tracer = StepTracer()


def reset() -> None:
    """Clear the tracer (telemetry.scope does this on entry)."""
    tracer.reset()


def run(phase: str):
    """``with steptrace.run("mfsgd.epochs"): ...`` — a training loop's
    entry."""
    return tracer.run(phase)


def superstep(phase: str, step: int | None = None):
    """``with steptrace.superstep(phase, i): train_one()``."""
    return tracer.superstep(phase, step)


def export_jsonl(fh) -> None:
    """Append steptrace rows (telemetry.export calls this); stamped
    with the flight recorder's provenance triple."""
    if not tracer._rows:
        return
    from harp_tpu_torch.utils import flightrec

    tracer.export_jsonl(fh, flightrec.provenance_stamp())


# ---------------------------------------------------------------------------
# Perfetto export (shared Chrome-Trace plumbing, utils/perfetto.py)
# ---------------------------------------------------------------------------

_PID_STEP, _PID_MARK, _PID_LANE = 1, 2, 3

#: provenance keys stripped from Perfetto args (stamped on every row)
_STAMP_KEYS = ("backend", "date", "commit")


def perfetto(rows: list[dict]) -> dict:
    """Convert ``kind:"steptrace"`` rows into Chrome Trace Event JSON.

    Runs and their supersteps are nested ``X`` spans on one track per
    run (pid 1), marks are instants on pid 2, and the per-worker skew
    lanes fan out to one thread per worker on pid 3 — so a hot worker
    reads as a dense lane next to its idle peers.
    """
    from harp_tpu_torch.utils import perfetto as pft

    st = [r for r in rows if r.get("kind") == "steptrace"]
    if not st:
        return pft.empty()
    b = pft.TraceBuilder(min(float(r.get("t0", r["ts"])) for r in st))
    b.process(_PID_STEP, "supersteps")
    b.process(_PID_MARK, "events")
    b.process(_PID_LANE, "skew lanes")
    for r in st:
        ev = r.get("ev")
        if ev == "run":
            b.complete(f"run {r['run']} {r.get('phase')}", _PID_STEP,
                       r["run"], r.get("t0", r["ts"]), r["ts"],
                       args={"supersteps": r.get("supersteps"),
                             "outcomes": r.get("outcomes"),
                             "flight": r.get("flight")})
        elif ev == "superstep":
            b.complete(f"step {r.get('step')} [{r.get('outcome')}]",
                       _PID_STEP, r["run"], r.get("t0", r["ts"]), r["ts"],
                       args={"outcome": r.get("outcome"),
                             "flight": r.get("flight")})
        elif ev == "mark":
            b.instant(f"{r.get('source')}:{r.get('name')}", _PID_MARK, 1,
                      r["ts"],
                      args={k: v for k, v in r.items()
                            if k not in ("kind", "ev", "ts")
                            and k not in _STAMP_KEYS})
        elif ev == "lane":
            for w, load in enumerate(r.get("work") or []):
                b.instant(f"w{w}", _PID_LANE, w, r["ts"], scope="t",
                          args={"work": load, "step": r.get("step"),
                                "unit": r.get("unit")})
    return b.build()


# ---------------------------------------------------------------------------
# Timeline-file summary + CLI
# ---------------------------------------------------------------------------

def summarize_rows(rows: list[dict]) -> dict:
    """Validate + summarize loaded steptrace rows (the CLI's core).

    The reference checker's span checks: every run seen in
    span/mark/lane rows must terminate in exactly one run row, every
    span outcome must be known, and each run's dispatch marks must
    equal its flight-counter delta (the two-spine reconciliation).
    """
    runs: dict[int, dict] = {}
    spans: dict[int, list[dict]] = {}
    seen: set[int] = set()
    marks = lanes = 0
    bad_outcomes: list = []
    dispatch_marks: dict[int, int] = {}
    for r in rows:
        ev = r.get("ev")
        rid = r.get("run")
        if ev == "run":
            runs[rid] = r
        elif ev == "superstep":
            seen.add(rid)
            spans.setdefault(rid, []).append(r)
            if r.get("outcome") not in OUTCOMES:
                bad_outcomes.append([rid, r.get("seq")])
        elif ev == "mark":
            seen.add(rid)
            marks += 1
            if r.get("source") == "flight" and r.get("name") == "dispatch":
                dispatch_marks[rid] = dispatch_marks.get(rid, 0) + 1
        elif ev == "lane":
            seen.add(rid)
            lanes += 1
    unterminated = sorted(seen - set(runs))
    counts = {o: sum(rn.get("outcomes", {}).get(o, 0)
                     for rn in runs.values()) for o in OUTCOMES}
    dispatch_mismatch = sorted(
        rid for rid, rn in runs.items()
        if dispatch_marks.get(rid, 0)
        != rn.get("flight", {}).get("dispatches"))
    out = {"runs": len(runs),
           "supersteps": sum(rn.get("supersteps", 0)
                             for rn in runs.values()),
           **counts, "marks": marks, "lanes": lanes,
           "unterminated": unterminated, "bad_outcomes": bad_outcomes,
           "dispatch_mismatch": dispatch_mismatch}
    durs = sorted(r["ts"] - r["t0"] for rs in spans.values() for r in rs
                  if r.get("outcome") == "completed" and "t0" in r)
    if durs:
        out["step_p50_ms"] = round(
            durs[min(len(durs) - 1, int(0.50 * len(durs)))] * 1e3, 4)
    return out


def _render(rows: list[dict], summary: dict, max_steps: int = 40) -> str:
    lines = ["== harp-tpu training timeline =="]
    lines.append(
        f"{summary['runs']} run(s), {summary['supersteps']} superstep(s): "
        f"{summary['completed']} completed / {summary['faulted']} faulted "
        f"/ {summary['rebalanced']} rebalanced / {summary['resumed']} "
        f"resumed; {summary['marks']} mark(s), {summary['lanes']} lane(s)")
    if summary.get("step_p50_ms") is not None:
        lines.append(f"completed superstep p50 {summary['step_p50_ms']} ms")
    if summary["unterminated"]:
        lines.append(f"UNTERMINATED runs: {summary['unterminated']}")
    if summary["dispatch_mismatch"]:
        lines.append("dispatch marks != flight counters in runs: "
                     f"{summary['dispatch_mismatch']}")
    by_run: dict[int, list[dict]] = {}
    run_rows: dict[int, dict] = {}
    for r in rows:
        if r.get("ev") == "run":
            run_rows[r["run"]] = r
        elif r.get("ev") in ("superstep", "mark"):
            by_run.setdefault(r.get("run"), []).append(r)
    shown = 0
    for rid in sorted(by_run):
        rn = run_rows.get(rid)
        head = f"run {rid}"
        if rn is not None:
            head += (f" [{rn.get('phase')}] {rn.get('supersteps')} "
                     f"superstep(s), flight {rn.get('flight')}")
        lines.append(head + ":")
        t0 = by_run[rid][0].get("t0", by_run[rid][0]["ts"])
        for e in by_run[rid]:
            if shown >= max_steps:
                break
            shown += 1
            off = (e["ts"] - t0) * 1e3
            if e.get("ev") == "superstep":
                lines.append(f"  +{off:9.3f} ms  step {e.get('step')} "
                             f"[{e.get('outcome')}] flight "
                             f"{e.get('flight')}")
            else:
                lines.append(f"  +{off:9.3f} ms  "
                             f"{e.get('source')}:{e.get('name')}")
    n_events = sum(len(v) for v in by_run.values())
    if n_events > shown:
        lines.append(f"... {n_events - shown} more event(s) "
                     "(use --perfetto for the full timeline)")
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m harp_tpu_torch timeline run.jsonl``: validate and
    summarize a training-plane timeline, optionally writing Perfetto JSON.

    Exit codes: 0 clean, 1 the timeline is incomplete or irreconciled
    (unterminated runs, unknown outcomes, dispatch marks disagreeing
    with the flight counters), 2 unreadable input.
    """
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch timeline",
        description="superstep timeline: validate + summarize a "
                    "kind:'steptrace' JSONL export (telemetry.export / "
                    "HARP_TELEMETRY_OUT), export Chrome/Perfetto JSON")
    p.add_argument("jsonl", help="timeline JSONL (telemetry.export "
                                 "output or an export_timeline file)")
    p.add_argument("--perfetto", metavar="OUT", default=None,
                   help="write a Chrome Trace Event JSON here (load in "
                        "chrome://tracing or ui.perfetto.dev)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable summary line "
                        "instead of the human timeline")
    args = p.parse_args(argv)
    try:
        rows = telemetry.load_rows(args.jsonl)["steptrace"]
    except OSError as e:
        print(f"timeline: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 2
    summary = summarize_rows(rows)
    if args.perfetto:
        with open(args.perfetto, "w") as fh:
            json.dump(perfetto(rows), fh)
        summary["perfetto"] = args.perfetto
    if args.json:
        from harp_tpu_torch.utils.metrics import benchmark_json

        print(benchmark_json("timeline", summary, "cpu"))
    else:
        print(_render(rows, summary))
    if (summary["unterminated"] or summary["bad_outcomes"]
            or summary["dispatch_mismatch"]):
        print(f"timeline: {len(summary['unterminated'])} unterminated "
              f"run(s), {len(summary['bad_outcomes'])} unknown "
              f"outcome(s), {len(summary['dispatch_mismatch'])} "
              "dispatch mismatch(es)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # python -m harp_tpu_torch timeline
    import sys

    sys.exit(main())
