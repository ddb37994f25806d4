"""Request-level tracing: one causal timeline across the serve plane — the
port of ``harp_tpu.utils.reqtrace``.

The other spines each answer one question about a run; this one answers
what happened to one request between its arrival and its response.

**ReqTracer**: per-request span trees.  A trace id is minted at transport
arrival (:func:`arrive`; the sustained bench mints at admission) and
threaded through the :class:`~harp_tpu_torch.serve.server.
ContinuousRunner`: admission, batch membership (which scheduler batch
carried which row slice), dispatch, readback, delivery, and every
degradation (queue_full or deadline shed, retry with a fresh stage,
engine failure), so every offered request ends in exactly one terminal
outcome in {served, shed, failed}.  Batches get their own records (seq,
rung, rows, dispatch/readback times, member slices).  Timestamps are
whatever clock drives the runner (wall ``perf_counter`` on the TCP plane,
the virtual replay clock in ``benchmark_sustained``).

**LogHist / RollingWindow**: streaming percentiles in bounded memory.
Fixed log-spaced buckets (ratio :data:`HIST_RATIO` a bucket), so a
quantile read is within :data:`QUANTILE_REL_ERR` of the exact one
(≈ 9.1 %) and memory is a few KiB however long the server runs.
:class:`RollingWindow` keeps a ring of sub-window histogram pairs
(latency and queue depth) and expires them by time: the live windowed
p50/p95/p99 of the TCP ``stats`` line and the sustained bench row.

**Exporters**: :meth:`ReqTracer.export_jsonl` writes provenance-stamped
``kind:"trace"`` rows (``telemetry.export`` rides it), :func:`perfetto`
converts them into a Chrome/Perfetto ``trace.json``, and :func:`main` is
the ``python -m harp_tpu_torch trace <run.jsonl>`` CLI.

Every entry returns before it touches state while telemetry is off, and
nothing here touches a tensor, so the serve budgets (one dispatch, one
readback, no compile a batch) are the same with tracing on or off.  The
rolling histograms belong to the runner's stats and stay on.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any

from harp_tpu_torch.utils import telemetry

#: terminal request outcomes (the reference's frozen vocabulary)
OUTCOMES = ("served", "shed", "failed")

# ---------------------------------------------------------------------------
# Streaming histograms
# ---------------------------------------------------------------------------

#: per-bucket growth ratio of the log histogram.  2^(1/4) ≈ 1.189: nine
#: decades of latency (1 µs … 1000 s) fit in ~126 buckets at a bounded
#: relative quantile error — the EXPLICIT bucket-error contract callers
#: (and the acceptance test) hold the rolling p99 to.
HIST_RATIO = 2.0 ** 0.25

#: documented quantile error bound: a quantile read returns its
#: bucket's geometric midpoint, at most sqrt(HIST_RATIO) - 1 (≈ 9.1%)
#: from any sample that landed in the bucket.
QUANTILE_REL_ERR = HIST_RATIO ** 0.5 - 1.0


class LogHist:
    """Fixed log-bucket histogram — bounded memory, no retained samples.

    Buckets are ``lo * HIST_RATIO**i`` for ``i in [0, n_buckets)``; one
    underflow bucket catches values ``<= lo`` (zeros included — a queue
    depth of 0 is a real sample) and reads back as exactly 0.0, the
    last bucket clamps overflow.  ``quantile`` returns the geometric
    midpoint of the bucket holding the requested rank — within
    :data:`QUANTILE_REL_ERR` of the exact sample percentile whenever
    the rank lands inside the histogram's range.
    """

    __slots__ = ("lo", "n", "counts", "total", "_log_lo", "_log_r")

    def __init__(self, lo: float = 1e-3, n_buckets: int = 128):
        if lo <= 0 or n_buckets < 2:
            raise ValueError(f"need lo > 0 and >= 2 buckets, got "
                             f"lo={lo} n_buckets={n_buckets}")
        self.lo = float(lo)
        self.n = int(n_buckets)
        self.counts = [0] * (self.n + 1)  # [underflow] + n log buckets
        self.total = 0
        self._log_lo = math.log(self.lo)
        self._log_r = math.log(HIST_RATIO)

    def add(self, v: float) -> None:
        if v <= self.lo:
            i = 0
        else:
            i = 1 + min(self.n - 1,
                        int((math.log(v) - self._log_lo) / self._log_r))
        self.counts[i] += 1
        self.total += 1

    def merge_into(self, acc: list[int]) -> int:
        """Add this histogram's counts into ``acc`` (the rolling-window
        merge); returns this histogram's total."""
        for i, c in enumerate(self.counts):
            acc[i] += c
        return self.total

    @staticmethod
    def quantile_of(counts: list[int], total: int, lo: float,
                    p: float) -> float | None:
        """Quantile over a (possibly merged) bucket-count vector."""
        if total <= 0:
            return None
        rank = max(1, math.ceil(p / 100.0 * total))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank:
                if i == 0:
                    return 0.0
                return lo * HIST_RATIO ** (i - 1) * HIST_RATIO ** 0.5
        return lo * HIST_RATIO ** (len(counts) - 2)  # pragma: no cover

    def quantile(self, p: float) -> float | None:
        return self.quantile_of(self.counts, self.total, self.lo, p)


class RollingWindow:
    """Time-rolling latency + queue-depth percentiles, bounded memory.

    A ring of ``subwindows`` histogram pairs, each covering
    ``window_s / subwindows`` of the driving clock; a sample lands in
    the sub-window its timestamp selects and whole sub-windows expire
    as the clock advances — so :meth:`snapshot` always describes the
    most recent ``window_s`` (±one sub-window of quantization) without
    retaining a single sample.  The driving clock is the runner's
    (wall-time on the TCP plane, virtual in the sustained replay).
    """

    def __init__(self, window_s: float = 60.0, subwindows: int = 6,
                 lat_lo_ms: float = 1e-3, depth_lo: float = 0.5):
        if window_s <= 0 or subwindows < 1:
            raise ValueError(f"need window_s > 0 and >= 1 subwindow, "
                             f"got {window_s}/{subwindows}")
        self.window_s = float(window_s)
        self.sub_s = self.window_s / int(subwindows)
        self.k = int(subwindows)
        self.lat_lo_ms = lat_lo_ms
        self.depth_lo = depth_lo
        # ring slot -> (epoch, lat LogHist, depth LogHist); epoch is the
        # absolute sub-window index, so a stale slot is detected (not
        # merged) without ever scanning or clearing on the hot path
        self._ring: list[tuple[int, LogHist, LogHist] | None] = \
            [None] * self.k

    def _slot(self, now: float) -> tuple[int, LogHist, LogHist]:
        epoch = int(now / self.sub_s)
        i = epoch % self.k
        cur = self._ring[i]
        if cur is None or cur[0] != epoch:
            cur = (epoch, LogHist(self.lat_lo_ms), LogHist(self.depth_lo))
            self._ring[i] = cur
        return cur

    def add_latency(self, now: float, ms: float) -> None:
        self._slot(now)[1].add(ms)

    def add_qdepth(self, now: float, depth: float) -> None:
        self._slot(now)[2].add(depth)

    def _merged(self, now: float, which: int) -> tuple[list[int], int,
                                                       float]:
        epoch_now = int(now / self.sub_s)
        lo = self.lat_lo_ms if which == 1 else self.depth_lo
        acc = [0] * (LogHist(lo).n + 1)
        total = 0
        for cur in self._ring:
            if cur is not None and epoch_now - cur[0] < self.k:
                total += cur[which].merge_into(acc)
        return acc, total, lo

    def snapshot(self, now: float) -> dict:
        """Live windowed percentiles (None before any sample)."""
        out: dict[str, Any] = {"window_s": self.window_s,
                               "rel_err": round(QUANTILE_REL_ERR, 4)}
        for which, prefix, unit in ((1, "p", "_ms"), (2, "qdepth_p", "")):
            acc, total, lo = self._merged(now, which)
            out["samples" if which == 1 else "qdepth_samples"] = total
            for p in (50, 95, 99):
                q = LogHist.quantile_of(acc, total, lo, p)
                out[f"{prefix}{p}{unit}"] = (None if q is None
                                             else round(q, 4))
        return out


# ---------------------------------------------------------------------------
# ReqTracer
# ---------------------------------------------------------------------------

class ReqTracer:
    """Request span trees + batch records + free timeline marks.

    All entry points are no-ops while telemetry is disabled; ids are a
    process-local monotone counter (deterministic — no wall entropy),
    so a seeded replay yields the same trace twice.  Collection is
    unbounded by design: tracing is for instrumented runs (the rolling
    histograms are the bounded-memory surface for always-on stats).

    Thread safety: on the TCP plane the event-loop thread mints ids at
    arrival while the dispatcher thread stamps deliver/outcome events,
    so every mutator takes ``self._lock`` (an RLock: :meth:`end` records
    its outcome event through :meth:`event`).  The lock sits after the
    telemetry-enabled early return, so the disabled path stays free.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        self._next_id = 0
        # rid -> {"req","t0","t_last","events":[{name,ts,...}],"outcome"}
        self._reqs: dict[int, dict] = {}
        # batch seq -> {"seq","rung","rows","padding_frac","members",
        #               "events":[...]}
        self._batches: dict[int, dict] = {}
        self.marks: list[dict] = []   # free events (fault plane, ...)
        self.counts = {o: 0 for o in OUTCOMES}

    # -- request spans -----------------------------------------------------
    def begin(self, ts: float, **attrs: Any) -> int | None:
        """Mint a trace id and open its span with an ``arrival`` event.
        Returns None (and records nothing) while telemetry is off."""
        if not telemetry.enabled():
            return None
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            ev = {"name": "arrival", "ts": float(ts)}
            if attrs:
                ev.update(attrs)
            self._reqs[rid] = {"req": rid, "t0": float(ts),
                               "t_last": float(ts),
                               "events": [ev], "outcome": None}
            return rid

    def event(self, rid: int | None, name: str, ts: float,
              **attrs: Any) -> None:
        """Append one event to an open (or already-terminated — e.g.
        ``deliver`` after ``served``) request span; unknown/None ids are
        ignored so tracing may arm mid-run without raising."""
        if rid is None or not telemetry.enabled():
            return
        with self._lock:
            r = self._reqs.get(rid)
            if r is None:
                return
            ev = {"name": name, "ts": float(ts)}
            if attrs:
                ev.update(attrs)
            r["events"].append(ev)
            r["t_last"] = max(r["t_last"], float(ts))

    def end(self, rid: int | None, outcome: str, ts: float,
            **attrs: Any) -> None:
        """Terminate a request span with its outcome (once; a second
        end on the same id is ignored — outcomes never flip)."""
        if rid is None or not telemetry.enabled():
            return
        if outcome not in OUTCOMES:
            raise ValueError(f"outcome {outcome!r} not in {OUTCOMES}")
        with self._lock:
            r = self._reqs.get(rid)
            if r is None or r["outcome"] is not None:
                return
            self.event(rid, outcome, ts, **attrs)
            r["outcome"] = outcome
            self.counts[outcome] += 1

    # -- batch records -----------------------------------------------------
    def batch(self, seq: int, ts: float, *, rung: int, rows: int,
              members: list[tuple[int | None, int, int]]) -> None:
        """Open one scheduler batch's record: ``members`` is
        [(trace_id, row_lo, row_hi)] — the request→batch join."""
        if not telemetry.enabled():
            return
        self._batches[seq] = {
            "seq": int(seq), "t0": float(ts), "rung": int(rung),
            "rows": int(rows),
            "padding_frac": round((rung - rows) / rung, 6) if rung else 0.0,
            "members": [[m if m is not None else -1, lo, hi]
                        for m, lo, hi in members],
            "events": [{"name": "form", "ts": float(ts)}]}

    def batch_event(self, seq: int, name: str, ts: float,
                    **attrs: Any) -> None:
        if not telemetry.enabled():
            return
        b = self._batches.get(seq)
        if b is None:
            return
        ev = {"name": name, "ts": float(ts)}
        if attrs:
            ev.update(attrs)
        b["events"].append(ev)

    def batch_event_count(self, name: str) -> int:
        """How many batch events named ``name`` the trace holds (the
        chaos-completeness tests count ``retry``/``engine_failure``)."""
        return sum(1 for b in self._batches.values()
                   for ev in b["events"] if ev["name"] == name)

    # -- free marks (fault plane etc.) -------------------------------------
    def mark(self, source: str, name: str, ts: float, **attrs: Any) -> None:
        if not telemetry.enabled():
            return
        with self._lock:
            m = {"source": source, "name": name, "ts": float(ts)}
            if attrs:
                m.update(attrs)
            self.marks.append(m)

    # -- reading / export --------------------------------------------------
    def summary(self) -> dict:
        open_spans = sum(1 for r in self._reqs.values()
                         if r["outcome"] is None)
        return {"requests": len(self._reqs), "open": open_spans,
                "batches": len(self._batches), **self.counts}

    def rows(self) -> list[dict]:
        """The trace as ``kind:"trace"`` rows, sorted by ``ts`` (a
        monotone timeline).  Three row shapes share the
        kind, split by ``ev``: per-request ``event`` rows, one terminal
        ``request`` row per span (ts = its last event), and one
        ``batch`` row per scheduler batch (ts = its last event,
        carrying the member slices and dispatch/readback events)."""
        out: list[dict] = []
        for r in self._reqs.values():
            for ev in r["events"]:
                out.append({"kind": "trace", "ev": "event", "req": r["req"],
                            **ev})
            out.append({"kind": "trace", "ev": "request", "req": r["req"],
                        "ts": r["t_last"], "t0": r["t0"],
                        "outcome": r["outcome"],
                        "n_events": len(r["events"])})
        for b in self._batches.values():
            out.append({"kind": "trace", "ev": "batch",
                        "ts": max(ev["ts"] for ev in b["events"]), **b})
        for m in self.marks:
            out.append({"kind": "trace", "ev": "mark", **m})
        # stable causal order: ts first, then terminal rows after their
        # own events (event < request), batches after the events they
        # carried, marks wherever their clock put them
        rank = {"event": 0, "mark": 1, "batch": 2, "request": 3}
        out.sort(key=lambda r: (r["ts"], rank[r["ev"]]))
        return out

    def export_jsonl(self, fh) -> None:
        """Provenance-stamped trace rows (telemetry.export rides this),
        so a CPU request timeline never reads as the card's."""
        rows = self.rows()
        if not rows:
            return
        from harp_tpu_torch.utils.flightrec import provenance_stamp

        stamp = provenance_stamp()
        for row in rows:
            fh.write(json.dumps({**row, **stamp}) + "\n")


tracer = ReqTracer()


def reset() -> None:
    """Clear the request tracer (telemetry.scope does this on entry)."""
    tracer.reset()


def arrive(ts: float, **attrs: Any) -> int | None:
    """Mint a trace id at transport arrival (module-level shorthand)."""
    return tracer.begin(ts, **attrs)


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------

_PID_REQ, _PID_BATCH, _PID_MARK = 1, 2, 3


def perfetto(rows: list[dict]) -> dict:
    """Convert ``kind:"trace"`` rows into Chrome Trace Event JSON.

    Loadable by chrome://tracing and ui.perfetto.dev as-is: request
    spans are ``X`` (complete) events on one track per request (pid 1),
    batches are ``X`` events from form to readback on a
    pipeline-depth-folded track (pid 2, tid = seq % 4 so the depth-2
    overlap is visible instead of stacked), and degradation/fault
    events are instants (``i``).  Timestamps are microseconds from the
    earliest row (the Trace Event format's unit).  The event plumbing
    is the shared :mod:`harp_tpu_torch.utils.perfetto` builder.
    """
    from harp_tpu_torch.utils import perfetto as pft

    trace_rows = [r for r in rows if r.get("kind") == "trace"]
    if not trace_rows:
        return pft.empty()
    b = pft.TraceBuilder(min(float(r["ts"]) for r in trace_rows))
    b.process(_PID_REQ, "requests")
    b.process(_PID_BATCH, "batches")
    b.process(_PID_MARK, "events")
    by_req: dict[int, list[dict]] = {}
    for r in trace_rows:
        ev = r.get("ev")
        if ev == "event" and "req" in r:
            by_req.setdefault(r["req"], []).append(r)
        elif ev == "request":
            b.complete(f"req {r['req']} [{r.get('outcome')}]",
                       _PID_REQ, r["req"], r.get("t0", r["ts"]), r["ts"],
                       args={"outcome": r.get("outcome"),
                             "n_events": r.get("n_events")})
        elif ev == "batch":
            evs = r.get("events") or []
            t_open = float(r.get("t0", r["ts"]))
            t_close = max((float(e["ts"]) for e in evs),
                          default=float(r["ts"]))
            b.complete(f"batch {r['seq']} rung={r.get('rung')}",
                       _PID_BATCH, int(r["seq"]) % 4, t_open, t_close,
                       args={"rows": r.get("rows"),
                             "padding_frac": r.get("padding_frac"),
                             "members": r.get("members")})
            for e in evs:
                if e["name"] in ("retry", "engine_failure"):
                    b.instant(f"{e['name']} (batch {r['seq']})",
                              _PID_BATCH, int(r["seq"]) % 4, e["ts"])
        elif ev == "mark":
            b.instant(f"{r.get('source')}:{r.get('name')}", _PID_MARK, 1,
                      r["ts"],
                      args={k: v for k, v in r.items()
                            if k not in ("kind", "ev", "ts")})
    # per-request instants for the interesting intermediate hops
    for rid, evs in by_req.items():
        for e in evs:
            if e["name"] in ("shed", "failed", "batch", "deliver"):
                b.instant(e["name"], _PID_REQ, rid, e["ts"], scope="t",
                          args={k: v for k, v in e.items()
                                if k not in ("kind", "ev", "ts", "name")})
    return b.build()


# ---------------------------------------------------------------------------
# Trace-file summary + CLI
# ---------------------------------------------------------------------------

def summarize_rows(rows: list[dict]) -> dict:
    """Validate + summarize loaded trace rows (the CLI's core): every
    request seen in event rows must have a terminal row with a known
    outcome."""
    reqs: dict[int, dict] = {}
    seen: set[int] = set()
    batches = 0
    marks = 0
    bad_outcomes = []
    for r in rows:
        ev = r.get("ev")
        if ev == "event" and "req" in r:
            seen.add(r["req"])
        elif ev == "request":
            if r.get("outcome") not in OUTCOMES:
                bad_outcomes.append(r.get("req"))
            reqs[r["req"]] = r
        elif ev == "batch":
            batches += 1
        elif ev == "mark":
            marks += 1
    unterminated = sorted(seen - set(reqs))
    counts = {o: sum(1 for r in reqs.values() if r.get("outcome") == o)
              for o in OUTCOMES}
    lat = sorted((r["ts"] - r["t0"]) * 1e3 for r in reqs.values()
                 if r.get("outcome") == "served" and "t0" in r)
    out = {"requests": len(reqs), "batches": batches, "marks": marks,
           **counts, "unterminated": unterminated,
           "bad_outcomes": bad_outcomes}
    if lat:
        out["served_p50_ms"] = round(
            lat[min(len(lat) - 1, int(0.50 * len(lat)))], 4)
        out["served_p99_ms"] = round(
            lat[min(len(lat) - 1, int(0.99 * len(lat)))], 4)
    return out


def _render(rows: list[dict], summary: dict, max_requests: int = 20) -> str:
    lines = ["== harp-tpu request trace =="]
    lines.append(
        f"{summary['requests']} request(s): {summary['served']} served / "
        f"{summary['shed']} shed / {summary['failed']} failed; "
        f"{summary['batches']} batch(es), {summary['marks']} mark(s)")
    if summary.get("served_p50_ms") is not None:
        lines.append(f"served latency p50 {summary['served_p50_ms']} ms, "
                     f"p99 {summary['served_p99_ms']} ms")
    if summary["unterminated"]:
        lines.append(f"UNTERMINATED spans: {summary['unterminated']}")
    by_req: dict[int, list[dict]] = {}
    outcomes: dict[int, str] = {}
    for r in rows:
        if r.get("ev") == "event" and "req" in r:
            by_req.setdefault(r["req"], []).append(r)
        elif r.get("ev") == "request":
            outcomes[r["req"]] = r.get("outcome")
    for rid in sorted(by_req)[:max_requests]:
        evs = by_req[rid]
        t0 = evs[0]["ts"]
        lines.append(f"req {rid} [{outcomes.get(rid, '?')}]:")
        for e in evs:
            extra = {k: v for k, v in e.items()
                     if k not in ("kind", "ev", "req", "name", "ts",
                                  "backend", "date", "commit")}
            note = f"  {extra}" if extra else ""
            lines.append(f"  +{(e['ts'] - t0) * 1e3:9.3f} ms  "
                         f"{e['name']}{note}")
    if len(by_req) > max_requests:
        lines.append(f"... {len(by_req) - max_requests} more request(s) "
                     "(use --perfetto for the full timeline)")
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m harp_tpu_torch trace run.jsonl`` — validate + summarize a
    trace export, optionally writing the Perfetto ``trace.json``.

    Exit codes: 0 clean, 1 the trace is incomplete (unterminated spans
    or unknown outcomes), 2
    usage / unreadable input.
    """
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch trace",
        description="request-level timeline: validate + summarize a "
                    "kind:'trace' JSONL export (telemetry.export / "
                    "HARP_TELEMETRY_OUT), export Chrome/Perfetto JSON")
    p.add_argument("jsonl", help="trace JSONL (telemetry.export output "
                                 "or a pure export_timeline file)")
    p.add_argument("--perfetto", metavar="OUT", default=None,
                   help="write a Chrome Trace Event JSON here (load in "
                        "chrome://tracing or ui.perfetto.dev)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable summary line "
                        "instead of the human timeline")
    args = p.parse_args(argv)
    try:
        rows = telemetry.load_rows(args.jsonl)["trace"]
    except OSError as e:
        print(f"trace: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 2
    summary = summarize_rows(rows)
    if args.perfetto:
        with open(args.perfetto, "w") as fh:
            json.dump(perfetto(rows), fh)
        summary["perfetto"] = args.perfetto
    if args.json:
        from harp_tpu_torch.utils.metrics import benchmark_json

        print(benchmark_json("trace", summary, "cpu"))
    else:
        print(_render(rows, summary))
    if summary["unterminated"] or summary["bad_outcomes"]:
        print(f"trace: {len(summary['unterminated'])} unterminated "
              f"span(s), {len(summary['bad_outcomes'])} unknown "
              "outcome(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
