"""Comm ledger and span tracer — the part of ``harp_tpu.utils.telemetry``
that KMeans and MF-SGD need.

**CommLedger**: every verb in :mod:`harp_tpu_torch.parallel.collective`
calls :func:`record_comm`, which adds the call's per-worker payload bytes
(from shape and dtype only) to the ledger under the innermost active
:meth:`CommLedger.run` tag, by verb and by call site: :func:`site_key` of
the nearest frame that :func:`is_ledger_user_frame` accepts, the key the
wire audit (:mod:`harp_tpu_torch.analysis.commgraph`) derives for each
``torch.distributed`` call it sees.  PyTorch runs eagerly, so a verb records once
per *call*, at run time; there is no trace-time sheet to multiply.
``run(tag, steps)`` counts ``steps`` executions of the tagged block (the
Lloyd iterations of one ``fit``), so ``bytes_per_execution`` is the
recorded total over the executions.  A verb on a quantized wire passes
``wire_dtype``: its float leaves count at the wire's width (the int8 wire
one byte an element), its other leaves at their own.

**Spans**: ``with span("kmeans.fit", iters=3): ...`` is the program's one
way to name a stage.  What it does depends on what is listening:

- nothing (telemetry off, no profiler recording): it returns one shared
  null context and does nothing more, no clock read and no record;
- a ``torch.profiler`` recording: it also opens
  ``torch.profiler.record_function(name)``, whatever the telemetry switch
  says, so the stage shows in the profiler's trace as a
  ``user_annotation`` on the profiler's own clock, enclosing the ops and
  kernel launches made inside it;
- telemetry on, or a :func:`collect_spans` block open: it appends a host
  record (``span``, ``path``, ``t0`` on the tracer's clock, ``dur``,
  ``depth`` and the attributes) to :data:`tracer`, which
  :func:`export` writes out.  :func:`collect_spans` turns on these
  records alone: the ledger and the other host planes stay off.

Telemetry is off unless ``HARP_TELEMETRY=1`` is set or :func:`enable` /
:func:`scope` turns it on; when off, ``record_comm`` returns before
touching its argument.  The host planes (the flight recorder, the request
tracer, the health sentinel, the memory ledger, the skew ledger, the
superstep timeline and the elastic ledger) share this switch; :func:`scope`
resets them with the ledger and :func:`export` writes them all to one
JSONL file (``HARP_TELEMETRY_OUT`` names it for a CLI), the input of the
``report``, ``trace``, ``timeline``, ``health`` and ``memory`` CLIs.
:func:`export_timeline` merges the timestamped spines into one causal
``kind:"trace"`` file.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any

import torch

_ENABLED = os.environ.get("HARP_TELEMETRY", "0").lower() not in (
    "", "0", "off", "false")

_UNTAGGED = "(untagged)"
_HERE = os.path.abspath(__file__)
#: open :func:`collect_spans` blocks: span records on, the other planes off
_COLLECT = 0
#: is a torch.profiler recording?  (~0.1 us a call)
_profiling = torch.autograd._profiler_enabled


def enabled() -> bool:
    """Is telemetry collection on?"""
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn collection on or off process-wide (tests use :func:`scope`)."""
    global _ENABLED
    _ENABLED = bool(on)


def out_path() -> str | None:
    """Export destination for instrumented CLIs (``HARP_TELEMETRY_OUT``)."""
    return os.environ.get("HARP_TELEMETRY_OUT") or None


def budget(**kw):
    """``with telemetry.budget(compiles=1, readbacks=1): ...``: the flight
    recorder's budget guard (:func:`harp_tpu_torch.utils.flightrec.budget`
    has the counters and the raise and warn actions)."""
    from harp_tpu_torch.utils import flightrec

    return flightrec.budget(**kw)


@contextlib.contextmanager
def scope(on: bool = True, *, reset: bool = True):
    """Turn collection on (or off) within a block, restoring the prior
    flag on exit; ``reset`` clears every collector on entry: the ledger,
    the tracer, the flight recorder, the request tracer, the health
    monitor and the memory ledger."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    if reset:
        ledger.reset()
        tracer.reset()
        from harp_tpu_torch import elastic, health
        from harp_tpu_torch.utils import (flightrec, memrec, reqtrace, skew,
                                          steptrace)

        flightrec.reset()
        reqtrace.reset()
        health.reset()
        memrec.reset()
        skew.reset()
        steptrace.reset()
        elastic.reset()
    try:
        yield
    finally:
        _ENABLED = prev


def tree_leaves(tree: Any) -> list:
    """Leaves of a tensor, or of a tuple/list/dict nest of tensors."""
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_bytes(tree: Any, wire_dtype: "torch.dtype | None" = None
                ) -> tuple[int, int]:
    """(payload bytes, number of leaves) of one verb call, per worker."""
    leaves = tree_leaves(tree)
    total = 0
    for x in leaves:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        width = x.element_size()
        if wire_dtype is not None and x.is_floating_point():
            width = wire_dtype.itemsize
        total += x.numel() * width
    return total, len(leaves)


def is_ledger_user_frame(filename: str) -> bool:
    """Is an absolute source filename a *user* frame for a collective's
    call site?  The ledger's :func:`record_comm` and the wire audit both
    key a call by the nearest such frame, so they must agree on it.
    Excluded: this module, the collective verb layer, the torch package
    and contextlib's glue."""
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    return (filename != _HERE
            and not filename.endswith(os.path.join("parallel",
                                                   "collective.py"))
            and not filename.startswith(torch_dir + os.sep)
            and "contextlib" not in os.path.basename(filename))


def site_key(filename: str, lineno: int) -> str:
    """The ledger's call-site key: ``basename.py:lineno``."""
    return f"{os.path.basename(filename)}:{lineno}"


def call_site(frame=None) -> str:
    """:func:`site_key` of the nearest user frame at or above ``frame``
    (the caller's when None), or ``"?:0"``."""
    f = sys._getframe(1) if frame is None else frame
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if is_ledger_user_frame(fn):
            return site_key(fn, f.f_lineno)
        f = f.f_back
    return "?:0"


class CommLedger:
    """Per-tag, per-verb and per-site collective byte accounting (module
    docstring)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # tag -> {"executions": int,
        #         "verbs": {(verb, combiner, wire): record},
        #         "sites": {(site, verb, combiner, wire): record}}
        self._tags: dict[str, dict] = {}
        self._tag_stack: list[str] = []

    def _tag(self, name: str) -> dict:
        return self._tags.setdefault(name, {"executions": 0, "verbs": {},
                                            "sites": {}})

    def record(self, verb: str, tree: Any, *,
               combiner: str | None = None,
               wire_dtype: "torch.dtype | None" = None,
               hops: int = 1) -> None:
        if not _ENABLED:
            return
        payload, n_leaves = _tree_bytes(tree, wire_dtype)
        wire = None if wire_dtype is None else str(wire_dtype).removeprefix(
            "torch.")
        t = self._tag(self._tag_stack[-1] if self._tag_stack else _UNTAGGED)
        rec = t["verbs"].setdefault((verb, combiner, wire), {
            "verb": verb, "combiner": combiner, "wire_dtype": wire,
            "payload_bytes": 0, "calls": 0, "leaves": n_leaves})
        rec["payload_bytes"] += payload
        rec["calls"] += 1
        site = call_site(sys._getframe(1))
        srec = t["sites"].setdefault((site, verb, combiner, wire, hops), {
            "site": site, "verb": verb, "combiner": combiner,
            "wire_dtype": wire, "payload_bytes": 0, "calls": 0,
            "hops": hops})
        srec["payload_bytes"] += payload
        srec["calls"] += 1

    @contextlib.contextmanager
    def run(self, tag: str, *, steps: int = 1):
        """Attribute the verbs called inside the block to ``tag`` and count
        ``steps`` executions of it."""
        if not _ENABLED:
            yield self
            return
        t = self._tag(tag)
        self._tag_stack.append(tag)
        try:
            yield self
        finally:
            self._tag_stack.pop()
            t["executions"] += int(steps)

    def volume(self, tag: str | None = None) -> int:
        """Total bytes recorded under ``tag`` (all tags when None)."""
        names = [tag] if tag is not None else list(self._tags)
        return sum(r["payload_bytes"] for n in names if n in self._tags
                   for r in self._tags[n]["verbs"].values())

    def executions(self, tag: str) -> int:
        t = self._tags.get(tag)
        return 0 if t is None else t["executions"]

    def bytes_per_execution(self, tag: str) -> int:
        return self.volume(tag) // max(self.executions(tag), 1)

    def export_jsonl(self, fh) -> None:
        for tag, t in sorted(self._tags.items()):
            for r in t["verbs"].values():
                fh.write(json.dumps({"kind": "comm", "tag": tag,
                                     "executions": t["executions"],
                                     **r}) + "\n")

    def summary(self) -> dict:
        out = {}
        for name, t in sorted(self._tags.items()):
            verbs = sorted(t["verbs"].values(),
                           key=lambda r: -r["payload_bytes"])
            out[name] = {"executions": t["executions"],
                         "bytes_per_execution": self.bytes_per_execution(name),
                         "total_bytes": self.volume(name),
                         "verbs": [dict(r) for r in verbs],
                         "sites": [dict(r) for r in t["sites"].values()]}
        return out


#: the span when nothing listens: one shared context that does nothing
_NULL_SPAN = contextlib.nullcontext()


class SpanTracer:
    """Nested host-level spans: {span, path, t0, dur, depth, **attrs}."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._stack: list[str] = []
        self.records: list[dict] = []

    def current_path(self) -> str | None:
        """The live span path ("epoch/ingest"), or None outside any span:
        the flight recorder stamps its records with it."""
        return "/".join(self._stack) or None

    def span(self, name: str, **attrs: Any):
        """``with span("mfsgd.k3"): ...``: a stage named ``name``; the
        module docstring says what it does when nothing, a profiler or a
        collector listens."""
        if _ENABLED or _COLLECT:
            return self._recorded(name, attrs)
        if _profiling():
            return torch.profiler.record_function(name)
        return _NULL_SPAN

    @contextlib.contextmanager
    def _recorded(self, name: str, attrs: dict):
        rf = torch.profiler.record_function(name) if _profiling() else None
        if rf is not None:
            rf.__enter__()
        path = "/".join(self._stack + [name])
        depth = len(self._stack)
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.records.append({"span": name, "path": path,
                                 "t0": round(t0 - self._t0, 6),
                                 "dur": time.perf_counter() - t0,
                                 "depth": depth, **attrs})
            if rf is not None:
                rf.__exit__(None, None, None)

    def summary(self) -> dict:
        """{name: {mean_s, total_s, n}} over the recorded spans."""
        agg: dict[str, list[float]] = {}
        for r in self.records:
            agg.setdefault(r["span"], []).append(float(r["dur"]))
        return {k: {"mean_s": sum(v) / len(v), "total_s": sum(v),
                    "n": len(v)} for k, v in agg.items()}

    def export_jsonl(self, fh) -> None:
        for r in self.records:
            fh.write(json.dumps({"kind": "span", **r}, default=str) + "\n")


ledger = CommLedger()
tracer = SpanTracer()


#: the program's span entry: :meth:`SpanTracer.span` on :data:`tracer`
span = tracer.span


@contextlib.contextmanager
def collect_spans():
    """Record spans, and nothing else, within a block: the tracer is
    cleared on entry and yielded, and its records and :meth:`SpanTracer.
    summary` hold the block's spans afterwards.  The comm ledger, the
    flight recorder and the other host planes stay as the telemetry
    switch has them."""
    global _COLLECT
    tracer.reset()
    _COLLECT += 1
    try:
        yield tracer
    finally:
        _COLLECT -= 1


def record_comm(verb: str, tree: Any, *, combiner: str | None = None,
                wire_dtype: "torch.dtype | None" = None,
                hops: int = 1) -> None:
    """The one hook the collective verbs call, once per call.  ``hops``:
    how many times the recorded payload crosses the wire in the call (a
    chunked ring move records one chunk and makes ``n_chunks`` hops); the
    site records keep it, so the wire audit can hold the call's bytes to
    payload × hops."""
    if not _ENABLED:
        return
    ledger.record(verb, tree, combiner=combiner, wire_dtype=wire_dtype,
                  hops=hops)
    from harp_tpu_torch.utils import steptrace

    if steptrace.tracer._run is not None:
        steptrace.tracer.on_comm(verb)


def export(path: str) -> None:
    """Write every collected record as one JSONL file: spans, the comm
    ledger, the flight recorder, the skew ledger, the request trace, the
    health findings, the elastic actions, the superstep timeline and the
    memory ledger (the input of the ``report``, ``trace``, ``timeline``,
    ``health`` and ``memory`` CLIs)."""
    from harp_tpu_torch import elastic, health
    from harp_tpu_torch.utils import (flightrec, memrec, reqtrace, skew,
                                      steptrace)

    with open(path, "w") as fh:
        tracer.export_jsonl(fh)
        ledger.export_jsonl(fh)
        flightrec.export_jsonl(fh)
        skew.export_jsonl(fh)
        reqtrace.tracer.export_jsonl(fh)
        health.export_jsonl(fh)
        elastic.export_jsonl(fh)
        steptrace.export_jsonl(fh)
        memrec.export_jsonl(fh)


def export_timeline(path: str) -> None:
    """Merge every timestamped spine into one causally ordered
    ``kind:"trace"`` JSONL: the request trace and its marks as they are,
    host spans (at their start) and compiles (kernel builds and graph
    captures, at their wall offset) as marks, each source normalised to
    its own origin; then the aggregate spines (comm ledger, transfer
    totals, skew phases) as ``summary`` rows at the last timestamp, and
    the superstep timeline's ``kind:"steptrace"`` rows unmodified."""
    from harp_tpu_torch.utils import flightrec, reqtrace, skew, steptrace

    def _normalized(rows: list[dict]) -> list[dict]:
        if not rows:
            return []
        t0 = min(float(r["ts"]) for r in rows)
        return [{**r, "ts": round(float(r["ts"]) - t0, 6)} for r in rows]

    rows = _normalized(reqtrace.tracer.rows())
    host: list[dict] = [
        {"kind": "trace", "ev": "mark", "source": "span", "ts": r["t0"],
         "name": r["span"], "path": r["path"], "dur": r["dur"],
         "depth": r["depth"]}
        for r in tracer.records]
    host += [
        {"kind": "trace", "ev": "mark", "source": "compile",
         "ts": r.get("t", 0.0), "name": r.get("event") or "compile",
         "dur": r["dur"], "span": r["span"]}
        for r in flightrec.compile_watch.records]
    rows += _normalized(host)
    rows.sort(key=lambda r: r["ts"])
    t_end = rows[-1]["ts"] if rows else 0.0
    for tag, t in sorted(ledger.summary().items()):
        rows.append({"kind": "trace", "ev": "summary", "source": "comm",
                     "ts": t_end, "name": tag,
                     "executions": t["executions"],
                     "total_bytes": t["total_bytes"]})
    tr = flightrec.transfers.summary()
    if tr["sites"]:
        rows.append({"kind": "trace", "ev": "summary",
                     "source": "transfer", "ts": t_end, "name": "totals",
                     "h2d_bytes": tr["h2d_bytes"],
                     "dispatches": tr["dispatches"],
                     "readbacks": tr["readbacks"]})
    for phase, s in skew.ledger.summary().items():
        rows.append({"kind": "trace", "ev": "summary", "source": "skew",
                     "ts": t_end, "name": phase,
                     "max_mean_ratio": s.get("max_mean_ratio")})
    stamp = flightrec.provenance_stamp()
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps({**row, **stamp}, default=str) + "\n")
        steptrace.tracer.export_jsonl(fh, stamp)


#: the record kinds an export holds
KINDS = ("span", "comm", "compile", "transfer", "skew", "trace", "health",
         "elastic", "steptrace", "memory")


def load_rows(path: str) -> dict[str, list[dict]]:
    """Read an :func:`export` file back, keyed by record kind (an unknown
    kind lands under ``"comm"``, as in the reference)."""
    out: dict[str, list[dict]] = {k: [] for k in KINDS}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            kind = row.get("kind")
            out[kind if kind in out else "comm"].append(row)
    return out


def load_jsonl(path: str) -> tuple[list[dict], list[dict]]:
    """(span rows, comm rows) of an :func:`export` file."""
    rows = load_rows(path)
    return rows["span"], rows["comm"]
