"""Execution flight recorder: compile, transfer and dispatch counts with
budgets that a test or a serving loop enforces — the port of
``harp_tpu.utils.flightrec``.

**CompileWatch** counts what "compiles" on this card: a kernel build by
:func:`harp_tpu_torch.ops.build.build` (each source it compiles, also in
its ``BUILD_LOG``) and a CUDA-graph capture made through
:func:`harp_tpu_torch.utils.timing.capture_graph`.  PyTorch runs eagerly,
so nothing else compiles; a serving loop that captures or builds in its
steady state shows up here, with the span it happened under, and an
open superstep-timeline run (``steptrace``) marks each one.

**TransferLedger** counts H2D bytes and calls, blocking D2H readbacks and
their bytes, and dispatches, per (op, call site, span).  The port's
transfer points feed it: ``WorkerMesh.shard_array`` and the serve engines'
``put_input`` (H2D, :func:`record_h2d`), :func:`readback` (one blocking
``.cpu()``) and ``timing.device_sync`` (D2H), and :func:`track`-wrapped
callables (one dispatch a call).

**budget** / **SteadyState** snapshot the counters and raise
:class:`BudgetExceeded` (or warn) when a block or a serving batch spends
more than its bound.

Everything shares telemetry's switch (``HARP_TELEMETRY=1`` /
``telemetry.enable()``) and is free while it is off: every entry returns
before it touches a tensor, byte counts come from shapes only, and no
record adds a device op.  The four observer registries
(:func:`observe_dispatches`, :func:`observe_h2d`,
:func:`observe_readbacks`, :func:`observe_ckpt_writes`) work with
telemetry off: the fault injector rides them.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import warnings
from typing import Any, Callable

from harp_tpu_torch.utils import telemetry

_PROV_FIELDS = ("backend", "date", "commit")


def _call_site() -> str:
    """The nearest frame outside this package's utils, the transfer
    wrappers (mesh, dispatch), torch and contextlib."""
    import torch

    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    here = os.path.dirname(os.path.abspath(__file__))
    skip_tails = ("parallel/mesh.py", "parallel/dispatch.py")
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if (not fn.startswith(torch_dir) and not fn.endswith(skip_tails)
                and os.path.dirname(fn) != here
                and "contextlib" not in os.path.basename(fn)):
            return f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?:0"


# ---------------------------------------------------------------------------
# CompileWatch
# ---------------------------------------------------------------------------

class CompileWatch:
    """Every kernel build and graph capture, with its duration, what it
    was and the span it ran under."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.records: list[dict] = []  # {"dur", "span", "t", "event", "name"}

    def on_compile(self, duration: float, *, event: str = "graph_capture",
                   name: str | None = None) -> None:
        self.count += 1
        self.total_s += float(duration)
        self.records.append({"dur": round(float(duration), 6),
                             "span": telemetry.tracer.current_path(),
                             "t": round(time.perf_counter()
                                        - telemetry.tracer._t0, 6),
                             "event": event, "name": name})
        from harp_tpu_torch.utils import steptrace

        if steptrace.tracer._run is not None:
            steptrace.tracer.on_compile(duration, event, name)

    def summary(self) -> dict:
        """{"count", "total_s", "by_span": {span_path: {count, total_s}}}."""
        by_span: dict[str, dict] = {}
        for r in self.records:
            s = by_span.setdefault(r["span"] or "(no span)",
                                   {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] = round(s["total_s"] + r["dur"], 6)
        return {"count": self.count, "total_s": round(self.total_s, 6),
                "by_span": by_span}

    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        """One row per compile; ``count``/``total_s`` are cumulative."""
        cum = 0.0
        for i, r in enumerate(self.records):
            cum = round(cum + r["dur"], 6)
            row = {"kind": "compile", "event": r["event"], "name": r["name"],
                   "count": i + 1, "dur": r["dur"], "total_s": cum,
                   "span": r["span"], "t": r["t"], **(stamp or {})}
            fh.write(json.dumps(row) + "\n")


def on_build(name: str, seconds: float) -> None:
    """Hook for ``ops.build.build``: one kernel source compiled."""
    if telemetry.enabled():
        compile_watch.on_compile(seconds, event="kernel_build", name=name)


def on_capture(label: str, seconds: float) -> None:
    """Hook for ``timing.capture_graph``: one CUDA graph captured."""
    if telemetry.enabled():
        compile_watch.on_compile(seconds, event="graph_capture", name=label)


# ---------------------------------------------------------------------------
# TransferLedger
# ---------------------------------------------------------------------------

class TransferLedger:
    """H2D/D2H bytes and dispatches per (op, site, span).  Ops: ``h2d``
    (host to device placement), ``readback`` (a blocking device to host
    fetch), ``dispatch`` (one call of a :func:`track`-wrapped callable),
    ``bucket`` (exchange-buffer bytes staged by a capacity bucketing)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.h2d_bytes = 0
        self.h2d_calls = 0
        self.d2h_bytes = 0
        self.readbacks = 0
        self.dispatches = 0
        self.bucket_bytes = 0
        self._sites: dict[tuple, dict] = {}

    def _rec(self, op: str, nbytes: int, site: str | None) -> None:
        site = site or _call_site()
        span = telemetry.tracer.current_path()
        r = self._sites.setdefault(
            (op, site, span), {"op": op, "site": site, "span": span,
                               "bytes": 0, "calls": 0})
        r["bytes"] += int(nbytes)
        r["calls"] += 1

    def record_h2d(self, nbytes: int, site: str | None = None) -> None:
        self.h2d_bytes += int(nbytes)
        self.h2d_calls += 1
        self._rec("h2d", nbytes, site)

    def record_readback(self, nbytes: int = 0,
                        site: str | None = None) -> None:
        self.d2h_bytes += int(nbytes)
        self.readbacks += 1
        self._rec("readback", nbytes, site)

    def record_dispatch(self, site: str | None = None) -> None:
        self.dispatches += 1
        self._rec("dispatch", 0, site)

    def record_bucket(self, nbytes: int, site: str | None = None) -> None:
        self.bucket_bytes += int(nbytes)
        self._rec("bucket", nbytes, site)

    def summary(self) -> dict:
        sites = sorted(self._sites.values(),
                       key=lambda r: (-r["bytes"], r["op"], r["site"]))
        return {"h2d_bytes": self.h2d_bytes, "h2d_calls": self.h2d_calls,
                "d2h_bytes": self.d2h_bytes, "readbacks": self.readbacks,
                "dispatches": self.dispatches,
                "bucket_bytes": self.bucket_bytes,
                "sites": [dict(r) for r in sites]}

    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        for r in sorted(self._sites.values(),
                        key=lambda r: (r["op"], r["site"])):
            fh.write(json.dumps({"kind": "transfer", **r,
                                 **(stamp or {})}) + "\n")


compile_watch = CompileWatch()
transfers = TransferLedger()


def reset() -> None:
    """Clear both collectors (``telemetry.scope`` does this on entry)."""
    compile_watch.reset()
    transfers.reset()


# ---------------------------------------------------------------------------
# Observers (independent of the telemetry switch)
# ---------------------------------------------------------------------------

# An observer sees the original arguments and may raise: a raising
# observer aborts the observed operation before it is counted or
# performed, which models a transient failure in flight.  Every list is
# empty in an unobserved run, so the cost is one falsy check an event.
_READBACK_OBSERVERS: list[Callable[[Any], None]] = []
_DISPATCH_OBSERVERS: list[Callable[[str], None]] = []
_H2D_OBSERVERS: list[Callable[[int, Any], None]] = []
_CKPT_WRITE_OBSERVERS: list[Callable[[str], None]] = []


@contextlib.contextmanager
def _observe(registry: list, cb: Callable):
    registry.append(cb)
    try:
        yield
    finally:
        registry.remove(cb)


def observe_readbacks(cb: Callable[[Any], None]):
    """``cb(x)`` before every :func:`readback` of ``x`` within the block."""
    return _observe(_READBACK_OBSERVERS, cb)


def observe_dispatches(cb: Callable[[str], None]):
    """``cb(label)`` before every :func:`track`-wrapped dispatch, before it
    is counted or launched (only launched dispatches count)."""
    return _observe(_DISPATCH_OBSERVERS, cb)


def observe_h2d(cb: Callable[[int, Any], None]):
    """``cb(nbytes, site)`` before every counted host to device placement
    (``WorkerMesh.shard_array``, a serve engine's ``put_input``)."""
    return _observe(_H2D_OBSERVERS, cb)


def observe_ckpt_writes(cb: Callable[[str], None]):
    """``cb(path)`` at every checkpoint write, just before the write's
    rename; an exception from ``cb`` aborts the save."""
    return _observe(_CKPT_WRITE_OBSERVERS, cb)


def notify_ckpt_write(path: str) -> None:
    """Hook for ``CheckpointManager.save``."""
    for cb in tuple(_CKPT_WRITE_OBSERVERS):
        cb(path)


# ---------------------------------------------------------------------------
# Record points
# ---------------------------------------------------------------------------

def record_h2d(nbytes: int, site: str | None = None) -> None:
    """Hook for host to device placements (observers first)."""
    if _H2D_OBSERVERS:
        for cb in tuple(_H2D_OBSERVERS):
            cb(nbytes, site)
    if telemetry.enabled():
        transfers.record_h2d(nbytes, site)
        from harp_tpu_torch.utils import memrec

        memrec.on_staged(nbytes, site or _call_site())


def record_readback(nbytes: int = 0, site: str | None = None) -> None:
    """Hook for blocking device to host fetches (``timing.device_sync``)."""
    if telemetry.enabled():
        transfers.record_readback(nbytes, site)


def record_bucket(nbytes: int, site: str | None = None) -> None:
    """Hook for capacity-bucket staging."""
    if telemetry.enabled():
        transfers.record_bucket(nbytes, site)


def readback(x: Any):
    """``x`` as a numpy array: one blocking copy of a tensor to the host (a
    numpy array passes through), counted as one D2H round trip."""
    import numpy as np
    import torch

    if _READBACK_OBSERVERS:
        for cb in tuple(_READBACK_OBSERVERS):
            cb(x)
    # a copy even on the CPU: the caller keeps the array while a buffer
    # it came from is reused
    out = (x.detach().to("cpu", copy=True).numpy()
           if isinstance(x, torch.Tensor) else np.asarray(x))
    if telemetry.enabled():
        transfers.record_readback(out.nbytes)
    return out


class _Tracked:
    """:func:`track`'s wrapper: one dispatch a call; every other attribute
    is the wrapped callable's."""

    __slots__ = ("__wrapped__", "_label")

    def __init__(self, fn: Callable, label: str):
        self.__wrapped__ = fn
        self._label = label

    def __call__(self, *args, **kw):
        if _DISPATCH_OBSERVERS:  # before counting: a raising observer
            for cb in tuple(_DISPATCH_OBSERVERS):  # is a dispatch that
                cb(self._label)                    # never launched
        if telemetry.enabled():
            transfers.record_dispatch(self._label)
            from harp_tpu_torch.utils import memrec

            memrec.on_dispatch(self._label, args)
            out = self.__wrapped__(*args, **kw)
            memrec.on_output(self._label, out)
            return out
        return self.__wrapped__(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.__wrapped__, name)


def track(fn: Callable, label: str,
          donate_argnums: tuple[int, ...] | None = None) -> Callable:
    """Wrap ``fn`` so each call counts one dispatch under ``label``.  The
    wrapper adds one Python ``if`` a call and never touches the
    arguments.  ``donate_argnums`` declares to the memory ledger which
    arguments a call consumes (their buffers leave its live set)."""
    if donate_argnums is not None:
        from harp_tpu_torch.utils import memrec

        memrec.register_dispatch(label, donate_argnums)
    return _Tracked(fn, label)


# ---------------------------------------------------------------------------
# Budgets
# ---------------------------------------------------------------------------

class BudgetExceeded(RuntimeError):
    """A flight-recorder budget was exceeded (see :func:`budget`)."""


_BUDGET_KEYS = ("compiles", "compile_s", "h2d_bytes", "h2d_calls",
                "dispatches", "readbacks", "d2h_bytes")


def snapshot() -> dict:
    """The cumulative counters (a budget's baseline)."""
    return {"compiles": compile_watch.count,
            "compile_s": round(compile_watch.total_s, 6),
            "h2d_bytes": transfers.h2d_bytes,
            "h2d_calls": transfers.h2d_calls,
            "dispatches": transfers.dispatches,
            "readbacks": transfers.readbacks,
            "d2h_bytes": transfers.d2h_bytes}


def delta_since(base: dict) -> dict:
    now = snapshot()
    return {k: (round(now[k] - base[k], 6) if k == "compile_s"
                else now[k] - base[k]) for k in _BUDGET_KEYS}


class _BudgetScope:
    """Yielded by :func:`budget`: ``spent()`` reads the live deltas."""

    def __init__(self, base: dict):
        self._base = base

    def spent(self) -> dict:
        return delta_since(self._base)


def _notify_health(tag: str, over: list[tuple[str, Any, Any]]) -> None:
    """A warn-mode violation also lands on the health monitor's
    budget-drift detector."""
    from harp_tpu_torch import health

    health.monitor.observe_budget(tag, over)


@contextlib.contextmanager
def budget(compiles: int | None = None, h2d_bytes: int | None = None,
           dispatches: int | None = None, readbacks: int | None = None,
           d2h_bytes: int | None = None, h2d_calls: int | None = None,
           *, action: str = "raise", tag: str = ""):
    """Bound the counters' deltas across a block (None: unbounded).  On a
    violation ``action="raise"`` raises :class:`BudgetExceeded` naming
    every exceeded counter; ``action="warn"`` warns, records a
    budget-drift health finding and goes on.  A no-op while telemetry is
    off; if the block raises, its exception propagates unchecked."""
    if not telemetry.enabled():
        yield None
        return
    limits = {"compiles": compiles, "h2d_bytes": h2d_bytes,
              "h2d_calls": h2d_calls, "dispatches": dispatches,
              "readbacks": readbacks, "d2h_bytes": d2h_bytes}
    scope_ = _BudgetScope(snapshot())
    yield scope_
    spent = scope_.spent()
    over = [(name, spent[name], limit) for name, limit in limits.items()
            if limit is not None and spent[name] > limit]
    if over:
        msg = (f"flight-recorder budget exceeded"
               f"{f' [{tag}]' if tag else ''}: "
               + "; ".join(f"{n} used {s} > budget {l}" for n, s, l in over))
        if action == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            _notify_health(tag or _call_site(), over)
        else:
            raise BudgetExceeded(msg)


class SteadyState:
    """A per-batch budget for a long-lived loop (the serving guard): each
    :meth:`batch` window is held to the limits, violations are counted,
    and :meth:`summary` gives the counter deltas since :meth:`reset`.
    ``action="raise"`` raises on the offending batch, ``"warn"`` warns,
    counts and keeps serving.  A window is a no-op while telemetry is
    off."""

    def __init__(self, compiles: int | None = 0,
                 dispatches: int | None = 1, readbacks: int | None = 1,
                 h2d_bytes: int | None = None,
                 d2h_bytes: int | None = None,
                 h2d_calls: int | None = None, *,
                 action: str = "raise", tag: str = "steady"):
        self.limits = {"compiles": compiles, "dispatches": dispatches,
                       "readbacks": readbacks, "h2d_bytes": h2d_bytes,
                       "d2h_bytes": d2h_bytes, "h2d_calls": h2d_calls}
        self.action = action
        self.tag = tag
        self.reset()

    def reset(self) -> None:
        """Start a fresh steady-state window (a server's startup calls
        this, so its captures never count against the steady state)."""
        self.batches = 0
        self.violations = 0
        self._base = snapshot() if telemetry.enabled() else None

    @contextlib.contextmanager
    def batch(self):
        if not telemetry.enabled():
            yield None
            return
        if self._base is None:  # telemetry enabled after construction
            self._base = snapshot()
        base = snapshot()
        yield None
        spent = delta_since(base)
        self.batches += 1
        over = [(k, spent[k], v) for k, v in self.limits.items()
                if v is not None and spent[k] > v]
        if over:
            self.violations += 1
            msg = (f"steady-state budget exceeded [{self.tag}] batch "
                   f"{self.batches}: "
                   + "; ".join(f"{k} used {s} > budget {v}"
                               for k, s, v in over))
            if self.action == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
                _notify_health(self.tag, over)
            else:
                raise BudgetExceeded(msg)

    def summary(self) -> dict:
        out = {"batches": self.batches, "violations": self.violations}
        if self._base is not None:
            out.update(delta_since(self._base))
        return out

    def verify_exact(self, batches: int, *, compiles: int = 0) -> dict:
        """The continuous loop's exact accounting: since :meth:`reset`,
        exactly one dispatch and one readback a dispatched batch and
        exactly ``compiles`` compiles (under-spending means work bypassed
        the tracked path).  Returns the spent dict ({} while telemetry
        never was on); raises or warns per ``action``."""
        if self._base is None:
            return {}
        spent = delta_since(self._base)
        wrong = [(k, spent[k], want)
                 for k, want in (("compiles", compiles),
                                 ("dispatches", batches),
                                 ("readbacks", batches))
                 if spent[k] != want]
        if wrong:
            self.violations += 1
            msg = (f"steady-state exact accounting failed [{self.tag}] "
                   f"over {batches} batches: "
                   + "; ".join(f"{k} spent {s} != exactly {w}"
                               for k, s, w in wrong))
            if self.action == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                _notify_health(self.tag, wrong)
            else:
                raise BudgetExceeded(msg)
        return spent


# ---------------------------------------------------------------------------
# Calibrated overheads (the cost model's readout)
# ---------------------------------------------------------------------------

#: Fixed costs of the execution plane on the card, which the cost model
#: (:mod:`harp_tpu_torch.perfmodel`) charges as its ``overhead`` term, so
#: that the flight recorder and the model agree about what a dispatch
#: costs.  Each value is the median of the probe that
#: ``python -m harp_tpu_torch.perfmodel.measure --overheads`` runs, from
#: the ``kind: "overhead"`` row of ``H100_EVIDENCE.jsonl`` (NVIDIA H100
#: 80GB HBM3, 700.00 W, 2026-10-18):
#:
#: - ``dispatch_s``: one small op's launch from the host, back to back
#:   with no synchronize (what a wrapper call or a torch op costs the host);
#: - ``readback_s``: a scalar ``.item()`` after a synchronize;
#: - ``compile_s``: one CUDA-graph capture of a ten-op step (the serve
#:   plane's cost of a rung; a kernel build is cached on disk, and its
#:   cached load is below this);
#: - ``h2d_gbs``: a 256 MiB copy from pinned host memory, bytes a second.
CALIBRATED_OVERHEADS = {
    "dispatch_s": 9.863209e-06,
    "readback_s": 1.3859e-05,
    "compile_s": 4.508155e-03,
    "h2d_gbs": 50.466870826e9,
}


def calibrated_overheads() -> dict:
    """A copy of :data:`CALIBRATED_OVERHEADS` (a copy, so a consumer that
    changes its dict recalibrates no one else)."""
    return dict(CALIBRATED_OVERHEADS)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def provenance_stamp() -> dict:
    """backend/date/commit for exported rows: ``backend`` is ``cuda`` once
    this process has used a card, else ``cpu``, so a CPU count never
    reads as evidence about the card."""
    import torch

    from harp_tpu_torch.utils.metrics import provenance

    prov = provenance("cuda" if torch.cuda.is_initialized() else "cpu")
    return {k: prov.get(k) for k in _PROV_FIELDS}


def export_jsonl(fh) -> None:
    """Append compile and transfer rows (``telemetry.export`` calls this)."""
    if not compile_watch.records and not transfers._sites:
        return
    stamp = provenance_stamp()
    compile_watch.export_jsonl(fh, stamp)
    transfers.export_jsonl(fh, stamp)
