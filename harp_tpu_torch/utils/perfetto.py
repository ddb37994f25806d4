"""Chrome Trace Event plumbing for the request tracer: the port of
``harp_tpu.utils.perfetto``.

:func:`harp_tpu_torch.utils.reqtrace.perfetto` emits the Trace Event JSON
dialect that chrome://tracing and ui.perfetto.dev load directly:

- one ``M`` (metadata) event naming each process track,
- ``X`` (complete) events for terminated spans, ``ts``/``dur`` in
  microseconds from the earliest row in the export,
- ``i`` (instant) events for point marks, with scope ``"g"`` (global
  line across the view) or ``"t"`` (thread-local tick).

A :class:`TraceBuilder` holds the epoch ``t0`` and the growing event list;
an emitter appends spans and instants in its own pid/tid coordinates and
calls :meth:`TraceBuilder.build` for the ``{"traceEvents": [...],
"displayTimeUnit": "ms"}`` envelope.
"""

from __future__ import annotations

from typing import Any


def empty() -> dict:
    """The envelope for a rowless export (still Perfetto-loadable)."""
    return {"traceEvents": [], "displayTimeUnit": "ms"}


class TraceBuilder:
    """Accumulate Trace Event JSON events against one epoch ``t0``.

    Timestamps in are seconds on the caller's clock (wall
    ``perf_counter`` or a replay clock); timestamps out are microseconds
    from ``t0`` rounded to 3 decimals.
    """

    __slots__ = ("t0", "events")

    def __init__(self, t0: float = 0.0):
        self.t0 = float(t0)
        self.events: list[dict] = []

    def us(self, ts: float) -> float:
        """Seconds on the export clock → µs from the epoch."""
        return round((float(ts) - self.t0) * 1e6, 3)

    def process(self, pid: int, name: str) -> None:
        """Name a process track (``ph:"M"`` metadata event)."""
        self.events.append({"name": "process_name", "ph": "M",
                            "pid": pid, "args": {"name": name}})

    def complete(self, name: str, pid: int, tid: int, t_open: float,
                 t_close: float, args: dict[str, Any] | None = None) -> None:
        """A terminated span (``ph:"X"``); duration clamps at 0."""
        ev = {"name": name, "ph": "X", "pid": pid, "tid": int(tid),
              "ts": self.us(t_open),
              "dur": round(max(float(t_close) - float(t_open), 0.0) * 1e6,
                           3)}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, pid: int, tid: int, ts: float,
                scope: str = "g",
                args: dict[str, Any] | None = None) -> None:
        """A point mark (``ph:"i"``), scope "g" global / "t" thread."""
        ev = {"name": name, "ph": "i", "s": scope, "pid": pid,
              "tid": int(tid), "ts": self.us(ts)}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def build(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}
