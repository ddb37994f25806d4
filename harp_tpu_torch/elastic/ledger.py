"""Elastic-execution evidence: provenance-stamped ``kind:"elastic"``
rows — the port of ``harp_tpu.elastic.ledger``.

One row per elastic action, in the order they happened:

- ``rebalance``: a consumed ``skew_trigger`` moved packs between workers
  mid-run: per-worker ``loads_before``/``loads_after`` (both summing to
  ``total``: moves conserve work) and ``wasted_frac_before``/``_after``
  (the skew ledger's imbalance model; a move that does not lower it is
  refused and leaves no row);
- ``shrink``: a permanent worker loss removed a worker:
  ``n_workers_after < n_workers_before``, the lost worker, the injection
  site and ordinal, and ``capacity_frac`` (the run goes on at
  survivors / workers before the loss);
- ``resume``: a rebuild from a checkpoint completed: the worker count,
  the replayed per-worker ``loads`` (summing to ``total``), their
  ``wasted_frac``, and whether a repartition plan was replayed (after a
  shrink) or the stored assignment reused (a restart on the same mesh).

Rows are recorded whether telemetry is on or off: they describe actions,
not observations (the zero-cost contract governs the sentinel that
triggers them).  ``telemetry.export`` writes them with the flight
recorder's provenance stamp, so a CPU drill never reads as the card's.
"""

from __future__ import annotations

import json

#: the event vocabulary (the reference's)
EVENTS = ("rebalance", "shrink", "resume")


class ElasticLedger:
    """Append-only action log; one dict per event (see module doc)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.rows: list[dict] = []

    def record(self, event: str, phase: str, **fields) -> dict:
        if event not in EVENTS:
            raise ValueError(f"event {event!r} not in {EVENTS}")
        # on_timeline says whether a steptrace run covered this event:
        # covered rows match the timeline's elastic marks one for one,
        # while a row recorded outside any run (a manual install() for a
        # comparison) has no mark
        from harp_tpu_torch.utils import steptrace

        covered = steptrace.tracer._run is not None
        row = {"kind": "elastic", "event": event, "phase": phase,
               "on_timeline": covered, **fields}
        self.rows.append(row)
        if covered:
            steptrace.tracer.on_elastic(event, phase, row)
        return row

    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        for row in self.rows:
            fh.write(json.dumps({**row, **(stamp or {})}) + "\n")


# ---------------------------------------------------------------------------
# Module singleton + hooks (the other spines' shape)
# ---------------------------------------------------------------------------

ledger = ElasticLedger()


def reset() -> None:
    """Clear the ledger (telemetry.scope does this on entry)."""
    ledger.reset()


def record(event: str, phase: str, **fields) -> dict:
    """Module-level shorthand for :meth:`ElasticLedger.record`."""
    return ledger.record(event, phase, **fields)


def export_jsonl(fh) -> None:
    """Append elastic rows (telemetry.export calls this); stamped with
    the flight recorder's provenance triple."""
    if not ledger.rows:
        return
    from harp_tpu_torch.utils import flightrec

    ledger.export_jsonl(fh, flightrec.provenance_stamp())
