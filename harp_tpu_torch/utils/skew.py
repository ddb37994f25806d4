"""Superstep skew profiler: per-worker load and straggler attribution —
the port of ``harp_tpu.utils.skew``.

A BSP superstep runs at the pace of its slowest worker; the comm ledger
and the flight recorder cannot say which worker that is.  The
**SkewLedger** records per-worker work at the three places it is cheaply
known, turns max/mean load into a predicted idle share, and
:meth:`SkewLedger.suggest_rebalance` gives the greedy repartition plan
that :mod:`harp_tpu_torch.schedule` and the elastic loops replay.

- **ingest** (:func:`record_partition`): the :mod:`harp_tpu_torch.
  fileformat` readers and the mfsgd/lda/subgraph/rf partitioners report
  per-shard real rows or nonzeros and the padding fraction, host
  arithmetic over arrays they already built.  ``units`` may carry the
  movable grains (files with byte sizes) for a whole-unit plan.
- **execution** (:func:`record_execution`): the kmeans/mfsgd/lda epoch
  loops report per-worker work (points, ratings, tokens) read back with
  the epoch's existing statistics, so no readback is added.
- **host phases** (:func:`record_host`): a process stamps its own wall
  seconds for a phase (:meth:`harp_tpu_torch.mapper.CollectiveApp.run`).

Everything shares telemetry's switch and is free while it is off: the
module-level hooks return before they touch their arguments.

The imbalance model: for per-worker work ``w`` a barrier superstep ends
when the most loaded worker does, so the idle share is ``1 - mean/max``
and a phase of ``wall_s`` wastes ``wall_s * n_workers * (1 - mean/max)``
worker-seconds.  Pricing that waste against a device's peak
(:func:`wasted_pct_of_peak`) needs a roofline of the card, which is not
ported (ROADMAP.md, Queue 1, item 9).
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

from harp_tpu_torch.utils import telemetry


class SkewLedger:
    """Per-phase, per-worker work accounting (see module docstring).

    One record per phase name; re-recording a phase overwrites its work
    vector (latest superstep wins — work is per-superstep, and a rerun
    re-measures the same corpus) while ``runs`` counts how often.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._phases: dict[str, dict] = {}

    # -- recording ----------------------------------------------------------
    def _put(self, phase: str, source: str, work, unit: str, **extra) -> None:
        w = np.asarray(work, np.float64).reshape(-1)
        rec = self._phases.get(phase)
        if rec is None or rec["source"] != source or len(rec["work"]) != len(w):
            rec = self._phases[phase] = {
                "phase": phase, "source": source, "unit": unit,
                "work": w, "runs": 0, "padding_frac": None, "wall_s": None,
                "units": None}
        rec["work"] = w
        rec["unit"] = unit
        rec["runs"] += 1
        for k, v in extra.items():
            if v is not None:
                rec[k] = v

    def record_partition(self, phase: str, work, *, unit: str = "rows",
                         padded_total: int | None = None,
                         units: Sequence[Sequence[tuple]] | None = None
                         ) -> None:
        """Ingest-time record: ``work[w]`` = real items on worker ``w``.

        ``padded_total`` is the total slot count after shape padding
        (``padding_frac = 1 - sum(work)/padded_total``); ``units`` is an
        optional per-worker list of movable ``(unit_id, size)`` grains
        (e.g. files) that :meth:`suggest_rebalance` can move whole.
        """
        pf = None
        if padded_total:
            pf = max(0.0, min(1.0, 1.0 - float(np.sum(np.asarray(
                work, np.float64))) / float(padded_total)))
        self._put(phase, "ingest", work, unit, padding_frac=pf,
                  units=[list(u) for u in units] if units is not None
                  else None)

    def record_execution(self, phase: str, work, *, unit: str,
                         wall_s: float | None = None,
                         units: Sequence[Sequence[tuple]] | None = None
                         ) -> None:
        """Execution record: ``work[w]`` = work units worker ``w``
        actually processed this superstep (from the epoch loop's stacked
        readback); ``wall_s`` is the measured host wall for the phase,
        the basis of the wasted-chip-seconds prediction.

        ``units``: optional per-worker movable ``(unit_id,
        size)`` grains, exactly as :meth:`record_partition` takes them.
        The elastic loops attach their pack grains here so the health
        sentinel's ``skew_trigger`` carries a WHOLE-UNIT
        ``suggest_rebalance`` plan — the shape
        ``schedule.apply_rebalance`` replays mid-run."""
        self._put(phase, "execution", work, unit,
                  wall_s=None if wall_s is None else float(wall_s),
                  units=[list(u) for u in units] if units is not None
                  else None)

    def record_host(self, phase: str, worker: int, wall_s: float,
                    n_workers: int | None = None) -> None:
        """Host-phase record: process ``worker`` spent ``wall_s`` seconds
        in ``phase`` this superstep.  Each process stamps only its own
        column (the Gloo/multi-host path); single-process callers fill
        worker 0 of a width-``n_workers`` vector."""
        rec = self._phases.get(phase)
        n = n_workers or (len(rec["work"]) if rec else worker + 1)
        n = max(n, worker + 1)
        w = np.zeros(n, np.float64)
        if rec is not None and rec["source"] == "host":
            w[: len(rec["work"])] = rec["work"][:n]
        w[worker] = float(wall_s)
        self._put(phase, "host", w, "seconds", wall_s=float(wall_s))

    # -- the imbalance model ------------------------------------------------
    @staticmethod
    def _imbalance(rec: dict) -> dict:
        w = rec["work"]
        total = float(w.sum())
        mean = total / len(w) if len(w) else 0.0
        mx = float(w.max()) if len(w) else 0.0
        ratio = (mx / mean) if mean > 0 else None
        wasted = (1.0 - mean / mx) if mx > 0 else None
        out = {"max_mean_ratio": None if ratio is None else round(ratio, 4),
               "wasted_frac": None if wasted is None else round(wasted, 4)}
        if wasted is not None and rec.get("wall_s"):
            # a barrier superstep ends when the max-loaded worker does:
            # every other worker idles (1 - w_i/max) of the wall
            out["wasted_chip_s"] = round(
                rec["wall_s"] * len(w) * wasted, 6)
        return out

    def summary(self) -> dict:
        """{phase: {source, unit, work, total, n_workers, max_mean_ratio,
        wasted_frac, [wasted_chip_s], [padding_frac], runs, [wall_s]}},
        most-imbalanced phases first."""
        out = {}
        for phase, rec in self._phases.items():
            row = {"source": rec["source"], "unit": rec["unit"],
                   "work": [round(float(x), 4) for x in rec["work"]],
                   "total": round(float(rec["work"].sum()), 4),
                   "n_workers": len(rec["work"]),
                   "runs": rec["runs"]}
            row.update(self._imbalance(rec))
            for k in ("padding_frac", "wall_s"):
                if rec.get(k) is not None:
                    row[k] = round(rec[k], 6)
            out[phase] = row
        return dict(sorted(out.items(),
                           key=lambda kv: -(kv[1]["max_mean_ratio"] or 0)))

    # -- the scheduler bridge -----------------------------------------------
    def suggest_rebalance(self, phase: str) -> dict | None:
        """Greedy repartition plan toward equal per-worker load.

        With ``units`` recorded (movable grains), re-runs greedy
        longest-processing-time placement over every unit (the same rule
        :func:`harp_tpu_torch.fileformat.multi_file_splits` applies to byte
        sizes, here on MEASURED loads) and emits whole-unit moves that
        :func:`harp_tpu_torch.schedule.apply_rebalance` can apply.  Without
        units the plan is fractional: surplus flows from overloaded to
        underloaded workers until all sit at the mean — the target a
        finer-grained partitioner should aim for.  Returns ``{phase,
        unit, moves, ratio_before, ratio_after, work_after}`` or None
        when the phase is unknown/empty.
        """
        rec = self._phases.get(phase)
        if rec is None or not len(rec["work"]) or rec["work"].sum() <= 0:
            return None
        before = self._imbalance(rec)["max_mean_ratio"]
        n = len(rec["work"])
        moves: list[dict] = []
        if rec.get("units"):
            units = [(uid, float(sz), w)
                     for w, lst in enumerate(rec["units"])
                     for uid, sz in lst]
            loads = np.zeros(n)
            assign: dict[Any, int] = {}
            for uid, sz, _ in sorted(units, key=lambda t: -t[1]):
                tgt = int(loads.argmin())
                assign[uid] = tgt
                loads[tgt] += sz
            for uid, sz, src in units:
                if assign[uid] != src:
                    moves.append({"id": uid, "from": src,
                                  "to": assign[uid], "work": sz})
            after_w = loads
        else:
            w = rec["work"].copy()
            mean = w.mean()
            surplus = [(i, w[i] - mean) for i in range(n) if w[i] > mean]
            deficit = [(i, mean - w[i]) for i in range(n) if w[i] < mean]
            surplus.sort(key=lambda t: -t[1])
            deficit.sort(key=lambda t: -t[1])
            si = di = 0
            while si < len(surplus) and di < len(deficit):
                s_i, s_amt = surplus[si]
                d_i, d_amt = deficit[di]
                amt = min(s_amt, d_amt)
                if amt > 1e-12:
                    moves.append({"from": s_i, "to": d_i,
                                  "work": round(float(amt), 4)})
                    w[s_i] -= amt
                    w[d_i] += amt
                if s_amt <= d_amt:
                    si += 1
                    deficit[di] = (d_i, d_amt - amt)
                if d_amt <= s_amt:
                    di += 1
                    if s_amt > d_amt:
                        surplus[si] = (s_i, s_amt - amt)
            after_w = w
        mean = after_w.mean()
        after = round(float(after_w.max() / mean), 4) if mean > 0 else None
        return {"phase": phase, "unit": rec["unit"], "moves": moves,
                "ratio_before": before, "ratio_after": after,
                "work_after": [round(float(x), 4) for x in after_w]}

    # -- export -------------------------------------------------------------
    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        """One provenance-stamped row per phase (``kind: "skew"``) — the
        shape the reference's JSONL checker validates: per-worker
        ``work`` sums to ``total``, ``padding_frac`` in [0, 1]."""
        for phase, row in self.summary().items():
            out = {"kind": "skew", "phase": phase, **row, **(stamp or {})}
            fh.write(json.dumps(out) + "\n")


# ---------------------------------------------------------------------------
# Module singleton + zero-cost hooks
# ---------------------------------------------------------------------------

ledger = SkewLedger()


def reset() -> None:
    """Clear the ledger (telemetry.scope does this on entry)."""
    ledger.reset()


def record_partition(phase: str, work, *, unit: str = "rows",
                     padded_total: int | None = None,
                     units=None) -> None:
    """Ingest hook for readers/partitioners (no-op when telemetry off).

    Also feeds the health sentinel's skew trigger: K consecutive
    records with ``wasted_frac`` over the threshold emit a
    ``kind:"health"`` finding carrying the ``suggest_rebalance`` plan
    inline — the elastic-execution hook the elastic loops consume
    mid-run (:mod:`harp_tpu_torch.elastic`)."""
    if telemetry.enabled():
        ledger.record_partition(phase, work, unit=unit,
                                padded_total=padded_total, units=units)
        from harp_tpu_torch import health

        health.monitor.observe_skew(phase, ledger)


def record_execution(phase: str, work, *, unit: str,
                     wall_s: float | None = None, units=None) -> None:
    """Execution hook for the epoch loops (no-op when telemetry off).
    Feeds the health sentinel's skew trigger like
    :func:`record_partition` — each call is one superstep's record.
    ``units`` carries the elastic loops' movable pack grains
    so the fired trigger's inline plan is whole-unit replayable."""
    if telemetry.enabled():
        ledger.record_execution(phase, work, unit=unit, wall_s=wall_s,
                                units=units)
        from harp_tpu_torch.utils import steptrace

        if steptrace.tracer._run is not None:
            # the per-worker lane for the covering superstep
            steptrace.tracer.on_execution(phase, work, unit=unit,
                                          wall_s=wall_s)
        from harp_tpu_torch import health

        health.monitor.observe_skew(phase, ledger)


def record_host(phase: str, worker: int, wall_s: float,
                n_workers: int | None = None) -> None:
    """Host-phase hook (the multi-process path; no-op when off)."""
    if telemetry.enabled():
        ledger.record_host(phase, worker, wall_s, n_workers=n_workers)


def suggest_rebalance(phase: str) -> dict | None:
    """Module-level shorthand for :meth:`SkewLedger.suggest_rebalance`."""
    return ledger.suggest_rebalance(phase)


def wasted_pct_of_peak(config: str, result: dict,
                       phase: str) -> float | None:
    """Skew waste stated in percent of the card's peak (the roofline
    composition).

    ``roofline.annotate(config, result)`` gives the percent of the H100's
    peak (:data:`roofline.H100_PEAKS`) that the measured rate achieves, on
    the peak of the route the row ran; the phase's wasted fraction says
    how much of that a balanced partition would reclaim.  None when
    either half is unavailable (no work model, phase unknown, zero
    work)."""
    from harp_tpu_torch.utils import roofline

    rec = ledger._phases.get(phase)
    if rec is None:
        return None
    imb = SkewLedger._imbalance(rec)
    if not imb.get("wasted_frac"):
        return None
    ann = roofline.annotate(config, result, roofline.H100_PEAKS)
    pct = ann.get("pct_peak_flops")
    if pct is None:
        return None
    return round(pct * imb["wasted_frac"], 3)


def export_jsonl(fh) -> None:
    """Append skew rows (telemetry.export calls this); stamped with the
    flight recorder's provenance triple — a CPU-sim work sheet must never
    read as the card's."""
    if not ledger._phases:
        return
    from harp_tpu_torch.utils import flightrec

    ledger.export_jsonl(fh, flightrec.provenance_stamp())
