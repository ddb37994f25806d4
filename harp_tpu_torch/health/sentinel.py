"""Streaming health sentinel: SLO burn, budget drift and memory pressure —
the port of ``harp_tpu.health.sentinel``.

The derived telemetry spine: it watches the others at run time and keeps
``kind:"health"`` findings, one upserted row per (detector, subject), with
the reference's frozen vocabularies (:data:`DETECTORS`,
:data:`SEVERITIES`, :data:`VERDICTS`).

- **SLO burn** (:class:`SLOBurn`): multi-window error-budget burn over a
  serving plane's request outcomes (shed, failed, deadline-missed, or
  over a latency objective): a breach needs the fast window (the newest
  sub-window) and the slow window (the whole ring) past their floors.  It
  lives on the serve plane's ``ContinuousRunner`` (``runner.health``).
- **budget drift** (:meth:`HealthMonitor.observe_budget`): the flight
  recorder's warn-mode budget violations, one row a site with the count
  and the worst offender.
- **memory pressure** (:meth:`HealthMonitor.observe_memory`): the memory
  ledger's peak eating into the card's capacity, or drifting above a
  baseline peak.

- **skew trigger** (:meth:`HealthMonitor.observe_skew`): K consecutive
  skew-ledger records of a phase over :data:`WASTED_FRAC_TRIGGER` fire a
  finding with the ``suggest_rebalance`` plan inline; the elastic loop
  takes it exactly once (:meth:`HealthMonitor.consume_skew_trigger`), and
  a recovery below the threshold re-arms it.

A new finding is a ``health`` mark on an open superstep timeline
(``steptrace``).  The evidence grader is :mod:`harp_tpu_torch.health.grade`,
over ``perfmodel``.

Every observe entry returns before it touches state while telemetry is
off, and none touches a tensor.
"""

from __future__ import annotations

import json
from typing import Any

from harp_tpu_torch.utils import telemetry

#: frozen detector vocabulary, the reference's.  ``memory_pressure``
#: rides the memory ledger: the run's peak eating into the card's
#: capacity past :data:`HEADROOM_WARN_FRAC` remaining, or drifting more
#: than :data:`MEM_DRIFT_FRAC` above a committed baseline peak, warns.
#: ``evidence_regression`` and ``profile_drift`` come from the grader,
#: which is not ported.
DETECTORS = ("slo_burn", "skew_trigger", "budget_drift",
             "evidence_regression", "profile_drift", "memory_pressure")

#: frozen severity vocabulary, mildest first.  ``info`` = recorded, no
#: action; ``warn`` = degradation that needs a look; ``page`` = the SLO
#: is burning fast enough to exhaust its error budget within the window.
SEVERITIES = ("info", "warn", "page")

#: frozen evidence-regression verdicts (the grader's vocabulary).
VERDICTS = ("confirmed", "improved", "regressed", "model_invalidated")

_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# -- SLO burn thresholds ------------------------------------------------------

#: default error budget: the allowed fraction of offered requests that
#: may go bad (shed / hard-failed / deadline-missed / over the latency
#: objective) — 1%, the serve plane's degraded-mode tolerance.
SLO_ERROR_BUDGET = 0.01

#: burn-rate floor on the FAST window (the newest sub-window).  Burn
#: rate = bad_fraction / error_budget; >= 2 means the newest sub-window
#: alone is spending budget at least twice as fast as sustainable.
FAST_BURN_MIN = 2.0

#: burn-rate floor on the SLOW window (the whole ring).  Both floors
#: must be crossed to breach — the classic multi-window rule: the fast
#: window alone pages on blips, the slow window alone pages too late.
SLOW_BURN_MIN = 1.0

#: slow-window burn at or above this escalates the breach to ``page``
#: (budget exhausted ~6x faster than sustainable).
PAGE_BURN = 6.0

# -- skew trigger thresholds --------------------------------------------------

#: ``wasted_frac`` (SkewLedger imbalance model: the fraction of total
#: chip-time idle-waiting at the superstep barrier) at or above this is
#: a trigger-eligible superstep.
WASTED_FRAC_TRIGGER = 0.25

#: consecutive trigger-eligible records of one phase before the finding
#: fires (a single skewed superstep is noise; K in a row is a workload).
TRIGGER_SUPERSTEPS = 3

# -- memory pressure thresholds ----------------------------------------------

#: remaining-HBM fraction below which the memrec watermark is a warn:
#: a run whose peak leaves <10% headroom has no room for a second
#: tenant's executables, a donated depth-2 pipeline's second buffer, or
#: a restage-after-shrink — the admission margin, not an OOM predictor.
HEADROOM_WARN_FRAC = 0.10

#: fractional growth of the peak watermark over a committed baseline
#: peak at or above which memory_pressure warns (the profile_drift
#: analogue for bytes: the footprint mix changed, re-price admission).
MEM_DRIFT_FRAC = 0.10


class HealthMonitor:
    """The findings ledger — one upserted row per (detector, subject).

    Rows are plain dicts mutated in place as a run progresses, so the
    exported row always carries the run's final cumulative counts and
    reconciles exactly with the serve plane's outcome counts.
    ``mark()``/``since()`` let a bench delimit "findings new to this
    run" without resetting the monitor.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._rows: dict[Any, dict] = {}
        self._skew: dict[str, dict] = {}
        self._seq = 0

    # -- row lifecycle ------------------------------------------------------
    def mark(self) -> int:
        """Sequence watermark: findings created after this mark are
        "new" to the caller's run (see :meth:`since`)."""
        return self._seq

    def since(self, mark: int) -> list[dict]:
        return [r for r in self.findings() if r["_seq"] > mark]

    def upsert(self, detector: str, key: Any, *,
               severity: str = "warn") -> dict:
        """Get-or-create the (detector, key) row; severity only ever
        escalates (a page never demotes back to warn)."""
        if detector not in DETECTORS:
            raise ValueError(f"detector {detector!r} not in {DETECTORS}")
        if severity not in SEVERITIES:
            raise ValueError(f"severity {severity!r} not in {SEVERITIES}")
        k = (detector, key)
        row = self._rows.get(k)
        if row is None:
            self._seq += 1
            row = {"kind": "health", "detector": detector,
                   "severity": severity, "_seq": self._seq}
            self._rows[k] = row
            # one superstep-timeline mark per new finding (updates mutate
            # the row in place)
            from harp_tpu_torch.utils import steptrace

            if steptrace.tracer._run is not None:
                steptrace.tracer.on_health(detector, key)
        elif _SEV_RANK[severity] > _SEV_RANK[row["severity"]]:
            row["severity"] = severity
        return row

    def findings(self) -> list[dict]:
        """Every finding, oldest first (``_seq`` retained for
        :meth:`since`; export strips private fields)."""
        return sorted(self._rows.values(), key=lambda r: r["_seq"])

    # -- skew trigger -------------------------------------------------------
    def observe_skew(self, phase: str, ledger) -> None:
        """One SkewLedger record for ``phase`` landed (the module-level
        ``skew.record_execution``/``record_partition`` hooks call this).
        Fires after :data:`TRIGGER_SUPERSTEPS` consecutive records with
        ``wasted_frac >= WASTED_FRAC_TRIGGER``, carrying the
        ``suggest_rebalance`` plan inline; latched until the phase
        recovers below the threshold (no per-superstep re-fire spam)."""
        if not telemetry.enabled():
            return
        rec = ledger._phases.get(phase)
        if rec is None:
            return
        from harp_tpu_torch.utils.skew import SkewLedger

        imb = SkewLedger._imbalance(rec)
        wf = imb.get("wasted_frac")
        st = self._skew.setdefault(
            phase, {"consec": 0, "supersteps": 0, "latched": False,
                    "consumed": False})
        st["supersteps"] += 1
        if wf is None or wf < WASTED_FRAC_TRIGGER:
            st["consec"] = 0
            st["latched"] = False
            # the latch release re-arms the handshake: a LATER re-fire
            # hands a fresh plan to consume_skew_trigger
            st["consumed"] = False
            return
        st["consec"] += 1
        if st["consec"] < TRIGGER_SUPERSTEPS or st["latched"]:
            return
        st["latched"] = True
        row = self.upsert("skew_trigger", phase, severity="warn")
        row.update({
            "phase": phase, "wasted_frac": wf,
            "max_mean_ratio": imb.get("max_mean_ratio"),
            "supersteps": st["supersteps"],
            "consecutive": st["consec"],
            # the elastic-execution handoff: apply_rebalance-shaped; the
            # elastic loops consume it between supersteps via
            # :meth:`consume_skew_trigger` and replay it through
            # schedule.apply_rebalance
            "plan": ledger.suggest_rebalance(phase),
        })

    def consume_skew_trigger(self, phase: str) -> dict | None:
        """The sentinel↔trainer handshake: hand the latched
        ``skew_trigger`` finding for ``phase`` to the elastic loop
        EXACTLY ONCE.

        Returns the finding row (inline ``plan`` included) the first
        time the elastic loop asks after the trigger fired; every later call
        returns None until the phase recovers below the threshold (the
        latch release) and a NEW trigger fires — so one fired plan can
        never be applied twice, and a still-skewed phase cannot spam
        re-application of a stale plan.  No-op (None) while telemetry
        is off: the zero-cost contract extends to the acting half.
        """
        if not telemetry.enabled():
            return None
        st = self._skew.get(phase)
        if st is None or not st.get("latched") or st.get("consumed"):
            return None
        st["consumed"] = True
        row = self._rows.get(("skew_trigger", phase))
        if row is not None:
            row["consumed"] = True  # visible in the exported evidence
        from harp_tpu_torch.utils import steptrace

        if steptrace.tracer._run is not None:
            # actuation mark: the handshake firing lands on the
            # superstep timeline next to the rebalance it triggers
            steptrace.tracer.on_skew_consume(phase)
        return row

    # -- budget drift -------------------------------------------------------
    def observe_budget(self, tag: str,
                       over: list[tuple[str, Any, Any]]) -> None:
        """One WARN-mode flight-budget violation at ``tag`` (flightrec
        calls this next to its RuntimeWarning).  ``over`` is the
        violation list as (counter, spent, bound) triples; the row keeps
        the per-site count and the worst offender by overspend ratio."""
        if not telemetry.enabled():
            return
        row = self.upsert("budget_drift", tag, severity="warn")
        row["tag"] = tag
        row["violations"] = row.get("violations", 0) + 1

        def ratio(t):
            name, spent, bound = t
            return (float(spent) - float(bound)) / max(abs(float(bound)),
                                                       1.0)

        worst = max(over, key=ratio)
        if ratio(worst) > row.get("_worst_ratio", float("-inf")):
            row["_worst_ratio"] = ratio(worst)
            row["worst"] = (f"{worst[0]} used {worst[1]} > "
                            f"budget {worst[2]}")

    # -- memory pressure ----------------------------------------------------
    def observe_memory(self, tag: str, peak_bytes: int, hbm_bytes: int,
                       *, baseline_peak: int | None = None) -> None:
        """One memrec watermark observation at ``tag`` (memrec fires
        this the first time a run's peak crosses the headroom line;
        graders pass ``baseline_peak`` to check drift against committed
        evidence).  Warns when remaining headroom drops below
        :data:`HEADROOM_WARN_FRAC` or the peak grew more than
        :data:`MEM_DRIFT_FRAC` over the baseline."""
        if not telemetry.enabled():
            return
        if hbm_bytes <= 0:
            return
        headroom = max(0.0, 1.0 - peak_bytes / hbm_bytes)
        drift = (None if not baseline_peak
                 else (peak_bytes - baseline_peak) / baseline_peak)
        pressed = headroom < HEADROOM_WARN_FRAC
        drifted = drift is not None and drift >= MEM_DRIFT_FRAC
        if not (pressed or drifted):
            return
        row = self.upsert("memory_pressure", tag, severity="warn")
        row["tag"] = tag
        row["peak_hbm_bytes"] = int(peak_bytes)
        row["hbm_bytes"] = int(hbm_bytes)
        row["headroom_frac"] = round(headroom, 6)
        if drift is not None:
            row["peak_drift_frac"] = round(drift, 6)

    # -- reading / export ---------------------------------------------------
    def summary(self) -> dict:
        """Machine summary for the report's ``health`` section."""
        rows = [_public(r) for r in self.findings()]
        return summarize_rows(rows) | {"rows": rows}

    def export_jsonl(self, fh, stamp: dict | None = None) -> None:
        """One provenance-stamped row per finding (``kind: "health"``)."""
        for row in self.findings():
            fh.write(json.dumps({**_public(row), **(stamp or {})}) + "\n")


def _public(row: dict) -> dict:
    return {k: v for k, v in row.items() if not k.startswith("_")}


def summarize_rows(rows: list[dict]) -> dict:
    """Summarize loaded ``kind:"health"`` rows (CLI + report core).

    ``actionable`` counts findings a clean run must not have: severity
    warn/page, or an evidence verdict in {regressed, model_invalidated}
    — the health CLI's exit-1 condition.
    """
    by_det: dict[str, int] = {}
    worst = None
    actionable = 0
    for r in rows:
        det = r.get("detector", "?")
        by_det[det] = by_det.get(det, 0) + 1
        sev = r.get("severity")
        if sev in _SEV_RANK and (worst is None
                                 or _SEV_RANK[sev] > _SEV_RANK[worst]):
            worst = sev
        if sev in ("warn", "page") or r.get("verdict") in (
                "regressed", "model_invalidated"):
            actionable += 1
    return {"findings": len(rows), "by_detector": by_det,
            "worst_severity": worst, "actionable": actionable}


# ---------------------------------------------------------------------------
# SLO burn
# ---------------------------------------------------------------------------

class SLOBurn:
    """Multi-window burn-rate tracking over one serving plane's outcomes.

    Error-budget semantics: of the requests offered in a window, at most
    ``error_budget`` may go *bad* (not served, deadline-missed, or over
    the optional ``latency_slo_ms`` objective).  Burn rate is
    ``bad_fraction / error_budget``; 1.0 spends the budget exactly at
    the sustainable rate.  A breach needs the FAST window (newest
    sub-window, a cliff detector) at :data:`FAST_BURN_MIN` AND the SLOW
    window (the whole ring) at :data:`SLOW_BURN_MIN` — the classic
    two-window rule.  Breaches latch until the slow burn recovers below
    1.0, so a sustained outage is one finding, not one per request.

    The ring reuses :class:`~harp_tpu_torch.utils.reqtrace.
    RollingWindow`'s epoch-keyed slot scheme (stale slots detected by
    epoch, never scanned or cleared on the hot path); memory is
    ``subwindows`` count pairs no matter how long the server runs.
    Cumulative outcome counters (``counts``) reconcile exactly with the
    runner's served/shed/failed counts and the request tracer's.
    """

    def __init__(self, tag: str, *, window_s: float = 60.0,
                 subwindows: int = 6,
                 error_budget: float = SLO_ERROR_BUDGET,
                 latency_slo_ms: float | None = None):
        if window_s <= 0 or subwindows < 2:
            raise ValueError(f"need window_s > 0 and >= 2 subwindows, "
                             f"got {window_s}/{subwindows}")
        if not 0.0 < error_budget <= 1.0:
            raise ValueError(f"error_budget {error_budget} must be in "
                             "(0, 1]")
        self.tag = tag
        self.window_s = float(window_s)
        self.sub_s = self.window_s / int(subwindows)
        self.k = int(subwindows)
        self.error_budget = float(error_budget)
        self.latency_slo_ms = latency_slo_ms
        # ring slot -> [epoch, offered, bad]
        self._ring: list[list | None] = [None] * self.k
        self.counts = {"offered": 0, "served": 0, "shed": 0, "failed": 0,
                       "deadline_missed": 0}
        self.breaches = 0
        self.peak_fast = 0.0
        self.peak_slow = 0.0
        self._latched = False
        self._recent_bad: list[int] = []
        self._row: dict | None = None

    # -- the one entry point ------------------------------------------------
    def observe(self, now: float, outcome: str, *,
                latency_ms: float | None = None,
                deadline_missed: bool = False,
                rid: int | None = None) -> None:
        """One terminal request outcome on the runner's clock.  No-op
        while telemetry is off (the zero-cost contract)."""
        if not telemetry.enabled():
            return
        c = self.counts
        c["offered"] += 1
        c[outcome] += 1
        if deadline_missed:
            c["deadline_missed"] += 1
        bad = (outcome != "served" or deadline_missed
               or (self.latency_slo_ms is not None
                   and latency_ms is not None
                   and latency_ms > self.latency_slo_ms))
        epoch = int(now / self.sub_s)
        i = epoch % self.k
        cur = self._ring[i]
        if cur is None or cur[0] != epoch:
            cur = [epoch, 0, 0]
            self._ring[i] = cur
        cur[1] += 1
        if bad:
            cur[2] += 1
            if rid is not None:
                self._recent_bad.append(rid)
                del self._recent_bad[:-8]
        self._check(now, epoch)
        if self._row is not None:  # keep the exported row's counts FINAL
            self._row.update(c)
            self._row["breaches"] = self.breaches
            self._row["fast_burn"] = round(self.peak_fast, 3)
            self._row["slow_burn"] = round(self.peak_slow, 3)
            self._row["recent_reqs"] = list(self._recent_bad)

    def burn(self, now: float) -> tuple[float, float]:
        """(fast, slow) burn rates at ``now`` (0.0 before any sample)."""
        epoch = int(now / self.sub_s)
        fo = fb = so = sb = 0
        for cur in self._ring:
            if cur is None or epoch - cur[0] >= self.k:
                continue
            so += cur[1]
            sb += cur[2]
            if cur[0] == epoch:
                fo, fb = cur[1], cur[2]
        fast = (fb / fo / self.error_budget) if fo else 0.0
        slow = (sb / so / self.error_budget) if so else 0.0
        return fast, slow

    def _check(self, now: float, epoch: int) -> None:
        fast, slow = self.burn(now)
        self.peak_fast = max(self.peak_fast, fast)
        self.peak_slow = max(self.peak_slow, slow)
        if fast >= FAST_BURN_MIN and slow >= SLOW_BURN_MIN:
            if not self._latched:
                self._latched = True
                self.breaches += 1
            sev = "page" if slow >= PAGE_BURN else "warn"
            # keyed by the instance, not the tag: two runs of the same
            # app in one process each get their own run-scoped row
            self._row = monitor.upsert("slo_burn", self, severity=sev)
            self._row.setdefault("tag", self.tag)
            self._row["error_budget"] = self.error_budget
            self._row["window_s"] = self.window_s
        elif slow < SLOW_BURN_MIN:
            self._latched = False  # hysteresis: re-arm on recovery

    def snapshot(self, now: float) -> dict:
        """Live view for stats lines (works with telemetry off: zeros)."""
        fast, slow = self.burn(now)
        return {**self.counts, "fast_burn": round(fast, 3),
                "slow_burn": round(slow, 3), "breaches": self.breaches,
                "error_budget": self.error_budget}


# ---------------------------------------------------------------------------
# Module singleton + export
# ---------------------------------------------------------------------------

monitor = HealthMonitor()


def reset() -> None:
    """Clear the monitor (telemetry.scope does this on entry)."""
    monitor.reset()


def export_jsonl(fh) -> None:
    """Append health rows (telemetry.export calls this), stamped with
    the flight recorder's provenance, so a CPU finding never reads as
    the card's."""
    if not monitor._rows:
        return
    from harp_tpu_torch.utils import flightrec

    monitor.export_jsonl(fh, flightrec.provenance_stamp())
