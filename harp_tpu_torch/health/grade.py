"""Evidence regression: grade fresh card measurements against the port's
committed ones and the cost model: the port of ``harp_tpu.health.grade``.

A freshly measured bench row is judged against two baselines:

1. the **committed incumbent**: the latest full-shape CUDA row for the
   same config in ``H100_EVIDENCE.jsonl`` (the collector's file,
   ``perfmodel.grade.latest_card_rows``): ``regressed`` / ``improved``
   outside the ±10% dead band (:data:`REL_TOL`), ``confirmed`` inside;
2. the **cost model's prediction** (:mod:`harp_tpu_torch.perfmodel`), on
   ``single_card``: the magnitude band (``grade.MAGNITUDE_TOL``) and, for
   a candidate with a measured incumbent, the ranking direction.  Either
   failing gives ``model_invalidated``: the model mis-priced the card.

:func:`model_gate` re-runs the model's whole self-grade against the
committed evidence and turns it into one ``evidence_regression`` finding;
``python -m harp_tpu_torch health --grade-model`` prints it.  A fresh
``kind: "profile"`` row is held to the committed ``kind: "profile"`` rows
of the same file (:func:`grade_profile_row`).
"""

from __future__ import annotations

import os

from harp_tpu_torch.health import sentinel

#: |ratio - 1| at or below this is "confirmed": the model's dead band
REL_TOL = 0.10

#: headline metric resolution order: the first key present in a row is
#: its metric family
METRIC_KEYS = ("iters_per_sec", "updates_per_sec_per_chip",
               "tokens_per_sec_per_chip", "samples_per_sec",
               "vertices_per_sec", "trees_per_sec", "points_per_sec",
               "iters_per_sec_ex_gen", "qps")


def headline_metric(row: dict) -> tuple[str | None, float | None]:
    for k in METRIC_KEYS:
        v = row.get(k)
        if v is not None:
            try:
                return k, float(v)
            except (TypeError, ValueError):
                return None, None
    return None, None


def _evidence(repo: str) -> str:
    from harp_tpu_torch.perfmodel.grade import EVIDENCE

    return os.path.join(repo, EVIDENCE)


def grade_bench_row(row: dict, repo: str, *, bench: dict | None = None,
                    topo=None) -> dict | None:
    """Judge one freshly measured bench row; register and return the
    ``evidence_regression`` finding, or None when there is nothing to
    grade against (no incumbent and no model).

    Rows that are not the card's (``backend`` other than ``cuda``), smoke
    rows and error rows are never graded."""
    from harp_tpu_torch.perfmodel import grade as G
    from harp_tpu_torch.perfmodel import model as M

    cfg = row.get("config")
    if (not cfg or row.get("smoke") or "error" in row
            or row.get("backend") != "cuda"):
        return None
    metric, value = headline_metric(row)
    if metric is None or not value or value <= 0:
        return None
    if bench is None:
        bench = G.latest_card_rows(_evidence(repo))

    finding: dict = {"config": cfg, "metric": metric,
                     "measured": round(value, 4)}
    verdict = None

    # 1. vs the committed incumbent (same config, same metric family)
    inc = bench.get(cfg)
    iv = inc.get(metric) if inc is not None else None
    if iv:
        ratio = value / float(iv)
        finding["incumbent"] = round(float(iv), 4)
        finding["ratio_vs_incumbent"] = round(ratio, 4)
        verdict = ("regressed" if ratio < 1.0 - REL_TOL
                   else "improved" if ratio > 1.0 + REL_TOL
                   else "confirmed")

    # 2. vs the model: magnitude band + ranking direction
    if cfg in M.CONFIG_MODELS:
        if topo is None:
            from harp_tpu_torch.plan.topology import single_card

            topo = single_card()  # the committed evidence is one card's
        p = M.price(cfg, row, topo)
        factor = max(p.predicted_rate / value, value / p.predicted_rate)
        finding["predicted"] = round(p.predicted_rate, 4)
        finding["model_factor"] = round(factor, 2)
        if factor > G.MAGNITUDE_TOL:
            verdict = "model_invalidated"
        pair = G.FAMILY_PAIRS.get(cfg)
        if pair is not None and verdict != "model_invalidated":
            inc_name, pmetric, fb = pair
            irow = bench.get(inc_name)
            miv = G._metric_value(irow, pmetric, fb) if irow else None
            mcv = G._metric_value(row, pmetric, fb)
            if miv and mcv and inc_name in M.CONFIG_MODELS:
                pi = M.price(inc_name, irow, topo)
                measured = mcv / miv
                predicted = pi.predicted_s / p.predicted_s
                finding["measured_speedup"] = round(measured, 4)
                finding["predicted_speedup"] = round(predicted, 4)
                if (abs(measured - 1.0) > G.DEAD_BAND
                        and (measured > 1.0) != (predicted > 1.0)):
                    verdict = "model_invalidated"

    if verdict is None:
        return None
    sev = ("warn" if verdict in ("regressed", "model_invalidated")
           else "info")
    out = sentinel.monitor.upsert("evidence_regression", cfg,
                                  severity=sev)
    out.update(finding)
    out["verdict"] = verdict
    return sentinel._public(out)


#: bucket-share drift (absolute points of the wall) at or above which a
#: fresh profile row's attribution is a ``profile_drift`` warn
PROFILE_SHARE_DRIFT = 0.10


def committed_profiles(repo: str) -> dict[str, dict]:
    """Latest committed card ``kind: "profile"`` row per app (the
    collector's ``profile --all`` baseline in ``H100_EVIDENCE.jsonl``)."""
    from harp_tpu_torch.perfmodel.grade import read_rows

    out: dict[str, dict] = {}
    for row in read_rows(_evidence(repo)):
        if row.get("kind") == "profile" and row.get("app"):
            out[row["app"]] = row
    return out


def _bucket_shares(row: dict) -> dict[str, float] | None:
    wall = row.get("wall_s")
    terms = row.get("terms")
    if not isinstance(terms, dict) or not wall:
        return None
    try:
        return {k: float(v) / float(wall) for k, v in terms.items()}
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def grade_profile_row(row: dict, repo: str, *,
                      committed: dict | None = None) -> dict | None:
    """Judge one fresh ``kind: "profile"`` row against the committed
    baseline for its app; register and return a ``profile_drift``
    finding when the mechanism mix moved (the ``bound`` flipped, or a
    bucket's share of the wall moved more than
    :data:`PROFILE_SHARE_DRIFT`), else None.  Unreconciled rows are never
    graded."""
    app = row.get("app")
    if not app or row.get("reconciled") is not True:
        return None
    if committed is None:
        committed = committed_profiles(repo)
    base = committed.get(app)
    if base is None or base is row:
        return None
    shares, base_shares = _bucket_shares(row), _bucket_shares(base)
    if shares is None or base_shares is None:
        return None
    deltas = {k: shares.get(k, 0.0) - base_shares.get(k, 0.0)
              for k in set(shares) | set(base_shares)}
    worst = max(deltas, key=lambda k: abs(deltas[k]))
    bound_flipped = (row.get("bound") != base.get("bound"))
    if not bound_flipped and abs(deltas[worst]) <= PROFILE_SHARE_DRIFT:
        return None
    out = sentinel.monitor.upsert("profile_drift", app, severity="warn")
    out.update({
        "app": app, "bound": row.get("bound"),
        "committed_bound": base.get("bound"),
        "bound_flipped": bound_flipped,
        "worst_bucket": worst.removesuffix("_s"),
        "share_delta": round(abs(deltas[worst]), 4),
        "wall_s": row.get("wall_s"),
        "committed_wall_s": base.get("wall_s"),
    })
    return sentinel._public(out)


def model_gate(repo: str) -> tuple[bool, dict]:
    """Re-run the cost model's whole self-grade
    (``perfmodel.grade.grade``: pair directions, sweep rank correlation,
    magnitude band, against the committed evidence) and turn the outcome
    into an ``evidence_regression`` finding.  Returns ``(ok, finding)``;
    the gate re-grades every time, so it lifts exactly when the model has
    been re-calibrated against the evidence that invalidated it."""
    from harp_tpu_torch.perfmodel import grade as G

    report = G.grade(repo)
    ok = bool(report["ok"])
    verdict = "confirmed" if ok else "model_invalidated"
    row = sentinel.monitor.upsert("evidence_regression", "perfmodel.grade",
                                  severity="info" if ok else "page")
    row.update({
        "tag": "perfmodel.grade", "verdict": verdict,
        "failures": len(report["failures"]),
        # enough to act on without re-running (predict --grade has the
        # full term breakdowns); bounded so the row stays one line
        "detail": [f["what"] for f in report["failures"]][:4],
    })
    return ok, sentinel._public(row)
