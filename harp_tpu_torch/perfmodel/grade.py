"""Self-grading: replay the cost model against the port's own card rows:
the port of ``harp_tpu.perfmodel.grade``.

Before the model may rank anything, it must agree with every card
measurement the port has committed: ``H100_EVIDENCE.jsonl`` at the repo
root, which ``python -m harp_tpu_torch.perfmodel.measure`` writes on the
card (and nothing else).  Three checks, all CPU-only, all fail-closed (a
row the harness cannot price is reported, never skipped into a pass):

1. **Family ranking**: for every candidate → incumbent pair of
   :data:`FAMILY_PAIRS` whose two arms both have full-shape card rows, the
   model's predicted winner must match the measured one.  A pair whose
   measured speedup lies within the :data:`DEAD_BAND` is ``too_close``.
   The reference also holds the model to its committed flip verdicts; the
   port has no flip verdicts (no config's default has been flipped by a
   measurement on the card), so that check has nothing to read here.
2. **Sweep rank correlation**: the card sweeps of the knobs the port's
   kernels honour (:data:`SWEEPS`: K3's ``u_tile``/``i_tile`` and K4's
   ``d_tile``/``w_tile``) must rank alike under the model: Spearman rho ≥
   :data:`RANK_FLOOR` a sweep.  K1 and K2 have no tile knob (their library
   plans the tiles, ``km::make_plan``), so they have no sweep.
3. **Magnitude band**: every committed full-shape card row the model
   prices must land within :data:`MAGNITUDE_TOL`× of the measured rate.

Rows whose ``backend`` is not ``cuda``, smoke rows and error rows are
never graded.  ``grade()`` returns a report; any failure flips ``ok`` and
carries both sides' term breakdowns.
"""

from __future__ import annotations

import json
import os

from harp_tpu_torch.perfmodel import model as M

#: the committed evidence file, at the repo root
EVIDENCE = "H100_EVIDENCE.jsonl"

#: |measured speedup - 1| at or below this is a tie
DEAD_BAND = 0.10

#: predicted rate must land within this factor of the measured rate
MAGNITUDE_TOL = 50.0

#: minimum Spearman rho a sweep
RANK_FLOOR = 0.9

#: candidate -> (incumbent, metric, metric_fallback | None): each kernel
#: arm over the plain arm of its family, and int8 streaming over f32
FAMILY_PAIRS = {
    "kmeans_pallas": ("kmeans", "iters_per_sec", None),        # K2
    "kmeans_int8": ("kmeans", "iters_per_sec", None),          # K1
    "kmeans_stream_int8": ("kmeans_stream", "iters_per_sec", None),
    "mfsgd_pallas": ("mfsgd", "updates_per_sec_per_chip", None),   # K3
    "lda_pallas": ("lda", "tokens_per_sec_per_chip", None),        # K4
    "svm_kernel_pallas": ("svm", "samples_per_sec", None),         # K5
    "wdamds_dist_pallas": ("wdamds", "iters_per_sec", None),       # K6
    "rf_hist_pallas": ("rf_dense_hist", "trees_per_sec", None),    # K7
}

#: sweep name -> (config, the knobs a point sets, metric); the points are
#: the committed ``kind: "sweep"`` rows of that name
SWEEPS = {
    "mfsgd_pallas_tile": ("mfsgd_pallas", ("u_tile", "i_tile"),
                          "updates_per_sec_per_chip"),
    "lda_pallas_tile": ("lda_pallas", ("d_tile", "w_tile"),
                        "tokens_per_sec_per_chip"),
}


def _gradable(row: dict) -> bool:
    return (row.get("backend") == "cuda" and not row.get("smoke")
            and "error" not in row)


def read_rows(path: str) -> list[dict]:
    """Every JSON object line of ``path`` (none when it is missing)."""
    rows = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        pass
    return rows


def latest_card_rows(path: str) -> dict:
    """config -> the last full-shape card bench row (a row with a
    ``config`` and no ``kind``); CPU, smoke and error rows never grade."""
    out: dict = {}
    for row in read_rows(path):
        if row.get("kind") is None and row.get("config") and _gradable(row):
            out[row["config"]] = row
    return out


def load_sweep_points(path: str) -> dict:
    """sweep name -> (config, [(knobs, measured rate)]) from the
    committed ``kind: "sweep"`` card rows, the last row of each point."""
    pts: dict = {}
    for row in read_rows(path):
        name = row.get("sweep")
        if row.get("kind") != "sweep" or name not in SWEEPS \
                or not _gradable(row):
            continue
        cfg, knobs, metric = SWEEPS[name]
        if row.get(metric) is None:
            continue
        key = tuple(row.get(k) for k in knobs)
        pts.setdefault(name, {})[key] = (
            {k: row.get(k) for k in knobs}, float(row[metric]), row)
    return {name: (SWEEPS[name][0], [v for _, v in sorted(p.items())])
            for name, p in pts.items()}


def committed_sheets(path: str) -> dict:
    """program -> its ledger sheet, from the last committed card
    ``kind: "plan"`` row of each program (a site's ``sheet_bytes`` are a
    program run's, so its amplification is 1)."""
    out: dict = {}
    for row in read_rows(path):
        if row.get("kind") == "plan" and row.get("program") \
                and _gradable(row):
            out[row["program"]] = {"collectives": [
                {"site": s["site"], "verb": s.get("verb"),
                 "primitive": s["primitive"],
                 "per_shard_bytes": s["sheet_bytes"], "amplification": 1}
                for s in row.get("sites") or []]}
    return out


def spearman(xs, ys) -> float:
    """Spearman rank correlation (no ties: knob sweeps)."""
    def ranks(vals):
        order = sorted(range(len(vals)), key=lambda i: vals[i])
        r = [0] * len(vals)
        for rank_, i in enumerate(order):
            r[i] = rank_
        return r

    rx, ry = ranks(xs), ranks(ys)
    n = len(xs)
    if n < 2:
        return 1.0
    d2 = sum((a - b) ** 2 for a, b in zip(rx, ry))
    return 1.0 - 6.0 * d2 / (n * (n * n - 1))


def _metric_value(row, metric, fallback):
    v = row.get(metric)
    if v is None and fallback:
        v = row.get(fallback)
    return float(v) if v is not None else None


def grade(repo: str | None = None, topo=None) -> dict:
    """Run the three checks against ``<repo>/H100_EVIDENCE.jsonl``."""
    if repo is None:
        repo = os.getcwd()
    if topo is None:
        from harp_tpu_torch.plan.topology import single_card

        topo = single_card()  # every committed row is one card's
    path = os.path.join(repo, EVIDENCE)
    bench = latest_card_rows(path)
    report = {"ok": True, "evidence": path, "rows": len(bench),
              "pairs": [], "sweeps": [], "magnitude": [], "unpriced": [],
              "failures": []}

    def fail(msg, **detail):
        report["ok"] = False
        report["failures"].append({"what": msg, **detail})

    if not bench:
        fail(f"no card bench rows in {path}: nothing to grade against "
             "(python -m harp_tpu_torch.perfmodel.measure writes them)")

    # 1. family ranking ----------------------------------------------------
    for cand, (inc, metric, fb) in sorted(FAMILY_PAIRS.items()):
        crow, irow = bench.get(cand), bench.get(inc)
        entry = {"candidate": cand, "incumbent": inc}
        cv = _metric_value(crow, metric, fb) if crow else None
        iv = _metric_value(irow, metric, fb) if irow else None
        if not cv or not iv:
            entry["status"] = "unmeasured"
            report["pairs"].append(entry)
            continue
        measured = cv / iv
        entry["measured"] = round(measured, 4)
        if cand not in M.CONFIG_MODELS or inc not in M.CONFIG_MODELS:
            entry["status"] = "unpriced"
            report["pairs"].append(entry)
            continue
        pc, pi = price(cand, crow, topo), price(inc, irow, topo)
        predicted = pi.predicted_s / pc.predicted_s
        entry.update({"predicted": round(predicted, 4),
                      "candidate_terms": pc.terms(),
                      "incumbent_terms": pi.terms()})
        if abs(measured - 1.0) <= DEAD_BAND:
            entry["status"] = "too_close"
        elif (measured > 1.0) == (predicted > 1.0):
            entry["status"] = "agrees"
        else:
            entry["status"] = "DISAGREES"
            fail(f"ranking: {cand} vs {inc} measured {measured:.3f}x "
                 f"but the model predicts {predicted:.3f}x", pair=entry)
        report["pairs"].append(entry)

    # 2. sweep rank correlation --------------------------------------------
    loaded = load_sweep_points(path)
    for name in sorted(SWEEPS):
        if name not in loaded:
            report["sweeps"].append({"sweep": name, "status": "unmeasured"})
            continue
        cfg, pts = loaded[name]
        meas = [r for _, r, _ in pts]
        prices = [price(cfg, row, topo) for _, _, row in pts]
        pred = [p.predicted_rate for p in prices]
        rho = spearman(meas, pred)
        entry = {"sweep": name, "config": cfg, "points": len(pts),
                 "knobs": [k for k, _, _ in pts], "rho": round(rho, 4),
                 "measured_rates": meas,
                 "predicted_rates": [round(p, 2) for p in pred]}
        report["sweeps"].append(entry)
        if rho < RANK_FLOOR:
            fail(f"sweep {name}: rho {rho:.3f} < floor {RANK_FLOOR}",
                 sweep=entry, terms=[p.terms() for p in prices])

    # 3. magnitude band ----------------------------------------------------
    for cfg, row in sorted(bench.items()):
        if cfg not in M.CONFIG_MODELS:
            report["unpriced"].append(cfg)
            continue
        p = price(cfg, row, topo)
        mv = _metric_value(row, p.metric, None)
        if mv is None or mv <= 0:
            continue
        factor = max(p.predicted_rate / mv, mv / p.predicted_rate)
        entry = {"config": cfg, "measured": mv,
                 "predicted": round(p.predicted_rate, 4),
                 "factor": round(factor, 3), "bound": p.bound}
        report["magnitude"].append(entry)
        if factor > MAGNITUDE_TOL:
            fail(f"magnitude: {cfg} predicted {p.predicted_rate:.3g} vs "
                 f"measured {mv:.3g} ({factor:.0f}x off > "
                 f"{MAGNITUDE_TOL}x)", row=entry, terms=p.terms())
    return report


def price(config, row, topo):
    """Module-level alias: grade-side callers and tests patch one name."""
    return M.price(config, row, topo)
