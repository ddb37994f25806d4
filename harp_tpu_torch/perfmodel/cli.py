"""``python -m harp_tpu_torch predict [--json | --top N | --grade]
[--topology T] [--repo DIR]``: price configs and programs offline.

A predictor prices; it runs nothing and touches no device (no tensor is
made on any device; the CPU is enough).  Three modes:

- default / ``--json``: one provenance-stamped ``kind: "model"`` row a
  driver program (its ledger sheet priced wire + overhead: the sheet of
  the committed ``kind: "plan"`` row the collector took on the card, so
  that nothing runs here) and one a priceable config (the full
  compute/memory/wire/overhead breakdown at its graded shape);
- ``--top N``: the candidates ranked by predicted speedup over their
  incumbents (priced at the incumbent's committed row), with the unpriced
  candidates listed, never dropped;
- ``--grade``: replay the model against the committed
  ``H100_EVIDENCE.jsonl``; exit 1 with both sides' term breakdowns on any
  disagreement (:mod:`harp_tpu_torch.perfmodel.grade`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def candidate_ranking(topo, bench_rows=None) -> tuple:
    """(ranked [(candidate, speedup)...] desc, unpriced [names...]) over
    the grader's family pairs."""
    from harp_tpu_torch.perfmodel import grade as G
    from harp_tpu_torch.perfmodel import model as M

    pairs = {c: inc for c, (inc, _, _) in G.FAMILY_PAIRS.items()}
    speedups = M.rank_candidates(pairs, topo, bench_rows)
    ranked = sorted(speedups.items(), key=lambda kv: (-kv[1], kv[0]))
    unpriced = sorted(set(pairs) - set(speedups))
    return ranked, unpriced


def main(argv=None) -> int:
    from harp_tpu_torch.plan.topology import TOPOLOGY_NAMES

    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch predict",
        description="offline cost model on the H100's rates (a ranking "
                    "model, graded against the port's committed card "
                    "rows)")
    p.add_argument("--topology", choices=TOPOLOGY_NAMES,
                   default="single_card",
                   help="price list to predict against (default: one "
                        "card, the evidence's own)")
    p.add_argument("--json", action="store_true",
                   help="print only the machine-readable rows")
    p.add_argument("--top", type=int, default=None, metavar="N",
                   help="print only the top-N candidate ranking")
    p.add_argument("--grade", action="store_true",
                   help="replay the model against the committed evidence; "
                        "exit 1 on any disagreement")
    p.add_argument("--repo", default=None,
                   help="repo root whose H100_EVIDENCE.jsonl is read "
                        "(default: the current directory)")
    args = p.parse_args(argv)

    from harp_tpu_torch.perfmodel import grade as G
    from harp_tpu_torch.perfmodel import model as M
    from harp_tpu_torch.plan.topology import by_name

    topo = by_name(args.topology)
    repo = args.repo or os.getcwd()

    if args.grade:
        report = G.grade(repo)   # the evidence is one card's
        print(json.dumps({"kind": "model_grade", "ok": report["ok"],
                          "rows": report["rows"], "pairs": report["pairs"],
                          "sweeps": report["sweeps"],
                          "magnitude": report["magnitude"],
                          "unpriced": report["unpriced"]}))
        if not report["ok"]:
            for f in report["failures"]:
                print(f"GRADE FAIL: {json.dumps(f)}", file=sys.stderr)
            return 1
        n_ok = sum(1 for e in report["pairs"]
                   if e.get("status") == "agrees")
        print(f"model grade: OK ({n_ok} ranking agreements, "
              f"{len(report['sweeps'])} sweeps, "
              f"{len(report['magnitude'])} rows in band)", file=sys.stderr)
        return 0

    if args.top is not None:
        bench = G.latest_card_rows(os.path.join(repo, G.EVIDENCE))
        ranked, unpriced = candidate_ranking(topo, bench)
        for cand, speedup in ranked[:args.top]:
            print(json.dumps({"kind": "model_rank", "candidate": cand,
                              "predicted_speedup": speedup,
                              "topology": topo.name,
                              "rates_source": topo.rates_source}))
        if unpriced:
            print(f"unpriced candidates (no cost model: measure, don't "
                  f"guess): {unpriced}", file=sys.stderr)
        return 0

    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.utils.metrics import provenance

    # not metrics.benchmark_json's stamp order: the row's own kind first,
    # the stamp after, full precision
    stamp = provenance("cpu")

    def emit(row):
        print(json.dumps({**row, **stamp}), flush=True)

    sheets = G.committed_sheets(os.path.join(repo, G.EVIDENCE))
    for name in sorted(DRIVERS):
        if name not in sheets:
            print(f"== {name}: no committed sheet (no kind:'plan' row in "
                  f"{G.EVIDENCE})", file=sys.stderr)
            continue
        sheet = sheets[name]
        price = M.price_sheet(name, sheet, topo)
        row = M.model_row(price, topo, program=name)
        if not args.json:
            print(f"== {name}: wire {price.wire_s:.3g}s/run "
                  f"({len(sheet['collectives'])} sites), bound "
                  f"{row['bound']}")
        emit(row)
    for cfg in sorted(M.CONFIG_MODELS):
        price = M.price(cfg, None, topo)
        row = M.model_row(price, topo, config=cfg)
        if not args.json:
            t = price.terms()
            print(f"== {cfg}: {price.predicted_rate:.4g} {price.metric} "
                  f"predicted, bound {row['bound']} "
                  f"(c={t['compute_s']:.3g} m={t['memory_s']:.3g} "
                  f"w={t['wire_s']:.3g} o={t['overhead_s']:.3g})")
        emit(row)
    if not args.json:
        print(f"unpriced: {sorted(M.UNPRICED)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
