"""``python -m harp_tpu_torch profile <app|--all> [--json] [--device D]``:
the wall-attribution CLI.

Captures each requested app's registered driver under the trace hook,
attributes every device op into the frozen mechanism buckets, and prints
a human attribution table (or, with ``--json``, one provenance-stamped
``kind: "profile"`` row per app).  Runs on the card unless ``--device``
says otherwise, and raises without one, like every entry point.

Exit codes: 0 every row reconciled; 1 a row failed a cross-check (the
bucket sum, the flight recorder's dispatch count, a build or capture in
the timed window, or a trace short of a kernel's launches); 2 an unknown
app or a capture that raised.
"""

from __future__ import annotations

import argparse
import json
import sys


def _render(row: dict) -> str:
    terms = row["terms"]
    wall = row["wall_s"] or 1e-12
    parts = "  ".join(
        f"{k[:-2]} {v:.4f}s ({100.0 * v / wall:4.1f}%)"
        for k, v in sorted(terms.items(), key=lambda kv: -kv[1])
        if v > 0)
    flag = "ok" if row["reconciled"] else "FAILED: " + "; ".join(
        row.get("why", []))
    kernels = "  ".join(f"{k} {v['traced']}/{v['launches']}"
                        for k, v in row.get("kernels", {}).items())
    return (f"{row['app']:13s} {row['program']:20s} wall {wall:.4f}s  "
            f"bound={row['bound']:11s} [{flag}]\n"
            f"          {parts}\n"
            f"          wire {row['wire_bytes']} B over "
            f"{row['wire_sites']} site(s)  dispatches "
            f"{row['dispatches']} ({row['dispatches_per_rep']}/rep)  "
            f"compiles {row['compiles_in_window']}  "
            f"sum_rel_err {row['sum_rel_err']}"
            + (f"\n          kernels traced/launched: {kernels}"
               if kernels else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch profile",
        description="capture one driver run per app and attribute its "
                    "wall to the frozen mechanism buckets")
    p.add_argument("app", nargs="?", help="app to profile "
                   "(kmeans/mfsgd/lda/rf/svm/wdamds/subgraph/serve and "
                   "the _pallas arms)")
    p.add_argument("--all", action="store_true",
                   help="profile every registered app")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="one kind:'profile' JSONL row per app")
    p.add_argument("--reps", type=int, default=4,
                   help="timed repetitions inside the trace (default 4)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card)")
    args = p.parse_args(argv)

    from harp_tpu_torch.profile import attribution

    if args.all:
        apps = list(attribution.PROFILE_APPS)
    elif args.app:
        if args.app not in attribution.PROFILE_APPS:
            print(f"unknown app {args.app!r}; known: "
                  f"{', '.join(attribution.PROFILE_APPS)}", file=sys.stderr)
            return 2
        apps = [args.app]
    else:
        p.print_usage(sys.stderr)
        return 2

    attribution._device(args.device)  # no card and no --device: raise
    rows = []
    for app in apps:
        try:
            rows.append(attribution.capture(app, reps=args.reps,
                                            device=args.device))
        except Exception as e:  # noqa: BLE001 - a broken capture is loud
            print(f"profile: capture failed for {app!r}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 2

    for row in rows:
        if args.as_json:
            print(json.dumps(row), flush=True)
        else:
            print(_render(row))
    return 0 if all(r["reconciled"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
