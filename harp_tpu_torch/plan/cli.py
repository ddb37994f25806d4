"""``python -m harp_tpu_torch plan [PROGRAM…] [--topology T] [--json]
[--device D]``: plan the registered driver programs' collectives.

Runs each registered driver program once (the eleven of
:mod:`harp_tpu_torch.analysis.drivers`) under the CommLedger, prices
every site against the selected topology, and prints a schedule table
and ONE provenance-stamped ``kind: "plan"`` JSON line a program (through
:func:`harp_tpu_torch.utils.metrics.benchmark_json`).  The drivers run on
the card unless ``--device`` says otherwise, and raise without one, like
every entry point; the topology priced is a model, not the device the
drivers ran on.  Exit 0, or 2 for an unknown program.
"""

from __future__ import annotations

import argparse
import sys


def render(plan) -> str:
    lines = [f"== plan: {plan.program} on {plan.topology} "
             f"({plan.rates_source} rates) =="]
    if not plan.sites:
        lines.append("  (no collectives — nothing to schedule)")
    for s in plan.sites:
        alts = ", ".join(f"{k}={v:.3g}s" for k, v in
                         sorted(s.alternatives.items())) or "-"
        flip = f" -> measure with {s.flip_candidate}" \
            if s.flip_candidate else ""
        lines.append(
            f"  {s.site:32s} {s.primitive:14s} {s.sheet_bytes:>12d} B  "
            f"keep={s.cost_s:.3g}s  [{alts}]{flip}")
    lines.append(f"  total predicted: {plan.predicted_bytes_total()} B; "
                 f"knobs to measure: {plan.flip_candidates() or 'none'}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from harp_tpu_torch.plan.topology import TOPOLOGY_NAMES

    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch plan",
        description="topology-aware collective planner over the runtime "
                    "CommLedger of the registered drivers (fail-closed: "
                    "decisions name knobs to measure, never change "
                    "defaults)")
    p.add_argument("programs", nargs="*", metavar="PROGRAM",
                   help="registered driver programs (default: all)")
    p.add_argument("--topology", choices=("auto",) + TOPOLOGY_NAMES,
                   default="auto",
                   help="price list to plan against (auto: the mesh the "
                        "drivers run on)")
    p.add_argument("--json", action="store_true",
                   help="print only the machine-readable lines")
    p.add_argument("--device", default=None,
                   help="torch device the drivers run on (default: this "
                        "worker's card)")
    args = p.parse_args(argv)

    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.plan import topology as T
    from harp_tpu_torch.plan.planner import plan_program
    from harp_tpu_torch.utils.metrics import benchmark_json

    names = args.programs or sorted(DRIVERS)
    unknown = [n for n in names if n not in DRIVERS]
    if unknown:
        print(f"unknown program(s) {unknown}; registered: "
              f"{sorted(DRIVERS)}", file=sys.stderr)
        return 2
    mesh = WorkerMesh(args.device)   # no card and no --device: raise
    topo = (T.detect(mesh) if args.topology == "auto"
            else T.by_name(args.topology))
    for name in names:
        plan = plan_program(name, topo, mesh.device)
        if not args.json:
            print(render(plan))
        print(benchmark_json("plan", plan.row(), mesh.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
