"""``python -m harp_tpu_torch health``: the sentinel's offline half — the
port of ``harp_tpu.health.cli``.

Two modes, both on the CPU (a health check touches no card):

- ``health run.jsonl [--json]``: read a JSONL file (a telemetry export, a
  run's output, or the collector's evidence), summarize its
  ``kind:"health"`` rows, and GRADE the file's freshest bench row per
  config and its freshest ``kind:"profile"`` row per app against the
  committed ``H100_EVIDENCE.jsonl`` and the cost model
  (:mod:`harp_tpu_torch.health.grade`; ``--no-grade-bench`` skips,
  ``--grade-bench`` is the default said out loud).  Exit 0 healthy, 1
  actionable findings (severity warn/page, or a regressed /
  model_invalidated verdict), 2 unreadable input.
- ``health --grade-model``: the model gate
  (:func:`harp_tpu_torch.health.grade.model_gate`): ONE
  provenance-stamped ``kind:"health"`` row.  Exit 0 confirmed, 1
  model_invalidated.

``--repo`` names the root whose ``H100_EVIDENCE.jsonl`` is read (the
current directory by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from harp_tpu_torch.health import sentinel


def _stamped(row: dict) -> dict:
    from harp_tpu_torch.utils.metrics import provenance

    prov = provenance("cpu")
    return {**row, **{k: prov[k] for k in ("backend", "date", "commit")}}


def _render(rows: list[dict], summary: dict) -> str:
    lines = ["== harp-tpu health =="]
    lines.append(
        f"{summary['findings']} finding(s), "
        f"{summary['actionable']} actionable"
        + (f", worst severity {summary['worst_severity']}"
           if summary.get("worst_severity") else ""))
    for r in rows:
        det, sev = r.get("detector", "?"), r.get("severity", "?")
        who = r.get("tag") or r.get("phase") or r.get("config") or "?"
        bits = []
        if det == "slo_burn":
            bits.append(f"burn fast {r.get('fast_burn')} / slow "
                        f"{r.get('slow_burn')}; offered "
                        f"{r.get('offered')} = {r.get('served')} served"
                        f" + {r.get('shed')} shed + {r.get('failed')} "
                        f"failed ({r.get('deadline_missed')} missed "
                        "deadline)")
        elif det == "skew_trigger":
            plan = r.get("plan") or {}
            bits.append(f"wasted_frac {r.get('wasted_frac')} for "
                        f"{r.get('consecutive')} superstep(s); inline "
                        f"plan: {len(plan.get('moves') or [])} move(s), "
                        f"ratio {plan.get('ratio_before')} -> "
                        f"{plan.get('ratio_after')}")
        elif det == "budget_drift":
            bits.append(f"{r.get('violations')} violation(s); worst: "
                        f"{r.get('worst')}")
        elif det == "memory_pressure":
            bits.append(f"peak {r.get('peak_hbm_bytes')} of "
                        f"{r.get('hbm_bytes')} B, headroom "
                        f"{r.get('headroom_frac')}")
        elif det == "evidence_regression":
            bits.append(f"verdict {r.get('verdict')}"
                        + (f" (measured {r.get('measured')} vs "
                           f"incumbent {r.get('incumbent')})"
                           if r.get("incumbent") is not None else "")
                        + (f" [model factor {r.get('model_factor')}x]"
                           if r.get("model_factor") is not None else ""))
        elif det == "profile_drift":
            who = r.get("app") or who
            bits.append(
                ("bound FLIPPED "
                 f"{r.get('committed_bound')} -> {r.get('bound')}; "
                 if r.get("bound_flipped") else
                 f"bound {r.get('bound')} unchanged; ")
                + f"worst bucket {r.get('worst_bucket')} moved "
                  f"{r.get('share_delta')} of the wall vs committed "
                  "attribution")
        lines.append(f"  [{sev:<4s}] {det:<20s} {who}: "
                     + "; ".join(bits))
    if not rows:
        lines.append("  no findings — healthy")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch health",
        description="health sentinel, offline: summarize kind:'health' "
                    "rows, grade fresh bench and profile rows against the "
                    "committed card evidence and the cost model, and run "
                    "the model gate")
    p.add_argument("jsonl", nargs="?", default=None,
                   help="JSONL to check (a telemetry export, a run's "
                        "output or the collector's evidence)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable summary line")
    p.add_argument("--grade-model", action="store_true",
                   help="run the cost model's self-grade gate and print "
                        "one kind:'health' row (exit 1 on "
                        "model_invalidated)")
    p.add_argument("--grade-bench", action="store_true",
                   help="grade the file's bench and profile rows (the "
                        "default)")
    p.add_argument("--no-grade-bench", action="store_true",
                   help="only summarize health rows")
    p.add_argument("--repo", default=None,
                   help="repo root whose H100_EVIDENCE.jsonl is read "
                        "(default: the current directory)")
    args = p.parse_args(argv)
    repo = args.repo or os.getcwd()

    if args.grade_model:
        from harp_tpu_torch.health import grade as HG

        ok, row = HG.model_gate(repo)
        print(json.dumps(_stamped(row)), flush=True)
        if not ok:
            print("health: the cost model is INVALIDATED by the committed "
                  "evidence (python -m harp_tpu_torch predict --grade for "
                  "the term breakdowns)", file=sys.stderr)
            return 1
        return 0

    if not args.jsonl:
        p.error("need a JSONL file (or --grade-model)")
    try:
        with open(args.jsonl) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        print(f"health: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 2

    health_rows: list[dict] = []
    latest_bench: dict[str, dict] = {}
    latest_profile: dict[str, dict] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue  # a malformed line is not a finding; read the rest
        if not isinstance(row, dict):
            continue
        if row.get("kind") == "health":
            health_rows.append(row)
        elif row.get("kind") == "profile" and row.get("app"):
            latest_profile[row["app"]] = row  # the last row per app wins
        elif row.get("kind") is None and "config" in row:
            latest_bench[row["config"]] = row  # the last row per config

    graded: list[dict] = []
    if (latest_bench or latest_profile) and not args.no_grade_bench:
        from harp_tpu_torch.health import grade as HG

        for cfg in sorted(latest_bench):
            f = HG.grade_bench_row(latest_bench[cfg], repo)
            if f is not None:
                graded.append(f)
        committed = HG.committed_profiles(repo) if latest_profile else {}
        for app in sorted(latest_profile):
            f = HG.grade_profile_row(latest_profile[app], repo,
                                     committed=committed)
            if f is not None:
                graded.append(f)

    rows = health_rows + graded
    summary = sentinel.summarize_rows(rows)
    summary["graded_configs"] = len(graded)
    if args.json:
        from harp_tpu_torch.utils.metrics import benchmark_json

        print(benchmark_json("health", summary, "cpu"))
    else:
        print(_render(rows, summary))
    return 1 if summary["actionable"] else 0


if __name__ == "__main__":  # python -m harp_tpu_torch health
    sys.exit(main())
