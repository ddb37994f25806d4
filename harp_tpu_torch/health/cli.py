"""``python -m harp_tpu_torch health``: the sentinel's offline half — the
port of ``harp_tpu.health.cli``.

``health run.jsonl [--json]`` reads a JSONL file (a telemetry export or
a run's output), summarizes its ``kind:"health"`` rows and prints them.
Exit 0 healthy, 1 actionable findings (severity warn/page, or a
regressed/model_invalidated verdict), 2 unreadable input.

Not ported yet (ROADMAP.md, Queue 1, item 9): grading the file's bench
rows against committed evidence (``--grade-bench``) and the model gate
(``--grade-model``) both need the evidence grader, ``health/grade.py``,
which rides ``perfmodel/``; each raises ``NotImplementedError``.  Until
then the summary mode does not grade (``--no-grade-bench``, kept for the
reference's command lines, is the default).
"""

from __future__ import annotations

import argparse
import json
import sys

from harp_tpu_torch.health import sentinel

_GRADE_NOT_PORTED = (
    "health {what} needs the evidence grader (health/grade.py), which rides "
    "perfmodel/ and is not ported yet (ROADMAP.md, Queue 1, item 9)")


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
            bits.append(f"verdict {r.get('verdict')}")
        lines.append(f"  [{sev:<4s}] {det:<20s} {who}: "
                     + "; ".join(bits))
    if not rows:
        lines.append("  no findings — healthy")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch health",
        description="health sentinel, offline: summarize the kind:'health' "
                    "rows of a telemetry export")
    p.add_argument("jsonl", nargs="?", default=None,
                   help="JSONL to check (a telemetry export or a run's "
                        "output)")
    p.add_argument("--json", action="store_true",
                   help="print one machine-readable summary line")
    p.add_argument("--grade-model", action="store_true",
                   help="the perfmodel self-grade gate (not ported yet)")
    p.add_argument("--grade-bench", action="store_true",
                   help="grade the file's bench rows against committed "
                        "evidence (not ported yet)")
    p.add_argument("--no-grade-bench", action="store_true",
                   help="only summarize health rows (the default)")
    args = p.parse_args(argv)
    if args.grade_model:
        raise NotImplementedError(_GRADE_NOT_PORTED.format(
            what="--grade-model"))
    if args.grade_bench and not args.no_grade_bench:
        raise NotImplementedError(_GRADE_NOT_PORTED.format(
            what="--grade-bench"))
    if not args.jsonl:
        p.error("need a JSONL file")
    try:
        with open(args.jsonl) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        print(f"health: cannot read {args.jsonl}: {e}", file=sys.stderr)
        return 2

    rows: list[dict] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except ValueError:
            continue  # a malformed line is not a finding; read the rest
        if isinstance(row, dict) and row.get("kind") == "health":
            rows.append(row)
    summary = sentinel.summarize_rows(rows)
    summary["graded_configs"] = 0
    if args.json:
        from harp_tpu_torch.utils.metrics import benchmark_json

        print(benchmark_json("health", summary, "cpu"))
    else:
        print(_render(rows, summary))
    return 1 if summary["actionable"] else 0


if __name__ == "__main__":  # python -m harp_tpu_torch health
    sys.exit(main())
