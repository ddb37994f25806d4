"""``python -m harp_tpu_torch lint``: harplint's front door on the port.

Runs the four layers (``ast``, ``threads``, ``kernels``, ``wire``), applies
the committed allowlist, prints a report and ONE stamped machine line
(``kind: "lint"``, through :func:`harp_tpu_torch.utils.metrics.
benchmark_json`, in the reference's row shape; a full run's row carries
the wire layer's per-program byte sheets), and exits non-zero when any
unallowlisted violation remains or the allowlist holds a stale entry.

- positional ``paths`` restrict the AST layer to those files;
- ``--changed`` restricts the AST layer to files changed against git HEAD
  (and untracked ones) and the threads layer to the planes owning them;
  the kernels and wire layers still run in full;
- ``--audit-module FILE`` imports a Python file and sweeps its
  ``HARPLINT_DRIVERS`` (wire layer: name -> build(device) -> (fn, args)),
  ``HARPLINT_PROTOCOLS`` (staging audit: name -> build(device) -> drive),
  ``HARPLINT_PLANES`` (threads layer: name -> (PlaneSpec, sources)) and
  ``HARPLINT_KERNELS`` (kernels layer: name -> the wrapper's planned
  shared-memory bytes) dicts instead of the repo's.

``paths`` and ``--audit-module`` skip the repo-wide sweeps, so the exit
code reflects only the requested targets.  The ``ast``, ``threads`` and
``kernels`` layers make no tensor (given no card, K1's and K2's plans are
listed as unchecked); the ``wire`` layer runs the drivers on ``--device``,
this worker's card by default, and raises without one unless the CPU is
asked for.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

from harp_tpu_torch.analysis import RULES, Violation, rule_ids
from harp_tpu_torch.analysis import allowlist as allowlist_mod
from harp_tpu_torch.analysis.astlints import iter_python_files, lint_paths

LAYERS = ("ast", "threads", "kernels", "wire", "all")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _load_audit_module(path: str):
    import importlib.util

    name = f"_harplint_fixture_{os.path.basename(path).removesuffix('.py')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_wire_layer(builds: dict, device) -> tuple[list[Violation], dict]:
    """Each driver under the wire tap: its HL301/HL302 findings and its
    byte sheet."""
    from harp_tpu_torch.analysis import commgraph

    out: list[Violation] = []
    sheets: dict[str, dict] = {}
    for name in sorted(builds):
        target = f"driver:{name}"
        try:
            fn, args = builds[name](device)
            violations, sheet = commgraph.analyze_program(name, fn, args)
        except Exception as e:  # noqa: BLE001 - a broken driver is loud
            out.append(Violation("HL301", target, 0,
                                 f"driver run failed: "
                                 f"{type(e).__name__}: {e}"))
            continue
        out.extend(violations)
        sheets[name] = sheet
    return out, sheets


def run_protocol_layer(builds: dict, device) -> list[Violation]:
    """The staging audit (HL303) over the registered host protocols."""
    from harp_tpu_torch.analysis import commgraph

    out: list[Violation] = []
    for name in sorted(builds):
        try:
            drive = builds[name](device)
        except Exception as e:  # noqa: BLE001
            out.append(Violation("HL303", f"protocol:{name}", 0,
                                 f"protocol build failed: "
                                 f"{type(e).__name__}: {e}"))
            continue
        out.extend(commgraph.audit_protocol(name, drive))
    return out


def run_threads_layer(builds: dict | None, repo: str,
                      only: list[str] | None = None) -> list[Violation]:
    """HL401-HL405, pure ast.  ``builds`` maps fixture names to
    ``(PlaneSpec, {relpath: source})``; ``None`` sweeps the repo's
    planes (only those in ``only`` on ``--changed`` runs)."""
    from harp_tpu_torch.analysis import threadgraph

    if builds is None:
        return threadgraph.analyze_repo(repo, only=only)
    out: list[Violation] = []
    for name in sorted(builds):
        try:
            spec, sources = builds[name]
        except Exception as e:  # noqa: BLE001
            out.append(Violation("HL401", f"plane:{name}", 0,
                                 f"plane fixture malformed: "
                                 f"{type(e).__name__}: {e}"))
            continue
        out.extend(threadgraph.analyze_sources(spec, sources))
    return out


def render(kept: list[Violation], suppressed: list[Violation],
           stale: list[dict], scanned: int) -> str:
    lines = ["== harplint report =="]
    by_rule: dict[str, list[Violation]] = {}
    for v in kept:
        by_rule.setdefault(v.rule, []).append(v)
    for rid in sorted(by_rule):
        rule = RULES.get(rid)
        title = rule.title if rule else "(unregistered rule)"
        lines.append(f"{rid} {title}: {len(by_rule[rid])} violation(s)")
        for v in by_rule[rid]:
            lines.append("  " + v.format().replace("\n", "\n  "))
    lines.append(f"{scanned} file(s) scanned; {len(kept)} violation(s), "
                 f"{len(suppressed)} allowlisted")
    for e in stale:
        lines.append(f"STALE allowlist entry: {e['rule']} {e['path']} "
                     f"({e['reason']}) matched nothing: remove it (stale "
                     "entries fail the lint)")
    lines.append("harplint: " + ("FAILED" if kept or stale else "clean"))
    return "\n".join(lines)


def build_row(kept, suppressed, stale, scanned,
              byte_sheets: dict | None = None) -> dict:
    per_rule = Counter(v.rule for v in kept)
    per_file = Counter(v.path for v in kept)
    row = {
        "kind": "lint",
        "rules": rule_ids(),
        "files_scanned": scanned,
        "violations": len(kept),
        "allowlisted": len(suppressed),
        "stale_allowlist": len(stale),
        "per_rule": dict(sorted(per_rule.items())),
        "per_file": dict(sorted(per_file.items())),
        "clean": not kept,
    }
    if byte_sheets is not None:
        # per-program sheets (full runs only: the program names come from
        # analysis/drivers.py)
        row["byte_sheets"] = byte_sheets
    return row


def _changed_paths(repo: str) -> list[str]:
    """Repo-relative .py files changed against git HEAD, and untracked
    ones, within the default sweep set."""
    import subprocess

    changed: set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=repo, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            return []
        if res.returncode != 0:
            return []
        changed.update(ln.strip() for ln in res.stdout.splitlines()
                       if ln.strip())
    swept = set(iter_python_files(repo))
    return sorted(p.replace(os.sep, "/") for p in changed
                  if p.replace(os.sep, "/") in swept)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch lint",
        description="harplint on the port: AST lints, the thread-root "
                    "graph, the kernels' shared-memory declarations and "
                    "the wire audit")
    p.add_argument("paths", nargs="*",
                   help="restrict the AST layer to these files "
                        "(repo-relative or absolute); skips the repo-wide "
                        "sweeps")
    p.add_argument("--changed", action="store_true",
                   help="restrict the AST layer to changed files and the "
                        "threads layer to the planes owning them (against "
                        "git HEAD, and untracked files)")
    p.add_argument("--layer", choices=LAYERS, default="all")
    p.add_argument("--json", action="store_true",
                   help="print only the machine-readable line")
    p.add_argument("--audit-module", action="append", default=[],
                   metavar="FILE",
                   help="sweep FILE's HARPLINT_* dicts instead of the "
                        "repo's registries (fixture mode)")
    p.add_argument("--allowlist", default=None,
                   help="allowlist TOML (default: analysis/allowlist.toml)")
    p.add_argument("--no-allowlist", action="store_true")
    p.add_argument("--device", default=None,
                   help="the wire layer's device (default: this worker's "
                        "card; pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    if args.changed and args.paths:
        p.error("--changed and explicit paths are mutually exclusive")

    repo = repo_root()
    fixture_mode = bool(args.paths or args.audit_module)
    violations: list[Violation] = []
    scanned = 0
    changed_rels = (_changed_paths(repo)
                    if args.changed and not fixture_mode else None)

    if args.layer in ("ast", "all"):
        if args.paths:
            rels = [os.path.relpath(os.path.abspath(x), repo)
                    .replace(os.sep, "/") for x in args.paths]
            violations += lint_paths(repo, rels)
            scanned += len(rels)
        elif not fixture_mode:
            rels = (changed_rels if changed_rels is not None
                    else list(iter_python_files(repo)))
            violations += lint_paths(repo, rels)
            scanned += len(rels)

    fixture: dict[str, dict] = {k: {} for k in ("DRIVERS", "PROTOCOLS",
                                                "PLANES", "KERNELS")}
    for mod_path in args.audit_module:
        mod = _load_audit_module(mod_path)
        for k in fixture:
            fixture[k].update(getattr(mod, f"HARPLINT_{k}", {}))

    if args.layer in ("threads", "all"):
        if fixture_mode:
            if fixture["PLANES"]:
                violations += run_threads_layer(fixture["PLANES"], repo)
        else:
            from harp_tpu_torch.analysis.threadgraph import planes_for_paths

            only = (planes_for_paths(changed_rels)
                    if changed_rels is not None else None)
            violations += run_threads_layer(None, repo, only=only)

    unchecked: list[str] = []
    if args.layer in ("kernels", "all"):
        from harp_tpu_torch.analysis import kernel_audit

        if fixture_mode:
            if fixture["KERNELS"]:
                violations += kernel_audit.check_smem_declarations(
                    fixture["KERNELS"])
        else:
            import torch

            # K1's and K2's plans come from their library on the card
            card = args.device if args.device else (
                "cuda" if torch.cuda.is_available() else None)
            card = card if str(card).startswith("cuda") else None
            violations += kernel_audit.check_smem_declarations(device=card)
            unchecked = kernel_audit.unchecked(card)

    stamp_device = args.device or "cpu"
    byte_sheets: dict | None = None
    if args.layer in ("wire", "all") and (
            not fixture_mode or fixture["DRIVERS"] or fixture["PROTOCOLS"]):
        from harp_tpu_torch.parallel.mesh import resolve_device

        device = resolve_device(args.device)   # raises without a card
        stamp_device = device
        if fixture_mode:
            if fixture["DRIVERS"]:
                violations += run_wire_layer(fixture["DRIVERS"], device)[0]
            if fixture["PROTOCOLS"]:
                violations += run_protocol_layer(fixture["PROTOCOLS"],
                                                 device)
        else:
            from harp_tpu_torch.analysis.drivers import DRIVERS, PROTOCOLS

            vs, byte_sheets = run_wire_layer(DRIVERS, device)
            violations += vs
            violations += run_protocol_layer(PROTOCOLS, device)

    entries = [] if args.no_allowlist else allowlist_mod.load(args.allowlist)
    kept, suppressed, stale = allowlist_mod.apply(violations, entries)
    # staleness means something only when every layer swept everything: a
    # fixture run or a --changed scope cannot prove an entry dead, and a
    # --layer run judges only the entries of its own layer
    if fixture_mode or args.changed:
        stale = []
    elif args.layer != "all":
        stale = [e for e in stale
                 if RULES.get(e["rule"]) is not None
                 and RULES[e["rule"]].layer == args.layer]

    row = build_row(kept, suppressed, stale, scanned, byte_sheets)
    if unchecked:
        row["kernels_unchecked"] = unchecked
    from harp_tpu_torch.utils.metrics import benchmark_json

    if not args.json:
        print(render(kept, suppressed, stale, scanned))
        if unchecked:
            print(f"kernels: {', '.join(unchecked)} plan on the card only "
                  "(pass --device cuda to hold them to it)")
    print(benchmark_json("lint", row, stamp_device), flush=True)
    # a stale entry fails like a violation: an exception excusing nothing
    # outlived its fix or was always wrong
    return 1 if kept or stale else 0


if __name__ == "__main__":
    sys.exit(main())
