"""The committed allowlist: reviewed lint exceptions, each with a reason.

``analysis/allowlist.toml`` (next to this module) holds one ``[[allow]]``
table an exception:

.. code-block:: toml

    [[allow]]
    rule = "HL001"
    path = "harp_tpu_torch/models/mlp.py"
    match = "dist.all_reduce(y, group=group)"   # optional anchor
    reason = "why this site is right as it is"

``rule`` and ``path`` must match the violation exactly; ``match`` (optional)
also requires the flagged source line to contain the substring, so an entry
stays pinned to the code it excuses as line numbers drift.  ``reason`` is
required: loading fails on an entry without one.  Entries that match nothing
in a full run are reported stale by the CLI, which then fails.
"""

from __future__ import annotations

import os
import tomllib

from harp_tpu_torch.analysis import Violation

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "allowlist.toml")


class AllowlistError(ValueError):
    """Malformed allowlist file (missing rule, path or reason)."""


def load(path: str | None = None) -> list[dict]:
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return []
    with open(path, "rb") as fh:
        data = tomllib.load(fh)
    entries = data.get("allow", [])
    for i, e in enumerate(entries):
        for field in ("rule", "path", "reason"):
            if not e.get(field):
                raise AllowlistError(
                    f"{os.path.basename(path)}: [[allow]] entry #{i + 1} "
                    f"missing required field {field!r}: every exception "
                    "needs a rule, a path, and a one-line justification")
        e.setdefault("_hits", 0)
    return entries


def matches(entry: dict, v: Violation) -> bool:
    if entry["rule"] != v.rule or entry["path"] != v.path:
        return False
    m = entry.get("match")
    return m is None or m in (v.source or "")


def apply(violations: list[Violation], entries: list[dict]
          ) -> tuple[list[Violation], list[Violation], list[dict]]:
    """(kept, suppressed, stale entries): each entry counts its hits, so
    one that matched nothing this run can be reported."""
    kept: list[Violation] = []
    suppressed: list[Violation] = []
    for v in violations:
        hit = next((e for e in entries if matches(e, v)), None)
        if hit is None:
            kept.append(v)
        else:
            hit["_hits"] += 1
            suppressed.append(v)
    stale = [e for e in entries if e["_hits"] == 0]
    return kept, suppressed, stale
