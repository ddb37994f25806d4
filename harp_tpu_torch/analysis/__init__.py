"""harplint on the port: static and runtime analysis of ``harp_tpu_torch``.

The counterpart of ``harp_tpu.analysis``.  Four layers machine-check the
port's conventions behind one rule registry (:mod:`.rules`), one committed
allowlist (``analysis/allowlist.toml``, :mod:`.allowlist`) and one CLI
(``python -m harp_tpu_torch lint``, :mod:`.cli`):

- ``ast`` (HL000-HL005, :mod:`.astlints`): source lints, pure ``ast``;
- ``threads`` (HL401-HL405, :mod:`.threadgraph`): the thread-root graph of
  the serve, ingest, schedule, timing, fault and bench planes, whose
  ownership map also arms the runtime twin
  :mod:`harp_tpu_torch.utils.threadguard`;
- ``kernels`` (HL205, :mod:`.kernel_audit`): the kernel registry's
  shared-memory declarations against the wrappers' own plans;
- ``wire`` (HL301-HL303, :mod:`.commgraph`): the registered driver
  programs (:mod:`.drivers`) run under an interceptor of the
  ``torch.distributed`` calls, held against the CommLedger's records of
  the same run, and the staging protocols driven under an in-flight audit.

The core currency is :class:`Violation`: every layer emits them, the
allowlist suppresses reviewed exceptions, and the CLI renders the rest as a
report and one stamped ``kind: "lint"`` JSON line.  Importing this package
imports no torch and builds nothing.
"""

from __future__ import annotations

import dataclasses

from harp_tpu_torch.analysis.rules import RULES, Rule, rule_ids


@dataclasses.dataclass
class Violation:
    """One finding.  ``path`` is repo-relative for source findings, a
    pseudo-path (``kernel:<name>``, ``driver:<name>``, ``protocol:<name>``)
    for run ones; allowlist entries match on it either way."""

    rule: str
    path: str
    line: int
    message: str
    source: str = ""     # the offending source line

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: {self.rule} {self.message}"
        if self.source:
            out += f"\n    {self.source.strip()}"
        return out


__all__ = ["Violation", "Rule", "RULES", "rule_ids"]
