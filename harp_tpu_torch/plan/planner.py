"""The collective planner: the runtime CommLedger's sheet × a topology →
an explicit :class:`Plan`: the port of ``harp_tpu.plan.planner``.

The reference reads a static byte sheet per program (its CommGraph,
walked from the program's jaxpr).  The port has no jaxpr: its verbs
record their payload at run time in the CommLedger
(:mod:`harp_tpu_torch.utils.telemetry`).  So the sheet here is made by
running a registered driver program (:mod:`harp_tpu_torch.analysis.
drivers`) once under ``telemetry.scope()`` and ``ledger.run(program)``
(:func:`ledger_sheet`): each ``(tag, verb, combiner, wire_dtype)`` record
of that run is one site, with

- ``per_shard_bytes = payload_bytes / calls`` (one call's bytes a worker),
- ``amplification = calls / executions`` (calls a program run; the sheet
  holds one run, so ``per_shard_bytes × amplification`` is the ledger's
  bytes exactly), and
- ``primitive`` = the verb's collective (:data:`VERB_PRIMITIVES`, after
  the reference's ``PRIMITIVE_VERBS`` table).

For each site the planner prices today's schedule against the
alternatives the port can execute (``hier_psum``: ``allreduce_hier``;
``chunked_pipeline``: ``rotate_pipeline(n_chunks=…)``; ``wire_bf16`` /
``wire_int8``: the quantized verbs and wires) and emits a serializable
:class:`Plan`.  **Every choice fails closed**: the chosen ``schedule`` is
always ``"keep"``; a cheaper alternative only names the port's knob that
would measure it (:data:`MEASURE_KNOBS`), never a change of default.
"""

from __future__ import annotations

import dataclasses

from harp_tpu_torch.plan.topology import Topology, detect

#: the schedule vocabulary; "keep" is today's exact lowering, the only
#: schedule a fail-closed Plan ever chooses
SCHEDULES = ("keep", "hier_psum", "chunked_pipeline", "wire_bf16",
             "wire_int8")


def predicted_bytes(schedule: str, sheet_bytes: int) -> int:
    """Predicted per-site bytes under ``schedule`` (the reference's frozen
    math): keep/chunked move the same payload; hier_psum pays both
    stages; the narrow wires are the byte fractions (ceil)."""
    if schedule in ("keep", "chunked_pipeline"):
        return int(sheet_bytes)
    if schedule == "hier_psum":
        return 2 * int(sheet_bytes)
    if schedule == "wire_bf16":
        return (int(sheet_bytes) + 1) // 2
    if schedule == "wire_int8":
        return (int(sheet_bytes) + 3) // 4
    raise ValueError(f"unknown schedule {schedule!r}")


#: verb (as the CommLedger records it) → its collective primitive, after
#: the reference's ``parallel/collective.PRIMITIVE_VERBS``:
#:
#: ======================================  =================
#: verb                                    primitive
#: ======================================  =================
#: allreduce (add, avg), allreduce_hier,   psum
#: allreduce_quantized, reduce (add),
#: broadcast, barrier
#: allreduce / reduce (max)                pmax
#: allreduce / reduce (min)                pmin
#: allreduce (multiply)                    all_gather
#: push, push_quantized                    reduce_scatter
#: rotate, rotate_quantized                ppermute
#: allgather, pull                         all_gather
#: regroup, regroup_quantized, reshard     all_to_all
#: ======================================  =================
VERB_PRIMITIVES = {
    "allreduce": "psum", "allreduce_hier": "psum",
    "allreduce_quantized": "psum", "reduce": "psum", "broadcast": "psum",
    "barrier": "psum",
    "push": "reduce_scatter", "push_quantized": "reduce_scatter",
    "rotate": "ppermute", "rotate_quantized": "ppermute",
    "allgather": "all_gather", "pull": "all_gather",
    "regroup": "all_to_all", "regroup_quantized": "all_to_all",
    "reshard": "all_to_all",
}
_COMBINER_PRIMITIVES = {"max": "pmax", "min": "pmin",
                        "multiply": "all_gather"}


def primitive_of(verb: str, combiner: str | None = None) -> str:
    """The collective a ledger record's verb lowers to."""
    if verb in ("allreduce", "reduce") and combiner in _COMBINER_PRIMITIVES:
        return _COMBINER_PRIMITIVES[combiner]
    if verb not in VERB_PRIMITIVES:
        raise KeyError(f"verb {verb!r} has no collective primitive "
                       "(planner.VERB_PRIMITIVES)")
    return VERB_PRIMITIVES[verb]


#: which alternatives each verb can legally lower to (hier needs an ADD
#: reduction; pipelines and wires need a data-movement verb)
_VERB_ALTERNATIVES = {
    "allreduce": ("hier_psum", "wire_bf16", "wire_int8"),
    "push": ("wire_bf16", "wire_int8"),
    "reshard": ("chunked_pipeline", "wire_bf16", "wire_int8"),
    "rotate": ("chunked_pipeline", "wire_bf16", "wire_int8"),
    "regroup": ("wire_bf16", "wire_int8"),
}

#: (program, verb, schedule) → the port's knob that measures the
#: alternative on the card.  Only mapped sites ever carry a candidate: an
#: alternative with no way to measure it stays a priced row.
MEASURE_KNOBS = {
    ("kmeans.fit", "allreduce", "hier_psum"):
        'psum_schedule="hier" on kmeans.fit',
    ("mfsgd.epoch", "reshard", "chunked_pipeline"):
        "rotate_chunks=4 on mfsgd.benchmark",
    ("mfsgd.epoch", "reshard", "wire_bf16"):
        'rotate_wire="bf16" on mfsgd.benchmark',
    ("lda.epoch", "reshard", "wire_bf16"):
        'rotate_wire="bf16" on lda.benchmark',
    ("lda.epoch", "reshard", "wire_int8"):
        'rotate_wire="int8" on lda.benchmark',
    ("svm.train", "reshard", "wire_bf16"): 'sv_wire="bf16" on svm.benchmark',
    ("svm.train", "reshard", "wire_int8"): 'sv_wire="int8" on svm.benchmark',
    ("wdamds.smacof", "reshard", "wire_bf16"):
        'coord_wire="bf16" on wdamds.benchmark',
    ("wdamds.smacof", "reshard", "wire_int8"):
        'coord_wire="int8" on wdamds.benchmark',
}

#: an alternative must price at least this much below "keep" before the
#: planner names its knob: float noise, or an equal schedule such as hier
#: on a one-node ring, never reads as a predicted win
CANDIDATE_MARGIN = 0.95


@dataclasses.dataclass
class SiteDecision:
    """One collective site's schedule decision."""

    site: str               # "<ledger tag>:<verb>[:<combiner>][:<wire>]"
    primitive: str
    verb: str | None
    sheet_bytes: int        # the site's bytes a program run, from the sheet
    schedule: str = "keep"  # fail-closed: always "keep"
    predicted_bytes: int = 0
    cost_s: float = 0.0     # topology price of the chosen schedule
    alternatives: dict = dataclasses.field(default_factory=dict)
    #: schedule -> the knob that measures it, one entry per alternative
    #: that prices under the margin AND has a knob
    candidates: dict = dataclasses.field(default_factory=dict)
    flip_candidate: str | None = None   # the cheapest of `candidates`

    def row(self) -> dict:
        return {
            "site": self.site, "primitive": self.primitive,
            "verb": self.verb, "schedule": self.schedule,
            "sheet_bytes": self.sheet_bytes,
            "predicted_bytes": self.predicted_bytes,
            "cost_s": round(self.cost_s, 9),
            "alternatives": {k: round(v, 9)
                             for k, v in sorted(self.alternatives.items())},
            "candidates": dict(sorted(self.candidates.items())),
            "flip_candidate": self.flip_candidate,
        }


@dataclasses.dataclass
class Plan:
    """One program's explicit, serializable schedule plan."""

    program: str
    topology: str
    rates_source: str
    sites: list
    note: str | None = None   # the topology's, when its probe was skipped

    def predicted_bytes_total(self) -> int:
        return sum(s.predicted_bytes for s in self.sites)

    def flip_candidates(self) -> list:
        out: set = set()
        for s in self.sites:
            out.update(s.candidates.values())
        return sorted(out)

    def row(self) -> dict:
        """The ``kind: "plan"`` record."""
        row = {
            "kind": "plan",
            "program": self.program,
            "topology": self.topology,
            "rates_source": self.rates_source,
            "sites": [s.row() for s in self.sites],
            "predicted_bytes_total": self.predicted_bytes_total(),
            "flip_candidates": self.flip_candidates(),
        }
        if self.note:
            row["note"] = self.note
        return row


def _site_cost(topo: Topology, primitive: str, schedule: str,
               sheet_bytes: int) -> float:
    """One (site, schedule) price: the cost model's shared wire oracle
    (``perfmodel.model.wire_cost_s``), so the plan's cost column and the
    model's wire term are one function."""
    from harp_tpu_torch.perfmodel.model import wire_cost_s

    return wire_cost_s(topo, primitive, schedule, sheet_bytes)


def decide_site(program: str, entry: dict, topo: Topology) -> SiteDecision:
    """One sheet entry → its fail-closed decision.

    ``entry`` is a row of ``sheet["collectives"]``: ``per_shard_bytes ×
    amplification`` is the site's bytes a program run.  The schedule is
    ALWAYS "keep"; a cheaper alternative only attaches its knob, and only
    when a) the verb can legally lower to it, b) the site's wire is still
    exact (a quantized site already took its trade), and c) a knob exists
    to measure it."""
    sheet_bytes = int(round(float(entry["per_shard_bytes"]) * max(
        float(entry.get("amplification") or 1), 1.0)))
    prim = entry["primitive"]
    verb = entry.get("verb")
    dec = SiteDecision(site=entry["site"], primitive=prim, verb=verb,
                       sheet_bytes=sheet_bytes)
    dec.predicted_bytes = predicted_bytes("keep", sheet_bytes)
    dec.cost_s = _site_cost(topo, prim, "keep", sheet_bytes)
    already_quantized = bool(entry.get("wire_dtype")) or (
        verb or "").endswith("_quantized")
    for alt in _VERB_ALTERNATIVES.get(verb or "", ()):
        if already_quantized and alt.startswith("wire_"):
            continue
        if alt == "hier_psum" and entry.get("combiner") not in ("add", None):
            continue
        cost = _site_cost(topo, prim, alt, sheet_bytes)
        dec.alternatives[alt] = cost
        if cost < dec.cost_s * CANDIDATE_MARGIN:
            knob = MEASURE_KNOBS.get((program, verb, alt))
            if knob is not None:
                dec.candidates[alt] = knob
    if dec.candidates:
        dec.flip_candidate = dec.candidates[
            min(dec.candidates, key=lambda a: dec.alternatives[a])]
    return dec


def plan_sheet(program: str, sheet: dict,
               topo: Topology | None = None) -> Plan:
    """Plan one program from its sheet: the pure-decision core."""
    topo = topo or detect()
    sites = [decide_site(program, e, topo)
             for e in sheet.get("collectives") or []]
    return Plan(program=program, topology=topo.name,
                rates_source=topo.rates_source, sites=sites, note=topo.note)


def sheet_from_ledger(summary: dict, executions: int = 1) -> dict:
    """A sheet from a CommLedger summary (``telemetry.ledger.summary()``)
    of ``executions`` program runs: one site a ``(tag, verb, combiner,
    wire_dtype)`` record that was called."""
    rows = []
    for tag, t in sorted(summary.items()):
        for r in t["verbs"]:
            if not r["calls"]:
                continue
            site = ":".join([tag, r["verb"]] + [x for x in (
                r["combiner"], r["wire_dtype"]) if x])
            rows.append({
                "site": site, "tag": tag, "verb": r["verb"],
                "combiner": r["combiner"], "wire_dtype": r["wire_dtype"],
                "primitive": primitive_of(r["verb"], r["combiner"]),
                "payload_bytes": int(r["payload_bytes"]),
                "calls": int(r["calls"]),
                "per_shard_bytes": r["payload_bytes"] / r["calls"],
                "amplification": r["calls"] / executions,
            })
    return {"collectives": rows, "executions": executions}


def ledger_sheet(name: str, device=None) -> dict:
    """Run the registered driver program ``name`` once under
    ``telemetry.scope()`` and ``ledger.run(name)``, and return its sheet
    (:func:`sheet_from_ledger`).  ``device`` defaults to this worker's
    card, as every entry point's does."""
    import torch

    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.utils import telemetry

    if name not in DRIVERS:
        raise KeyError(
            f"{name!r} is not a registered driver program "
            f"(analysis/drivers.py has: {sorted(DRIVERS)})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("plan: no CUDA device; pass device='cpu' "
                           "(--device cpu) to run the drivers on the CPU")
    fn, args = DRIVERS[name](dev)
    with telemetry.scope(True):
        with telemetry.ledger.run(name):
            fn(*args)
        summary = telemetry.ledger.summary()
    return sheet_from_ledger(summary)


def plan_program(name: str, topo: Topology | None = None,
                 device=None) -> Plan:
    """Run the registered driver program once (:func:`ledger_sheet`) and
    plan its sheet."""
    return plan_sheet(name, ledger_sheet(name, device), topo)


def plan_all(topo: Topology | None = None, device=None) -> dict:
    """Plan every registered driver program."""
    from harp_tpu_torch.analysis.drivers import DRIVERS

    topo = topo or detect()
    return {name: plan_program(name, topo, device)
            for name in sorted(DRIVERS)}
