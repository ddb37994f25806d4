"""Topology-aware collective planner: the port of ``harp_tpu.plan``.

:mod:`~harp_tpu_torch.plan.topology` prices collective sites per link
class on the H100's topologies; :mod:`~harp_tpu_torch.plan.planner` runs
a registered driver program under the runtime CommLedger and emits an
explicit, serializable :class:`~harp_tpu_torch.plan.planner.Plan` whose
every choice fails closed.  ``python -m harp_tpu_torch plan`` is the
front door.
"""

from harp_tpu_torch.plan.planner import (
    MEASURE_KNOBS,
    Plan,
    SCHEDULES,
    SiteDecision,
    VERB_PRIMITIVES,
    decide_site,
    ledger_sheet,
    plan_all,
    plan_program,
    plan_sheet,
    predicted_bytes,
    sheet_from_ledger,
)
from harp_tpu_torch.plan.topology import (
    TOPOLOGY_NAMES,
    Topology,
    by_name,
    detect,
    dgx_h100_8,
    h100_4x8,
    probed,
    sim_ring,
    single_card,
)

__all__ = [
    "MEASURE_KNOBS", "Plan", "SCHEDULES", "SiteDecision", "TOPOLOGY_NAMES",
    "Topology", "VERB_PRIMITIVES", "by_name", "decide_site", "detect",
    "dgx_h100_8", "h100_4x8", "ledger_sheet", "plan_all", "plan_program",
    "plan_sheet", "predicted_bytes", "probed", "sheet_from_ledger",
    "sim_ring", "single_card",
]
