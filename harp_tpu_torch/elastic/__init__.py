"""Elastic execution: act on the skew trigger mid-run, and survive the
permanent loss of a worker without a restart — the port of
``harp_tpu.elastic``.

- **Mid-run rebalance** (:mod:`harp_tpu_torch.elastic.rebalance`): between
  supersteps the elastic loop takes a latched ``skew_trigger`` finding exactly
  once (``health.monitor.consume_skew_trigger``), replays its inline plan
  through ``schedule.apply_rebalance`` over the corpus's movable packs and
  repartitions; factor rows move over the ``reshard`` verb
  (:mod:`harp_tpu_torch.elastic.move`), token and rating layouts repack on
  the host.
- **Worker-loss survival** (:mod:`harp_tpu_torch.elastic.apps`): an
  injected :class:`~harp_tpu_torch.utils.fault.PermanentWorkerLoss`
  shrinks the mesh to the survivors (a process subgroup without the lost
  worker, which then sits the run out), the survivors replay the
  repartition plan from the last checkpoint and train on.

Evidence: :mod:`harp_tpu_torch.elastic.ledger`, one ``kind:"elastic"`` row
an action.  This ``__init__`` imports the ledger only: ``telemetry.scope``
and ``export`` import it on every run.
"""

from harp_tpu_torch.elastic import ledger  # noqa: F401  (the module)
from harp_tpu_torch.elastic.ledger import (  # noqa: F401
    EVENTS, ElasticLedger, export_jsonl, record, reset)
