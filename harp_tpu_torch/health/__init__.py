"""Health sentinel: the port of ``harp_tpu.health`` (see
:mod:`harp_tpu_torch.health.sentinel`; the ``health`` CLI is
:mod:`harp_tpu_torch.health.cli`).  The evidence grader
(``health/grade.py``) rides ``perfmodel/`` and is not ported yet
(ROADMAP.md, Queue 1, item 9)."""

from harp_tpu_torch.health.sentinel import (  # noqa: F401
    DETECTORS, SEVERITIES, VERDICTS, FAST_BURN_MIN, PAGE_BURN,
    SLO_ERROR_BUDGET, SLOW_BURN_MIN, TRIGGER_SUPERSTEPS,
    WASTED_FRAC_TRIGGER, HealthMonitor, SLOBurn, export_jsonl, monitor,
    reset, summarize_rows)
