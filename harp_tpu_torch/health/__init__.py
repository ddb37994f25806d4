"""Health sentinel: the port of ``harp_tpu.health`` (see
:mod:`harp_tpu_torch.health.sentinel`; the ``health`` CLI is
:mod:`harp_tpu_torch.health.cli`; the evidence grader is
:mod:`harp_tpu_torch.health.grade`)."""

from harp_tpu_torch.health.sentinel import (  # noqa: F401
    DETECTORS, SEVERITIES, VERDICTS, FAST_BURN_MIN, PAGE_BURN,
    SLO_ERROR_BUDGET, SLOW_BURN_MIN, TRIGGER_SUPERSTEPS,
    WASTED_FRAC_TRIGGER, HealthMonitor, SLOBurn, export_jsonl, monitor,
    reset, summarize_rows)
