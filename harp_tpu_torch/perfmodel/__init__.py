"""The offline cost model on the H100 and its self-grade: the port of
``harp_tpu.perfmodel``.

:mod:`~harp_tpu_torch.perfmodel.model` prices every config from the
card's peaks, the kernel registry's work, the calibrated launch and
readback costs and the planner's wire price;
:mod:`~harp_tpu_torch.perfmodel.grade` replays it against the port's own
committed card rows (``H100_EVIDENCE.jsonl``), which
:mod:`~harp_tpu_torch.perfmodel.measure` collects on the card
(``grade.grade()`` keeps its module's name, so the package re-exports it
as :func:`grade_evidence`).
"""

from harp_tpu_torch.perfmodel import grade, model  # noqa: F401
from harp_tpu_torch.perfmodel.model import (  # noqa: F401
    BOUNDS, CONFIG_MODELS, FULL_SHAPES, PROGRAM_CONFIGS, RATES_SOURCES,
    UNPRICED, Price, model_row, presize, price, price_sheet,
    rank_candidates, wire_cost_s,
)
from harp_tpu_torch.perfmodel.grade import (  # noqa: F401
    DEAD_BAND, FAMILY_PAIRS, MAGNITUDE_TOL, RANK_FLOOR, SWEEPS, spearman,
)

grade_evidence = grade.grade
