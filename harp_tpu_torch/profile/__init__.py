"""Wall attribution: ``python -m harp_tpu_torch profile``.

See :mod:`harp_tpu_torch.profile.attribution` for the frozen bucket
vocabulary and the capture and reconciliation contract.
"""

from harp_tpu_torch.profile.attribution import (  # noqa: F401
    BUCKETS,
    PROFILE_APPS,
    SUM_REL_TOL,
    attribute,
    capture,
    capture_all,
    classify,
)
