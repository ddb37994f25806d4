"""Worker group and the Harp collective verbs over ``torch.distributed``."""

from harp_tpu_torch.parallel.collective import regroup

__all__ = ["regroup"]
