"""Worker group and the Harp collective verbs over ``torch.distributed``."""
