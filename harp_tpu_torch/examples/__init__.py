"""Runnable compositions of the port's pieces (``python -m
harp_tpu_torch.examples.<name>``)."""
