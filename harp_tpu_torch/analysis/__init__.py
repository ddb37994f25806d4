"""The analysis layer's counterpart on the port: so far only the driver
programs the wall-attribution profile captures
(:mod:`harp_tpu_torch.analysis.drivers`)."""
