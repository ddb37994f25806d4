"""Host-side helpers: device sync and timing, the comm ledger and spans,
metrics, config, checkpoints.

The port of ``harp_tpu.utils``, with the same exports; the other modules
(``checkpoint``, ``config``, ``metrics``, ``profiling``, ``fault``,
``check``, ``skew``, ``telemetry``, ...) are imported where they are used.
"""

from harp_tpu_torch.utils.timing import device_sync, Timer

__all__ = ["device_sync", "Timer"]
