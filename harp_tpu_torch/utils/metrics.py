"""One JSON line per CLI benchmark result, stamped with its provenance.

The port's copy of ``harp_tpu.utils.metrics.benchmark_json``: the stamp
names the device the result ran on (``backend`` is ``cuda`` or ``cpu``,
with the card's name where there is one), so a CPU row can never pass as
a device measurement.
"""

from __future__ import annotations

import datetime
import json
import subprocess
from typing import Any

import numpy as np
import torch


def _commit() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        # a missing or hung git must not lose a finished measurement
        return None


def provenance(device: "torch.device | str") -> dict:
    """date / backend / device / torch / commit stamp for ``device``."""
    dev = torch.device(device)
    stamp = {"date": datetime.date.today().isoformat(),
             "backend": dev.type,
             "n_devices": (torch.cuda.device_count() if dev.type == "cuda"
                           else 1),
             "torch": torch.__version__,
             "commit": _commit()}
    if dev.type == "cuda":
        stamp["device_name"] = torch.cuda.get_device_name(dev)
        stamp["cuda"] = torch.version.cuda
    return stamp


def _plain(v: Any):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.floating, float)):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def benchmark_json(config: str, result: dict,
                   device: "torch.device | str") -> str:
    """One JSON line: ``config``, the provenance stamp, then ``result``
    (a result key that collides with a stamp field wins)."""
    return json.dumps({"config": config, **provenance(device),
                       **{k: _plain(v) for k, v in result.items()}})
