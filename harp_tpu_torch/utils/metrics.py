"""Per-iteration metrics as JSONL, and one JSON line per CLI benchmark
result stamped with its provenance — the port of
``harp_tpu.utils.metrics``.

:class:`MetricsLogger` is Harp's per-iteration log lines, structured: one
JSON object an iteration, appended to a file and mirrored to the
``harp_tpu_torch.metrics`` logger.  :func:`benchmark_json`'s stamp names
the device the result ran on (``backend`` is ``cuda`` or ``cpu``, with the
card's name where there is one), so a CPU row can never pass as a device
measurement.
"""

from __future__ import annotations

import datetime
import json
import logging
import subprocess
import time
from typing import IO, Any

import numpy as np
import torch


log = logging.getLogger("harp_tpu_torch.metrics")


class MetricsLogger:
    """Per-iteration JSONL.  Use it as a context manager (``with
    MetricsLogger(path) as m: ...``) so the file closes on any exit;
    :meth:`close` is idempotent, so a caller that closes explicitly and a
    surrounding ``with`` can coexist."""

    def __init__(self, path: str | None = None):
        self._fh: IO | None = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def log(self, step: int | None = None, **metrics: Any) -> dict:
        rec = {"t": round(time.perf_counter() - self._t0, 6),
               **{k: _plain(v) for k, v in metrics.items()}}
        if step is not None:
            rec["step"] = step
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        log.info("%s", rec)
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _commit() -> str | None:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        # a missing or hung git must not lose a finished measurement
        return None


_POWER_LIMIT: list = []


def power_limit_w() -> float | None:
    """The card's power limit in watts, as ``nvidia-smi --query-gpu=
    power.limit`` reads it (asked once a process), or None when
    ``nvidia-smi`` is missing or fails: a finished measurement is never
    lost for want of it."""
    if not _POWER_LIMIT:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30)
            _POWER_LIMIT.append(float(out.stdout.strip().splitlines()[0])
                                if out.returncode == 0 else None)
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            _POWER_LIMIT.append(None)
    return _POWER_LIMIT[0]


def provenance(device: "torch.device | str") -> dict:
    """date / backend / device / torch / commit stamp for ``device``; on
    the card also its name and power limit (``power_limit_w``)."""
    dev = torch.device(device)
    stamp = {"date": datetime.date.today().isoformat(),
             "backend": dev.type,
             "n_devices": (torch.cuda.device_count() if dev.type == "cuda"
                           else 1),
             "torch": torch.__version__,
             "commit": _commit()}
    if dev.type == "cuda":
        stamp["device_name"] = torch.cuda.get_device_name(dev)
        stamp["power_limit_w"] = power_limit_w()
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
