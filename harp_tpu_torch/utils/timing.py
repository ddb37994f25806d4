"""Device synchronization and kernel timing on the card.

PyTorch returns from a CUDA call before the device has finished, so a host
clock measures only the enqueue unless the timed region ends in a
synchronize.  :func:`device_sync` is that end; :func:`cuda_ms` times a
device-side run of many launches with CUDA events.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from harp_tpu_torch.utils.telemetry import tree_leaves


def device_sync(x: Any) -> float:
    """Wait for everything ``x`` depends on; return its first element.

    ``x`` is a tensor or a tuple/list/dict nest of tensors.  On the card
    this is ``torch.cuda.synchronize`` plus a scalar readback, which cannot
    complete before the work that produced it."""
    leaf = tree_leaves(x)[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0].item())


def cuda_ms(fn: Callable[[], Any], *, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA stream, from
    CUDA events around ``reps`` calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
