"""Device synchronization and kernel timing on the card.

PyTorch returns from a CUDA call before the device has finished, so a host
clock measures only the enqueue unless the timed region ends in a
synchronize.  :func:`device_sync` is that end; :func:`cuda_ms` times a
device-side run of many launches with CUDA events, and :func:`graph_ms`
the same work replayed from a CUDA graph, without the host's launch cost.
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


def graph_ms(fn: Callable[[], Any], *, reps: int = 20, replays: int = 5,
             warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the card with the host's launch
    cost left out: ``reps`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  The ``warmup`` calls run
    first on the capturing side stream, so that nothing (a plan, a
    workspace) is made during the capture.  A kernel of a few tens of
    microseconds runs faster than Python launches it, so :func:`cuda_ms`
    would time the launches; ``fn`` must not synchronize."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)

