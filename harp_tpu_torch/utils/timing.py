"""Device synchronization, kernel timing, graph capture and a hang
watchdog on the card.

PyTorch returns from a CUDA call before the device has finished, so a host
clock measures only the enqueue unless the timed region ends in a
synchronize.  :func:`device_sync` is that end (one readback for the flight
recorder); :func:`cuda_ms` times a device-side run of many launches with
CUDA events, and :func:`graph_ms` the same work replayed from a CUDA graph,
without the host's launch cost.  :func:`capture_graph` is the port's
capture helper: each capture counts as one compile on the flight
recorder's CompileWatch.  :class:`HangWatchdog` hard-exits a process whose
phase produced nothing in time, and :class:`Timer` keeps per-phase
iteration times.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable

import torch

from harp_tpu_torch.utils.telemetry import tree_leaves


class HangWatchdog:
    """Hard-exit instead of hanging the caller forever.

    A benchmark entry point arms a daemon timer that ``os._exit``\\ s with
    a diagnostic after ``timeout_s`` (``HARP_BENCH_TIMEOUT``, 1200 s by
    default): a collective whose peer died, or a kernel that never
    returns, then ends the process with a record of the phase instead of
    holding its caller.  ``arm`` may be called again to restart the clock
    for each phase; ``on_fire(what)`` runs first, so the caller can emit a
    structured record naming the hung phase.
    """

    def __init__(self, timeout_s: float | None = None, *, exit_code: int = 3,
                 on_fire: Callable[[str], None] | None = None,
                 _exit: Callable[[int], None] = os._exit):
        if timeout_s is None:
            timeout_s = float(os.environ.get("HARP_BENCH_TIMEOUT", "1200"))
        self.timeout_s = timeout_s
        self.exit_code = exit_code
        self.on_fire = on_fire
        self._exit = _exit
        self._timer: threading.Timer | None = None
        # Timer.cancel() cannot stop a _fire already past its wait: the
        # generation check keeps a just-cancelled timer from killing a
        # healthy process
        self._lock = threading.Lock()
        self._gen = 0

    def arm(self, what: str = "benchmark") -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._gen += 1
            t = threading.Timer(self.timeout_s, self._fire, (what, self._gen))
            t.daemon = True
            # a stable name: threadguard's ownership map (generated from
            # the thread graph) forbids device work on this timer
            t.name = "harp-watchdog"
            self._timer = t
        t.start()

    def cancel(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._gen += 1

    def _fire(self, what: str, gen: int) -> None:
        with self._lock:
            if gen != self._gen:
                return  # cancelled or re-armed as it left its wait
        print(f"watchdog: {what} produced no result after "
              f"{self.timeout_s:.0f}s; exiting", file=sys.stderr, flush=True)
        if self.on_fire is not None:
            try:
                self.on_fire(what)
            except Exception:
                pass  # the diagnostic never masks the exit
        self._exit(self.exit_code)


def device_sync(x: Any) -> float:
    """Wait for everything ``x`` depends on; return its first element.

    ``x`` is a tensor or a tuple/list/dict nest of tensors.  On the card
    this is ``torch.cuda.synchronize`` plus a scalar readback, which cannot
    complete before the work that produced it."""
    from harp_tpu_torch.utils import flightrec

    leaf = tree_leaves(x)[0]
    flightrec.record_readback(leaf.element_size())
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    return float(leaf.reshape(-1)[0].item())


class Timer:
    """Per-iteration timer table, printed like Harp's per-phase logs."""

    def __init__(self):
        self.records: dict[str, list[float]] = {}

    def time(self, name: str, fn, *args, sync: bool = True, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            device_sync(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {k: {"mean_s": sum(v) / len(v), "total_s": sum(v),
                    "n": len(v)} for k, v in self.records.items()}


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


def _capture(fn: Callable[[], Any], warmup: int, reps: int = 1):
    """``(graph, out)``: ``warmup`` calls of ``fn`` on a side stream, so
    that nothing (a plan, a workspace) is made during the capture, then
    ``reps`` calls captured in one CUDA graph; ``out`` is what the last
    captured call returned and ``graph.pool_bytes`` the memory the
    capture reserved (its graph pool, outputs included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reserved = torch.cuda.memory_reserved()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            out = fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.pool_bytes = torch.cuda.memory_reserved() - reserved
    return graph, out


def graph_ms(fn: Callable[[], Any], *, reps: int = 20, replays: int = 5,
             warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the card with the host's launch
    cost left out: ``reps`` calls captured in one CUDA graph (after
    ``warmup`` uncaptured ones), replayed ``replays`` times between CUDA
    events.  A kernel of a few tens of microseconds runs faster than
    Python launches it, so :func:`cuda_ms` would time the launches;
    ``fn`` must not synchronize."""
    graph, _ = _capture(fn, warmup, reps)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def capture_graph(fn: Callable[[], Any], *, label: str = "graph"):
    """Capture ``fn()`` into a CUDA graph after one warm-up call:
    ``(graph, out)``, where ``out`` is what the capture's call returned
    (static tensors that every ``graph.replay()`` rewrites) and
    ``graph.pool_bytes`` the memory the capture reserved.  The capture
    counts as one compile on the flight recorder, with its seconds."""
    from harp_tpu_torch.utils import flightrec

    t0 = time.perf_counter()
    graph, out = _capture(fn, warmup=1)
    flightrec.on_capture(label, time.perf_counter() - t0)
    return graph, out
