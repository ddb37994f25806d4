"""The traced slice of a run: torch.profiler between two synchronizes, and
the reduction of its trace to what the per-layer metrics read.

The trace is exported as a Chrome trace into a temporary file, read and
deleted.  Device operations are the kernel, memcpy and memset records.
Each is matched to the host call that launched it by its correlation id,
which tells the benchmark generator's work (launched inside a
``portbench.gen`` range) from the program's.  A trace is only read when it
is whole: every kernel launch that the host side recorded must have its
device record, or :class:`TraceShort` is raised and no number is taken
from it.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH = re.compile(r"LaunchKernel|LaunchCooperativeKernel")
_LABEL_CATS = ("cpu_op", "user_annotation")


class TraceShort(RuntimeError):
    """The trace lost device records: no number may be read from it."""


class Slice:
    """A profiled slice: :meth:`start` and :meth:`stop` each synchronize
    the device first, so the slice holds exactly the work launched between
    them; ``window_s`` is the host clock between the two."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self._done = None
        self.events: list = []
        self.window_s = 0.0
        self._t0 = 0.0

    @property
    def open(self) -> bool:
        return self.prof is not None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Close the slice; its trace is read later, by :meth:`collect`,
        outside the loop it was taken in."""
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._done, self.prof = self.prof, None
        self._done.stop()

    def collect(self) -> list:
        """The closed slice's trace events (a Chrome trace, exported to a
        temporary file that is read and deleted)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._done.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._done = None
        return self.events


def _complete(events) -> list:
    return [e for e in events if e.get("ph") == "X" and "ts" in e]


def reduce(events, window_s: float, tags: dict | None = None) -> dict:
    """The slice's trace → ``{"window_s", "busy_s", "ops", "gaps"}``.

    ``ops``: each device operation as ``{"name", "ts", "dur" (us),
    "gen" (launched inside a portbench.gen range), "tag"}``, where
    ``tag`` is the first key of ``tags`` ({tag: regex}) whose pattern the
    name matches.  ``gaps``: the idle stretches between device operations
    (seconds), each labelled by the innermost host operation around the
    launch of the operation that ends it.  Raises :class:`TraceShort` when a
    recorded launch has no device record."""
    events = _complete(events)
    launch_at = {}
    launched = set()
    for e in events:
        if e.get("cat") in _HOST_CALL_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = float(e["ts"])
                if _LAUNCH.search(e.get("name", "")):
                    launched.add(corr)
    gen_spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") == "portbench.gen")
    starts = [s for s, _ in gen_spans]

    def in_gen(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= gen_spans[i][1]

    compiled = {t: re.compile(p) for t, p in (tags or {}).items()}
    ops, seen = [], set()
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        corr = (e.get("args") or {}).get("correlation")
        seen.add(corr)
        name = e.get("name", "")
        ts_launch = launch_at.get(corr)
        ops.append({"name": name, "ts": float(e["ts"]),
                    "dur": float(e["dur"]),
                    "gen": ts_launch is not None and in_gen(ts_launch),
                    "tag": next((t for t, rx in compiled.items()
                                 if rx.search(name)), None),
                    "launch_ts": ts_launch})
    lost = launched - seen
    if lost:
        raise TraceShort(f"the trace holds {len(launched) - len(lost)} of "
                         f"{len(launched)} recorded kernel launches")
    ops.sort(key=lambda o: o["ts"])
    busy, gaps = 0.0, []
    labels = _labeller(events)
    end = None
    for o in ops:
        s, t = o["ts"], o["ts"] + o["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append((labels(o["launch_ts"]), (s - end) * 1e-6))
            busy += o["dur"]
            end = t
        elif t > end:
            busy += t - end
            end = t
    return {"window_s": window_s, "busy_s": busy * 1e-6, "ops": ops,
            "gaps": gaps}


def _labeller(events):
    """``label(ts)``: the innermost host operation running at ``ts``."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")) for e in events
                   if e.get("cat") in _LABEL_CATS)
    starts = [s for s, _, _ in spans]

    def label(ts):
        if ts is None:
            return "unattributed"
        best = None
        i = bisect.bisect_right(starts, ts) - 1
        # spans are sorted by start: walk back to the enclosing ones and
        # keep the latest-starting (innermost) that still covers ts
        while i >= 0:
            s, t, name = spans[i]
            if t >= ts:
                best = name
                break
            i -= 1
            if ts - s > 5e6:  # nothing encloses it within 5 s
                break
        return best or "host"

    return label


def breakdown(reduced: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by
    what the host was doing, each as ``[name, seconds]``."""
    by_op = defaultdict(float)
    for o in reduced["ops"]:
        by_op[o["name"][:160]] += o["dur"] * 1e-6
    by_gap = defaultdict(float)
    count = defaultdict(int)
    for label, sec in reduced["gaps"]:
        by_gap[label] += sec
        count[label] += 1
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[f"{n[:150]} x{count[n]}", s] for n, s in gaps]}


def count_tag(reduced: dict, tag: str, pattern: str | None = None) -> int:
    """Device operations tagged ``tag`` (whose name also matches
    ``pattern``, when given)."""
    rx = re.compile(pattern) if pattern else None
    return sum(1 for o in reduced["ops"] if o["tag"] == tag
               and (rx is None or rx.search(o["name"])))
