"""Profiler hook on ``torch.profiler``: the port of
``harp_tpu.utils.profiling``.

One context manager captures a Chrome trace of the host's and the card's
activity (:func:`trace`), and :func:`op_breakdown` reads the newest
capture back as a table of time by op: the quick "where did the time go"
behind ``PERF.md``'s breakdowns.  The program names its stages with
:func:`harp_tpu_torch.utils.telemetry.span`: while a capture records,
each span is a ``user_annotation`` in it, on the profiler's clock, from
the span's entry to its exit on the host, enclosing the ops and kernel
launches made inside it (a kernel itself may run later on the card).

On a CUDA capture the device tracks are the events whose ``cat`` is
``kernel``, ``gpu_memcpy`` or ``gpu_memset``, each on its device's track
(``args["device"]``) and stream.  Only a CPU capture lets the ``cpu_op``
spans stand in for them, as the reference keeps the CPU backend's spans:
a card's capture that lacks device records never falls back to the host.
torch.profiler can drop device records on the card (``PERF.md`` §7), so
a caller compares the trace's kernel records with the host's launch
records (:func:`launch_records`) or with the launches it counted
(``profile.attribution.capture`` does both).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import tempfile
import time

#: the ``cat`` of the trace events that ran on a card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the ``cat`` of the host's calls into the CUDA runtime and driver, and
#: the names of those that launch one kernel (``cudaLaunchKernel``,
#: ``cuLaunchKernelEx``, ``cudaLaunchCooperativeKernel``, ...)
_API_CATS = ("cuda_runtime", "cuda_driver")
_LAUNCH = re.compile(r"Launch\w*Kernel")
_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``with trace("dir") as d: run_steps()`` → one new Chrome trace file
    under ``d`` (``chrome://tracing`` or Perfetto reads it).  CUDA activity
    is captured when a card is present, the host's always.  Without
    ``logdir`` a fresh temporary directory is made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="harp_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        # named by the clock in ns, zero-padded: the newest sorts last
        prof.export_chrome_trace(os.path.join(
            logdir, f"capture-{time.time_ns():020d}{_SUFFIX}"))


def newest_capture(logdir: str) -> str:
    """The newest capture file under ``logdir`` (or ``logdir`` itself when
    it is one); ``FileNotFoundError`` when there is none."""
    if os.path.isfile(logdir):
        return logdir
    files = sorted(glob.glob(os.path.join(logdir, f"*{_SUFFIX}")))
    if not files:
        raise FileNotFoundError(f"no *{_SUFFIX} under {logdir!r} — was this "
                                "directory written by trace()?")
    return files[-1]


def load_events(logdir: str) -> list[dict]:
    """The ``traceEvents`` of the newest capture under ``logdir``."""
    with open(newest_capture(logdir)) as fh:
        return json.load(fh).get("traceEvents", [])


def device_events(events: list[dict]) -> list[dict]:
    """The complete (``ph: X``) events that ran on a card."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS]


def launch_records(events: list[dict]) -> int:
    """The host's records of kernel launches (runtime or driver calls)."""
    return sum(1 for e in events if e.get("cat") in _API_CATS
               and _LAUNCH.search(e.get("name", "")))


def is_card_capture(events: list[dict]) -> bool:
    """Whether the capture traced a card: it holds device records or the
    host's calls into the CUDA runtime or driver."""
    return any(e.get("cat") in DEVICE_CATS + _API_CATS for e in events)


def op_breakdown(logdir: str, top: int = 15, host_events: bool = False,
                 self_time: bool = True, per_device: bool = False,
                 device=None):
    """Top ops by total duration from the newest :func:`trace` capture
    under ``logdir`` → ``[(name, total_seconds)]``, largest first.

    Only the newest capture is read, so reusing a logdir never
    double-counts older runs.  The spans kept are the device tracks' (see
    the module docstring); on a CPU capture, the ``cpu_op`` spans.
    ``device`` is the device the capture was taken on; None reads it from
    the trace (:func:`is_card_capture`).  A card's capture without device
    records gives an empty table.  ``host_events`` keeps every complete
    span instead.

    ``self_time=True`` (default) makes the table flame-graph-style: each
    span is charged only the time not covered by spans nested inside it
    on the same track (host ops nest: ``aten::matmul`` ⊃ ``aten::mm``), so
    shares sum to the traced busy time.

    ``per_device=True`` returns ``[(name, device, total_seconds)]`` with
    the card's ordinal from the event's ``args["device"]`` (host spans:
    None).  The default call sums over devices.
    """
    events = load_events(logdir)
    card = (is_card_capture(events) if device is None
            else str(device).startswith("cuda"))
    if host_events:
        kept = [e for e in events if e.get("ph") == "X" and "dur" in e]
    elif card:
        kept = device_events(events)
    else:
        kept = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "cpu_op"]
    totals: dict[tuple, float] = {}  # (name, device or None) -> seconds
    tracks: dict[tuple, list] = {}

    def device_of(e):
        if e.get("cat") in DEVICE_CATS:
            return e.get("args", {}).get("device")
        return None

    for e in kept:
        name, dev = e.get("name", "?"), device_of(e)
        if not self_time:
            totals[(name, dev)] = totals.get((name, dev), 0.0) + float(
                e["dur"]) / 1e6
        else:
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["dur"]), name, dev))
    # flame-graph self time per track: a span's children are the spans it
    # fully contains; charge each span dur − Σ(child dur)
    for evs in tracks.values():
        evs.sort(key=lambda t: (t[0], -t[1]))
        stack: list[list] = []  # [end_ts, child_dur_sum, name, dur, device]

        def pop(rec):
            key = (rec[2], rec[4])
            totals[key] = totals.get(key, 0.0) + max(rec[3] - rec[1],
                                                     0.0) / 1e6
            if stack:
                stack[-1][1] += rec[3]

        for ts, dur, name, dev in evs:
            while stack and ts >= stack[-1][0] - 1e-9:
                pop(stack.pop())
            stack.append([ts + dur, 0.0, name, dur, dev])
        while stack:
            pop(stack.pop())
    if per_device:
        return sorted(((n, d, t) for (n, d), t in totals.items()),
                      key=lambda x: -x[2])[:top]
    agg: dict[str, float] = {}
    for (name, _dev), t in totals.items():
        agg[name] = agg.get(name, 0.0) + t
    return sorted(agg.items(), key=lambda kv: -kv[1])[:top]
