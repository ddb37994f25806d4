"""Comm ledger and span tracer — the part of ``harp_tpu.utils.telemetry``
that KMeans and MF-SGD need.

**CommLedger**: every verb in :mod:`harp_tpu_torch.parallel.collective`
calls :func:`record_comm`, which adds the call's per-worker payload bytes
(from shape and dtype only) to the ledger under the innermost active
:meth:`CommLedger.run` tag.  PyTorch runs eagerly, so a verb records once
per *call*, at run time; there is no trace-time sheet to multiply.
``run(tag, steps)`` counts ``steps`` executions of the tagged block (the
Lloyd iterations of one ``fit``), so ``bytes_per_execution`` is the
recorded total over the executions.  A verb on a quantized wire passes
``wire_dtype``: its float leaves count at the wire's width (the int8 wire
one byte an element), its other leaves at their own.

**Spans**: ``with span("kmeans.fit"): ...`` records name, duration and
attributes.

Both are off unless ``HARP_TELEMETRY=1`` is set or :func:`scope` turns
them on; when off, ``record_comm`` returns before
touching its argument.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch

_ENABLED = os.environ.get("HARP_TELEMETRY", "0").lower() not in (
    "", "0", "off", "false")

_UNTAGGED = "(untagged)"


@contextlib.contextmanager
def scope(on: bool = True, *, reset: bool = True):
    """Turn collection on (or off) within a block, restoring the prior
    flag on exit; ``reset`` clears the ledger and the tracer on entry."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    if reset:
        ledger.reset()
        tracer.reset()
    try:
        yield
    finally:
        _ENABLED = prev


def tree_leaves(tree: Any) -> list:
    """Leaves of a tensor, or of a tuple/list/dict nest of tensors."""
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_bytes(tree: Any, wire_dtype: "torch.dtype | None" = None
                ) -> tuple[int, int]:
    """(payload bytes, number of leaves) of one verb call, per worker."""
    leaves = tree_leaves(tree)
    total = 0
    for x in leaves:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        width = x.element_size()
        if wire_dtype is not None and x.is_floating_point():
            width = wire_dtype.itemsize
        total += x.numel() * width
    return total, len(leaves)


class CommLedger:
    """Per-tag, per-verb collective byte accounting (module docstring)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        # tag -> {"executions": int, "verbs": {(verb, combiner): record}}
        self._tags: dict[str, dict] = {}
        self._tag_stack: list[str] = []

    def _tag(self, name: str) -> dict:
        return self._tags.setdefault(name, {"executions": 0, "verbs": {}})

    def record(self, verb: str, tree: Any, *,
               combiner: str | None = None,
               wire_dtype: "torch.dtype | None" = None) -> None:
        if not _ENABLED:
            return
        payload, n_leaves = _tree_bytes(tree, wire_dtype)
        wire = None if wire_dtype is None else str(wire_dtype).removeprefix(
            "torch.")
        t = self._tag(self._tag_stack[-1] if self._tag_stack else _UNTAGGED)
        rec = t["verbs"].setdefault((verb, combiner, wire), {
            "verb": verb, "combiner": combiner, "wire_dtype": wire,
            "payload_bytes": 0, "calls": 0, "leaves": n_leaves})
        rec["payload_bytes"] += payload
        rec["calls"] += 1

    @contextlib.contextmanager
    def run(self, tag: str, *, steps: int = 1):
        """Attribute the verbs called inside the block to ``tag`` and count
        ``steps`` executions of it."""
        if not _ENABLED:
            yield self
            return
        t = self._tag(tag)
        self._tag_stack.append(tag)
        try:
            yield self
        finally:
            self._tag_stack.pop()
            t["executions"] += int(steps)

    def volume(self, tag: str | None = None) -> int:
        """Total bytes recorded under ``tag`` (all tags when None)."""
        names = [tag] if tag is not None else list(self._tags)
        return sum(r["payload_bytes"] for n in names if n in self._tags
                   for r in self._tags[n]["verbs"].values())

    def executions(self, tag: str) -> int:
        t = self._tags.get(tag)
        return 0 if t is None else t["executions"]

    def bytes_per_execution(self, tag: str) -> int:
        return self.volume(tag) // max(self.executions(tag), 1)

    def summary(self) -> dict:
        out = {}
        for name, t in sorted(self._tags.items()):
            verbs = sorted(t["verbs"].values(),
                           key=lambda r: -r["payload_bytes"])
            out[name] = {"executions": t["executions"],
                         "bytes_per_execution": self.bytes_per_execution(name),
                         "total_bytes": self.volume(name),
                         "verbs": [dict(r) for r in verbs]}
        return out


class SpanTracer:
    """Nested host-level spans: {span, path, dur, depth, **attrs}."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._stack: list[str] = []
        self.records: list[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        if not _ENABLED:
            yield
            return
        path = "/".join(self._stack + [name])
        depth = len(self._stack)
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.records.append({"span": name, "path": path,
                                 "dur": time.perf_counter() - t0,
                                 "depth": depth, **attrs})


ledger = CommLedger()
tracer = SpanTracer()


def span(name: str, **attrs: Any):
    """Module-level shorthand for ``tracer.span``."""
    return tracer.span(name, **attrs)


def record_comm(verb: str, tree: Any, *, combiner: str | None = None,
                wire_dtype: "torch.dtype | None" = None) -> None:
    """The one hook the collective verbs call, once per call."""
    if not _ENABLED:
        return
    ledger.record(verb, tree, combiner=combiner, wire_dtype=wire_dtype)
