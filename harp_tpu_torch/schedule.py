"""Intra-worker task scheduling — Harp L5 (``schstatic`` /
``schdynamic``), the port of ``harp_tpu.schedule``.

``edu.iu.harp.schstatic.StaticScheduler`` and ``schdynamic.
DynamicScheduler`` run user ``Task`` objects over a thread pool inside one
worker — Harp's answer to multicore.  The static scheduler pre-assigns
inputs to tasks; the dynamic one feeds a shared input queue and drains an
output queue.  The third L5 piece, the ``edu.iu.dymoro`` rotation
pipeline, is :mod:`harp_tpu_torch.parallel.rotate`.

On the card, regular per-item compute belongs in one batched call
(:func:`device_map`), not in threads.  What stays on the host is
irregular Python work that feeds or drains the device: file parsing,
per-partition host prep, output writing.  For that the schedulers keep
Harp's API on threads (loaders release the GIL in numpy and native code).

**Streams.**  A task runs on its scheduler's thread, whose current CUDA
stream is that thread's default, never the caller's.  A scheduler given a
``device`` runs each thread's tasks on a stream of its own and orders every
item both ways:

- an event recorded on the caller's current stream when the item is
  handed in (``submit``, or ``schedule`` for the static scheduler) is
  waited on by the task's stream before the task runs it, and the item's
  CUDA tensors are ``record_stream``-ed to the task's stream;
- an event recorded on the task's stream after the task is waited on by
  the caller's current stream before the result is handed out
  (``wait_output``, ``schedule``), and the result's CUDA tensors are
  ``record_stream``-ed to the caller's stream, so the caching allocator
  never hands a block out while the other stream still uses it;
- ``stop`` and the end of a static ``schedule`` also make the caller's
  stream wait for every task stream (a task that failed may have written).

Without a CUDA ``device`` the scheduler touches no stream at all.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Any, Callable, Generic, Iterable, Sequence, TypeVar

import torch

from harp_tpu_torch.utils.telemetry import span, tree_leaves

I = TypeVar("I")
O = TypeVar("O")

_SENTINEL = object()


class Task(Generic[I, O]):
    """User compute unit — ``edu.iu.harp.schdynamic.Task`` equivalent.

    Subclass and override :meth:`run`.  Pass a *list* of instances (one per
    thread) to a scheduler for thread-private per-task state (buffers,
    models), exactly like Harp's task objects; passing a single
    callable/instance shares it across every thread, so it must be
    stateless or thread-safe.
    """

    def run(self, item: I) -> O:
        raise NotImplementedError

    def __call__(self, item: I) -> O:
        return self.run(item)


def _n_threads(n: int | None) -> int:
    return n if n and n > 0 else (os.cpu_count() or 1)


def _record_stream(tree: Any, stream) -> None:
    """Mark every CUDA tensor of ``tree`` as used on ``stream``."""
    for x in tree_leaves(tree):
        if getattr(x, "is_cuda", False):
            x.record_stream(stream)


class _Streams:
    """The task threads' CUDA streams and the per-item order (see the
    module docstring): nothing at all without a CUDA ``device``."""

    def __init__(self, device):
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self._used: list = []
        self._lock = threading.Lock()

    def mark(self):
        """An event recorded on the calling thread's current stream (None
        without a device): a task's stream for a result, the caller's for
        an item handed in."""
        if self.device is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def context(self):
        """Entered by a task thread around its tasks: a stream of its own."""
        if self.device is None:
            return contextlib.nullcontext()
        s = torch.cuda.Stream(self.device)
        with self._lock:
            self._used.append(s)
        return torch.cuda.stream(s)

    def take(self, ready, item) -> None:
        """On a task thread, before its task runs ``item``: wait for the
        caller's stream as of the item's hand-in (``ready``)."""
        if self.device is not None:
            s = torch.cuda.current_stream(self.device)
            s.wait_event(ready)
            _record_stream(item, s)

    def give(self, done, out) -> None:
        """On the caller's thread, before ``out`` is handed out: wait for the
        task's stream as of the task's end (``done``)."""
        if self.device is not None and done is not None:
            s = torch.cuda.current_stream(self.device)
            s.wait_event(done)
            _record_stream(out, s)

    def end(self) -> None:
        """The caller's stream waits for every task stream used so far."""
        if self.device is not None:
            caller = torch.cuda.current_stream(self.device)
            with self._lock:
                used, self._used = self._used, []
            for s in used:
                caller.wait_stream(s)


class StaticScheduler(Generic[I, O]):
    """Pre-partitioned thread-pool execution — ``schstatic.StaticScheduler``.

    Inputs are split round-robin across task instances *before* execution
    (Harp: each task owns a fixed submission list); results return in input
    order.  Use when per-item cost is uniform; otherwise prefer
    :class:`DynamicScheduler`.  A single callable is shared by all threads
    (see :class:`Task`); pass one instance per thread for private state.
    """

    def __init__(self, tasks: Sequence[Callable[[I], O]] | Callable[[I], O],
                 n_threads: int | None = None, *, device=None):
        if callable(tasks):
            n = _n_threads(n_threads)
            self.tasks: list[Callable[[I], O]] = [tasks] * n
        else:
            self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("StaticScheduler needs at least one task")
        self._streams = _Streams(device)

    def schedule(self, items: Sequence[I]) -> list[O]:
        """Run every item; item *i* goes to task ``i % len(tasks)``."""
        with span("schedule.static", items=len(items), tasks=len(self.tasks)):
            return self._schedule(items)

    def _schedule(self, items: Sequence[I]) -> list[O]:
        n = len(self.tasks)
        results: list[Any] = [None] * len(items)
        done: list[Any] = [None] * len(items)
        errors: list[BaseException] = []
        ready = self._streams.mark()  # every item is handed in here

        def worker(t: int) -> None:
            try:
                with self._streams.context():
                    for idx in range(t, len(items), n):
                        self._streams.take(ready, items[idx])
                        results[idx] = self.tasks[t](items[idx])
                        done[idx] = self._streams.mark()
            except BaseException as e:  # noqa: BLE001 - re-raised on main thread
                errors.append(e)

        # named so a thread-ownership map can recognise scheduler workers
        threads = [threading.Thread(target=worker, args=(t,), daemon=True,
                                    name=f"harp-sched-static-{t}")
                   for t in range(min(n, len(items)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self._streams.end()
        if errors:
            raise errors[0]
        for out, ev in zip(results, done):
            self._streams.give(ev, out)
        return results


class DynamicScheduler(Generic[I, O]):
    """Work-stealing queue execution — ``schdynamic.DynamicScheduler``.

    Tasks pull from a shared input queue and push to an output queue; the
    Harp lifecycle (``start`` → ``submit``\\* → ``waitForOutput``/``stop``)
    is preserved for streaming use, and :meth:`schedule` wraps it for the
    common submit-all-then-drain pattern (results in completion order,
    tagged with input index).
    """

    def __init__(self, tasks: Sequence[Callable[[I], O]] | Callable[[I], O],
                 n_threads: int | None = None, *, device=None):
        if callable(tasks):
            self.tasks: list[Callable[[I], O]] = [tasks] * _n_threads(n_threads)
        else:
            self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("DynamicScheduler needs at least one task")
        self._streams = _Streams(device)
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._submitted = 0
        self._drained = 0

    # -- Harp lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self._threads:
            raise RuntimeError("scheduler already started")

        def worker(task: Callable[[I], O]) -> None:
            with self._streams.context():
                while True:
                    got = self._in.get()
                    if got is _SENTINEL:
                        return
                    idx, item, ready = got
                    try:
                        self._streams.take(ready, item)
                        out = task(item)
                        self._out.put((idx, out, None, self._streams.mark()))
                    except BaseException as e:  # noqa: BLE001 - surfaced in wait_output
                        self._out.put((idx, None, e, None))

        self._threads = [threading.Thread(target=worker, args=(t,),
                                          daemon=True,
                                          name=f"harp-sched-dyn-{i}")
                         for i, t in enumerate(self.tasks)]
        for th in self._threads:
            th.start()

    def submit(self, item: I) -> None:
        self._in.put((self._submitted, item, self._streams.mark()))
        self._submitted += 1

    def wait_output(self) -> tuple[int, O]:
        """Block for one result — ``waitForOutput``; raises task exceptions."""
        idx, out, err, done = self._out.get()
        self._drained += 1
        if err is not None:
            raise err
        self._streams.give(done, out)
        return idx, out

    def stop(self) -> None:
        for _ in self._threads:
            self._in.put(_SENTINEL)
        for th in self._threads:
            th.join()
        self._threads = []
        self._streams.end()

    # -- convenience --------------------------------------------------------
    def schedule(self, items: Iterable[I]) -> list[O]:
        """submit-all → drain-all → stop; results re-ordered to input order.

        On an externally-started scheduler every prior submission must have
        been drained first — otherwise a stale result would be mis-slotted
        into this batch.
        """
        with span("schedule.dynamic", tasks=len(self.tasks)):
            return self._schedule(items)

    def _schedule(self, items: Iterable[I]) -> list[O]:
        started = bool(self._threads)
        if started and self._submitted != self._drained:
            raise RuntimeError(
                f"schedule() with {self._submitted - self._drained} undrained "
                f"submissions outstanding; wait_output() them first")
        if not started:
            self.start()
        base = self._submitted
        n = 0
        for item in items:
            self.submit(item)
            n += 1
        out: list[Any] = [None] * n
        first_err: BaseException | None = None
        try:
            # drain the WHOLE batch even when a task failed — leaving results
            # queued would mis-slot them into the next schedule() call
            for _ in range(n):
                idx, val, err, done = self._out.get()
                self._drained += 1
                if err is not None:
                    first_err = first_err or err
                    continue
                assert base <= idx < base + n, (idx, base, n)
                self._streams.give(done, val)
                out[idx - base] = val
        finally:
            if not started:
                self.stop()
                while True:  # interrupted drain: discard leftovers
                    try:
                        self._out.get_nowait()
                    except queue.Empty:
                        break
                    self._drained += 1
        if first_err is not None:
            raise first_err
        return out


def apply_rebalance(splits: Sequence[Sequence[Any]], plan: dict) -> list[list]:
    """Apply a :func:`harp_tpu_torch.utils.skew.suggest_rebalance` plan to
    per-worker item lists (the :func:`harp_tpu_torch.fileformat.
    multi_file_splits` shape) — the bridge from *observing* skew back to
    Harp's schdynamic/dymoro load-balancing behavior: measure a run,
    ask the SkewLedger for the greedy repartition, replay it here before
    the next run.

    Only whole-unit moves apply (plans built from recorded ``units``,
    e.g. files); a fractional plan raises — it is a *target* for a
    finer-grained partitioner, not an item shuffle.  Returns new lists;
    the input is not mutated.
    """
    out = [list(s) for s in splits]
    for m in plan.get("moves", []):
        if "id" not in m:
            raise ValueError(
                "fractional rebalance plan (no unit ids): re-record the "
                "phase with units=..., or repartition toward the plan's "
                "work_after targets instead")
        try:
            out[m["from"]].remove(m["id"])
        except ValueError:
            raise ValueError(
                f"rebalance unit {m['id']!r} not found on worker "
                f"{m['from']} — the plan does not match these splits")
        out[m["to"]].append(m["id"])
    return out


def rebalance_assignment(splits: Sequence[Sequence[Any]],
                         plan: dict) -> dict:
    """:func:`apply_rebalance` flattened to ``{unit_id: worker}`` — the
    consumption shape of the elastic loops: a fired ``skew_trigger``'s
    inline plan replays over the current per-worker unit lists, and the
    resulting assignment drives the repartition
    (:mod:`harp_tpu_torch.elastic.rebalance`).  Same whole-unit contract as
    :func:`apply_rebalance` (fractional plans raise)."""
    return {uid: w
            for w, lst in enumerate(apply_rebalance(splits, plan))
            for uid in lst}


def device_map(fn: Callable, items, *, batched: bool = True):
    """The replacement for thread schedulers on regular work: the same
    per-item function over a batch in one call.  ``items`` is a tensor, or
    a tuple/list/dict nest of tensors with a leading item axis.
    ``batched=True`` vectorizes ``fn`` with ``torch.func.vmap``;
    ``batched=False`` maps it item by item and stacks the results (the
    reference's ``lax.map``)."""
    if batched:
        return torch.func.vmap(fn)(items)
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(items)
    n = leaves[0].shape[0]
    outs = [fn(pytree.tree_unflatten([x[i] for x in leaves], spec))
            for i in range(n)]
    out_leaves = [pytree.tree_flatten(o)[0] for o in outs]
    out_spec = pytree.tree_flatten(outs[0])[1]
    return pytree.tree_unflatten(
        [torch.stack([o[j] for o in out_leaves])
         for j in range(len(out_leaves[0]))], out_spec)
