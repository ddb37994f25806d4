"""Prefetch-pipelined host → device ingest: the port of ``harp_tpu.ingest``.

Harp's mappers streamed their HDFS split through memory while the previous
block was being consumed.  :class:`IngestPipeline` is that bounded
multi-stage host pipeline, shared by the streaming apps
(``models.kmeans_stream``) and RF's chunked binning:

- **read** (thread pool, submission order): disk slice, file block, parse.
  With ``read_threads=1`` (the default) calls run strictly in order on one
  thread, so stateful sequential sources (``FileSplits.next_block``) are
  safe.  A reader may return a lazy view (an ``np.memmap`` slice) and leave
  the one copy to a later stage.
- **prep** (thread pool): cast, quantize, slice: the CPU-bound transform.
- **ship** (caller thread): the host → device copy.  With ``depth >= 2``
  finished chunks are shipped ahead of consumption.

``depth`` bounds how many chunks exist beyond the one being consumed.
``depth=1`` runs every stage inline on the caller thread, the serial
anchor: every depth is bit-exact, since the stages are deterministic per
chunk and consumption is in order; only the overlap changes.

**The ship on the card** (:class:`StagingRing`).  A copy from pageable
memory is a blocking copy on the compute stream, so chunk j+1's transfer
would wait behind chunk j's compute and the pipeline would overlap
nothing.  The ring holds ``depth + 1`` pinned host buffers and as many
device buffers.  The prep stage writes chunk j straight into pinned buffer
``j % slots`` (the single host copy), after waiting for that buffer's last
H2D copy to complete: overwriting a buffer whose copy is still in flight
would corrupt the data nondeterministically.  The ship stage issues the
copy with ``non_blocking=True`` on a side stream, ordered after everything
the compute stream has been given so far (so a device buffer is never
overwritten under a chunk's compute), and hands the consumer a
:class:`Shipped` chunk whose :meth:`Shipped.get` makes the compute stream
wait for that copy alone.  On the CPU the same ring runs with plain
buffers and synchronous copies.

**Overlap accounting / stall detector.**  The pipeline times each stage,
the caller's blocked time and the caller's busy time between chunks.
``overlap_efficiency`` = consumer_s / (consumer_s + wait_s): of the
caller's loop time, the share spent computing rather than waiting on the
pipeline.  When the consumer granted no meaningful compute window to hide
under (an idle consumer, a serial run) the score is vacuously 1.0.  With
``stall_warn`` set, a score below it emits a ``RuntimeWarning``.

The pipeline's callers hold their loops to warn-mode flight budgets
(``flightrec.budget``): streaming KMeans's chunk loop, the MLP's epoch and
``fileformat.load_sharded_csv``'s reads.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import torch


@dataclasses.dataclass
class IngestStats:
    """One :meth:`IngestPipeline.stream` run's timing account.

    ``read_s``/``prep_s`` are stage busy sums (across their threads),
    ``ship_s`` is caller-thread ship time, ``wait_s`` is caller time
    blocked on background stages, ``blocked_s`` is the caller's total time
    inside the pipeline, ``consumer_s`` is the caller's busy time between
    chunks (the compute the pipeline hides behind), ``wall_s`` the whole
    stream."""

    chunks: int = 0
    read_s: float = 0.0
    prep_s: float = 0.0
    ship_s: float = 0.0
    wait_s: float = 0.0
    blocked_s: float = 0.0
    consumer_s: float = 0.0
    wall_s: float = 0.0
    depth: int = 1
    stalls: int = 0
    overlap_efficiency: float = 1.0

    def as_dict(self) -> dict:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


class IngestPipeline:
    """Bounded multi-stage host → device chunk pipeline (module doc).

    ``read(j)`` → raw chunk j; ``prep(raw)`` → host data (None = identity);
    ``ship(host)`` → device data (None = a host-only pipeline).
    :meth:`stream` yields chunks 0..n-1 in order; ``stats`` holds the
    latest run's :class:`IngestStats`.  Reusable across epochs (the thread
    pools persist); use as a context manager or call :meth:`close`."""

    def __init__(self, read: Callable[[int], Any],
                 prep: Callable[[Any], Any] | None = None,
                 ship: Callable[[Any], Any] | None = None, *,
                 depth: int = 2, read_threads: int = 1,
                 prep_threads: int = 1, tag: str = "ingest",
                 stall_warn: float | None = None,
                 stall_min_hideable_s: float = 0.005):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if read_threads < 1 or prep_threads < 1:
            raise ValueError("read_threads/prep_threads must be >= 1")
        self._read, self._prep, self._ship = read, prep, ship
        self.depth = int(depth)
        self.tag = tag
        self._read_threads = int(read_threads)
        self._prep_threads = int(prep_threads)
        self._stall_warn = stall_warn
        self._stall_min_s = float(stall_min_hideable_s)
        self._read_pool: ThreadPoolExecutor | None = None
        self._prep_pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()
        self.stats = IngestStats(depth=self.depth)

    # -- lifecycle ----------------------------------------------------

    def __enter__(self) -> "IngestPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Reap the stage thread pools (idempotent), cancelling queued
        stages and waiting for running ones: none writes into a staging
        buffer after the pipeline is closed."""
        for pool in (self._read_pool, self._prep_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)
        self._read_pool = self._prep_pool = None

    def _pools(self):
        if self._read_pool is None:
            self._read_pool = ThreadPoolExecutor(
                self._read_threads, thread_name_prefix=f"{self.tag}-read")
        if self._prep_pool is None and self._prep is not None:
            self._prep_pool = ThreadPoolExecutor(
                self._prep_threads, thread_name_prefix=f"{self.tag}-prep")
        return self._read_pool, self._prep_pool

    # -- streaming ----------------------------------------------------

    def stream(self, n_chunks: int):
        """Yield device (or host) chunks 0..n_chunks-1 in order."""
        self.stats = IngestStats(depth=self.depth)
        if self.depth <= 1:
            return self._stream_serial(n_chunks)
        return self._stream_threaded(n_chunks)

    def _timed_ship(self, x):
        if self._ship is None:
            return x
        t0 = time.perf_counter()
        out = self._ship(x)
        self.stats.ship_s += time.perf_counter() - t0
        return out

    def _stream_serial(self, n: int):
        """depth=1: every stage inline, in the caller's order."""
        st = self.stats
        t_wall = time.perf_counter()
        last_out = None
        try:
            for j in range(n):
                t_in = time.perf_counter()
                if last_out is not None:
                    st.consumer_s += t_in - last_out
                t0 = time.perf_counter()
                cur = self._read(j)
                # lock only the accumulation, never the stage's work: the
                # pool paths take the same lock for the same counters
                with self._lock:
                    st.read_s += time.perf_counter() - t0
                if self._prep is not None:
                    t0 = time.perf_counter()
                    cur = self._prep(cur)
                    with self._lock:
                        st.prep_s += time.perf_counter() - t0
                cur = self._timed_ship(cur)
                st.chunks += 1
                last_out = time.perf_counter()
                st.blocked_s += last_out - t_in
                yield cur
        finally:
            st.wall_s = time.perf_counter() - t_wall
            self._finalize(st)

    def _stream_threaded(self, n: int):
        st = self.stats
        read_pool, prep_pool = self._pools()
        pending: deque = deque()   # background futures, submission order
        shipped: deque = deque()   # device chunks shipped ahead
        submitted = 0
        consumed = 0

        def timed_read(j):
            t0 = time.perf_counter()
            out = self._read(j)
            with self._lock:
                st.read_s += time.perf_counter() - t0
            return out

        def chained_prep(rf):
            def run():
                raw = rf.result()   # stage handoff; not counted as busy
                t0 = time.perf_counter()
                out = self._prep(raw)
                with self._lock:
                    st.prep_s += time.perf_counter() - t0
                return out
            return run

        def pump():
            nonlocal submitted
            while submitted < n and submitted - consumed < self.depth:
                rf = read_pool.submit(timed_read, submitted)
                pending.append(prep_pool.submit(chained_prep(rf))
                               if self._prep is not None else rf)
                submitted += 1

        t_wall = time.perf_counter()
        last_out = None
        try:
            for _ in range(n):
                t_in = time.perf_counter()
                if last_out is not None:
                    st.consumer_s += t_in - last_out
                pump()
                if shipped:
                    cur = shipped.popleft()
                else:
                    f = pending.popleft()
                    t0 = time.perf_counter()
                    raw = f.result()
                    st.wait_s += time.perf_counter() - t0
                    cur = self._timed_ship(raw)
                # ship ahead: start the copies of chunks already prepped so
                # that they ride under the consumer's compute (depth bounds
                # the staged device memory)
                while (pending and pending[0].done()
                       and len(shipped) < self.depth - 1):
                    shipped.append(self._timed_ship(
                        pending.popleft().result()))
                st.chunks += 1
                consumed += 1
                pump()
                last_out = time.perf_counter()
                st.blocked_s += last_out - t_in
                yield cur
        finally:
            st.wall_s = time.perf_counter() - t_wall
            self._finalize(st)

    # -- overlap accounting -------------------------------------------

    def _finalize(self, st: IngestStats) -> None:
        if self.depth >= 2 and st.consumer_s > self._stall_min_s:
            st.overlap_efficiency = max(0.0, min(1.0, (
                st.consumer_s / (st.consumer_s + st.wait_s))))
        else:
            # nothing to hide under (an idle consumer, serial mode, a
            # trivial stream): vacuously efficient, never a stall
            st.overlap_efficiency = 1.0
        if (self._stall_warn is not None
                and st.overlap_efficiency < self._stall_warn):
            st.stalls += 1
            warnings.warn(
                f"ingest pipeline stalled [{self.tag}]: the consumer "
                f"waited {st.wait_s:.3f}s against {st.consumer_s:.3f}s of "
                f"its own compute (overlap_efficiency "
                f"{st.overlap_efficiency:.0%}) — the pipeline is not "
                "working ahead of consumption",
                RuntimeWarning, stacklevel=3)


class Shipped:
    """A chunk on its way to the device with its copy's completion event
    (None once the copy is done).  ``get()`` returns the tensor, after
    making the current stream wait for the copy on the card, or waiting
    for it on the host elsewhere."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor, self.event = tensor, event

    def get(self) -> torch.Tensor:
        if self.event is not None:
            if self.tensor.is_cuda:
                torch.cuda.current_stream(self.tensor.device).wait_event(
                    self.event)
            else:
                self.event.synchronize()
        return self.tensor


class StagingRing:
    """``slots`` host buffers (pinned on the card) and as many device
    buffers of ``[rows, *inner]`` ``dtype``, handed out round robin by
    chunk index (module doc, "The ship on the card").

    ``host(j, n)`` is the host buffer chunk j's prep writes its first
    ``n`` rows into; it first waits until that buffer's previous copy has
    completed.  ``ship(j, n)`` copies those rows to the device and returns
    a :class:`Shipped`.  ``waits`` counts the times :meth:`host` found a
    copy still in flight.  ``slots`` must exceed the pipeline's depth, so
    a chunk's buffers are never those of a chunk still ahead of the
    consumer."""

    def __init__(self, rows: int, inner: tuple, dtype: torch.dtype,
                 device: torch.device, slots: int):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        shape = (rows, *inner)
        self._host = [torch.empty(shape, dtype=dtype, pin_memory=cuda)
                      for _ in range(slots)]
        self._dev = ([torch.empty(shape, dtype=dtype, device=self.device)
                      for _ in range(slots)] if cuda else
                     [torch.empty(shape, dtype=dtype) for _ in range(slots)])
        self._events: list = [None] * slots
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.waits = 0

    @property
    def slots(self) -> int:
        return len(self._host)

    def host(self, j: int, n: int) -> torch.Tensor:
        s = j % self.slots
        ev = self._events[s]
        if ev is not None:
            if not ev.query():
                self.waits += 1
            ev.synchronize()   # the buffer's last copy has left it
        return self._host[s][:n]

    def _copy(self, dst: torch.Tensor, src: torch.Tensor):
        """Copy ``src`` (host) into ``dst`` (device); returns the copy's
        completion event, or None when the copy completed in the call."""
        if self._stream is None:
            dst.copy_(src)
            return None
        compute = torch.cuda.current_stream(self.device)
        # after everything the compute stream has so far: a device buffer
        # is reused only once the chunk it last held has been consumed
        self._stream.wait_stream(compute)
        with torch.cuda.stream(self._stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return ev

    def ship(self, j: int, n: int) -> Shipped:
        s = j % self.slots
        dst = self._dev[s][:n]
        ev = self._copy(dst, self._host[s][:n])
        self._events[s] = ev
        return Shipped(dst, ev)
