"""Request micro-batcher: a fixed ladder of padded batch shapes — the port
of ``harp_tpu.serve.batcher`` (pure host logic, copied).

A serving loop that captured a fresh graph per request size would pay a
capture on every novel batch; one that padded everything to the maximum
batch would waste most of its compute on padding at low load.  The ladder
is the middle ground: requests coalesce into the smallest rung that fits,
so the steady state only ever dispatches |ladder| shapes, all captured at
startup, and the padding fraction is bounded by the ladder's geometry
(see :meth:`ShapeLadder.bucket`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterator, Sequence

DEFAULT_LADDER = (1, 8, 64, 512)


class ShapeLadder:
    """The sorted set of batch sizes the server captures a step for."""

    def __init__(self, rungs: Sequence[int] = DEFAULT_LADDER):
        rungs = sorted(set(int(r) for r in rungs))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"ladder rungs must be >= 1, got {rungs}")
        self.rungs = tuple(rungs)

    @property
    def max_rung(self) -> int:
        return self.rungs[-1]

    def bucket(self, n: int) -> int:
        """Smallest rung >= n (n must fit under the max rung).

        Minimality bounds the padding: for the chosen rung ``s`` with
        predecessor ``p``, ``n > p`` so ``(s - n)/s < 1 - p/s`` — e.g.
        7/8 worst-case for the default 1/8/64/512 ladder, and exactly 0
        whenever ``n`` lands on a rung.
        """
        if n < 1:
            raise ValueError(f"batch of {n} rows")
        for r in self.rungs:
            if r >= n:
                return r
        raise ValueError(
            f"{n} rows exceeds the max ladder rung {self.max_rung} — "
            "split before bucketing (MicroBatcher.batches does)")

    def floor_rung(self, n: int) -> int:
        """Largest rung <= n (n >= 1; rung 1 is the floor of floors)."""
        if n < 1:
            raise ValueError(f"batch of {n} rows")
        best = self.rungs[0]
        for r in self.rungs:
            if r <= n:
                best = r
        return best

    def split(self, n: int) -> list[int]:
        """Row counts per batch for ``n`` queued rows: full max-size
        batches first, then one ragged tail batch (padded to its rung)."""
        out = [self.max_rung] * (n // self.max_rung)
        if n % self.max_rung:
            out.append(n % self.max_rung)
        return out


@dataclasses.dataclass
class Batch:
    """One padded batch: ``requests`` is [(request, row_lo, row_hi)] —
    the slice of each request's rows that landed in this batch."""

    rung: int                    # padded row count (the captured shape)
    rows: int                    # real rows (<= rung)
    requests: list[tuple[Any, int, int]]
    #: scheduler-assigned formation ordinal (continuous plane only):
    #: the request→batch join key the request tracer records, so a
    #: trace can say WHICH batch carried which row slice
    seq: int = -1

    @property
    def padding_frac(self) -> float:
        return (self.rung - self.rows) / self.rung


class MicroBatcher:
    """Coalesce queued (request, n_rows) pairs into ladder-shaped batches.

    Requests are answered in arrival order; a request larger than the max
    rung spans several batches (the per-request ``(lo, hi)`` row slices
    let the server reassemble it).  The batcher never holds work back:
    :meth:`batches` drains the whole queue, greedily filling max-rung
    batches and padding only the final ragged one — under sustained load
    padding tends to zero, at one queued single-row request the batch is
    the 1-rung (zero padding again).
    """

    def __init__(self, ladder: ShapeLadder | Sequence[int] = DEFAULT_LADDER):
        self.ladder = (ladder if isinstance(ladder, ShapeLadder)
                       else ShapeLadder(ladder))
        self._queue: list[tuple[Any, int]] = []
        # running padding accounting (the skew spine's padding_frac idiom)
        self.padded_rows = 0
        self.real_rows = 0

    def put(self, request: Any, n_rows: int) -> None:
        if n_rows < 1:
            raise ValueError(f"request with {n_rows} rows")
        self._queue.append((request, int(n_rows)))

    def __len__(self) -> int:
        return sum(n for _, n in self._queue)

    def batches(self) -> Iterator[Batch]:
        """Drain the queue into ladder-shaped batches (arrival order)."""
        queue, self._queue = self._queue, []
        pending: list[tuple[Any, int, int]] = []  # (request, lo, hi)
        pending_rows = 0

        def flush() -> Batch:
            nonlocal pending, pending_rows
            rung = self.ladder.bucket(pending_rows)
            b = Batch(rung=rung, rows=pending_rows, requests=pending)
            self.real_rows += pending_rows
            self.padded_rows += rung - pending_rows
            pending, pending_rows = [], 0
            return b

        for req, n in queue:
            taken = 0
            while taken < n:
                room = self.ladder.max_rung - pending_rows
                take = min(n - taken, room)
                pending.append((req, taken, taken + take))
                pending_rows += take
                taken += take
                if pending_rows == self.ladder.max_rung:
                    yield flush()
        if pending_rows:
            yield flush()

    def padding_frac(self) -> float:
        """Cumulative padded / dispatched rows (0.0 before any batch)."""
        total = self.real_rows + self.padded_rows
        return self.padded_rows / total if total else 0.0


@dataclasses.dataclass
class _Pending:
    """One admitted request in the continuous queue."""

    key: Any
    n_rows: int
    taken: int        # rows already placed into dispatched batches
    arrival: float    # scheduler-clock admission time


class ContinuousScheduler:
    """Admit-while-in-flight ladder scheduler (the continuous half of
    ``harp serve``).

    :class:`MicroBatcher` models the burst-drain plane: the queue is
    filled once, drained to empty, and nothing can be admitted until the
    drain completes.  This scheduler keeps one persistent FIFO of
    request rows that :meth:`put` may extend at ANY time — in
    particular while device batches are in flight — and hands out one
    ladder-shaped batch per :meth:`next_batch` call, so admission,
    staging and compute overlap instead of alternating.

    Two policy knobs, with the reference's defaults (it chose them from
    a sweep of its own; ``serve/bench.py``'s sustained mode measures
    them here):

    - ``max_queue_delay_s`` — the flush deadline: a queued row never
      waits longer than this for a fuller rung.  Binds only in the
      mid-load regime (at low load the idle-mesh rule dispatches
      immediately; at saturation the depth rule fires first).
    - ``rung_policy`` — ``"adaptive"`` (default) holds work back while
      a batch is in flight until the max rung fills or the deadline
      expires, so deep queues ride full max-rung batches.  ``"greedy"``
      dispatches whatever is queued at the minimal covering rung (the
      burst plane's no-holding-back rule with continuous admission) —
      lowest queueing delay, worst padding; the A/B bench row records
      the tradeoff.

    The dispatch decision needs to know whether the mesh is busy, so
    :meth:`ready` takes ``idle``: work is NEVER held back while the
    mesh idles (a lone 1-row request still gets its 1-rung latency).
    Arrival order is FIFO — rows leave in admission order, so responses
    complete in admission order and per-connection ordering is free.
    """

    def __init__(self, ladder: ShapeLadder | Sequence[int] = DEFAULT_LADDER,
                 *, max_queue_delay_s: float = 0.005,
                 rung_policy: str = "adaptive", overhead_rows: int = 64):
        if rung_policy not in ("adaptive", "greedy"):
            raise ValueError(f"rung_policy {rung_policy!r} must be "
                             "'adaptive' or 'greedy'")
        self.ladder = (ladder if isinstance(ladder, ShapeLadder)
                       else ShapeLadder(ladder))
        self.max_queue_delay_s = float(max_queue_delay_s)
        self.rung_policy = rung_policy
        # batch cost model: cost(rung) ∝ overhead_rows + rung, the fixed
        # cost of a dispatch in rows (the reference's default, 64).
        # Drives the nibble-vs-pad rung choice in next_batch: tiny
        # rungs are overhead-dominated (padding 3 rows up to the 8-rung
        # beats three 1-rung dispatches), big rungs are compute-
        # dominated (two full 64-rungs beat one 20%-filled 512).
        self.overhead_rows = int(overhead_rows)
        self._queue: collections.deque[_Pending] = collections.deque()
        self.queued_rows = 0
        self.padded_rows = 0
        self.real_rows = 0
        self.batches_formed = 0  # monotone Batch.seq source

    def put(self, key: Any, n_rows: int, now: float) -> None:
        """Admit a request (legal mid-flight — that is the point)."""
        if n_rows < 1:
            raise ValueError(f"request with {n_rows} rows")
        self._queue.append(_Pending(key, int(n_rows), 0, float(now)))
        self.queued_rows += int(n_rows)

    def __len__(self) -> int:
        return self.queued_rows

    def oldest_wait(self, now: float) -> float:
        return (now - self._queue[0].arrival) if self._queue else 0.0

    def next_deadline(self) -> float | None:
        """Scheduler-clock instant at which the flush rule fires, or
        None when nothing is queued (the TCP pump sleeps until this)."""
        if not self._queue:
            return None
        return self._queue[0].arrival + self.max_queue_delay_s

    def ready(self, now: float, idle: bool) -> bool:
        """Should the caller dispatch a batch right now?"""
        if not self.queued_rows:
            return False
        if idle or self.rung_policy == "greedy":
            return True
        if self.queued_rows >= self.ladder.max_rung:
            return True
        return self.oldest_wait(now) >= self.max_queue_delay_s

    def next_batch(self, now: float) -> Batch | None:
        """Pop one ladder-shaped batch off the queue head (FIFO rows).

        Rung choice is cost-aware (the burst batcher's minimal-cover
        rule is wrong for a persistent queue: covering a 100-row
        backlog with the 512 rung computes 5× the needed rows):

        - backlog >= max rung → one full max-rung batch;
        - else compare, under ``cost(rung) ∝ overhead_rows + rung``,
          serving the backlog as full ``floor_rung`` nibbles vs one
          padded covering batch, and take whichever is cheaper: a full
          64-rung nibble off a 100-row backlog, but 3 rows padded up
          to the 8-rung (three 1-rung dispatches cost 3× the fixed
          overhead for the same work).

        Oversized requests span successive calls via their ``(lo, hi)``
        slices exactly as the burst batcher's batches do.  Returns None
        on an empty queue — the ``ready`` policy, not this method,
        decides *whether* now is a good time.  ``rung_policy="greedy"``
        always covers the whole queue at the minimal rung (the burst
        rule), which is the knob's other arm in the sustained A/B.
        """
        if not self.queued_rows:
            return None
        rows = min(self.queued_rows, self.ladder.max_rung)
        if (self.rung_policy == "adaptive"
                and rows < self.ladder.max_rung):
            floor = self.ladder.floor_rung(rows)
            if floor < rows:  # not an exact rung fit
                nibble_cost = ((self.overhead_rows + floor)
                               * -(-rows // floor))
                pad_cost = self.overhead_rows + self.ladder.bucket(rows)
                if nibble_cost < pad_cost:
                    rows = floor
        rung = self.ladder.bucket(rows)
        requests: list[tuple[Any, int, int]] = []
        left = rows
        while left:
            p = self._queue[0]
            take = min(left, p.n_rows - p.taken)
            requests.append((p.key, p.taken, p.taken + take))
            p.taken += take
            left -= take
            if p.taken == p.n_rows:
                self._queue.popleft()
        self.queued_rows -= rows
        self.real_rows += rows
        self.padded_rows += rung - rows
        seq = self.batches_formed
        self.batches_formed += 1
        return Batch(rung=rung, rows=rows, requests=requests, seq=seq)

    def padding_frac(self) -> float:
        """Cumulative padded / dispatched rows (0.0 before any batch)."""
        total = self.real_rows + self.padded_rows
        return self.padded_rows / total if total else 0.0

    def expire(self, now: float, deadline_s: float) -> list:
        """Remove queued requests whose deadline already passed — the
        load-shedding half of the fault plane.  Only requests
        with NO rows in a dispatched batch are removable (``taken > 0``
        means earlier segments are in flight and the reassembly contract
        owns them — those complete late and count as deadline misses);
        expired keys are returned so the caller answers each with a
        structured shed error instead of unbounded latency."""
        expired: list = []
        keep: collections.deque[_Pending] = collections.deque()
        for p in self._queue:
            if p.taken == 0 and (now - p.arrival) > deadline_s:
                expired.append(p.key)
                self.queued_rows -= p.n_rows
            else:
                keep.append(p)
        self._queue = keep
        return expired

    def discard(self, keys: set) -> None:
        """Drop the still-queued rows of ``keys`` (a hard-failed batch's
        requests must not leave tail segments behind to dispatch into a
        request that was already answered with an error)."""
        keep: collections.deque[_Pending] = collections.deque()
        for p in self._queue:
            if p.key in keys:
                self.queued_rows -= p.n_rows - p.taken
            else:
                keep.append(p)
        self._queue = keep
