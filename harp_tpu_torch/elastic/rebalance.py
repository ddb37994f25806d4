"""Mid-run rebalance: packs, id relabeling and trigger consumption — the
port of ``harp_tpu.elastic.rebalance``.

The movable grain is a **pack**: a contiguous block of external ids (docs
for LDA, users for MF-SGD, point rows for streaming KMeans), aligned with
the partitioners' ``id // ceil(n_ids / n_workers)`` block ownership, so
the home assignment reproduces the plain layout exactly.  Packs are the
units the skew ledger records (``units=`` on the execution hook),
``suggest_rebalance`` plans over and ``schedule.apply_rebalance`` replays.

A rebalance (or a survivors' repartition after a worker loss) is an
**assignment** ``pack → worker`` plus an :class:`IdRemap`: a bijective
relabeling of the external ids under which plain block partition
``new_id // bound`` lands every pack on its planned owner.  The
partitioners then take the remapped corpus unchanged.  Model rows follow
the same relabeling (:mod:`harp_tpu_torch.elastic.apps`).
"""

from __future__ import annotations

import numpy as np

from harp_tpu_torch import schedule
from harp_tpu_torch.utils.skew import SkewLedger


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def wasted_frac(loads) -> float:
    """The SkewLedger imbalance model on a per-worker load vector:
    the fraction of total worker time idle-waiting at the superstep
    barrier, ``1 - mean/max`` (0.0 for empty/zero loads)."""
    w = np.asarray(loads, np.float64)
    mx = float(w.max()) if w.size else 0.0
    if mx <= 0:
        return 0.0
    return float(1.0 - w.mean() / mx)


class Packs:
    """Contiguous id-range packs over ``[0, n_ids)``.

    ``per_worker`` packs per HOME worker: worker ``w``'s ownership range
    ``[w·own, (w+1)·own)`` (``own = ceil(n_ids / n_home)`` — the exact
    rule every partitioner uses) splits into ``per_worker`` equal-width
    sub-ranges.  Pack ids are stable across any later assignment; the
    id→pack map is pure arithmetic, so pack loads are one ``bincount``
    over the corpus.
    """

    def __init__(self, n_ids: int, n_home: int, per_worker: int = 4):
        if n_ids < 1 or n_home < 1 or per_worker < 1:
            raise ValueError(
                f"need n_ids/n_home/per_worker >= 1, got "
                f"{n_ids}/{n_home}/{per_worker}")
        self.n_ids = int(n_ids)
        self.n_home = int(n_home)
        self.per_worker = int(per_worker)
        self.own = _ceil_div(self.n_ids, self.n_home)
        self.width = _ceil_div(self.own, self.per_worker)
        self.n_packs = self.n_home * self.per_worker
        ranges = []
        for pid in range(self.n_packs):
            w, j = divmod(pid, self.per_worker)
            lo = w * self.own + j * self.width
            hi = min(lo + self.width, (w + 1) * self.own, self.n_ids)
            ranges.append((min(lo, self.n_ids), max(min(lo, self.n_ids),
                                                    min(hi, self.n_ids))))
        self.ranges = ranges

    def pack_of(self, ids) -> np.ndarray:
        ids = np.asarray(ids)
        w = ids // self.own
        j = np.minimum((ids - w * self.own) // self.width,
                       self.per_worker - 1)
        return w * self.per_worker + j

    def loads(self, ids) -> np.ndarray:
        """Per-pack item counts for a corpus keyed by these ids."""
        return np.bincount(self.pack_of(ids),
                           minlength=self.n_packs).astype(np.float64)

    def widths(self) -> np.ndarray:
        return np.asarray([hi - lo for lo, hi in self.ranges], np.int64)

    def home_assignment(self) -> np.ndarray:
        """pack → its home worker (the non-elastic layout, exactly)."""
        return np.arange(self.n_packs) // self.per_worker


class IdRemap:
    """Bijective relabeling realizing a pack assignment as block
    partition.

    Worker ``w`` hosts its assigned packs' ids consecutively from
    ``w · bound`` (packs in ascending pack-id order — deterministic, so
    a survivors-only comparison run derives the identical layout);
    ``bound = max_w Σ widths`` so every worker fits, and the remapped
    id space is ``n_workers · bound`` (the trailing slots per worker
    are virtual pads no corpus item ever maps to).  ``fwd[old] = new``
    covers every original id; ``inv[new] = old`` is -1 on pads.
    """

    def __init__(self, packs: Packs, assignment, n_workers: int):
        asg = np.asarray(assignment, np.int64)
        if asg.shape != (packs.n_packs,):
            raise ValueError(
                f"assignment must map all {packs.n_packs} packs, got "
                f"shape {asg.shape}")
        if asg.min() < 0 or asg.max() >= n_workers:
            raise ValueError(
                f"assignment names workers outside [0, {n_workers})")
        widths = packs.widths()
        per_w = [np.flatnonzero(asg == w) for w in range(n_workers)]
        totals = [int(widths[p].sum()) for p in per_w]
        self.bound = max(1, max(totals))
        self.new_n = n_workers * self.bound
        fwd = np.full(packs.n_ids, -1, np.int64)
        for w, pids in enumerate(per_w):
            off = 0
            for pid in pids:
                lo, hi = packs.ranges[pid]
                if hi > lo:
                    fwd[lo:hi] = w * self.bound + off + np.arange(hi - lo)
                    off += hi - lo
        assert (fwd >= 0).all(), "remap did not cover the id space"
        self.fwd = fwd
        inv = np.full(self.new_n, -1, np.int64)
        inv[fwd] = np.arange(packs.n_ids)
        self.inv = inv


def worker_loads(assignment, pack_loads, n_workers: int) -> np.ndarray:
    return np.bincount(np.asarray(assignment, np.int64),
                       weights=np.asarray(pack_loads, np.float64),
                       minlength=n_workers)


def splits_of(assignment, n_workers: int) -> list[list[int]]:
    """Per-worker pack-id lists (ascending) — the
    ``schedule.apply_rebalance`` splits shape."""
    asg = np.asarray(assignment, np.int64)
    return [[int(p) for p in np.flatnonzero(asg == w)]
            for w in range(n_workers)]


def pack_units(assignment, pack_loads, n_workers: int) -> list[list[tuple]]:
    """Per-worker ``(pack_id, load)`` grains — the SkewLedger ``units=``
    payload the sentinel's whole-unit plan is built from."""
    loads = np.asarray(pack_loads, np.float64)
    return [[(pid, float(loads[pid])) for pid in lst]
            for lst in splits_of(assignment, n_workers)]


def replay_repartition(packs: Packs, pack_loads, stored_assignment,
                       n_workers: int, phase: str
                       ) -> tuple[np.ndarray, dict | None]:
    """Derive the survivors' repartition by replaying the same plan
    machinery a mid-run rebalance uses.

    The stored assignment may name workers outside the survivor range
    (a checkpoint written pre-shrink), so it first folds deterministically
    onto the survivors (``worker % n``); a throwaway SkewLedger then
    records the folded layout's pack grains, ``suggest_rebalance`` emits
    the whole-unit plan, and ``schedule.apply_rebalance`` replays it —
    the exact pipeline a skew trigger rides, forced whole-unit.  Pure
    function of (packs, loads, stored assignment, n): the elastic resume
    and an uninterrupted survivors-only run from the same checkpoint
    derive BIT-identical layouts (the worker-loss drill's pin).
    """
    folded = np.asarray(stored_assignment, np.int64) % n_workers
    led = SkewLedger()  # throwaway: never feeds the sentinel
    led.record_partition(
        phase, worker_loads(folded, pack_loads, n_workers), unit="load",
        units=pack_units(folded, pack_loads, n_workers))
    plan = led.suggest_rebalance(phase)
    if plan is None or not plan["moves"]:
        return folded, plan
    asg_map = schedule.rebalance_assignment(
        splits_of(folded, n_workers), plan)
    return np.asarray([asg_map[p] for p in range(packs.n_packs)],
                      np.int64), plan


def maybe_rebalance(adapter) -> dict | None:
    """The superstep-boundary hook: consume a latched
    ``skew_trigger`` for ``adapter.phase`` and act on it.

    Consumes exactly once per fired trigger (the sentinel handshake —
    no double-apply), replays the inline plan through
    ``schedule.apply_rebalance`` over the adapter's current pack
    splits, and applies the resulting assignment only when the
    projected ``wasted_frac`` actually improves (a plan that cannot
    help — e.g. one giant indivisible pack — is consumed and dropped,
    so a still-skewed phase never thrashes).  Returns the recorded
    ``kind:"elastic"`` rebalance row, or None when there was nothing
    to do (no trigger, telemetry off, fractional plan, no improvement).
    """
    from harp_tpu_torch import health
    from harp_tpu_torch.elastic import ledger as eledger

    row = health.monitor.consume_skew_trigger(adapter.phase)
    if row is None:
        return None
    plan = row.get("plan")
    if (not isinstance(plan, dict) or not plan.get("moves")
            or not all("id" in m for m in plan["moves"])):
        return None  # fractional or empty plan: nothing whole-unit
    n = adapter.mesh.num_workers
    asg_map = schedule.rebalance_assignment(
        splits_of(adapter.assignment, n), plan)
    new_asg = np.asarray([asg_map[p] for p in range(adapter.packs.n_packs)],
                         np.int64)
    before = worker_loads(adapter.assignment, adapter.loads, n)
    after = worker_loads(new_asg, adapter.loads, n)
    wf_b, wf_a = wasted_frac(before), wasted_frac(after)
    if wf_a >= wf_b:
        return None  # the move cannot help; keep the layout
    adapter.apply_assignment(new_asg)
    return eledger.record(
        "rebalance", adapter.phase,
        n_workers=n, moves=len(plan["moves"]),
        loads_before=[round(float(x), 4) for x in before],
        loads_after=[round(float(x), 4) for x in after],
        total=round(float(before.sum()), 4),
        wasted_frac_before=round(wf_b, 4),
        wasted_frac_after=round(wf_a, 4),
        trigger_supersteps=int(row.get("supersteps", 0)))
