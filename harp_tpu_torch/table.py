"""Table / Partition data model — the port of ``harp_tpu.table``.

Harp's ``edu.iu.harp.partition`` keeps a ``Table`` (partition id →
``Partition``) whose ``PartitionCombiner`` decides what happens when two
partitions with one id meet, and a ``Partitioner`` (partition id → owning
worker, ``id % numWorkers``); ``edu.iu.harp.keyval`` layers typed KV tables
with a ``ValCombiner`` on top.

Host side (numpy): :class:`Table`, the :class:`KVTable` family and
:func:`kv_allreduce`, whose union across processes is a
``torch.distributed`` object gather.  Worker side (tensors, called by every
worker of the group together, SPMD by process): :func:`combine_by_key` (a
segment reduction over a dense key space), :func:`regroup_by_key`, and the
row verbs on a row-sharded global table — the dense :func:`pull_rows` /
:func:`push_rows`, and the request/serve exchange
:func:`pull_rows_sparse` / :func:`push_rows_sparse` (with ``_dedup`` forms)
whose wire is ``nw · capacity`` rows, whatever the table's size.  Worker
``w`` of ``nw`` owns rows ``[w · rows_local, (w + 1) · rows_local)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.collective import Combiner
from harp_tpu_torch.parallel.dispatch import bucket_by_destination
from harp_tpu_torch.parallel.mesh import WorkerMesh, num_workers, worker_id


@dataclasses.dataclass
class Partition:
    """One partition: an id and its payload — Harp's ``Partition``."""

    id: int
    data: Any


def modulo_partitioner(num_workers: int) -> Callable[[int], int]:
    """Harp's default ``Partitioner``: partition id → ``id % numWorkers``."""

    def owner(pid: int) -> int:
        return pid % num_workers

    return owner


class Table:
    """Host-side table of partitions with Harp's combiner semantics.

    ``add_partition`` on an id already present invokes the combiner, as
    Harp's ``Table.addPartition`` does.  :meth:`to_stacked` gives the dense
    ``[num_partitions, ...]`` view to place on the workers and
    :meth:`from_stacked` rebuilds a table from one."""

    def __init__(self, combiner: Combiner | str = Combiner.ADD):
        self.combiner = C._as_combiner(combiner)
        self._parts: dict[int, Any] = {}
        self._counts: dict[int, int] = {}  # contributions per id (for AVG)

    def add_partition(self, pid: int, data: Any) -> None:
        # AVG is the running mean over ALL contributions, as allreduce(AVG)
        # and combine_by_key(AVG) give; a first insert is stored verbatim
        _accumulate(self._parts, self._counts, pid, data, self.combiner)

    def get_partition(self, pid: int) -> Any:
        return self._parts[pid]

    def partition_ids(self) -> list[int]:
        return sorted(self._parts)

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def __iter__(self) -> Iterator[Partition]:
        for pid in self.partition_ids():
            yield Partition(pid, self._parts[pid])

    def __contains__(self, pid: int) -> bool:
        return pid in self._parts

    def to_stacked(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense ``(ids, stack)``: ``stack[i]`` is partition ``ids[i]``'s
        data.  Partition shapes must match (pad irregular ones first)."""
        if not self._parts:
            raise ValueError(
                "Table has no partitions; to_stacked()/shard() need at least "
                "one (irregular apps should pad empty workers explicitly)")
        ids = np.asarray(self.partition_ids(), dtype=np.int32)
        stack = np.stack([np.asarray(self._parts[i]) for i in ids])
        return ids, stack

    @classmethod
    def from_stacked(cls, ids, stack,
                     combiner: Combiner | str = Combiner.ADD) -> "Table":
        t = cls(combiner)
        for pid, row in zip(np.asarray(ids).tolist(), np.asarray(stack)):
            t.add_partition(int(pid), row)
        return t

    def shard(self, mesh: WorkerMesh) -> tuple[torch.Tensor, torch.Tensor]:
        """This worker's block of the stacked table: ``(ids, stack)`` split
        over the workers along the partition axis, on ``mesh.device``."""
        ids, stack = self.to_stacked()
        return mesh.shard_array(ids, 0), mesh.shard_array(stack, 0)


def _combine_host(comb: Combiner, a, b):
    a, b = np.asarray(a), np.asarray(b)
    if comb is Combiner.ADD:
        return a + b
    if comb is Combiner.MAX:
        return np.maximum(a, b)
    if comb is Combiner.MIN:
        return np.minimum(a, b)
    if comb is Combiner.AVG:
        raise AssertionError(
            "AVG is _accumulate's running mean; a pairwise (a+b)/2 here would "
            "disagree with allreduce/combine_by_key AVG")
    if comb is Combiner.MULTIPLY:
        return a * b
    raise AssertionError(comb)


def _accumulate(store: dict, counts: dict, key: int, value, combiner: Combiner,
                weight: int = 1) -> None:
    """Fold one contribution into a keyed store — the one ValCombiner step
    of ``Table.add_partition``, ``KVTable.add`` and ``KVTable.merge``.
    ``weight`` is the number of raw contributions ``value`` already holds
    (a merge of pre-combined tables), so AVG stays the mean of them all."""
    if key in store:
        if combiner is Combiner.AVG:
            n = counts[key]
            old = np.asarray(store[key])
            store[key] = old + (np.asarray(value) - old) * (
                weight / (n + weight))
        else:
            store[key] = _combine_host(combiner, store[key], value)
        counts[key] += weight
    else:
        store[key] = value
        counts[key] = weight


class KVTable:
    """Typed key → value table with ValCombiner collision semantics.

    ``add`` on a key already present invokes the combiner; values are
    scalars or fixed-shape arrays.  ``partition`` buckets keys as Harp does
    (``key % num_partitions``); ``merge`` folds another worker's table in.
    AVG stores float64 means whatever the typed ``dtype`` (a mean is not
    closed over the integers)."""

    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1, dtype=None):
        self.combiner = C._as_combiner(combiner)
        self.num_partitions = int(num_partitions)
        self.dtype = np.float64 if self.combiner is Combiner.AVG \
            and dtype is not None \
            and np.issubdtype(np.dtype(dtype), np.integer) else dtype
        self._kv: dict[int, Any] = {}
        self._counts: dict[int, int] = {}

    def add(self, key: int, value: Any) -> None:
        _accumulate(self._kv, self._counts, int(key),
                    np.asarray(value, dtype=self.dtype), self.combiner)

    def get(self, key: int, default: Any = None) -> Any:
        return self._kv.get(int(key), default)

    def keys(self) -> list[int]:
        return sorted(self._kv)

    def items(self) -> Iterator[tuple[int, Any]]:
        for k in self.keys():
            yield k, self._kv[k]

    def __len__(self) -> int:
        return len(self._kv)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._kv

    def partition(self, key: int) -> int:
        """The key's partition — Harp's ``key % numPartitions``."""
        return int(key) % self.num_partitions

    def merge(self, other: "KVTable") -> None:
        """Fold ``other`` in through the combiner, count-weighted: a key
        holding ``m`` raw contributions there enters an AVG with weight
        ``m``, so merging combined tables equals combining the raw ones."""
        for k in other.keys():
            _accumulate(self._kv, self._counts, k,
                        np.asarray(other._kv[k], dtype=self.dtype),
                        self.combiner, weight=other._counts[k])

    def to_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense ``(keys [n] int64, values [n, ...], counts [n] int64)``,
        keys ascending; ``counts[i]`` is the number of raw contributions in
        ``values[i]``.  An empty table's values have shape ``(0,)``."""
        ks = self.keys()
        keys = np.asarray(ks, dtype=np.int64)
        counts = np.asarray([self._counts[k] for k in ks], dtype=np.int64)
        if ks:
            vals = np.stack([np.asarray(self._kv[k]) for k in ks])
        else:
            vals = np.zeros((0,), dtype=self.dtype or np.float32)
        return keys, vals, counts

    @classmethod
    def from_arrays(cls, keys, values, combiner: Combiner | str = Combiner.ADD,
                    num_partitions: int = 1, dtype=None,
                    counts=None) -> "KVTable":
        # the typed subclasses fix their dtype and take none
        t = cls(combiner, num_partitions) if cls is not KVTable \
            else cls(combiner, num_partitions, dtype)
        keys = np.asarray(keys).tolist()
        counts = [1] * len(keys) if counts is None \
            else np.asarray(counts).tolist()
        for k, v, c in zip(keys, np.asarray(values), counts):
            _accumulate(t._kv, t._counts, int(k),
                        np.asarray(v, dtype=t.dtype), t.combiner,
                        weight=int(c))
        return t


# Harp's typed tables (edu.iu.harp.keyval.*KVTable): the key is a Python
# int; the name fixes the value dtype
class Int2IntKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.int32)


class Int2LongKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.int64)


class Int2FloatKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.float32)


class Int2DoubleKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.float64)


class Long2IntKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.int32)


class Long2DoubleKVTable(KVTable):
    def __init__(self, combiner: Combiner | str = Combiner.ADD,
                 num_partitions: int = 1):
        super().__init__(combiner, num_partitions, dtype=np.float64)


def _empty_like(table: KVTable) -> KVTable:
    """A new empty table of the same class, combiner and partitioning."""
    if type(table) is KVTable:
        return KVTable(table.combiner, table.num_partitions, table.dtype)
    return type(table)(table.combiner, table.num_partitions)


def kv_allreduce(table: KVTable, worker_tables: list[KVTable] | None = None):
    """Merge KV tables across workers so that every worker holds the union
    — the KV form of Harp's table allreduce, the ValCombiner resolving
    collisions (count-weighted, so AVG equals combining the raw values).

    ``worker_tables``: further tables held by this process, merged first.
    With more than one worker in the group every worker calls this, and
    the union is formed over all of them (:func:`_kv_process_union`)."""
    merged = _empty_like(table)
    merged.merge(table)
    for t in worker_tables or []:
        merged.merge(t)
    if num_workers() > 1:
        merged = _kv_process_union(merged)
    return merged


def _kv_process_union(local: KVTable) -> KVTable:
    """The union of every worker's table, folded in rank order.  Each
    worker's ``(keys, values, counts)`` travels whole through
    ``all_gather_object`` (numpy arrays: their dtypes survive); workers
    with a non-empty table must agree on the values' dtype and shape."""
    keys, vals, counts = local.to_arrays()
    gathered: list = [None] * num_workers()
    dist.all_gather_object(gathered, (keys, vals, counts))
    sigs = {(v.dtype.str, v.shape[1:]) for k, v, _ in gathered if len(k)}
    if not sigs:
        return local  # every worker is empty
    if len(sigs) > 1:
        raise ValueError("kv_allreduce: value dtypes/shapes differ across "
                         f"processes: {sorted(sigs)}")
    union = _empty_like(local)
    for ks, vs, cs in gathered:
        for k, v, c in zip(ks.tolist(), vs, cs.tolist()):
            _accumulate(union._kv, union._counts, int(k),
                        np.asarray(v, dtype=union.dtype), union.combiner,
                        weight=int(c))
    return union


# ---- worker side: keyed reductions and the row verbs ------------------------

def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` [n] as ``like``'s dtype, broadcastable over its trailing
    dims."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim())).to(
        like.dtype)


def _segment(values: torch.Tensor, keys: torch.Tensor, num_keys: int,
             how: str) -> torch.Tensor:
    """A segment reduction over ``num_keys`` segments: an id outside
    ``[0, num_keys)`` is dropped, and an empty segment holds the
    reduction's identity (0, the dtype's lowest/highest value for max/min,
    1 for prod)."""
    inside = (keys >= 0) & (keys < num_keys)
    k, v = keys[inside].long(), values[inside]
    shape = (num_keys,) + tuple(values.shape[1:])
    if how == "sum":
        return torch.zeros(shape, dtype=values.dtype,
                           device=values.device).index_add_(0, k, v)
    if values.is_floating_point():
        lo, hi = -float("inf"), float("inf")
    else:
        info = torch.iinfo(values.dtype)
        lo, hi = info.min, info.max
    fill = {"amax": lo, "amin": hi, "prod": 1}[how]
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    idx = k.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(v)
    return out.scatter_reduce_(0, idx, v, how, include_self=True)


def combine_by_key(keys: torch.Tensor, values: torch.Tensor, num_keys: int,
                   op: Combiner | str = Combiner.ADD) -> torch.Tensor:
    """Combine values that share a key — the ValCombiner reduction, on the
    worker's device: ``[num_keys, ...]``, segment ``k`` the combined
    values of key ``k``.  Keys outside ``[0, num_keys)`` (the -1 padding of
    :func:`regroup_by_key`) are dropped; AVG of an empty key is 0."""
    comb = C._as_combiner(op)
    if comb is Combiner.ADD:
        return _segment(values, keys, num_keys, "sum")
    if comb is Combiner.MAX:
        return _segment(values, keys, num_keys, "amax")
    if comb is Combiner.MIN:
        return _segment(values, keys, num_keys, "amin")
    if comb is Combiner.AVG:
        s = _segment(values, keys, num_keys, "sum")
        n = _segment(torch.ones_like(values), keys, num_keys, "sum")
        return s / torch.clamp_min(n, 1)
    return _segment(values, keys, num_keys, "prod")


def regroup_by_key(keys: torch.Tensor, values: torch.Tensor, *,
                   capacity: int):
    """Route (key, value) pairs to their owning worker (``key % nw``) — the
    KV regroup, one all-to-all over capacity-bounded buckets.

    Per worker: ``keys [n]`` (non-negative), ``values [n, ...]``,
    ``capacity`` pair slots to EACH destination.  Returns ``(keys_out
    [nw·capacity], values_out [nw·capacity, ...], mask [nw·capacity],
    dropped)``: the pairs this worker now owns and the GLOBAL count of
    pairs dropped past a bucket's capacity.  Padding slots carry key -1
    and mask 0, which :func:`combine_by_key` drops for every combiner."""
    nw = num_workers()
    dest = keys % nw
    # keys travel +1, so a zero-filled padding slot decodes to -1
    (buf_k1, buf_v, buf_m), _, _, dropped_local = bucket_by_destination(
        dest, (keys + 1, values, torch.ones(keys.shape[0],
                                            dtype=torch.float32,
                                            device=keys.device)),
        capacity, nw)
    dropped = C.allreduce(dropped_local)
    rk1, rv, rm = C.regroup((buf_k1, buf_v, buf_m), split_dim=0,
                            concat_dim=0)

    def flat(a):
        return a.reshape((nw * capacity,) + tuple(a.shape[2:]))

    return flat(rk1) - 1, flat(rv), flat(rm), dropped


def pull_rows(global_shard: torch.Tensor, row_ids: torch.Tensor
              ) -> torch.Tensor:
    """Rows ``row_ids`` of the row-sharded global table: the whole table
    replicated by ``reshard(blocked(0) → replicated)``, then the rows
    taken.  Wire O(table); :func:`pull_rows_sparse` moves only the rows."""
    full = C.reshard(global_shard, C.ShardSpec.blocked(0),
                     C.ShardSpec.replicated())
    return full[row_ids.long()]


def push_rows(global_shard: torch.Tensor, row_ids: torch.Tensor,
              deltas: torch.Tensor) -> torch.Tensor:
    """Add row deltas into the row-sharded global table: a dense
    ``[n_total, ...]`` contribution pushed (reduce-scatter) to the owners.
    Wire O(table); an id outside the table adds nothing."""
    n_total = global_shard.shape[0] * num_workers()
    ids = row_ids.long()
    inside = (ids >= 0) & (ids < n_total)
    dense = torch.zeros((n_total,) + tuple(global_shard.shape[1:]),
                        dtype=deltas.dtype, device=deltas.device)
    dense.index_add_(0, ids[inside], deltas[inside])
    return global_shard + C.push(dense)


def _guard_row_requests(row_ids: torch.Tensor, valid, n_rows: int):
    """(requested, oor_local): the one out-of-range guard of both sparse
    verbs.  A bad id takes no slot (it would land in some owner's bucket)
    and counts as a drop, unlike ``valid`` padding, which is free."""
    in_range = (row_ids >= 0) & (row_ids < n_rows)
    if valid is None:
        return in_range, (~in_range).sum().to(torch.int32)
    return valid & in_range, (valid & ~in_range).sum().to(torch.int32)


def _owners(row_ids: torch.Tensor, rows_local: int) -> torch.Tensor:
    return torch.div(row_ids, rows_local, rounding_mode="floor")


def pull_rows_sparse(global_shard: torch.Tensor, row_ids: torch.Tensor, *,
                     capacity: int, valid: torch.Tensor | None = None):
    """Rows of the row-sharded global table without materializing it.

    ``row_ids [m]``: global rows this worker needs (duplicates fine).
    ``capacity``: request slots this worker may use at EACH owner;
    requests past it are dropped.  ``valid`` (optional [m] bool): False
    entries are padding — no request, no slot, ``ok`` False.  One
    all-to-all carries the requests, the owner serves rows from its shard,
    a second carries them back.

    Returns ``(rows [m, ...], ok [m] bool, dropped)``: ``rows[i]`` is zeros
    where ``ok[i]`` is False, and ``dropped`` is the GLOBAL count of
    requests not served — capacity overflow plus out-of-range ids."""
    nw, me = num_workers(), worker_id()
    rows_local = global_shard.shape[0]
    row_ids = row_ids.to(torch.int32)
    dest = _owners(row_ids, rows_local)
    requested, oor_local = _guard_row_requests(row_ids, valid,
                                               nw * rows_local)
    # ids travel +1, so a zero-filled padding slot decodes to the -1 sentinel
    (req,), keep, slot, dropped_local = bucket_by_destination(
        dest, (row_ids + 1,), capacity, nw, requested)       # [nw, capacity]
    dropped = C.allreduce(dropped_local + oor_local)
    # requests: recv[p, j] is the row peer p wants from me in its slot j
    recv = C.regroup(req, split_dim=0, concat_dim=0)
    local = recv - 1 - me * rows_local
    ok_r = (recv > 0) & (local >= 0) & (local < rows_local)
    served = global_shard[local.clamp(0, rows_local - 1).long()]
    served = served * _expand(ok_r, served)
    # replies: replies[o, j] is the row owner o served for my slot j
    replies = C.regroup(served, split_dim=0, concat_dim=0)
    flat = replies.reshape((nw * capacity,) + tuple(replies.shape[2:]))
    idx = torch.where(keep, dest.long() * capacity + slot,
                      torch.zeros_like(slot))
    out = flat[idx]
    return out * _expand(keep, out), keep, dropped


def push_rows_sparse(global_shard: torch.Tensor, row_ids: torch.Tensor,
                     deltas: torch.Tensor, *, capacity: int,
                     valid: torch.Tensor | None = None):
    """Add row deltas into the row-sharded global table, O(pushed) wire —
    Harp's ``LocalGlobalSyncCollective.push``: each (row id, delta) pair
    goes to its owner in one all-to-all of ``nw · capacity`` slots and is
    added there.  Pairs past ``capacity`` and out-of-range ids are
    dropped and counted, never added; ``valid`` as in
    :func:`pull_rows_sparse`.  Returns ``(new_shard, dropped)``."""
    nw, me = num_workers(), worker_id()
    rows_local = global_shard.shape[0]
    row_ids = row_ids.to(torch.int32)
    dest = _owners(row_ids, rows_local)
    requested, oor_local = _guard_row_requests(row_ids, valid,
                                               nw * rows_local)
    (ids1, dv), _, _, dropped_local = bucket_by_destination(
        dest, (row_ids + 1, deltas), capacity, nw, requested)
    dropped = C.allreduce(dropped_local + oor_local)
    rids1, rdv = C.regroup((ids1, dv), split_dim=0, concat_dim=0)
    flat_ids = rids1.reshape(nw * capacity).long() - 1
    # each delta is added into the table in slot order, as XLA's scatter
    # does (integer-valued deltas give the same sums in any order); the -1
    # padding goes to a spare row past the table, so that no mask (and no
    # wait for the device) is needed to leave it out
    local = torch.where(flat_ids >= 0, flat_ids - me * rows_local,
                        torch.full_like(flat_ids, rows_local))
    out = torch.empty((rows_local + 1,) + tuple(global_shard.shape[1:]),
                      dtype=global_shard.dtype, device=global_shard.device)
    out[:rows_local] = global_shard
    out[rows_local] = 0
    out.index_add_(0, local, rdv.reshape(
        (nw * capacity,) + tuple(rdv.shape[2:])).to(global_shard.dtype))
    return out[:rows_local], dropped


def _dedup_plan(row_ids: torch.Tensor, valid):
    """The layout of the ``_dedup`` verbs: the ids stably sorted (padding
    last, under an INT32_MAX sentinel that every row id is below), each
    run's first position marked, and every position mapped to its run.
    Returns ``(order, inv, wire_ids, first, run, firstpos)``; the wire
    then carries one slot per distinct id (``valid=first``)."""
    ids = row_ids.to(torch.int32)
    sentinel = torch.iinfo(torch.int32).max
    keyed = ids if valid is None else torch.where(
        valid, ids, torch.full_like(ids, sentinel))
    order = torch.argsort(keyed, stable=True)
    sw = keyed[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       sw[1:] != sw[:-1]]) & (sw < sentinel)
    run = torch.cumsum(first, 0) - 1               # run of each position
    idx = torch.arange(ids.shape[0], device=ids.device)
    firstpos = torch.cummax(torch.where(first, idx, torch.full_like(idx, -1)),
                            0).values
    inv = torch.empty_like(order)
    inv[order] = idx
    return order, inv, torch.where(first, sw, torch.zeros_like(sw)), first, \
        run, firstpos


def pull_rows_sparse_dedup(global_shard: torch.Tensor, row_ids: torch.Tensor,
                           *, capacity: int,
                           valid: torch.Tensor | None = None):
    """:func:`pull_rows_sparse` with the duplicates of an id sharing ONE
    wire slot: the same contract and result, but an owner's capacity is
    spent per DISTINCT id, so Zipf-skewed requests need far smaller
    capacities.  ``dropped`` counts distinct rows not served (an
    out-of-range id drops once per distinct id).  Equal to the raw verb's
    result when nothing drops."""
    order, inv, wire_ids, first, run, firstpos = _dedup_plan(row_ids, valid)
    pulled, ok_p, dropped = pull_rows_sparse(global_shard, wire_ids,
                                             capacity=capacity, valid=first)
    safe = firstpos.clamp_min(0)
    rows = pulled[safe][inv]
    ok = (ok_p[safe] & (firstpos >= 0))[inv]
    if valid is not None:
        ok = ok & valid
    # rows are zeros wherever ok is False, as in the raw verb (a padding
    # position would otherwise echo its neighbouring run)
    return rows * _expand(ok, rows), ok, dropped


def push_rows_sparse_dedup(global_shard: torch.Tensor, row_ids: torch.Tensor,
                           deltas: torch.Tensor, *, capacity: int,
                           valid: torch.Tensor | None = None):
    """:func:`push_rows_sparse` with the duplicates of an id sharing ONE
    wire slot: the deltas of a row are summed locally first (in sorted-run
    order), then one slot per distinct id travels and is added once.  The
    raw verb adds them one by one, so floats may round otherwise; on
    integer-valued tables and deltas (counts) both are exact.  Returns
    ``(new_shard, dropped)``, ``dropped`` counting distinct rows."""
    order, inv, wire_ids, first, run, firstpos = _dedup_plan(row_ids, valid)
    d_sorted = deltas[order]
    if valid is not None:
        d_sorted = d_sorted * _expand(valid[order], d_sorted)
    # a call with no valid id has run == -1 everywhere; its (zeroed)
    # padding deltas go to run 0 and no slot is marked first, so it adds
    # nothing, as segment_sum's dropped -1 ids do in the reference
    run = run.clamp_min(0)
    summed = torch.zeros_like(d_sorted).index_add_(0, run, d_sorted)
    d_push = summed[run] * _expand(first, d_sorted)
    return push_rows_sparse(global_shard, wire_ids, d_push,
                            capacity=capacity, valid=first)
