"""The Harp collective verbs over ``torch.distributed`` — the port of
``harp_tpu.parallel.collective``.

Every verb takes a tensor or a tuple/list/dict nest of tensors (Harp verbs
take any ``Table``) and runs on this worker's view, called by every worker
of the group in the same order (SPMD by process):

==============  =======================================================
Harp verb       torch.distributed
==============  =======================================================
allreduce       ``all_reduce`` (ADD/MAX/MIN; AVG = sum / n;
                MULTIPLY = ``all_gather_into_tensor`` + prod)
allgather       ``all_gather_into_tensor``
broadcast       ``broadcast`` (moves bytes, so floats arrive bit-exact)
reduce          the allreduce combiner, then zeros off the root
push            ``reduce_scatter_tensor`` (ADD/AVG); MAX/MIN reduce,
                then keep this worker's block
pull            ``all_gather_into_tensor`` along ``concat_dim``
rotate          ``batch_isend_irecv``: one send to worker
                ``(i + shift) % n``, one receive from ``(i - shift) % n``
regroup         ``all_to_all_single`` on a contiguous staging buffer:
                block *j* of ``split_dim`` to worker *j*, the received
                blocks joined along ``concat_dim`` in source order
barrier         ``barrier``
allreduce_hier  two ``all_reduce`` stages over cached subgroups: within
                contiguous groups of ``group_size`` workers, then across
==============  =======================================================

The quantized twins (``allreduce_quantized``, ``push_quantized``,
``rotate_quantized``, ``regroup_quantized``) narrow every float leaf to a
bf16 or int8 wire, and ``reshard`` moves a tree between two
:class:`ShardSpec` layouts by the cheapest of those moves.

On a one-worker group each verb is the identity (up to the combiner's
dtype rules), and still records its bytes on the CommLedger.  Inputs are
never modified.  bool tensors reduce as int32 and come back bool (ADD is
any, MULTIPLY and MIN are all), the reference's contract.

``rotate`` and ``regroup`` carry autograd, as the reference's ``ppermute``
and ``all_to_all`` do: the backward of a rotate by ``s`` is a rotate by
``-s``, that of a regroup the regroup with ``split_dim`` and
``concat_dim`` swapped.  The backward moves are not recorded again.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from harp_tpu_torch.parallel.mesh import num_workers, worker_id
from harp_tpu_torch.utils.telemetry import record_comm, tree_leaves


def tree_map(fn: Callable, tree: Any):
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        # leaves are visited in tree_leaves' (sorted-key) order, so ``fn``
        # may consume per-leaf state made from tree_leaves
        done = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return fn(tree)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    y = x.clone()
    if num_workers() > 1:
        dist.all_reduce(y, op)
    return y


# the single-tensor collectives were renamed (``*_single``) in newer torch
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _all_gather_stack(x: torch.Tensor) -> torch.Tensor:
    """[num_workers, *x.shape]: every worker's ``x``, in rank order."""
    nw = num_workers()
    if nw == 1:
        return x.unsqueeze(0).clone()
    wire = (x.to(torch.uint8) if x.dtype == torch.bool else x).reshape(1, -1)
    out = torch.empty((nw, wire.shape[1]), dtype=wire.dtype, device=x.device)
    _ALL_GATHER(out, wire.contiguous())
    return out.reshape(nw, *x.shape).to(x.dtype)


class Combiner(enum.Enum):
    """Reduction semantics — Harp's ``PartitionCombiner``."""

    ADD = "add"
    MAX = "max"
    MIN = "min"
    AVG = "avg"
    MULTIPLY = "multiply"

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Combine ``x`` over the group; every worker gets the result."""
        if x.dtype == torch.bool:
            return self.reduce(x.to(torch.int32)).to(torch.bool)
        if self is Combiner.MULTIPLY:
            # no product reduction on every backend; gather and multiply
            return torch.prod(_all_gather_stack(x), dim=0).to(x.dtype)
        if self is Combiner.AVG:
            # true division: integer inputs average to float32, as pmean does
            return _all_reduce(x, dist.ReduceOp.SUM) / num_workers()
        op = {Combiner.ADD: dist.ReduceOp.SUM, Combiner.MAX: dist.ReduceOp.MAX,
              Combiner.MIN: dist.ReduceOp.MIN}[self]
        return _all_reduce(x, op)


def _as_combiner(op: "Combiner | str") -> Combiner:
    return op if isinstance(op, Combiner) else Combiner(str(op).lower())


def allreduce(tree: Any, op: "Combiner | str" = Combiner.ADD):
    """All workers end with the combined value — Harp ``allreduce``."""
    comb = _as_combiner(op)
    record_comm("allreduce", tree, combiner=comb.value)
    return tree_map(comb.reduce, tree)


def allgather(tree: Any, *, tiled: bool = True):
    """Every worker's partitions on every worker — Harp ``allgather``.

    ``tiled=True`` concatenates along the leading dim; ``tiled=False``
    adds a leading worker axis."""
    record_comm("allgather", tree)

    def gather(x):
        stacked = _all_gather_stack(x)
        return stacked.reshape(-1, *x.shape[1:]) if tiled else stacked

    return tree_map(gather, tree)


def broadcast(tree: Any, root: int = 0):
    """Every worker receives root's value — Harp ``broadcast``.  The bytes
    move unchanged, so floats (subnormals and NaN payloads included) arrive
    bit-exact, and non-root values are discarded whatever they hold."""
    record_comm("broadcast", tree)

    def bcast(x):
        y = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone()
        if num_workers() > 1:
            dist.broadcast(y, src=root)
        return y.to(x.dtype)

    return tree_map(bcast, tree)


def reduce(tree: Any, op: "Combiner | str" = Combiner.ADD, root: int = 0):
    """Combine onto root; the other workers get zeros — Harp ``reduce``."""
    comb = _as_combiner(op)
    record_comm("reduce", tree, combiner=comb.value)

    def red(x):
        y = x.to(torch.int32) if x.dtype == torch.bool else x
        total = comb.reduce(y)
        if worker_id() != root:
            total = torch.zeros_like(total)
        return total.to(x.dtype)

    return tree_map(red, tree)


def _push_leaf(x: torch.Tensor, comb: Combiner, scatter_dim: int
               ) -> torch.Tensor:
    """This worker's combined block ``worker_id()`` of ``scatter_dim``."""
    if x.dtype == torch.bool:
        return _push_leaf(x.to(torch.int32), comb, scatter_dim).to(torch.bool)
    nw, size = num_workers(), x.shape[scatter_dim]
    if size % nw:
        raise ValueError(
            f"push: scatter dimension size {size} must be divisible by "
            f"the worker count {nw}")
    block = size // nw
    if comb in (Combiner.ADD, Combiner.AVG):
        y = x.movedim(scatter_dim, 0).contiguous()
        if nw == 1:
            out = y.clone()
        else:
            out = torch.empty((block, *y.shape[1:]), dtype=y.dtype,
                              device=y.device)
            _REDUCE_SCATTER(out, y, dist.ReduceOp.SUM)
        out = out.movedim(0, scatter_dim).contiguous()
        return out / nw if comb is Combiner.AVG else out
    # MAX/MIN have no reduce-scatter on every backend: reduce, then keep
    # our own block
    total = comb.reduce(x)
    return total.narrow(scatter_dim, worker_id() * block, block).contiguous()


def push(tree: Any, op: "Combiner | str" = Combiner.ADD, *,
         scatter_dim: int = 0):
    """Local contributions → combined owner blocks — Harp ``push``.

    Every worker holds a full-size contribution; worker ``w`` receives the
    combined block ``w`` of ``scatter_dim``, which must divide evenly over
    the workers."""
    comb = _as_combiner(op)
    record_comm("push", tree, combiner=comb.value)
    return tree_map(lambda x: _push_leaf(x, comb, scatter_dim), tree)


def pull(tree: Any, *, concat_dim: int = 0):
    """Owner blocks → the whole table on every worker — Harp ``pull``."""
    record_comm("pull", tree)

    def do_pull(x):
        return torch.cat(list(_all_gather_stack(x).unbind(0)), dim=concat_dim)

    return tree_map(do_pull, tree)


def barrier() -> torch.Tensor:
    """Synchronize all workers — Harp ``barrier``.  Returns int32 zero, as
    the reference's tiny psum does."""
    z = torch.zeros((), dtype=torch.int32)
    record_comm("barrier", z)
    if num_workers() > 1:
        dist.barrier()
    return z


def quantize_to_int8(x: torch.Tensor, amax) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Symmetric int8 quantization against a precomputed |max|:
    ``(q, scale)`` with ``scale = max(amax, 1e-30) / 127`` and
    ``x ≈ q * scale`` (``amax`` broadcasts)."""
    amax = torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _ring_move(x: torch.Tensor, shift: int) -> torch.Tensor:
    """This worker's ``x`` goes to worker ``(i + shift) % n``; returns what
    worker ``(i - shift) % n`` sent.  A shift that is a multiple of the
    ring size (one worker included) returns a copy."""
    nw = num_workers()
    if shift % nw == 0:
        return x.clone()
    me = worker_id()
    send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    recv = torch.empty_like(send)
    # both sides are posted before any wait: a blocking send-first pair
    # deadlocks gloo, whose sends complete only when received
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, (me + shift) % nw),
        dist.P2POp(dist.irecv, recv, (me - shift) % nw)])
    for w in works:
        w.wait()
    return recv.to(x.dtype)


class _RingMoveFn(torch.autograd.Function):
    """:func:`_ring_move` with its adjoint: the gradient travels back."""

    @staticmethod
    def forward(ctx, x, shift):
        ctx.shift = shift
        return _ring_move(x, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_move(g, -ctx.shift), None


def rotate(tree: Any, shift: int = 1):
    """Ring-shift partitions: worker *i*'s data goes to worker
    *(i + shift) % n* — Harp ``rotate``, the model-rotation primitive.
    Exact: the bytes move unchanged; a gradient moves back by ``-shift``."""
    record_comm("rotate", tree)
    return tree_map(lambda x: _RingMoveFn.apply(x, shift), tree)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int
                ) -> torch.Tensor:
    """The tiled all-to-all of one tensor: block *j* of ``split_dim`` goes
    to worker *j*; the blocks received are joined along ``concat_dim`` in
    source order.  One worker: a copy."""
    nw = num_workers()
    size = x.shape[split_dim]
    if size % nw:
        raise ValueError(
            f"regroup: split dimension {split_dim} of size {size} must be "
            f"divisible by the worker count {nw}")
    if nw == 1:
        return x.clone()
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    # stage [nw, *block]: block j, contiguous, at index j
    stage = torch.stack(wire.chunk(nw, dim=split_dim)).contiguous()
    recv = torch.empty_like(stage)
    dist.all_to_all_single(recv, stage)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim).to(x.dtype)


class _AllToAllFn(torch.autograd.Function):
    """:func:`_all_to_all` with its adjoint, the swapped regroup."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim):
        ctx.dims = (split_dim, concat_dim)
        return _all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim), None, None


def regroup(tree: Any, *, split_dim: int = 0, concat_dim: int | None = None):
    """Repartition by owner — Harp ``regroup`` (the shuffle equivalent).

    Each leaf's ``split_dim`` axis is laid out in destination order: block
    *j* goes to worker *j* (Harp's default ``Partitioner``,
    ``partition_id % num_workers``).  The blocks a worker receives are
    concatenated along ``concat_dim`` (default ``split_dim``) in source
    order: the reference's tiled ``all_to_all``.  ``split_dim`` must divide
    evenly over the workers.  A gradient returns by the swapped regroup."""
    cd = split_dim if concat_dim is None else concat_dim
    record_comm("regroup", tree)
    return tree_map(lambda x: _AllToAllFn.apply(x, split_dim, cd), tree)


_WIRE_DTYPES = (torch.bfloat16, torch.int8)


def _check_wire_dtype(wire_dtype) -> None:
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire_dtype {wire_dtype!r} "
                         "(use torch.bfloat16 or torch.int8)")


def _shared_amaxes(leaves: list):
    """An iterator over the float leaves' |max|, shared by the workers: all
    of them in ONE stacked MAX allreduce, so sender and receiver quantize
    with the same scale and no scale rides the wire; None without float
    leaves."""
    floats = [x for x in leaves if x.is_floating_point()]
    if not floats:
        return None
    amax = torch.stack([x.abs().amax().to(torch.float32) for x in floats])
    return iter(Combiner.MAX.reduce(amax).unbind(0))


def _narrow_move(x: torch.Tensor, wire_dtype, move, amax=None):
    """``move`` of one leaf on a wire (``None`` exact, ``torch.bfloat16`` or
    ``torch.int8``), rounding once: bf16 is one cast each way, int8
    quantizes against ``amax`` and dequantizes.  Non-float leaves move
    exact.  The reference divides in f32 whatever the leaf's float type,
    so the leaf is widened first."""
    if wire_dtype is None or not x.is_floating_point():
        return move(x)
    if wire_dtype == torch.bfloat16:
        return move(x.to(torch.bfloat16)).to(x.dtype)
    q, scale = quantize_to_int8(x.to(torch.float32), amax)
    return (move(q).to(torch.float32) * scale).to(x.dtype)


def _quantized_move(tree: Any, wire_dtype, move) -> Any:
    """``move`` on a wire (``None`` exact), rounding once per call: bf16 is
    one cast each way; int8 quantizes every float leaf against a
    worker-shared |max| (:func:`_shared_amaxes`), error at most ``|max| /
    254`` an element.  Non-float leaves move exact."""
    amaxes = (_shared_amaxes(tree_leaves(tree)) if wire_dtype == torch.int8
              else None)

    def one(x):
        amax = next(amaxes) if amaxes is not None and \
            x.is_floating_point() else None
        return _narrow_move(x, wire_dtype, move, amax)

    return tree_map(one, tree)


def _quantized_reduce(tree: Any, wire_dtype: torch.dtype, verb: str,
                      reduce_float, reduce_exact) -> Any:
    """The engine of :func:`allreduce_quantized` and :func:`push_quantized`:
    bf16 casts, reduces and accumulates in bf16 (the error grows with the
    worker count); int8 quantizes each float leaf against the shared
    |max| and reduces the int8 values in exact int32, so each worker adds
    at most ``scale / 2`` an element.  Non-float leaves take
    ``reduce_exact``.  Recorded once at the wire's width (ADD only)."""
    _check_wire_dtype(wire_dtype)
    record_comm(verb, tree, combiner="add", wire_dtype=wire_dtype)
    amaxes = (_shared_amaxes(tree_leaves(tree)) if wire_dtype == torch.int8
              else None)

    def one(x):
        if not x.is_floating_point():
            return reduce_exact(x)
        if wire_dtype == torch.bfloat16:
            return reduce_float(x.to(torch.bfloat16)).to(x.dtype)
        q, scale = quantize_to_int8(x.to(torch.float32), next(amaxes))
        total = reduce_float(q.to(torch.int32))
        return (total.to(torch.float32) * scale).to(x.dtype)

    return tree_map(one, tree)


def allreduce_quantized(tree: Any, *,
                        wire_dtype: torch.dtype = torch.bfloat16):
    """ADD-:func:`allreduce` on a quantized wire (``torch.bfloat16`` or
    ``torch.int8``): half or a quarter of the bytes for bandwidth-bound
    gradient sums.  bf16 reduces in bf16 (not one rounding: the error grows
    with the worker count); int8 rounds each contribution once against a
    worker-shared scale (``max / 127``) and sums exactly in int32.  Int
    leaves are exact and bool stays bool (ADD is any)."""
    return _quantized_reduce(
        tree, wire_dtype, "allreduce_quantized",
        lambda x: _all_reduce(x, dist.ReduceOp.SUM), Combiner.ADD.reduce)


def push_quantized(tree: Any, *, wire_dtype: torch.dtype = torch.bfloat16,
                   scatter_dim: int = 0):
    """ADD-:func:`push` (reduce-scatter) on a quantized wire, with
    :func:`allreduce_quantized`'s rules per wire.  ADD only: divide by the
    worker count for AVG."""
    def scatter(x):
        return _push_leaf(x, Combiner.ADD, scatter_dim)

    return _quantized_reduce(tree, wire_dtype, "push_quantized", scatter,
                             scatter)


def rotate_quantized(tree: Any, shift: int = 1, *,
                     wire_dtype: torch.dtype = torch.bfloat16):
    """:func:`rotate` on a quantized wire (``torch.bfloat16`` or
    ``torch.int8``): half or a quarter of the bytes per hop, one rounding
    per call whatever the ring size — on one worker too."""
    _check_wire_dtype(wire_dtype)
    record_comm("rotate_quantized", tree, wire_dtype=wire_dtype)
    return _quantized_move(tree, wire_dtype, lambda x: _ring_move(x, shift))


def regroup_quantized(tree: Any, *, wire_dtype: torch.dtype = torch.bfloat16,
                      split_dim: int = 0, concat_dim: int | None = None):
    """:func:`regroup` on a quantized wire, with :func:`rotate_quantized`'s
    one-rounding rule: the shuffle moves data and never accumulates."""
    cd = split_dim if concat_dim is None else concat_dim
    _check_wire_dtype(wire_dtype)
    record_comm("regroup_quantized", tree, wire_dtype=wire_dtype)
    return _quantized_move(tree, wire_dtype,
                           lambda x: _all_to_all(x, split_dim, cd))


#: ring payload formats of :func:`ring_hop` (and of the rotation pipeline)
RING_WIRES = {"exact": None, "bf16": torch.bfloat16, "int8": torch.int8}


def ring_hop(tree: Any, shift: int = 1, wire: str = "exact"):
    """One hop of the rotation pipeline: the reference's
    ``reshard(blocked(0), blocked(0, shift), wire=...)``.  A shift that is
    a multiple of the ring size (one worker included) moves nothing: the
    tree comes back as it is, unrounded and unrecorded.  Otherwise the hop
    is recorded under the verb ``reshard`` at its wire's width and moves
    as :func:`rotate` (exact) or :func:`rotate_quantized` does."""
    if wire not in RING_WIRES:
        raise ValueError(f"wire must be one of {tuple(RING_WIRES)}, "
                         f"got {wire!r}")
    if shift % num_workers() == 0:
        return tree
    wd = RING_WIRES[wire]
    record_comm("reshard", tree, wire_dtype=wd)
    return _quantized_move(tree, wd, lambda x: _ring_move(x, shift))


# ---- reshard: moves between sharding layouts --------------------------------

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One leaf's layout over the worker ring.

    ``dim=None``: replicated, every worker holds the whole array.  ``dim=d``:
    split along ``d`` into ``num_workers`` equal blocks; with ``shift=s``
    worker ``w`` holds global block ``(w - s) % num_workers``."""

    dim: int | None = 0
    shift: int = 0

    def __post_init__(self):
        if self.dim is None and self.shift:
            raise ValueError("a replicated ShardSpec has no ring shift")

    @classmethod
    def replicated(cls) -> "ShardSpec":
        return cls(dim=None)

    @classmethod
    def blocked(cls, dim: int = 0, shift: int = 0) -> "ShardSpec":
        return cls(dim=dim, shift=shift)


#: reshard wire formats (the ring hop's vocabulary)
RESHARD_WIRES = tuple(RING_WIRES)


def _reshard_plan(src: ShardSpec, dst: ShardSpec, n: int) -> tuple:
    """(kind, *params) for one leaf, the reference's decision table.  On one
    worker a blocked → replicated move still plans as "gather"."""
    s_src = 0 if src.dim is None else src.shift % n
    s_dst = 0 if dst.dim is None else dst.shift % n
    if src.dim is None and dst.dim is None:
        return ("identity",)
    if src.dim == dst.dim and s_src == s_dst:
        return ("identity",)
    if src.dim is None:
        return ("slice", dst.dim, s_dst)
    if dst.dim is None:
        return ("gather", src.dim, s_src)
    if src.dim == dst.dim:
        return ("rotate", (s_dst - s_src) % n)
    if s_src == 0 and s_dst == 0:
        return ("a2a", src.dim, dst.dim)
    return ("gather_slice", src.dim, s_src, dst.dim, s_dst)


def _spec_leaves(tree: Any, spec) -> list:
    if isinstance(spec, ShardSpec):
        return [spec] * len(tree_leaves(tree))
    return tree_leaves(spec)


def _leaf_paths(tree: Any, prefix: tuple = ()) -> list:
    """(key path, leaf) pairs in :func:`tree_leaves` order: dict keys and
    sequence indices, as the reference names a leaf's path."""
    if isinstance(tree, (tuple, list)):
        return [p for i, x in enumerate(tree)
                for p in _leaf_paths(x, prefix + (str(i),))]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], prefix + (str(k),))]
    return [(prefix, tree)]


def match_reshard_rules(rules, tree):
    """Regex rules → a nest of :class:`ShardSpec` shaped like ``tree``.

    ``rules``: ordered ``[(regex, ShardSpec), ...]``; each leaf's
    '/'-joined key path (dict keys, sequence indices) is matched with
    ``re.search`` and the first hit wins.  A scalar leaf (rank 0 or one
    element) is replicated whatever the rules say.  An unmatched leaf
    raises: a table left unsharded by accident is what the rules exist to
    prevent."""
    def spec_for(path, leaf) -> ShardSpec:
        shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ShardSpec.replicated()
        name = "/".join(path)
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                return spec
        raise ValueError(f"no reshard rule matches leaf {name!r}")

    specs = iter([spec_for(p, x) for p, x in _leaf_paths(tree)])
    return tree_map(lambda _: next(specs), tree)


def _block_size(x: torch.Tensor, dim: int, n: int, what: str) -> int:
    if dim >= x.dim():
        raise ValueError(
            f"reshard: {what} dim {dim} out of range for rank-{x.dim()} leaf")
    if x.shape[dim] % n:
        raise ValueError(
            f"reshard: leaf dim {dim} of size {x.shape[dim]} does not "
            f"split into {n} worker blocks")
    return x.shape[dim] // n


def _own_block(x: torch.Tensor, dim: int, shift: int, n: int) -> torch.Tensor:
    """Global block ``(worker_id() - shift) % n`` of a whole ``x`` along
    ``dim``: this worker's block of ``blocked(dim, shift)``."""
    bs = _block_size(x, dim, n, "dst")
    return x.narrow(dim, ((worker_id() - shift) % n) * bs, bs).clone()


def _gather_along(x: torch.Tensor, dim: int, shift: int) -> torch.Tensor:
    """Every worker's block of ``x``, joined along ``dim`` in rank order and
    rolled back by ``shift`` blocks: the whole array on every worker."""
    if dim >= x.dim():
        raise ValueError(f"reshard: src dim {dim} out of range for "
                         f"rank-{x.dim()} leaf")
    full = torch.cat(list(_all_gather_stack(x).unbind(0)), dim=dim)
    if shift:
        full = torch.roll(full, -shift * x.shape[dim], dims=dim)
    return full


def _record_rotate_dim(x: torch.Tensor, src: ShardSpec) -> int:
    """The dim a chunked rotation splits: the spec's sharded dim; a leaf of
    lower rank cannot chunk."""
    dim = 0 if src.dim is None else src.dim
    if dim >= x.dim():
        raise ValueError(
            f"reshard: cannot chunk a rank-{x.dim()} leaf along dim {dim}")
    return dim


def _chunked_ring_move(x: torch.Tensor, dim: int, n_chunks: int, move):
    """A ring move in ``n_chunks`` hops: ``x`` split along ``dim`` into equal
    sub-chunks, each moved in turn and joined again.  The bytes are the
    one-hop move's, so the result is bit-equal to it."""
    if x.shape[dim] % n_chunks:
        raise ValueError(
            f"reshard: n_chunks={n_chunks} does not divide leaf dim "
            f"{dim} of size {x.shape[dim]}")
    return torch.cat([move(c) for c in x.chunk(n_chunks, dim)], dim)


def _moves_bytes(plan: tuple) -> bool:
    return plan[0] not in ("identity", "slice")


def reshard(tree: Any, src_spec, dst_spec, *, wire: str = "exact",
            n_chunks: int = 1):
    """Move a tree from one :class:`ShardSpec` layout to another.

    ``src_spec`` / ``dst_spec``: one spec for every leaf, or a matching nest
    of specs (:func:`match_reshard_rules`).  Each leaf takes the cheapest
    legal move, the reference's decision table:

    ==============================  =====================================
    (src, dst)                      lowering
    ==============================  =====================================
    equal layouts                   identity (no wire)
    replicated → blocked            local slice (no wire)
    same dim, shifts differ         ring rotation (``_ring_move``)
    blocked dim a → blocked dim b   one all-to-all (both shifts 0)
    blocked → replicated            all-gather, then a roll for a shift
    anything else                   all-gather, then the local slice
    ==============================  =====================================

    ``wire`` ("exact" | "bf16" | "int8") narrows every moving floating
    leaf, labels and masks included, with one rounding per call, on one
    worker too; the int8 wire quantizes against a |max| shared by the
    workers (one stacked MAX allreduce for all moving leaves).
    ``n_chunks > 1`` moves a ring rotation in that many sub-chunk hops
    (rotations only; the sharded dim must split evenly).  Every lowering
    on the exact wire is bit-equal to :func:`reshard_reference`.  The
    moving leaves are recorded once under the verb ``reshard`` at the
    wire's width; a chunked rotation records one sub-chunk, the payload of
    one hop, as the reference does."""
    if wire not in RESHARD_WIRES:
        raise ValueError(f"wire must be one of {RESHARD_WIRES}, got {wire!r}")
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    n = num_workers()
    wd = RING_WIRES[wire]
    leaves = tree_leaves(tree)
    src_l, dst_l = _spec_leaves(tree, src_spec), _spec_leaves(tree, dst_spec)
    if not len(leaves) == len(src_l) == len(dst_l):
        raise ValueError("reshard: spec trees do not match the data tree")
    plans = [_reshard_plan(s, d, n) for s, d in zip(src_l, dst_l)]
    moving = []
    for x, src, plan in zip(leaves, src_l, plans):
        if not _moves_bytes(plan):
            continue
        if n_chunks > 1 and plan[0] != "rotate":
            raise ValueError("reshard: n_chunks applies to ring rotations "
                             f"only (this leaf lowers to {plan[0]!r})")
        if n_chunks > 1:
            dim = _record_rotate_dim(x, src)
            shape = list(x.shape)
            shape[dim] //= n_chunks
            x = torch.empty(shape, dtype=x.dtype, device="meta")
        moving.append(x)
    if moving:
        record_comm("reshard", tuple(moving), wire_dtype=wd)
    amaxes = None
    if wire == "int8":
        amaxes = _shared_amaxes([x for x, p in zip(leaves, plans)
                                 if _moves_bytes(p)])

    out = []
    for x, src, plan in zip(leaves, src_l, plans):
        kind = plan[0]
        if kind == "identity":
            out.append(x)
            continue
        if kind == "slice":
            out.append(_own_block(x, plan[1], plan[2], n))
            continue
        amax = next(amaxes) if amaxes is not None and \
            x.is_floating_point() else None
        if kind == "rotate":
            def move(y, delta=plan[1], src=src):
                def hop(c):
                    return _ring_move(c, delta)
                if n_chunks > 1:
                    return _chunked_ring_move(
                        y, _record_rotate_dim(y, src), n_chunks, hop)
                return hop(y)
        elif kind == "a2a":
            _, sd, dd = plan
            _block_size(x, dd, n, "dst")

            def move(y, sd=sd, dd=dd):
                return _all_to_all(y, dd, sd)
        else:  # gather / gather_slice: replicate, roll, maybe slice
            def move(y, dim=plan[1], s=plan[2]):
                return _gather_along(y, dim, s)
        y = _narrow_move(x, wd, move, amax)
        if kind == "gather_slice":
            y = _own_block(y, plan[3], plan[4], n)
        out.append(y)
    moved = iter(out)
    return tree_map(lambda _: next(moved), tree)


def reshard_reference(tree: Any, src_spec, dst_spec):
    """The naive lowering every :func:`reshard` path reproduces bit for bit
    on the exact wire: replicate (all-gather and roll), then slice the
    destination block.  A test oracle: unrecorded, and it always moves the
    whole array."""
    n = num_workers()
    src_l = iter(_spec_leaves(tree, src_spec))
    dst_l = iter(_spec_leaves(tree, dst_spec))

    def one(x):
        src, dst = next(src_l), next(dst_l)
        full = x
        if src.dim is not None:
            full = _gather_along(x, src.dim, src.shift % n)
        if dst.dim is None:
            return full.clone() if full is x else full
        return _own_block(full, dst.dim, dst.shift, n)

    return tree_map(one, tree)


# ---- allreduce_hier: a two-stage ADD over subgroups -------------------------

#: the subgroups of the current world, by group size:
#: {"world": the default group they belong to, "groups": {g: (intra, inter)}}
_HIER = {"world": None, "groups": {}}


def _hier_groups(group_size: int) -> tuple:
    """(intra, inter) process groups of this worker: contiguous groups of
    ``group_size`` workers, and the groups of their equal ranks.  ``None``
    stands for the default group and ``False`` for a stage whose groups
    are single workers (nothing to reduce).  Creating a group is a
    collective of every worker, so the groups are made once per world and
    size, every worker creating every group in the same order."""
    n, me = num_workers(), worker_id()
    if group_size == 1:
        return False, None
    if group_size == n:
        return None, False
    if _HIER["world"] is not dist.group.WORLD:
        _HIER["world"], _HIER["groups"] = dist.group.WORLD, {}
    if group_size not in _HIER["groups"]:
        mine = []
        for ranks in ([list(range(g * group_size, (g + 1) * group_size))
                       for g in range(n // group_size)],
                      [list(range(i, n, group_size))
                       for i in range(group_size)]):
            made = [dist.new_group(r) for r in ranks]
            mine.append(next(g for g, r in zip(made, ranks) if me in r))
        _HIER["groups"][group_size] = tuple(mine)
    return _HIER["groups"][group_size]


def allreduce_hier(tree: Any, *, group_size: int | None = None):
    """ADD-allreduce in two stages — the reference's ``hier_psum`` schedule:
    stage 1 sums within contiguous groups of ``group_size`` workers (the
    fast link class), stage 2 sums the group totals across groups (the slow
    one), so the payload crosses the slow links once per group.  On a flat
    ring it moves about twice the one-shot allreduce's bytes.

    ADD only; bool reduces through int32 (any); ints are exact and floats
    reassociate across the stages.  ``group_size`` must divide the worker
    count; ``None`` picks the largest divisor ≤ √n.  Both stages are
    recorded, a degenerate split (1 or n) included."""
    n = num_workers()
    if group_size is None:
        group_size = next(g for g in range(int(n ** 0.5), 0, -1)
                          if n % g == 0)
    if group_size < 1 or n % group_size:
        raise ValueError(
            f"group_size={group_size} must divide the axis size {n}")
    record_comm("allreduce_hier", (tree, tree), combiner="add")
    stages = _hier_groups(group_size) if n > 1 else (False, False)

    def two_stage(x):
        y = (x.to(torch.int32) if x.dtype == torch.bool else x).clone()
        for group in stages:
            if group is not False:
                dist.all_reduce(y, dist.ReduceOp.SUM, group=group)
        return y.to(x.dtype)

    return tree_map(two_stage, tree)


def host_op(mesh, verb, **verb_kwargs):
    """``verb`` as a callable on this worker's block: the argument (a tensor,
    a numpy array or a nest of them) moves to ``mesh.device`` and every
    worker of the group calls the result together.

    The reference compiles a verb into a program over a global array
    sharded on its mesh; with one process a worker there is no global
    array, so each process passes its own block and gets its own result."""
    def op(x):
        return verb(tree_map(mesh.replicated, x), **verb_kwargs)

    return op
