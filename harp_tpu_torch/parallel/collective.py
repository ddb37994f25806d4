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
barrier         ``barrier``
==============  =======================================================

On a one-worker group each verb is the identity (up to the combiner's
dtype rules), and still records its bytes on the CommLedger.  Inputs are
never modified.  bool tensors reduce as int32 and come back bool (ADD is
any, MULTIPLY and MIN are all), the reference's contract.
"""

from __future__ import annotations

import enum
from typing import Any, Callable

import torch
import torch.distributed as dist

from harp_tpu_torch.parallel.mesh import num_workers, worker_id
from harp_tpu_torch.utils.telemetry import record_comm


def _tree_map(fn: Callable, tree: Any):
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, x) for x in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
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
    return _tree_map(comb.reduce, tree)


def allgather(tree: Any, *, tiled: bool = True):
    """Every worker's partitions on every worker — Harp ``allgather``.

    ``tiled=True`` concatenates along the leading dim; ``tiled=False``
    adds a leading worker axis."""
    record_comm("allgather", tree)

    def gather(x):
        stacked = _all_gather_stack(x)
        return stacked.reshape(-1, *x.shape[1:]) if tiled else stacked

    return _tree_map(gather, tree)


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

    return _tree_map(bcast, tree)


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

    return _tree_map(red, tree)


def push(tree: Any, op: "Combiner | str" = Combiner.ADD, *,
         scatter_dim: int = 0):
    """Local contributions → combined owner blocks — Harp ``push``.

    Every worker holds a full-size contribution; worker ``w`` receives the
    combined block ``w`` of ``scatter_dim``, which must divide evenly over
    the workers."""
    comb = _as_combiner(op)
    record_comm("push", tree, combiner=comb.value)

    def do_push(x):
        if x.dtype == torch.bool:
            return do_push(x.to(torch.int32)).to(torch.bool)
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
        # MAX/MIN have no reduce-scatter on every backend: reduce, then
        # keep our own block
        total = comb.reduce(x)
        return total.narrow(scatter_dim, worker_id() * block,
                            block).contiguous()

    return _tree_map(do_push, tree)


def pull(tree: Any, *, concat_dim: int = 0):
    """Owner blocks → the whole table on every worker — Harp ``pull``."""
    record_comm("pull", tree)

    def do_pull(x):
        return torch.cat(list(_all_gather_stack(x).unbind(0)), dim=concat_dim)

    return _tree_map(do_pull, tree)


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
