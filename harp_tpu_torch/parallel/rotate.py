"""Model-rotation pipeline — the port of ``harp_tpu.parallel.rotate``.

Harp's dymoro rotation: each worker computes on the model slice resident on
it, then the slice moves one worker along the ring, until every slice has
visited every worker.  SPMD by process, so the reference's ``lax.scan``
becomes a Python loop and ``lax.axis_index`` becomes ``worker_id()``.

``n_chunks > 1`` splits each worker's slice into chunks that alternate
compute and in-flight roles (a software double buffer): at step ``t`` the
chunk computed at ``t-1`` travels while the next queued chunk computes.
The schedule is the reference's exactly: chunk ``C-1`` starts in flight,
the received chunk joins the tail of the queue, and after ``C·n`` steps
the chunks are reassembled in home order.  Here the hop runs on the
compute stream; overlapping it on a side stream matters only across cards
and is later work (ROADMAP.md, Queue 1).

Each hop is :func:`harp_tpu_torch.parallel.collective.ring_hop`, recorded
on the CommLedger under the verb the reference records, ``reshard``.
Each step is a ``rotate.step`` span (attribute ``t``) holding its hop's
``rotate.hop`` span (:func:`harp_tpu_torch.utils.telemetry.span`).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from harp_tpu_torch.parallel.collective import RING_WIRES, ring_hop, tree_map
from harp_tpu_torch.parallel.mesh import num_workers, worker_id
from harp_tpu_torch.utils import telemetry

#: ring payload formats for the pipelined rotation
ROTATE_WIRES = tuple(RING_WIRES)


def _split_chunks(tree: Any, n_chunks: int, axis: int) -> list:
    """``n_chunks`` trees, chunk ``c`` holding every leaf's ``c``-th equal
    piece along ``axis``."""
    def size(x):
        if x.shape[axis] % n_chunks:
            raise ValueError(
                f"model slice dim {axis} of size {x.shape[axis]} does not "
                f"split into {n_chunks} equal rotation chunks")
        return x.shape[axis] // n_chunks

    tree_map(size, tree)
    return [tree_map(lambda x, c=c: x.narrow(axis, c * size(x), size(x))
                     .contiguous(), tree) for c in range(n_chunks)]


def _join_chunks(trees: list, axis: int) -> Any:
    """Inverse of :func:`_split_chunks`."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_join_chunks([t[i] for t in trees], axis)
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _join_chunks([t[k] for t in trees], axis) for k in first}
    return torch.cat(trees, dim=axis)


def _check_shift(shift: int, n: int, what: str) -> None:
    g = math.gcd(shift % n, n)
    if g != 1:
        raise ValueError(
            f"shift={shift} shares a factor with the ring size {n}: {what} "
            f"would visit only {n // g} of {n} slices")


def rotate_pipeline(step_fn: Callable[[Any, Any, int], Any], carry: Any,
                    model_slice: Any, *, n_steps: int | None = None,
                    shift: int = 1, n_chunks: int = 1, wire: str = "exact",
                    chunk_axis: int = 0):
    """Run one rotation epoch of ``carry, chunk = step_fn(carry, chunk, t)``.

    ``n_chunks=1``: each step computes on the whole resident slice, then
    rotates it ``shift`` workers on; ``n_steps`` (default: the ring size)
    steps.  With ``gcd(shift, n) == 1`` the default visits every slice on
    every worker once and leaves each slice back home; a shift sharing a
    factor with the ring size is refused unless ``n_steps`` is given.

    ``n_chunks=C > 1``: the slice splits into C equal chunks along
    ``chunk_axis`` and the epoch is ``C · n`` steps of the double buffer
    (module docstring); ``n_steps`` must be None.  Step ``t`` computes the
    chunk :func:`resident_chunk_index` names.

    ``wire``: ``"exact"``, ``"bf16"`` or ``"int8"`` — the ring payload
    (:func:`~harp_tpu_torch.parallel.collective.ring_hop`); a quantized
    wire rounds a chunk once per hop it travels.

    Returns ``(carry, model_slice)``, the chunks reassembled in home order.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if wire not in ROTATE_WIRES:
        raise ValueError(f"wire must be one of {ROTATE_WIRES}, got {wire!r}")
    n = num_workers()

    if n_chunks == 1:
        if n_steps is None:
            n_steps = n
            _check_shift(shift, n, "a full revolution")
        cur = model_slice
        for t in range(n_steps):
            with telemetry.span("rotate.step", t=t):
                carry, cur = step_fn(carry, cur, t)
                with telemetry.span("rotate.hop"):
                    cur = ring_hop(cur, shift, wire)
        return carry, cur

    if n_steps is not None:
        raise ValueError(
            "chunked mode runs the full revolution (n_chunks * ring size "
            "steps); n_steps must be None")
    _check_shift(shift, n, "the chunks")
    chunks = _split_chunks(model_slice, n_chunks, chunk_axis)
    # local chunks 0..C-2 queue up for compute; chunk C-1 starts in flight
    queue, inflight = chunks[:-1], chunks[-1]
    for t in range(n_chunks * n):
        with telemetry.span("rotate.step", t=t):
            with telemetry.span("rotate.hop"):
                received = ring_hop(inflight, shift, wire)
            carry, cur = step_fn(carry, queue.pop(0), t)
        # the received chunk joins the tail: it computes C-1 steps from
        # now, so every chunk computes once per C steps on each worker
        queue.append(received)
        inflight = cur
    # home chunk p (p < C-1) sits at queue position p; chunk C-1, computed
    # on its home worker at the last step, is the outgoing one
    return carry, _join_chunks(queue + [inflight], chunk_axis)


def resident_chunk_index(t: int, n_chunks: int, *, shift: int = 1) -> int:
    """Global index of the chunk this worker computes at step ``t`` of
    :func:`rotate_pipeline` (``n_chunks · n`` steps an epoch): with
    ``r = t % n_chunks``, worker ``w`` computes chunk
    ``n_chunks * ((w - (t // n_chunks + (r == n_chunks-1)) * shift) % n) + r``
    (the initial in-flight chunk is one hop ahead).  ``n_chunks=1`` is
    slice ``(w - t·shift) % n``."""
    n = num_workers()
    r = t % n_chunks
    ahead = 1 if (n_chunks > 1 and r == n_chunks - 1) else 0
    home = (worker_id() - (t // n_chunks + ahead) * shift) % n
    return n_chunks * home + r
