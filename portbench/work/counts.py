"""Frozen work counts: the operations and bytes each measured function
needs, taken from its shapes or its data, so that a count reads the same
whatever kernel implements the function.

Each count is the least the algorithm asks for: inputs read once, outputs
written once, and the operations of its equations.  A bound is the larger
of the operations at the precision's peak and the bytes at the HBM rate
(``peaks.json``), in seconds.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

#: the peak each stated precision runs at
PRECISION_PEAK = {"int8": "int8_ops", "bf16": "bf16_flops",
                  "f32": "f32_flops"}


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time: ops at the precision's peak or bytes at the HBM
    rate, whichever is larger."""
    return max(ops / PEAKS[PRECISION_PEAK[precision]],
               nbytes / PEAKS["hbm_bytes_s"])


def k1_chunk(rows: int, d: int, k: int) -> dict:
    """One streamed chunk's int8 partials (K1's function): 2·rows·d·k
    integer multiply-adds on the tensor cores; the int8 points and
    centroids read once, the centroid and feature scales and |c|² read
    once (f32), the [k, d] sums, the counts and the best-score sum written
    once (4 bytes each)."""
    ops = 2 * rows * d * k
    nbytes = rows * d + k * d + 4 * (2 * k + d) + 4 * (k * d + k + 1)
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes,
                                                            "int8")}


def lloyd_epoch(n: int, d: int, k: int, precision: str) -> dict:
    """One Lloyd epoch over n points: 2·n·d·k for the distances and n·d
    adds for the sums; the points read once at their stored width (1 byte
    for int8, 4 for f32), one assignment written a point (int32), the
    centroids read and written once (f32)."""
    ops = 2 * n * d * k + n * d
    width = 1 if precision == "int8" else 4
    nbytes = n * d * width + 4 * n + 2 * 4 * k * d
    return {"ops": ops, "bytes": nbytes,
            "bound_s": bound_s(ops, nbytes, precision)}


def mfsgd_epoch(ratings: int, users_touched: int, items_touched: int,
                rank: int) -> dict:
    """One epoch of rating-visit SGD at ``rank``, from the update's
    equations: a rating's dot product (2·rank), its two gradients
    ``e·h − λ·w`` and ``e·w − λ·h`` (3·rank each) and its two row updates
    ``w += lr·g`` (2·rank each): 12·rank a rating.  Bytes: each rating
    read once (user id, item id, value: 12 bytes), each touched W and H
    row read and written once (f32).  The route is f32 on the CUDA
    cores."""
    ops = 12 * rank * ratings
    nbytes = 12 * ratings + 2 * 4 * rank * (users_touched + items_touched)
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(ops, nbytes,
                                                            "f32")}
