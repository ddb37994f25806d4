"""Fused KMeans partials: the port of ``harp_tpu.ops.kmeans_kernel``.

One Lloyd iteration's per-worker partials in a single pass over the points:
scores, argmin (lowest index wins ties), one-hot sums, counts, and the sum
of best scores.  Two kernels, each a CUDA C++ source for ``sm_90a`` beside
its wrapper and its plain PyTorch version, and a third that makes K1's
streamed input:

====  ==============================  ====================================
K1    :func:`kmeans_partials_int8`    ``csrc/kmeans_partials_int8.cu``;
                                      replaces the TPU kernel
                                      ``kmeans_partials_int8``
K2    :func:`kmeans_partials`         ``csrc/kmeans_partials.cu``;
                                      replaces the TPU kernel
                                      ``kmeans_partials``
—     :func:`quantize_rows_int8`      ``csrc/kmeans_quantize_int8.cu``;
                                      replaces no TPU kernel: an f32
                                      chunk on the card to its int8 chunk
                                      and its sum of |x|^2, in one pass
====  ==============================  ====================================

K1 and K2 share ``csrc/kmeans_tiles.cuh``.  Each source's head note gives
the kernel's bound on the card and what its design does about it.  K1's and
K2's library plans a launch per shape and card (:func:`plan`): fused (the
[k, d] sums in shared memory, k = 100 at d = 300) or two-pass (assignments,
then sums by centroid range, k = 1000); :func:`workspace` sizes the buffers
the wrapper allocates for it.  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel (on the current
stream) or raises — there is no fallback.  :data:`LAUNCHES` counts wrapper
calls that launched, so a run can show that its main path went through the
kernels.

Unlike the TPU kernels, these take any ``n`` (the ragged tile is masked),
any ``k`` (centroid tiles loop) and any ``d``; the TPU-only gates (VMEM
budget, tile divides n) have no counterpart.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from harp_tpu_torch.ops import build

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"kmeans_partials_int8": 0, "kmeans_partials": 0,
            "kmeans_quantize_int8": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kmeans_partials_int8": {
        "kmeans_partials_int8_plan": [_I, _I, _I, ctypes.POINTER(_I),
                                      ctypes.POINTER(_P)],
        "kmeans_partials_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                 _P, _P, _P, _P, _P],
    },
    "kmeans_partials": {
        "kmeans_partials_plan": [_I, _I, _I, _I, ctypes.POINTER(_I),
                                 ctypes.POINTER(_P)],
        "kmeans_partials": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                            _P, _P, _P, _P],
    },
    "kmeans_quantize_int8": {
        "kmeans_quantize_int8_plan": [_I, _I, _I, ctypes.POINTER(_I)],
        "kmeans_quantize_int8": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P],
    },
}
_BOUND: dict[str, ctypes.CDLL] = {}
_PLANS: dict[tuple, "Plan"] = {}
#: per (card index, n, d, vec): the fused quantize pass's launch plan
_QPLANS: dict[tuple, tuple[int, ...]] = {}
#: per (card index, stream, d): the fused pass's [d] column sums and its
#: blocks' ticket counter, d + 1 int64 words that every call leaves at zero
_ACC: dict[tuple[int, int, int], torch.Tensor] = {}
#: library name -> the kernel's registry name (the fit gates' rows)
_REGISTRY_NAMES = {"kmeans_partials_int8": "kmeans.partials_int8",
                   "kmeans_partials": "kmeans.partials"}


class Plan(NamedTuple):
    """A kernel's launch plan for one (n, d, k) on one card, as its
    ``*_plan`` entry point gives it: the fields the wrapper sizes its
    buffers by, and the library's own plan that every launch of the shape
    is given."""

    fused: bool     # one main launch (sums in shared memory), else main +
                    # range launches (assignments, then sums by range)
    grid: int       # main-kernel blocks: one partial of the best sum each
    k_pad: int      # centroids in the packed layout (a multiple of 64)
    sb: int         # packed centroid row stride in bytes
    tile_rows: int  # points a main-kernel tile
    ranges: int     # centroid ranges of the range launch (two-pass only)
    stripes: int    # point stripes of the range launch (two-pass only)
    smem: int = 0   # the main kernel's dynamic shared memory a block
    handle: int = 0  # the library's plan (kept for the process's life)


def workspace(plan: Plan, n: int, d: int, k: int, f32_sums: bool) -> dict:
    """The buffers one launch takes besides its outputs, name -> (shape,
    dtype): the packed centroids and the per-point assignments (two-pass
    only; one element each when fused), the per-block partials of the best sum and, for K2
    (``f32_sums``), the [slabs, k, d] f32 sums that reduce_kernel adds in
    order (one slab per main block when fused, per stripe otherwise)."""
    two = not plan.fused
    ws = {"cen_pack": ((plan.k_pad * plan.sb if two else 1,), torch.uint8),
          "c2_pack": ((plan.k_pad if two else 1,), torch.float32),
          "assign": ((n if two else 1,), torch.int32),
          "partial": ((plan.grid,), torch.float32)}
    if f32_sums:
        ws["slabs"] = ((plan.grid if plan.fused else plan.stripes, k, d),
                       torch.float32)
    else:
        ws["cs_pack"] = ((plan.k_pad if two else 1,), torch.float32)
    return ws


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib(name: str) -> ctypes.CDLL:
    if name not in _BOUND:
        _BOUND[name] = build.bind(name, _SIGNATURES[name])
    return _BOUND[name]


def launch_bytes(p: Plan, n: int, d: int, k: int, f32_sums: bool) -> int:
    """Device bytes one launch allocates: its :func:`workspace` and its
    outputs (the [k, d] sums, int32 for K1 or f32 for K2, and the counts)."""
    ws = sum(math.prod(shape) * dt.itemsize
             for shape, dt in workspace(p, n, d, k, f32_sums).values())
    return ws + 4 * (k * d + k)


def plan(name: str, dev: torch.device, n: int, d: int, k: int,
         pts_bf16: bool = False) -> Plan:
    """The card's launch plan for kernel ``name`` at (n, d, k), made by the
    library once per shape and card; its launches reuse it.

    Before the plan is kept, the fit gates hold it to the card: the main
    kernel's shared memory a block to the card's opt-in
    (``memrec.require_smem_fit``) and a launch's buffers to the free
    device memory, read once here (``memrec.require_hbm_fit``).  A refused
    shape raises ``MemoryError`` and launches nothing."""
    from harp_tpu_torch.utils import memrec

    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (name, index, n, d, k, pts_bf16)
    if key not in _PLANS:
        lib = _lib(name)
        out, handle = (_I * 8)(), _P()
        with torch.cuda.device(dev):
            args = (n, d, k, int(pts_bf16)) if name == "kmeans_partials" \
                else (n, d, k)
            build.check(getattr(lib, f"{name}_plan")(
                *args, out, ctypes.byref(handle)), f"{name}_plan")
        p = Plan(bool(out[0]), *out[1:], handle=handle.value)
        kernel = _REGISTRY_NAMES[name]
        memrec.require_smem_fit(kernel, p.smem, device=index)
        memrec.require_hbm_fit(kernel, launch_bytes(
            p, n, d, k, name == "kmeans_partials"), device=index)
        _PLANS[key] = p
    return _PLANS[key]


def _buffers(p: Plan, n, d, k, f32_sums, dev) -> dict:
    return {name: torch.empty(shape, dtype=dt, device=dev)
            for name, (shape, dt) in workspace(p, n, d, k, f32_sums).items()}


def exact_int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` of int8 matrices as exact int32, through a float matmul
    (CUDA has no integer matmul): f32 while every partial sum stays below
    2^24 (127^2 * d < 2^24, so d <= 1040), f64 beyond."""
    ft = torch.float32 if 127 * 127 * a.shape[1] < (1 << 24) else torch.float64
    return (a.to(ft) @ b.to(ft).T).to(torch.int32)


# ---- K1: int8 -------------------------------------------------------------

def kmeans_partials_int8_plain(pts_q, c_q, c_scale, c2, col_scale):
    """Plain PyTorch version of K1 (same arguments and results)."""
    k, d = c_q.shape
    dots = exact_int_dot(pts_q, c_q).to(torch.float32) * c_scale[None, :]
    scores = c2[None, :] - 2.0 * dots
    assign = torch.argmin(scores, dim=1)
    best = scores.gather(1, assign[:, None])[:, 0]
    sums_i = torch.zeros((k, d), dtype=torch.int32, device=pts_q.device)
    sums_i.index_add_(0, assign, pts_q.to(torch.int32))
    counts = torch.bincount(assign, minlength=k)
    return (sums_i.to(torch.float32) * col_scale[None, :],
            counts.to(torch.float32), best.sum())


def kmeans_partials_int8(pts_q, c_q, c_scale, c2, col_scale):
    """Fused int8 partials → (sums [k, d] f32, counts [k] f32, best_sum).

    ``pts_q`` int8 [n, d] with per-feature ``col_scale`` f32 [d]; ``c_q``
    int8 [k, d] and ``c_scale`` f32 [k] from ``models.kmeans.
    _quantize_centroids``; ``c2`` f32 [k] the original-space |c|^2.  Sums
    accumulate exactly in int32 and are dequantized by ``col_scale``;
    ``best_sum`` is the sum over points of the assigned score, to which the
    caller adds the iteration-invariant sum of |x|^2."""
    n, d = pts_q.shape
    k = c_q.shape[0]
    dev = pts_q.device
    build.require(pts_q, "pts_q", (torch.int8,), (n, d), dev)
    build.require(c_q, "c_q", (torch.int8,), (k, d), dev)
    build.require(c_scale, "c_scale", (torch.float32,), (k,), dev)
    build.require(c2, "c2", (torch.float32,), (k,), dev)
    build.require(col_scale, "col_scale", (torch.float32,), (d,), dev)
    if dev.type == "cpu":
        return kmeans_partials_int8_plain(pts_q, c_q, c_scale, c2, col_scale)
    if dev.type != "cuda":
        raise ValueError(f"kmeans_partials_int8 runs on cuda or cpu, not {dev}")
    lib = _lib("kmeans_partials_int8")
    p = plan("kmeans_partials_int8", dev, n, d, k)
    with torch.cuda.device(dev):
        ws = _buffers(p, n, d, k, False, dev)
        sums_i = torch.zeros((k, d), dtype=torch.int32, device=dev)
        counts_i = torch.zeros((k,), dtype=torch.int32, device=dev)
        build.check(lib.kmeans_partials_int8(
            p.handle, pts_q.data_ptr(), c_q.data_ptr(), c_scale.data_ptr(),
            c2.data_ptr(), n, d, k, ws["cen_pack"].data_ptr(),
            ws["c2_pack"].data_ptr(), ws["cs_pack"].data_ptr(),
            ws["assign"].data_ptr(), sums_i.data_ptr(), counts_i.data_ptr(),
            ws["partial"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            "kmeans_partials_int8 launch")
    LAUNCHES["kmeans_partials_int8"] += 1
    return (sums_i.to(torch.float32) * col_scale[None, :],
            counts_i.to(torch.float32), ws["partial"].sum())


# ---- K2: f32 (bf16 dot) ------------------------------------------------------

def bf16_centroids(centroids: torch.Tensor):
    """The TPU kernel's centroid operand: values rounded to bf16 (held in
    f32) and |c|^2 of those rounded values."""
    c_b = centroids.to(torch.bfloat16).to(torch.float32).contiguous()
    return c_b, (c_b ** 2).sum(dim=1)


def kmeans_partials_plain(points, centroids):
    """Plain PyTorch version of K2 (same arguments and results)."""
    k, d = centroids.shape
    c_b, c2 = bf16_centroids(centroids)
    pts_b = points.to(torch.bfloat16).to(torch.float32)
    scores = c2[None, :] - 2.0 * (pts_b @ c_b.T)
    assign = torch.argmin(scores, dim=1)
    best = scores.gather(1, assign[:, None])[:, 0]
    sums = torch.zeros((k, d), dtype=torch.float32, device=points.device)
    sums.index_add_(0, assign, pts_b)
    counts = torch.bincount(assign, minlength=k).to(torch.float32)
    inertia = (points.to(torch.float32) ** 2).sum() + best.sum()
    return sums, counts, inertia


def kmeans_partials(points, centroids):
    """Fused partials → (sums [k, d] f32, counts [k] f32, inertia).

    The TPU kernel's numerics: points and centroids rounded to bf16 for the
    dot and the one-hot sums, f32 accumulation, |x|^2 re-added to the
    inertia from the full-precision points.  ``points`` f32 or bf16
    [n, d]; ``centroids`` [k, d] (any float dtype)."""
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    build.require(points, "points", (torch.float32, torch.bfloat16),
                  (n, d), dev)
    build.require(centroids, "centroids",
                  (torch.float32, torch.bfloat16, torch.float16), (k, d), dev)
    if dev.type == "cpu":
        return kmeans_partials_plain(points, centroids)
    if dev.type != "cuda":
        raise ValueError(f"kmeans_partials runs on cuda or cpu, not {dev}")
    lib = _lib("kmeans_partials")
    bf16 = points.dtype == torch.bfloat16
    p = plan("kmeans_partials", dev, n, d, k, bf16)
    c_b, c2 = bf16_centroids(centroids)
    with torch.cuda.device(dev):
        ws = _buffers(p, n, d, k, True, dev)
        counts_i = torch.zeros((k,), dtype=torch.int32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        build.check(lib.kmeans_partials(
            p.handle, points.data_ptr(), int(bf16), c_b.data_ptr(), c2.data_ptr(), n,
            d, k, ws["cen_pack"].data_ptr(), ws["c2_pack"].data_ptr(),
            ws["assign"].data_ptr(), ws["slabs"].data_ptr(),
            counts_i.data_ptr(), ws["partial"].data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            "kmeans_partials launch")
    LAUNCHES["kmeans_partials"] += 1
    return sums, counts_i.to(torch.float32), ws["partial"].sum()


# ---- the streamed int8 chunk: quantize and sum of |x|^2 in one pass -------

def quantize_rows_int8_plain(x, col_scale):
    """Plain PyTorch version of :func:`quantize_rows_int8` (same arguments
    and results): the int8 rounding rule, then the chunk's sum of |x|^2."""
    q = x.div(col_scale).round().clamp(-127, 127).to(torch.int8)
    return q, ((q.to(torch.float32) * col_scale[None, :]) ** 2).sum()


def _qplan(lib: ctypes.CDLL, n: int, d: int, vec: int, idx: int
           ) -> tuple[int, ...]:
    """The fused pass's launch plan for (n, d, vec) on card ``idx``, asked
    once: (threads, tiles a block at a time, groups a tile, grid, dynamic
    shared memory, wide)."""
    key = (idx, n, d, vec)
    if key not in _QPLANS:
        out = (_I * 6)()
        build.check(lib.kmeans_quantize_int8_plan(n, d, vec, out),
                    "kmeans_quantize_int8_plan")
        _QPLANS[key] = tuple(out)
    return _QPLANS[key]


def quantize_rows_int8(x, col_scale):
    """An f32 chunk → ``(q [n, d] int8, x2 0-d f32)`` in one pass.

    ``q`` is ``x / col_scale`` rounded half to even and clipped to ±127, bit
    for bit as :func:`quantize_rows_int8_plain`; ``x2`` is the sum of
    ``(q · col_scale)^2``, the int8 chunk's iteration-invariant sum of
    |x|^2, formed exactly from integer sums of q^2 and rounded once to f32
    (the plain version sums in f32).  ``x`` [n, d] f32 is read and left as
    it is; ``col_scale`` [d] f32.  An empty chunk launches nothing."""
    n, d = x.shape
    dev = x.device
    build.require(x, "x", (torch.float32,), (n, d), dev)
    build.require(col_scale, "col_scale", (torch.float32,), (d,), dev)
    if dev.type == "cpu":
        return quantize_rows_int8_plain(x, col_scale)
    if dev.type != "cuda":
        raise ValueError(f"quantize_rows_int8 runs on cuda or cpu, not {dev}")
    q = torch.empty((n, d), dtype=torch.int8, device=dev)
    if n == 0:
        return q, torch.zeros((), device=dev)
    lib = _lib("kmeans_quantize_int8")
    vec = int(x.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0)
    with torch.cuda.device(dev):
        idx = torch.cuda.current_device()
        stream = torch.cuda.current_stream(dev)
        threads, m, groups, grid, smem, wide = _qplan(lib, n, d, vec, idx)
        key = (idx, stream.cuda_stream, d)
        if key not in _ACC:
            _ACC[key] = torch.zeros((d + 1,), dtype=torch.int64, device=dev)
        x2 = torch.empty((), dtype=torch.float32, device=dev)
        build.check(lib.kmeans_quantize_int8(
            x.data_ptr(), col_scale.data_ptr(), n, d, vec, threads, m,
            groups, grid, smem, wide, q.data_ptr(), _ACC[key].data_ptr(),
            x2.data_ptr(), stream.cuda_stream), "kmeans_quantize_int8 launch")
    LAUNCHES["kmeans_quantize_int8"] += 1
    return q, x2
