"""Fused KMeans partials: the port of ``harp_tpu.ops.kmeans_kernel``.

One Lloyd iteration's per-worker partials in a single pass over the points:
scores, argmin (lowest index wins ties), one-hot sums, counts, and the sum
of best scores.  Two kernels, each a CUDA C++ source for ``sm_90a`` beside
its wrapper and its plain PyTorch version:

====  ==============================  ====================================
K1    :func:`kmeans_partials_int8`    ``csrc/kmeans_partials_int8.cu``;
                                      replaces the TPU kernel
                                      ``kmeans_partials_int8``
K2    :func:`kmeans_partials`         ``csrc/kmeans_partials.cu``;
                                      replaces the TPU kernel
                                      ``kmeans_partials``
====  ==============================  ====================================

Each source's head note gives the kernel's bound on the card and what its
design does about it.  A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel (on the current stream) or
raises — there is no fallback.  :data:`LAUNCHES` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels.

Unlike the TPU kernels, these take any ``n`` (the ragged tile is masked),
any ``k`` (centroid tiles loop) and any ``d``; the TPU-only gates (VMEM
budget, tile divides n) have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops import build

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"kmeans_partials_int8": 0, "kmeans_partials": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "kmeans_partials_int8": {
        "kmeans_partials_int8_grid": [_I, _I, _I, ctypes.POINTER(_I)],
        "kmeans_partials_int8": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                 _I, _P],
    },
    "kmeans_partials": {
        "kmeans_partials_grid": [_I, _I, _I, ctypes.POINTER(_I)],
        "kmeans_partials": [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                            _P],
    },
}
_BOUND: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _BOUND.get(name)
    if lib is None:
        lib = build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
        _BOUND[name] = lib
    return lib


def _require(t: torch.Tensor, what: str, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of "
                        f"{[str(d) for d in dtypes]}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _grid(lib, fn: str, n: int, d: int, k: int) -> int:
    grid = _I()
    build.check(getattr(lib, fn)(n, d, k, ctypes.byref(grid)), fn)
    return grid.value


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
    _require(pts_q, "pts_q", (torch.int8,), (n, d), dev)
    _require(c_q, "c_q", (torch.int8,), (k, d), dev)
    _require(c_scale, "c_scale", (torch.float32,), (k,), dev)
    _require(c2, "c2", (torch.float32,), (k,), dev)
    _require(col_scale, "col_scale", (torch.float32,), (d,), dev)
    if dev.type == "cpu":
        return kmeans_partials_int8_plain(pts_q, c_q, c_scale, c2, col_scale)
    if dev.type != "cuda":
        raise ValueError(f"kmeans_partials_int8 runs on cuda or cpu, not {dev}")
    lib = _lib("kmeans_partials_int8")
    with torch.cuda.device(dev):
        grid = _grid(lib, "kmeans_partials_int8_grid", n, d, k)
        sums_i = torch.zeros((k, d), dtype=torch.int32, device=dev)
        counts_i = torch.zeros((k,), dtype=torch.int32, device=dev)
        best = torch.empty((grid,), dtype=torch.float32, device=dev)
        build.check(lib.kmeans_partials_int8(
            pts_q.data_ptr(), c_q.data_ptr(), c_scale.data_ptr(),
            c2.data_ptr(), n, d, k, sums_i.data_ptr(), counts_i.data_ptr(),
            best.data_ptr(), grid, torch.cuda.current_stream(dev).cuda_stream),
            "kmeans_partials_int8 launch")
    LAUNCHES["kmeans_partials_int8"] += 1
    return (sums_i.to(torch.float32) * col_scale[None, :],
            counts_i.to(torch.float32), best.sum())


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
    _require(points, "points", (torch.float32, torch.bfloat16), (n, d), dev)
    _require(centroids, "centroids",
             (torch.float32, torch.bfloat16, torch.float16), (k, d), dev)
    if dev.type == "cpu":
        return kmeans_partials_plain(points, centroids)
    if dev.type != "cuda":
        raise ValueError(f"kmeans_partials runs on cuda or cpu, not {dev}")
    lib = _lib("kmeans_partials")
    c_b, c2 = bf16_centroids(centroids)
    with torch.cuda.device(dev):
        grid = _grid(lib, "kmeans_partials_grid", n, d, k)
        slabs = torch.empty((grid, k, d), dtype=torch.float32, device=dev)
        counts_i = torch.zeros((k,), dtype=torch.int32, device=dev)
        inertia = torch.empty((grid,), dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        build.check(lib.kmeans_partials(
            points.data_ptr(), int(points.dtype == torch.bfloat16),
            c_b.data_ptr(), c2.data_ptr(), n, d, k, slabs.data_ptr(),
            counts_i.data_ptr(), inertia.data_ptr(), sums.data_ptr(), grid,
            torch.cuda.current_stream(dev).cuda_stream),
            "kmeans_partials launch")
    LAUNCHES["kmeans_partials"] += 1
    return sums, counts_i.to(torch.float32), inertia.sum()
