"""Weighted label histogram for RF growth: the port of
``harp_tpu.ops.rf_kernel``.

For each tree of the forest, one level's histogram ``hist[t, r, k·B + b] =
Σ_i 1[rowcode[t, i] = r]·w[t, i]·1[bins[i, k] = b]``, with exact int32
counts.  Kernel K7 (:func:`hist_bins`) is the CUDA C++ source
``csrc/rf_hist_bins.cu`` for ``sm_90a``; it replaces the TPU kernel
``hist_bins`` (``harp_tpu/ops/rf_kernel.py``), and the source's head note
gives its bound and design.  :func:`hist_bins_plain` is its plain PyTorch
version.

The TPU kernel takes the int8 one-hots ``BO = bins_onehot(bins)`` [n, f·B];
since BO is ``one_hot(bins)``, this takes the bin ids ``bins`` [n, f]
(uint8 or int32) and computes the same function without ever building BO.
The tree axis is written out: ``rowcode`` and ``weights`` are [T, n] and one
launch covers the forest.  Row codes outside ``[0, n_node_classes)`` and
bins outside ``[0, n_bins)`` add nothing, as in the one-hot product; the
weights must already be clipped to ``[0, 127]``, as the caller does.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches K7 on the current stream or raises.  :data:`LAUNCHES`
counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"hist_bins": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rf_hist_bins_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I),
                          ctypes.POINTER(_I)],
    "rf_hist_bins": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}
_BOUND: dict[str, ctypes.CDLL] = {}
#: per (T, n, f, B, R, card index): K7's (features a block's slice holds,
#: samples a block takes); fs = 0 when one feature's histogram does not fit
_PLANS: dict[tuple, tuple[int, int]] = {}


def reset_launches() -> None:
    LAUNCHES["hist_bins"] = 0


def _lib() -> ctypes.CDLL:
    if "lib" not in _BOUND:
        _BOUND["lib"] = build.bind("rf_hist_bins", _SIGNATURES)
    return _BOUND["lib"]


def _plan(lib: ctypes.CDLL, T: int, n: int, f: int, B: int, R: int,
          dev: torch.device) -> tuple[int, int]:
    """K7's launch plan for one level's shape on this card, asked once (a
    fit's levels repeat in every later fit); the ask also sets its
    shared-memory limit."""
    key = (T, n, f, B, R, dev.index if dev.index is not None
           else torch.cuda.current_device())
    if key not in _PLANS:
        fs, chunk = _I(), _I()
        build.check(lib.rf_hist_bins_plan(T, n, f, B, R, ctypes.byref(fs),
                                          ctypes.byref(chunk)),
                    "rf_hist_bins_plan")
        _PLANS[key] = (fs.value, chunk.value)
    return _PLANS[key]


def hist_bins_plain(bins, rowcode, weights, n_node_classes: int,
                    n_bins: int):
    """Plain PyTorch version of K7 (same arguments and result): a scatter
    add of int32 weights, one tree at a time."""
    T, n = rowcode.shape
    f = bins.shape[1]
    R, B = n_node_classes, n_bins
    b = bins.to(torch.int64)
    cols = torch.arange(f, device=bins.device)[None, :] * B + b  # [n, f]
    bin_ok = (b >= 0) & (b < B)
    hist = torch.zeros((T, R * f * B), dtype=torch.int32, device=bins.device)
    for t in range(T):
        rc, w = rowcode[t].to(torch.int64), weights[t]
        ok = bin_ok & ((rc >= 0) & (rc < R) & (w != 0))[:, None]
        flat = rc[:, None] * (f * B) + cols
        hist[t].index_put_((flat[ok],), w[:, None].expand(n, f)[ok],
                           accumulate=True)
    return hist.reshape(T, R, f * B)


def hist_bins(bins, rowcode, weights, n_node_classes: int, n_bins: int):
    """One level's label histograms of every tree → ``hist [T,
    n_node_classes, f·n_bins]`` int32.

    ``bins`` [n, f] uint8 or int32 bin ids, ``rowcode`` [T, n] int32 (node ·
    n_classes + label), ``weights`` [T, n] int32 in [0, 127]."""
    n, f = bins.shape
    T = rowcode.shape[0]
    R, B = n_node_classes, n_bins
    dev = bins.device
    build.require(bins, "bins", (torch.uint8, torch.int32), (n, f), dev)
    build.require(rowcode, "rowcode", (torch.int32,), (T, n), dev)
    build.require(weights, "weights", (torch.int32,), (T, n), dev)
    if dev.type == "cpu":
        return hist_bins_plain(bins, rowcode, weights, R, B)
    if dev.type != "cuda":
        raise ValueError(f"hist_bins runs on cuda or cpu, not {dev}")
    lib = _lib()
    with torch.cuda.device(dev):
        fs, chunk = _plan(lib, T, n, f, B, R, dev)
        if not fs:
            raise ValueError(
                f"hist_bins: one feature's histogram ({R} row codes x {B} "
                f"bins of int32) does not fit in a block's shared memory")
        binsT = bins.T.contiguous()  # [f, n]: a feature's ids contiguous
        hist = torch.zeros((T, R, f * B), dtype=torch.int32, device=dev)
        build.check(lib.rf_hist_bins(
            binsT.data_ptr(), int(bins.dtype == torch.int32),
            rowcode.data_ptr(), weights.data_ptr(), T, n, f, B, R, fs, chunk,
            hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "rf_hist_bins launch")
    LAUNCHES["hist_bins"] += 1
    return hist
