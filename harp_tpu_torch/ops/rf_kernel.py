"""Weighted label histogram for RF growth: the port of
``harp_tpu.ops.rf_kernel``.

For each tree of the forest, one level's histogram ``hist[t, r, k·B + b] =
Σ_i 1[rowcode[t, i] = r]·w[t, i]·1[bins[i, k] = b]``, with exact int32
counts.  Kernel K7 (:func:`hist_bins`) is the CUDA C++ source
``csrc/rf_hist_bins.cu`` for ``sm_90a``; it replaces the TPU kernel
``hist_bins`` (``harp_tpu/ops/rf_kernel.py``), and the source's head note
gives its bound and design; its launch plan (:func:`plan`) is made here,
once per card and shape.  :func:`hist_bins_plain` is its plain PyTorch
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
import math
from dataclasses import dataclass

import torch

from harp_tpu_torch.ops import build

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"hist_bins": 0}

#: ring slots (csrc/rf_hist_bins.cu's kStages), the sub-tiles a slot keeps
#: before a plan gives up trees or features, and the most it takes (the
#: kernel's 11-bit sample index)
STAGES, MIN_SUB_TILES, MAX_SUB_TILES = 4, 4, 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "rf_hist_bins_setup": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "rf_hist_bins": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _L, _L, _L, _L, _L, _L, _P, _P],
}
_BOUND: dict[str, ctypes.CDLL] = {}
#: per card index: (opt-in shared memory a block, SM count); the ask also
#: lets every instantiation of the kernel take the opt-in maximum
_CARDS: dict[int, tuple[int, int]] = {}
#: per (T, n, f, B, R, bins itemsize, card index)
_PLANS: dict[tuple, "Plan | None"] = {}


@dataclass(frozen=True)
class Plan:
    """K7's launch plan for one level's shape (``csrc/rf_hist_bins.cu``):
    ``fs`` features a slice, ``tg`` trees a block, ``w`` lanes an item's
    features take, ``ns`` 32-sample sub-tiles a super-tile (a ring slot),
    ``chunk`` samples a block (a multiple of 32·ns) over ``nchunks``
    chunks; and the block's shared memory, which the kernel takes as
    given here (:func:`layout`): ``fsp`` histogram columns a (row, bin),
    the byte offsets of the two counters, the item queue and the ring,
    a ring slot's bytes and the offset of its row codes, and ``smem`` in
    all."""

    fs: int
    tg: int
    w: int
    ns: int
    chunk: int
    nchunks: int
    fsp: int
    counts_at: int
    queue_at: int
    ring_at: int
    slot: int
    rcw_at: int
    smem: int


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def layout(fs: int, tg: int, w: int, ns: int, R: int, B: int,
           itemsize: int) -> dict:
    """A block's shared memory, in order: the [tg, R, B, fsp] int32
    histograms (fsp = fs rounded up to w), two counters, a queue of 8-byte
    items for a super-tile's tg·32·ns (tree, sample) pairs, and STAGES
    ring slots, each a super-tile's bins [32·ns, fs] and then its trees'
    row codes and weights [tg, 32·ns] each.  Regions start on 16 bytes."""
    S = 32 * ns
    fsp = -(-fs // w) * w
    counts_at = _round16(tg * R * B * fsp * 4)
    queue_at = counts_at + 16
    ring_at = queue_at + _round16(tg * S * 8)
    rcw_at = _round16(S * fs * itemsize)
    slot = rcw_at + 2 * tg * S * 4
    return {"fsp": fsp, "counts_at": counts_at, "queue_at": queue_at,
            "ring_at": ring_at, "slot": slot, "rcw_at": rcw_at,
            "smem": ring_at + STAGES * slot}


def smem_bytes(fs: int, tg: int, w: int, ns: int, R: int, B: int,
               itemsize: int) -> int:
    """The bytes of :func:`layout`."""
    return layout(fs, tg, w, ns, R, B, itemsize)["smem"]


def plan(T: int, n: int, f: int, B: int, R: int, itemsize: int, optin: int,
         sms: int, *, fs: int | None = None, tg: int | None = None,
         ns: int | None = None, nchunks: int | None = None) -> Plan | None:
    """K7's launch plan for one level, or None when one feature's [R, B]
    histogram does not fit in ``optin`` bytes of shared memory.

    - The widest feature slice (``min(f, 64)``, then its halvings) whose
      histograms fit beside a ring of MIN_SUB_TILES sub-tiles a slot: the
      fewer slices, the fewer blocks read each (tree, sample).
    - The groups of trees and features are split into sample chunks until
      the card holds about one block an SM (one chunk: each block stores
      the cells it owns; more: they add them).  Of the tree counts that
      fit (up to 32), the one whose busiest block reads the fewest (tree,
      sample) pairs, tg · chunk; the most trees of a tie.
    - The ring takes the rest of shared memory (up to MAX_SUB_TILES
      sub-tiles a slot): fewer super-tiles, fewer barriers.
    - When nothing fits beside MIN_SUB_TILES, one sub-tile a slot will do
      before the plan is refused.

    ``fs``, ``tg``, ``ns`` and ``nchunks`` pin a choice; only the tests
    (to reach each branch of the kernel: lanes an item, ragged slices,
    one sub-tile a slot, owner stores against atomic flushes) and
    ``examples/k67_phases.py --sweep`` (to time the other plans that fit,
    against which this rule was fitted on an H100) use them."""
    widths = sorted({min(f, 64) >> i for i in range(7)} - {0}, reverse=True)
    for least in (MIN_SUB_TILES, 1):
        for w_fs in widths if fs is None else [fs]:
            w = min(32, 1 << (w_fs - 1).bit_length())
            best = None
            for w_tg in range(1, min(T, 32) + 1) if tg is None else [tg]:
                w_ns = ns or least
                if smem_bytes(w_fs, w_tg, w, w_ns, R, B, itemsize) > optin:
                    continue
                while not ns and w_ns < MAX_SUB_TILES and smem_bytes(
                        w_fs, w_tg, w, w_ns + 1, R, B, itemsize) <= optin:
                    w_ns += 1
                groups = math.ceil(T / w_tg) * math.ceil(f / w_fs)
                tile = 32 * w_ns
                chunks = nchunks or max(1, min(sms // groups,
                                               math.ceil(n / tile)))
                chunk = math.ceil(math.ceil(n / chunks) / tile) * tile
                p = Plan(w_fs, w_tg, w, w_ns, chunk, math.ceil(n / chunk),
                         **layout(w_fs, w_tg, w, w_ns, R, B, itemsize))
                load = w_tg * math.ceil(n / chunks)  # the busiest block's
                if best is None or load <= best[0]:
                    best = (load, p)
            if best is not None:
                return best[1]
    return None


def reset_launches() -> None:
    LAUNCHES["hist_bins"] = 0


def _lib() -> ctypes.CDLL:
    if "lib" not in _BOUND:
        _BOUND["lib"] = build.bind("rf_hist_bins", _SIGNATURES)
    return _BOUND["lib"]


def _card(lib: ctypes.CDLL, index: int) -> tuple[int, int]:
    """(opt-in shared memory, SMs) of this card, asked once; the ask also
    sets the kernel's shared-memory limit."""
    if index not in _CARDS:
        optin, sms = _I(), _I()
        build.check(lib.rf_hist_bins_setup(ctypes.byref(optin),
                                           ctypes.byref(sms)),
                    "rf_hist_bins_setup")
        _CARDS[index] = (optin.value, sms.value)
    return _CARDS[index]


def _plan(lib: ctypes.CDLL, T: int, n: int, f: int, B: int, R: int,
          itemsize: int, index: int) -> Plan | None:
    """:func:`plan` for one level's shape on this card, made once (a fit's
    levels repeat in every later fit)."""
    key = (T, n, f, B, R, itemsize, index)
    if key not in _PLANS:
        _PLANS[key] = plan(T, n, f, B, R, itemsize, *_card(lib, index))
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
        p = _plan(lib, T, n, f, B, R, bins.element_size(),
                  torch.cuda.current_device())
        if p is None:
            raise ValueError(
                f"hist_bins: one feature's histogram ({R} row codes x {B} "
                f"bins of int32) does not fit in a block's shared memory")
        return launch(lib, p, bins, rowcode, weights, R, B)


def launch(lib: ctypes.CDLL, p: Plan, bins, rowcode, weights, R: int,
           B: int):
    """One launch of K7 from ``lib`` (the built ``csrc/rf_hist_bins.cu``)
    with plan ``p`` on the current stream; the arguments as
    :func:`hist_bins` checked them."""
    (n, f), T = bins.shape, rowcode.shape[0]
    dev = bins.device
    # one chunk: every block stores the cells it owns; else they add
    alloc = torch.empty if p.nchunks == 1 else torch.zeros
    hist = alloc((T, R, f * B), dtype=torch.int32, device=dev)
    build.check(lib.rf_hist_bins(
        bins.data_ptr(), int(bins.dtype == torch.int32), rowcode.data_ptr(),
        weights.data_ptr(), T, n, f, B, R, p.fs, p.tg, p.w, p.ns, p.chunk,
        p.nchunks, p.fsp, p.counts_at, p.queue_at, p.ring_at, p.slot,
        p.rcw_at, p.smem, hist.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rf_hist_bins launch")
    LAUNCHES["hist_bins"] += 1
    return hist
