"""MF-SGD tile-entry block update: the port of ``harp_tpu.ops.mfsgd_kernel``.

One rotation step's update of one worker's W range and its resident H
chunk, entry by entry.  An *entry* is up to ``C`` ratings inside one
``u_tile × i_tile`` sub-tile (``models.mfsgd.partition_ratings_tiles``):
tile-local ids ``eu/ei [NE, C]`` (a pad slot has ``eu == u_tile``), values
``ev`` and tile row offsets ``ou/oi [NE]``.

====  ==============================  ====================================
K3    :func:`sgd_tile_update`         ``csrc/mfsgd_tile_update.cu``;
                                      replaces the TPU kernel
                                      ``sgd_tile_update``
====  ==============================  ====================================

Semantics kept from the TPU kernel:

- every rating of an entry scores against the entry-start W and H tiles;
  the gradients accumulate in f32 and ONE apply ``tile = snapshot +
  lr·acc`` lands at the entry's end;
- the gathered rows are rounded to ``compute_dtype`` and read as f32; the
  error ``cm·(v − Σ wu·hi)`` is f32; the per-rating gradients ``err·hi −
  reg·cm·wu`` and ``err·wu − reg·cm·hi`` are rounded to ``compute_dtype``
  before they are summed; sums and apply are f32;
- a slot is masked by ``eu < u_tile`` alone, and a masked slot's ``ei`` is
  never read (pads carry ``i_tile`` or ``0``);
- entry order: the TPU runs the entries as a sequential grid.  Here a
  host-side *level schedule* (:class:`LevelSchedule`) gives each entry
  with a rating the level ``1 + max(level of the previous entry with the
  same ou, level of the previous entry with the same oi)``.  Entries of one
  level touch distinct W tiles and distinct H tiles and read only what
  earlier levels finished, so running level by level gives every entry the
  inputs the sequential order gives it.  Entries without a rating change
  nothing and get no level (the TPU's coverage entries are not needed).

W and H stay row-major ``[rows, rank]`` (no transposes, no one-hot
operands: those are TPU layout devices).  The wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches K3 or
raises.  :data:`LAUNCHES` counts wrapper calls that launched K3 (one per
rotation step; each call launches one CUDA kernel per level).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from harp_tpu_torch.ops import build

#: K3 wrapper calls that launched the kernel since :func:`reset_launches`
LAUNCHES = {"sgd_tile_update": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sgd_tile_update_init": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "sgd_tile_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _F, _F, _I, _P, _P, _P],
}
_BOUND: list[ctypes.CDLL] = []
#: per card index: (shared memory a block may use, the kernel's static part)
_SMEM: dict[int, tuple[int, int]] = {}


def reset_launches() -> None:
    LAUNCHES["sgd_tile_update"] = 0


def _lib() -> ctypes.CDLL:
    if not _BOUND:
        _BOUND.append(build.bind("mfsgd_tile_update", _SIGNATURES))
    return _BOUND[0]


def _smem(lib: ctypes.CDLL, dev: torch.device) -> tuple[int, int]:
    """The card's shared-memory limit a block and K3's static shared bytes,
    asked once per card (which also lets K3 take the rest dynamically)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMEM:
        limit, static = _I(), _I()
        with torch.cuda.device(idx):
            build.check(lib.sgd_tile_update_init(ctypes.byref(limit),
                                                 ctypes.byref(static)),
                        "sgd_tile_update_init")
        _SMEM[idx] = (limit.value, static.value)
    return _SMEM[idx]


# ---- the level schedule (host) ------------------------------------------------

def entry_levels(eu, ou, oi, u_tile: int) -> np.ndarray:
    """Level of every entry of one block row, -1 for an entry without a
    rating: ``1 + max(level of the previous entry with the same ou, level
    of the previous entry with the same oi)``, levels from 0."""
    real = (np.asarray(eu) < u_tile).any(axis=-1)
    ou_l, oi_l = np.asarray(ou).tolist(), np.asarray(oi).tolist()
    level = np.full(real.shape[0], -1, np.int64)
    last_u: dict[int, int] = {}
    last_i: dict[int, int] = {}
    for e in np.flatnonzero(real).tolist():
        lv = 1 + max(last_u.get(ou_l[e], -1), last_i.get(oi_l[e], -1))
        level[e] = last_u[ou_l[e]] = last_i[oi_l[e]] = lv
    return level


@dataclasses.dataclass
class LevelSchedule:
    """Entries grouped by level: ``order`` (int32, on the entries' device)
    lists the scheduled entry ids level by level, in entry order within a
    level; level ``l`` is ``order[offsets[l]:offsets[l + 1]]``.  ``offsets``
    stays on the host: the launch loop reads it there.  One int32 per
    entry with a rating plus one per level, built once per
    ``set_ratings``."""

    order: torch.Tensor
    offsets: np.ndarray  # int32 [n_levels + 1]

    @property
    def n_levels(self) -> int:
        return len(self.offsets) - 1

    @property
    def max_width(self) -> int:
        return int(np.diff(self.offsets).max(initial=0))

    @classmethod
    def build(cls, eu, ei, ou, oi, u_tile: int, i_tile: int, w_rows: int,
              h_rows: int, device) -> "LevelSchedule":
        """The schedule of one block row (host arrays or tensors).  Checks
        what the kernel trusts: real slots' ids inside their tiles,
        scheduled tiles aligned to the tile size (levels are keyed on the
        offsets, so two overlapping unaligned tiles could share a level)
        and inside W and H."""
        eu, ei, ou, oi = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                     else a) for a in (eu, ei, ou, oi))
        level = entry_levels(eu, ou, oi, u_tile)
        sel = np.flatnonzero(level >= 0)
        real = eu[sel] < u_tile
        if (eu[sel] < 0).any() or ((ei[sel] < 0) | (ei[sel] >= i_tile))[
                real].any():
            raise ValueError("entry ids out of their tiles")
        if (ou[sel] % u_tile).any() or (oi[sel] % i_tile).any():
            raise ValueError(f"an entry's offsets are not multiples of "
                             f"u_tile={u_tile} / i_tile={i_tile}")
        if sel.size and (ou[sel].min() < 0 or oi[sel].min() < 0
                         or ou[sel].max() + u_tile > w_rows
                         or oi[sel].max() + i_tile > h_rows):
            raise ValueError(f"an entry's tile lies outside W ({w_rows} "
                             f"rows) or H ({h_rows} rows)")
        order = sel[np.argsort(level[sel], kind="stable")].astype(np.int32)
        counts = np.bincount(level[sel], minlength=0)
        offsets = np.zeros(len(counts) + 1, np.int32)
        offsets[1:] = np.cumsum(counts)
        return cls(torch.from_numpy(order).to(device), offsets)


# ---- K3: plain version ----------------------------------------------------------

def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def sgd_tile_update_plain(W, H, eu, ei, ev, ou, oi, *, lr, reg, u_tile,
                          i_tile, compute_dtype=torch.bfloat16,
                          schedule: LevelSchedule | None = None):
    """Plain PyTorch version of K3 (same arguments and results), one level
    at a time, vectorised over the level's entries."""
    if schedule is None:
        schedule = LevelSchedule.build(eu, ei, ou, oi, u_tile, i_tile,
                                       W.shape[0], H.shape[0], W.device)
    cd = compute_dtype
    W, H = W.clone(), H.clone()
    dev = W.device
    se = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    ar_u = torch.arange(u_tile, device=dev)
    ar_i = torch.arange(i_tile, device=dev)
    for lo, hi_ in zip(schedule.offsets[:-1].tolist(),
                       schedule.offsets[1:].tolist()):
        E = schedule.order[lo:hi_].long()
        cu, ci, cv = eu[E].long(), ei[E].long(), ev[E]
        m = cu < u_tile
        cu, ci = torch.where(m, cu, 0), torch.where(m, ci, 0)
        tou, toi = ou[E].long()[:, None], oi[E].long()[:, None]
        wu = _rounded(W[tou + cu], cd)                       # [k, C, R]
        hi = _rounded(H[toi + ci], cd)
        cm = m.to(torch.float32)
        err = cm * (cv - (wu * hi).sum(-1))
        gw = _rounded(err[..., None] * hi - reg * cm[..., None] * wu, cd)
        gh = _rounded(err[..., None] * wu - reg * cm[..., None] * hi, cd)
        slot = torch.arange(E.numel(), device=dev)[:, None]
        acc_w = torch.zeros((E.numel() * u_tile, W.shape[1]),
                            dtype=torch.float32, device=dev)
        acc_w.index_add_(0, (slot * u_tile + cu)[m], gw[m])
        acc_h = torch.zeros((E.numel() * i_tile, H.shape[1]),
                            dtype=torch.float32, device=dev)
        acc_h.index_add_(0, (slot * i_tile + ci)[m], gh[m])
        rows_w = (tou + ar_u).reshape(-1)
        rows_h = (toi + ar_i).reshape(-1)
        W[rows_w] = W[rows_w] + lr * acc_w
        H[rows_h] = H[rows_h] + lr * acc_h
        se = se + (err * err).sum()
        cnt = cnt + cm.sum()
    return W, H, se, cnt


# ---- K3: the wrapper ---------------------------------------------------------------

def check_accumulator_fits(u_tile: int, i_tile: int, rank: int,
                           limit: int, static_bytes: int = 0) -> None:
    """Refuse tiles whose f32 gradient accumulators (the W tile's and the
    H tile's), with the kernel's ``static_bytes`` of shared memory, exceed
    ``limit`` bytes a block (232,448 on an H100): never clip silently."""
    need = (u_tile + i_tile) * rank * 4 + static_bytes
    if need > limit:
        raise ValueError(
            f"mfsgd K3: accumulators for u_tile={u_tile}, i_tile={i_tile}, "
            f"rank={rank} need {need} bytes of shared memory (with "
            f"{static_bytes} static), above this card's {limit} a block; "
            f"use smaller tiles")


def sgd_tile_update(W, H, eu, ei, ev, ou, oi, *, lr, reg, u_tile, i_tile,
                    compute_dtype=torch.bfloat16,
                    schedule: LevelSchedule | None = None):
    """One rotation step's block update → ``(W', H', se, cnt)``.

    ``W`` [u_bound, R] and ``H`` [i_rows, R] f32 (row-major), ``eu/ei``
    int32 and ``ev`` f32 [NE, C], ``ou/oi`` int32 [NE]; ``schedule`` from
    :meth:`LevelSchedule.build` on the same entries (built here, with a
    readback, when None).  ``se`` is the sum of squared errors and ``cnt``
    the number of ratings visited.

    ``W'`` and ``H'`` are new tensors, as the reference's and the plain
    version's are: callers keep their inputs (the rotation pipeline's
    chunks, factors injected through ``convert``).  The copy moves
    2 × 4 B × (u_bound + i_rows) × R, 78 MB at ML-20M, about 0.05 ms of
    HBM time against a step of tens of ms."""
    NE, C = eu.shape
    R = W.shape[1]
    dev = W.device
    f32, i32 = (torch.float32,), (torch.int32,)
    build.require(W, "W", f32, (W.shape[0], R), dev)
    build.require(H, "H", f32, (H.shape[0], R), dev)
    for name, t, dt, shape in (("eu", eu, i32, (NE, C)),
                               ("ei", ei, i32, (NE, C)),
                               ("ev", ev, f32, (NE, C)),
                               ("ou", ou, i32, (NE,)), ("oi", oi, i32, (NE,))):
        build.require(t, name, dt, shape, dev)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")
    kw = dict(lr=lr, reg=reg, u_tile=u_tile, i_tile=i_tile,
              compute_dtype=compute_dtype, schedule=schedule)
    if dev.type == "cpu":
        return sgd_tile_update_plain(W, H, eu, ei, ev, ou, oi, **kw)
    if dev.type != "cuda":
        raise ValueError(f"sgd_tile_update runs on cuda or cpu, not {dev}")
    if schedule is None:
        schedule = LevelSchedule.build(eu, ei, ou, oi, u_tile, i_tile,
                                       W.shape[0], H.shape[0], dev)
    build.require(schedule.order, "schedule.order", i32,
                  tuple(schedule.order.shape), dev)
    lib = _lib()
    check_accumulator_fits(u_tile, i_tile, R, *_smem(lib, dev))
    offsets = np.ascontiguousarray(schedule.offsets, np.int32)
    with torch.cuda.device(dev):
        W2, H2 = W.clone(), H.clone()
        se = torch.zeros((NE,), dtype=torch.float32, device=dev)
        cnt = torch.zeros((NE,), dtype=torch.float32, device=dev)
        build.check(lib.sgd_tile_update(
            W2.data_ptr(), H2.data_ptr(), eu.data_ptr(), ei.data_ptr(),
            ev.data_ptr(), ou.data_ptr(), oi.data_ptr(),
            schedule.order.data_ptr(), offsets.ctypes.data,
            schedule.n_levels, C, R, u_tile, i_tile, float(lr), float(reg),
            int(compute_dtype == torch.bfloat16), se.data_ptr(),
            cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "sgd_tile_update launch")
    LAUNCHES["sgd_tile_update"] += 1
    return W2, H2, se.sum(), cnt.sum()
