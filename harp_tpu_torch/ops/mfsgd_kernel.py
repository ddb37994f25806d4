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
  host-side schedule (:class:`LevelSchedule`) gives each entry with a
  rating its two predecessors, the previous entry with the same ou and the
  previous entry with the same oi, and the level ``1 + max(level of
  either)``.  An entry that runs after both predecessors have applied gets
  the inputs the sequential order gives it.  The plain version runs level
  by level (entries of one level touch distinct W tiles and distinct H
  tiles); the kernel runs the entries in dataflow order, each as soon as
  its two predecessors are done.  Entries without a rating change nothing
  and are not scheduled (the TPU's coverage entries are not needed).

W and H stay row-major ``[rows, rank]`` (no transposes, no one-hot
operands: those are TPU layout devices).  The wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches K3 or
raises.  :data:`LAUNCHES` counts wrapper calls that launched K3: one per
rotation step, each one CUDA launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from harp_tpu_torch.ops import build

#: K3 wrapper calls that launched the kernel since :func:`reset_launches`
LAUNCHES = {"sgd_tile_update": 0}

#: blocks in a thread-block cluster: one entry runs on one cluster
CLUSTER = 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sgd_tile_update_init": [ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "sgd_tile_update_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    "sgd_tile_update": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P],
}
_BOUND: list[ctypes.CDLL] = []
#: per card index: (shared memory a block may use, the kernel's static part)
_SMEM: dict[int, tuple[int, int]] = {}
#: per (card index, cluster, shared bytes, bf16): clusters the card holds
_PLANS: dict[tuple, int] = {}
#: launch shapes that passed the fit gates (:func:`_gate`)
_FITS: set[tuple] = set()


def reset_launches() -> None:
    LAUNCHES["sgd_tile_update"] = 0


def _lib() -> ctypes.CDLL:
    if not _BOUND:
        _BOUND.append(build.bind("mfsgd_tile_update", _SIGNATURES))
    return _BOUND[0]


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _smem(lib: ctypes.CDLL, dev: torch.device) -> tuple[int, int]:
    """The card's shared-memory limit a block and K3's static shared bytes,
    asked once per card (which also lets K3 take the rest dynamically)."""
    idx = _index(dev)
    if idx not in _SMEM:
        limit, static = _I(), _I()
        with torch.cuda.device(idx):
            build.check(lib.sgd_tile_update_init(ctypes.byref(limit),
                                                 ctypes.byref(static)),
                        "sgd_tile_update_init")
        _SMEM[idx] = (limit.value, static.value)
    return _SMEM[idx]


def _clusters(lib: ctypes.CDLL, dev: torch.device, cluster: int, smem: int,
              bf16: int) -> int:
    """How many clusters of K3 the card holds at once, asked once per
    shape of launch; raises when it holds none."""
    key = (_index(dev), cluster, smem, bf16)
    if key not in _PLANS:
        n = _I()
        with torch.cuda.device(key[0]):
            build.check(lib.sgd_tile_update_plan(cluster, smem, bf16,
                                                 ctypes.byref(n)),
                        "sgd_tile_update_plan")
        if n.value < 1:
            raise RuntimeError(f"mfsgd K3: this card cannot hold a cluster "
                               f"of {cluster} blocks with {smem} bytes of "
                               f"shared memory each")
        _PLANS[key] = n.value
    return _PLANS[key]


def _gate(dev: torch.device, smem: int, limit: int, nbytes: int) -> None:
    """The fit gates of one launch shape, held once a shape (the free
    device memory is read then): a block's shared memory (with the static
    part) against the card's limit, and the launch's buffers against the
    free device memory.  A refused shape raises ``MemoryError`` before
    anything is allocated or launched."""
    from harp_tpu_torch.utils import memrec

    key = (_index(dev), smem, limit, nbytes)
    if key not in _FITS:
        memrec.require_smem_fit("mfsgd.sgd_tile_update", smem, budget=limit)
        memrec.require_hbm_fit("mfsgd.sgd_tile_update", nbytes,
                               device=key[0])
        _FITS.add(key)


# ---- the schedule (host) ------------------------------------------------------

def entry_dependencies(eu, ou, oi, u_tile: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """``(level, prev)`` of every entry of one block row: ``prev[e]`` holds
    the previous entry with the same ou and the previous entry with the
    same oi (-1 if none), ``level[e] = 1 + max(level of either)`` (levels
    from 0, -1 for a predecessor that does not exist).  An entry without a
    rating gets level -1 and no place in either chain."""
    real = (np.asarray(eu) < u_tile).any(axis=-1)
    ou_l, oi_l = np.asarray(ou).tolist(), np.asarray(oi).tolist()
    level = np.full(real.shape[0], -1, np.int64)
    prev = np.full((real.shape[0], 2), -1, np.int64)
    last_u: dict[int, int] = {}
    last_i: dict[int, int] = {}
    for e in np.flatnonzero(real).tolist():
        pu, pi = last_u.get(ou_l[e], -1), last_i.get(oi_l[e], -1)
        prev[e] = pu, pi
        level[e] = 1 + max(level[pu] if pu >= 0 else -1,
                           level[pi] if pi >= 0 else -1)
        last_u[ou_l[e]] = last_i[oi_l[e]] = e
    return level, prev


def entry_sorts(eu, ei, u_tile: int, i_tile: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """For each entry (rows of ``eu/ei`` [n, C]): its real slots sorted by
    W row and by H row, stably → ``(sort int32 [n, 5, C], n_real int32
    [n])``.  ``sort[e, 0]`` lists the slots by W row (the real ones
    first) and ``sort[e, 1, j]`` is the first position of the run of
    ``sort[e, 0, j]``'s row; ``sort[e, 2]`` and ``sort[e, 3]`` likewise by
    H row; ``sort[e, 4, j]`` is the position of slot ``sort[e, 2, j]`` in
    the W order."""
    eu, ei = np.asarray(eu), np.asarray(ei)
    real = eu < u_tile
    n, C = eu.shape
    out = np.empty((n, 5, C), np.int32)
    pos = np.arange(C)
    for q, (ids, pad) in enumerate(((eu, u_tile), (ei, i_tile))):
        key = np.where(real, ids, pad).astype(np.int64)
        by = np.argsort(key, axis=1, kind="stable")
        ks = np.take_along_axis(key, by, axis=1)
        new = np.ones(ks.shape, bool)
        new[:, 1:] = ks[:, 1:] != ks[:, :-1]
        out[:, 2 * q] = by
        out[:, 2 * q + 1] = np.maximum.accumulate(np.where(new, pos, 0),
                                                  axis=1)
    upos = np.empty((n, C), np.int32)
    np.put_along_axis(upos, out[:, 0].astype(np.int64),
                      np.broadcast_to(pos, (n, C)), axis=1)
    out[:, 4] = np.take_along_axis(upos, out[:, 2].astype(np.int64), axis=1)
    return out, real.sum(axis=1).astype(np.int32)


@dataclasses.dataclass
class LevelSchedule:
    """The scheduled entries (those with a rating) in a topological order:
    ``order`` (int32, on the entries' device) lists them level by level,
    in entry order within a level; level ``l`` is
    ``order[offsets[l]:offsets[l + 1]]``.  ``pred`` (int32 ``[n_scheduled,
    2]``, on the device) holds, for each position of ``order``, the
    positions of the previous entry with the same ou and of the previous
    entry with the same oi (-1 if none): the kernel runs an entry once both
    are done.  ``sort`` and ``n_real`` (on the device) are
    :func:`entry_sorts` of the entries in ``order``: the kernel splits an
    entry's ratings by row with them.  ``offsets`` stays on the host: the
    plain version's level loop reads it there.  Built once per
    ``set_ratings``: 4·C + 4 int32 per entry with a rating plus one per
    level."""

    order: torch.Tensor
    offsets: np.ndarray  # int32 [n_levels + 1]
    pred: torch.Tensor
    sort: torch.Tensor
    n_real: torch.Tensor

    @property
    def n_levels(self) -> int:
        """The critical path: the longest chain of dependent entries."""
        return len(self.offsets) - 1

    @property
    def max_width(self) -> int:
        return int(np.diff(self.offsets).max(initial=0))

    @classmethod
    def build(cls, eu, ei, ou, oi, u_tile: int, i_tile: int, w_rows: int,
              h_rows: int, device) -> "LevelSchedule":
        """The schedule of one block row (host arrays or tensors).  Checks
        what the kernel trusts: real slots' ids inside their tiles,
        scheduled tiles aligned to the tile size (the chains are keyed on
        the offsets, so two overlapping unaligned tiles could run at once)
        and inside W and H."""
        eu, ei, ou, oi = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                     else a) for a in (eu, ei, ou, oi))
        level, prev = entry_dependencies(eu, ou, oi, u_tile)
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
        order = sel[np.argsort(level[sel], kind="stable")]
        pos = np.full(len(level) + 1, -1, np.int64)  # pos[-1] stays -1
        pos[order] = np.arange(len(order))
        pred = pos[prev[order]].astype(np.int32).reshape(-1, 2)
        counts = np.bincount(level[sel], minlength=0)
        offsets = np.zeros(len(counts) + 1, np.int32)
        offsets[1:] = np.cumsum(counts)
        sort, n_real = entry_sorts(eu[order], ei[order], u_tile, i_tile)
        T = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return cls(T(order.astype(np.int32)), offsets, T(pred), T(sort),
                   T(n_real))


# ---- K3: plain version ----------------------------------------------------------

def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def entries_update_plain(W, H, E, eu, ei, ev, ou, oi, *, lr, reg, u_tile,
                         i_tile, compute_dtype):
    """The plain per-entry math on entries ``E`` (int64, touching distinct
    W tiles and distinct H tiles), vectorised over them: W and H updated
    in place, one apply an entry from the entry-start tiles.  Returns
    ``(err, cm)`` [len(E), C]: each slot's error and real-slot mask."""
    cd = compute_dtype
    dev = W.device
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
    rows_w = (tou + torch.arange(u_tile, device=dev)).reshape(-1)
    rows_h = (toi + torch.arange(i_tile, device=dev)).reshape(-1)
    W[rows_w] = W[rows_w] + lr * acc_w
    H[rows_h] = H[rows_h] + lr * acc_h
    return err, cm


def sgd_tile_update_plain(W, H, eu, ei, ev, ou, oi, *, lr, reg, u_tile,
                          i_tile, compute_dtype=torch.bfloat16,
                          schedule: LevelSchedule | None = None):
    """Plain PyTorch version of K3 (same arguments and results), one level
    at a time, vectorised over the level's entries."""
    if schedule is None:
        schedule = LevelSchedule.build(eu, ei, ou, oi, u_tile, i_tile,
                                       W.shape[0], H.shape[0], W.device)
    W, H = W.clone(), H.clone()
    se = torch.zeros((), dtype=torch.float32, device=W.device)
    cnt = torch.zeros((), dtype=torch.float32, device=W.device)
    for lo, hi_ in zip(schedule.offsets[:-1].tolist(),
                       schedule.offsets[1:].tolist()):
        err, cm = entries_update_plain(
            W, H, schedule.order[lo:hi_].long(), eu, ei, ev, ou, oi, lr=lr,
            reg=reg, u_tile=u_tile, i_tile=i_tile,
            compute_dtype=compute_dtype)
        se = se + (err * err).sum()
        cnt = cnt + cm.sum()
    return W, H, se, cnt


# ---- K3: the wrapper ---------------------------------------------------------------

def block_bytes(u_tile: int, i_tile: int, rank: int, C: int,
                cluster: int) -> int:
    """Dynamic shared memory of one K3 block: its rows (rows ``r % cluster
    == block`` of the W tile and of the H tile, f32), then, for entries of
    C > 0 slots, a flag for each W row and the entry's ratings in its two
    sorts (36 bytes a slot)."""
    u_rows = -(-u_tile // cluster)
    rows = u_rows + -(-i_tile // cluster)
    return rows * rank * 4 + (u_rows * 4 + 36 * C if C else 0)


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
    2 × 4 B × (u_bound + i_rows) × R, 78 MB at ML-20M: a bound of about
    0.05 ms at the H100's HBM rate against a step of milliseconds."""
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
    n = schedule.order.numel()
    build.require(schedule.order, "schedule.order", i32, (n,), dev)
    build.require(schedule.pred, "schedule.pred", i32, (n, 2), dev)
    build.require(schedule.sort, "schedule.sort", i32, (n, 5, C), dev)
    build.require(schedule.n_real, "schedule.n_real", i32, (n,), dev)
    lib = _lib()
    limit, static = _smem(lib, dev)
    cl = CLUSTER
    smem = block_bytes(u_tile, i_tile, R, C, cl)
    # W', H', the work counter and the per-block se and cnt
    _gate(dev, smem + static, limit,
          4 * (W.numel() + H.numel()) + 4 * (1 + n) + 8 * n * cl)
    bf16 = int(compute_dtype == torch.bfloat16)
    clusters = min(_clusters(lib, dev, cl, smem, bf16), n) if n else 0
    with torch.cuda.device(dev):
        W2, H2 = W.clone(), H.clone()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if n == 0:
            return W2, H2, zero, zero.clone()
        work = torch.zeros((1 + n,), dtype=torch.int32, device=dev)
        se = torch.empty((n * cl,), dtype=torch.float32, device=dev)
        cnt = torch.empty_like(se)
        build.check(lib.sgd_tile_update(
            W2.data_ptr(), H2.data_ptr(), eu.data_ptr(), ei.data_ptr(),
            ev.data_ptr(), ou.data_ptr(), oi.data_ptr(),
            schedule.order.data_ptr(), schedule.pred.data_ptr(),
            schedule.sort.data_ptr(), schedule.n_real.data_ptr(), n, C, R,
            u_tile, i_tile, float(lr), float(reg), bf16, cl, clusters, smem,
            work.data_ptr(), se.data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            "sgd_tile_update launch")
    LAUNCHES["sgd_tile_update"] += 1
    return W2, H2, se.sum(), cnt.sum()
