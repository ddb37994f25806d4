"""LDA-CGS tile-entry resample: the port of ``harp_tpu.ops.lda_kernel``.

One rotation step resamples the topic of every token of one worker's
(doc range × resident word chunk) block, entry by entry.  An *entry* is up
to ``C`` tokens inside one ``d_tile × w_tile`` sub-tile
(``models.mfsgd.partition_ratings_tiles``): tile-local ids ``cd/cw [NE, C]``
(a pad slot has ``cd == d_tile``), current topics ``z [NE, C]`` and tile row
offsets ``od/ow [NE]``.

====  ==============================  ====================================
K4    :func:`cgs_entry_update`,       ``csrc/lda_cgs_entry.cu``; replaces
      :func:`cgs_step`                the TPU kernel ``cgs_entry_update``
====  ==============================  ====================================

Semantics kept from the TPU kernel:

- an entry is walked in chunks of ``cc`` tokens (:func:`chunk_width`, the
  reference's own rule, since ``cc`` decides which tokens share a
  snapshot).  Every token of a chunk samples against the same counts: the
  doc and word tiles and ``nk + dnk`` as the chunks before it left them;
  the chunk's ±1 deltas land after all of its tokens have read;
- per token and topic: ``a = max(ndk - old + α, 1e-10)``, ``b = max(nwk -
  old + β, 1e-10)``, ``c = max(nk - old + Vβ, 1e-10)`` and the exponential
  race ``ratio = (-log(u) · c) / (a · b)``, argmin with ties to the lowest
  topic; ``old`` is 1 at the token's current topic;
- ``exact_gathers=False`` rounds the gathered doc and word counts to bf16
  (the TPU's single-dot gather); the default reads them exactly (the TPU's
  base-256 planes are a matrix-unit device and are not needed here);
- a slot is masked by ``cd >= d_tile`` alone; a masked slot keeps its topic
  and changes nothing;
- uniforms: injected (``u [.., C, K]``, for checks against the reference)
  or drawn from Philox4x32-10 inside the kernel (``seeds [NE, 2]``): key
  ``(s0, s1 ^ chunk · 0x9E3779B9)``, counter ``(slot, topic // 4, 0, 0)``,
  ``u = (bits >> 8) · 2⁻²⁴ + 2⁻²⁵`` as on the TPU.  :func:`philox_uniforms`
  is the same generator in plain torch, so the plain version and the kernel
  agree bit for bit on both arms.

Counts are integers held in f32 (Nwk, Nk) and f32 or int16 (Ndk); every
delta is ±1, so the order of the kernel's atomics never changes a result.
The tables stay row-major ``[rows, K]`` (the reference's transposes are TPU
layout devices).  :func:`cgs_step` updates Ndk, the word chunk and ``z`` in
place (the port's choice: no copy of the tables per step).  The wrappers run
the plain version only for tensors on the CPU; for CUDA tensors they launch
K4 or raise.  On the card a step is one cooperative launch that walks every
chunk of every entry itself, with a grid barrier on each side of each
chunk's deltas.  :data:`LAUNCHES` counts those launches (one per rotation
step on the model's path).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from harp_tpu_torch.ops import build

#: K4 wrapper calls that launched the kernel since :func:`reset_launches`
LAUNCHES = {"cgs_entry_update": 0}

_LANE = 128
_VMEM_BUDGET = 14 << 20

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "cgs_step": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _I, _I, _F, _F, _F, _I, _P],
}
#: cudaErrorCooperativeLaunchTooLarge: the cc blocks cannot all be resident
_TOO_LARGE = 720
_BOUND: list[ctypes.CDLL] = []


def reset_launches() -> None:
    LAUNCHES["cgs_entry_update"] = 0


def _lib() -> ctypes.CDLL:
    if not _BOUND:
        _BOUND.append(build.bind("lda_cgs_entry", _SIGNATURES))
    return _BOUND[0]


def _is_int16(dtype) -> bool:
    return dtype in (torch.int16, "int16", np.int16) or (
        isinstance(dtype, np.dtype) and dtype == np.int16)


# ---- the chunk rule (the reference's, copied) -------------------------------

def planes_for(count_bound, int16: bool) -> int:
    """The reference's ``_planes_for``: base-256 digit planes of an exact
    gather, from a static count bound, else from what the dtype holds."""
    if count_bound is not None:
        if count_bound <= 256:
            return 1
        if count_bound < 2 ** 16:
            return 2
        return 3
    return 2 if int16 else 3


def chunk_width(K: int, d_tile: int, w_tile: int, C: int, ndk_dtype,
                exact_gathers: bool = True, count_bounds=(None, None),
                chunk_c: int = 256) -> int:
    """Tokens per snapshot chunk: the reference's rule exactly.

    It starts at ``min(C, chunk_c)`` and halves while the reference's VMEM
    estimate for the shape exceeds its 14 MB budget, down to 128; the port
    has no VMEM, but ``cc`` decides which tokens share a snapshot, so the
    two packages must agree.  Shapes the reference refuses are refused here
    too (the TPU-only multiple-of-128 checks are dropped)."""
    int16 = _is_int16(ndk_dtype)
    nd = planes_for(count_bounds[0], int16) if exact_gathers else 0
    nw = planes_for(count_bounds[1], False) if exact_gathers else 0

    def est(cc):
        per_elem = 6 if max(nd, nw) >= 2 else 2
        planes = per_elem * K * max(d_tile, w_tile) if exact_gathers else 0
        return ((2 if int16 else 4) + 4) * K * d_tile + 8 * K * w_tile \
            + 6 * 4 * K * cc + planes

    cc = min(C, chunk_c)
    while est(cc) > _VMEM_BUDGET and cc > _LANE and cc % 2 == 0:
        cc //= 2
    if C % cc:
        raise ValueError(f"C={C} must be a multiple of chunk_c={cc} "
                         f"(pad entries with d_tile/w_tile ids)")
    if est(cc) > _VMEM_BUDGET:
        raise ValueError(
            f"lda K4: the reference's ~{est(cc) >> 20} MB VMEM estimate "
            f"exceeds its 14 MB budget even at chunk {cc}, and both "
            f"packages refuse the shape; lower d_tile/w_tile or use "
            f"algo='dense'")
    return cc


# ---- Philox4x32-10 in plain torch -------------------------------------------

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a · m`` for uint32 values held in int64,
    without int64 overflow (``a`` is split into 16-bit halves)."""
    x = (a & 0xFFFF) * m            # < 2^48
    y = (a >> 16) * m               # < 2^48
    s = ((y & 0xFFFF) << 16) + x    # < 2^49
    return (y >> 16) + (s >> 32), s & _MASK


def philox_bits(c0, c1, k0, k1):
    """Philox4x32-10 of counters ``(c0, c1, 0, 0)`` under key ``(k0, k1)``
    (int64 tensors holding uint32, broadcast together); returns the four
    output words.  Ten rounds, the key bumped after each, as the kernel."""
    c0, c1 = torch.broadcast_tensors(c0, c1)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return c0, c1, c2, c3


def philox_uniforms(seed2: torch.Tensor, C: int, K: int, cc: int,
                    device=None) -> torch.Tensor:
    """The kernel's uniforms for one entry: ``[C, K]`` f32 in (0, 1].
    ``seed2`` holds two int32 words; slot ``s`` of chunk ``j = s // cc``
    draws topic ``k`` from word ``k % 4`` of Philox under key ``(s0, s1 ^
    j · 0x9E3779B9)`` at counter ``(s, k // 4)``."""
    dev = device if device is not None else seed2.device
    s = seed2.to(dev, torch.int64) & _MASK
    slot = torch.arange(C, device=dev, dtype=torch.int64)[:, None]
    grp = torch.arange(-(-K // 4), device=dev, dtype=torch.int64)[None, :]
    k1 = s[1] ^ (((slot // cc) * _W0) & _MASK)
    words = torch.stack(philox_bits(slot, grp, s[0], k1), dim=-1)
    bits = words.reshape(C, -1)[:, :K]
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25


# ---- K4: plain version ------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def cgs_entry_update_plain(Db, Wb, nk, z, cd, cw, u, *, alpha, beta, vbeta,
                           cc, exact_gathers=True):
    """Plain PyTorch version of K4 for one entry (module docstring).

    ``Db [d_tile, K]`` f32 or int16 and ``Wb [w_tile, K]`` f32 row-major
    tiles, ``nk [K]`` the topic totals the entry samples against, ``z, cd,
    cw [C]`` int32, ``u [C, K]`` uniforms in (0, 1].  Returns new tensors
    ``(Db', Wb', z', dnk)``."""
    DR, K = Db.shape
    WR = Wb.shape[0]
    C = z.shape[0]
    dev = Db.device
    Db, Wb, z_out = Db.clone(), Wb.clone(), z.clone()
    dnk = torch.zeros(K, dtype=torch.float32, device=dev)
    topics = torch.arange(K, device=dev)
    for j in range(0, C, cc):
        cdj, cwj, zj = cd[j:j + cc].long(), cw[j:j + cc].long(), \
            z[j:j + cc].long()
        m = cdj < DR
        rd = torch.where(m, cdj, 0)
        rw = torch.where(m, cwj, 0)
        oh_old = ((topics == zj[:, None]) & m[:, None]).to(torch.float32)
        gd, gw = Db[rd].to(torch.float32), Wb[rw]
        if not exact_gathers:
            gd, gw = _bf16(gd), _bf16(gw)
        a = torch.clamp_min((gd - oh_old) + alpha, 1e-10)
        b = torch.clamp_min((gw - oh_old) + beta, 1e-10)
        c = torch.clamp_min(((nk + dnk)[None, :] - oh_old) + vbeta, 1e-10)
        ratio = (-torch.log(u[j:j + cc])) * c / (a * b)
        best = ratio.min(dim=1, keepdim=True).values
        z_new = torch.where(ratio == best, topics, K).min(dim=1).values
        z_new = torch.where(m, z_new, zj)
        delta = ((topics == z_new[:, None]) & m[:, None]).to(
            torch.float32) - oh_old
        Db.index_add_(0, rd[m], delta[m].to(Db.dtype))
        Wb.index_add_(0, rw[m], delta[m])
        dnk += delta.sum(0)
        z_out[j:j + cc] = z_new.to(z_out.dtype)
    return Db, Wb, z_out, dnk


# ---- the entry plan (host) --------------------------------------------------

@dataclasses.dataclass
class EntryPlan:
    """Host facts of one block row's entries that K4 trusts: ``n_chunks``
    (int32 [NE]) is the number of ``cc``-chunks each entry runs, through
    its last real slot (trailing all-pad chunks change nothing and are not
    run; an entry without a token runs none).  The kernel reads them as
    :attr:`chunk_offsets`, copied to the card once per device."""

    n_chunks: np.ndarray
    cc: int
    d_rows: int  # the tables the offsets were checked against
    w_rows: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @property
    def chunks(self) -> int:
        """Chunks one :func:`cgs_step` call runs, in order, on the card."""
        return int(self.n_chunks.sum())

    @property
    def chunk_offsets(self) -> np.ndarray:
        """int32 [NE + 1]: entry ``e`` runs the step's chunks
        ``chunk_offsets[e]`` to ``chunk_offsets[e + 1]``."""
        return np.concatenate([[0], np.cumsum(self.n_chunks, dtype=np.int64)]
                              ).astype(np.int32)

    def offsets_on(self, device) -> torch.Tensor:
        """:attr:`chunk_offsets` on ``device``, copied there once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(self.chunk_offsets).to(
                device)
        return self._on_device[key]

    @classmethod
    def build(cls, cd, cw, od, ow, d_tile: int, w_tile: int, d_rows: int,
              w_rows: int, cc: int) -> "EntryPlan":
        """Check real slots' ids inside their tiles and the tiles of entries
        with a token inside the tables, and count each entry's chunks."""
        cd, cw, od, ow = (np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                     else a) for a in (cd, cw, od, ow))
        NE, C = cd.shape
        if C % cc:
            raise ValueError(f"C={C} is not a multiple of cc={cc}")
        real = cd < d_tile
        if (cd[real] < 0).any() or ((cw < 0) | (cw >= w_tile))[real].any():
            raise ValueError("entry ids out of their tiles")
        has = real.any(axis=1)
        if has.any() and (od[has].min() < 0 or ow[has].min() < 0
                          or od[has].max() + d_tile > d_rows
                          or ow[has].max() + w_tile > w_rows):
            raise ValueError(f"an entry's tile lies outside Ndk ({d_rows} "
                             f"rows) or the word chunk ({w_rows} rows)")
        last = np.where(has, C - 1 - np.argmax(real[:, ::-1], axis=1), -1)
        return cls(((last + cc) // cc).astype(np.int32), cc, d_rows, w_rows)


# ---- step level -------------------------------------------------------------

def block_smem(n_topics: int) -> int:
    """The dynamic shared memory of one K4 block, as ``cgs_step``'s launch
    asks it: the -log(u) row of the block's slot, one float a topic."""
    return 4 * int(n_topics)


def cgs_step_plain(Ndk, Nwk, nk, z, cd, cw, od, ow, *, alpha, beta, vbeta,
                   d_tile, w_tile, cc, exact_gathers=True, u=None,
                   seeds=None):
    """Plain version of :func:`cgs_step`: the entries in order through
    :func:`cgs_entry_update_plain`, each against ``nk`` plus the deltas of
    the entries before it.  Updates ``Ndk``, ``Nwk`` and ``z`` in place and
    returns the step's topic-total deltas ``dNk [K]``."""
    NE, C = cd.shape
    K = Ndk.shape[1]
    nk_run = nk.clone()
    od_h, ow_h = od.cpu().tolist(), ow.cpu().tolist()
    kw = dict(alpha=alpha, beta=beta, vbeta=vbeta, cc=cc,
              exact_gathers=exact_gathers)
    for e in range(NE):
        if not bool((cd[e] < d_tile).any()):
            continue  # no token: the entry changes nothing
        ue = u[e] if u is not None else philox_uniforms(seeds[e], C, K, cc)
        Db = Ndk[od_h[e]:od_h[e] + d_tile]
        Wb = Nwk[ow_h[e]:ow_h[e] + w_tile]
        Db2, Wb2, z2, dnk = cgs_entry_update_plain(
            Db, Wb, nk_run, z[e], cd[e], cw[e], ue, **kw)
        Db.copy_(Db2)
        Wb.copy_(Wb2)
        z[e].copy_(z2)
        nk_run += dnk
    return nk_run - nk


def _check_step_args(Ndk, Nwk, nk, z, cd, cw, od, ow, u, seeds):
    NE, C = cd.shape
    K = Ndk.shape[1]
    dev = Ndk.device
    i32 = (torch.int32,)
    build.require(Ndk, "Ndk", (torch.float32, torch.int16), tuple(Ndk.shape),
                  dev)
    build.require(Nwk, "Nwk", (torch.float32,), (Nwk.shape[0], K), dev)
    build.require(nk, "nk", (torch.float32,), (K,), dev)
    for name, t in (("z", z), ("cd", cd), ("cw", cw)):
        build.require(t, name, i32, (NE, C), dev)
    build.require(od, "od", i32, (NE,), dev)
    build.require(ow, "ow", i32, (NE,), dev)
    if (u is None) == (seeds is None):
        raise ValueError("pass exactly one of u (injected uniforms) and "
                         "seeds (the kernel's Philox)")
    if u is not None:
        build.require(u, "u", (torch.float32,), (NE, C, K), dev)
    else:
        build.require(seeds, "seeds", i32, (NE, 2), dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K4 runs on cuda or cpu, not {dev}")


def cgs_step(Ndk, Nwk, nk, z, cd, cw, od, ow, *, alpha, beta, vbeta, d_tile,
             w_tile, cc, exact_gathers=True, u=None, seeds=None,
             plan: EntryPlan | None = None):
    """One rotation step of K4 → ``dNk [K]`` f32.

    ``Ndk [d_rows, K]`` (f32 or int16) and the resident word chunk ``Nwk
    [w_rows, K]`` (f32) are updated in place, as is ``z [NE, C]`` (int32);
    ``cd/cw [NE, C]`` and ``od/ow [NE]`` int32; ``nk [K]`` the topic totals
    at the step's start (not modified).  Uniforms come from ``u [NE, C,
    K]`` or from the kernel's Philox under ``seeds [NE, 2]`` int32.  Entry
    ``e`` samples against ``nk`` plus the deltas of entries ``< e``.
    ``plan`` from :meth:`EntryPlan.build` on the same entries (built here,
    with a readback, when None).  On CUDA this is one cooperative launch on
    the current stream, which runs the plan's chunks in order; it raises if
    the card cannot hold all ``cc`` blocks at once."""
    _check_step_args(Ndk, Nwk, nk, z, cd, cw, od, ow, u, seeds)
    kw = dict(alpha=alpha, beta=beta, vbeta=vbeta, d_tile=d_tile,
              w_tile=w_tile, cc=cc, exact_gathers=exact_gathers)
    dev = Ndk.device
    if dev.type == "cpu":
        return cgs_step_plain(Ndk, Nwk, nk, z, cd, cw, od, ow, u=u,
                              seeds=seeds, **kw)
    if plan is None:
        plan = EntryPlan.build(cd, cw, od, ow, d_tile, w_tile, Ndk.shape[0],
                               Nwk.shape[0], cc)
    if (plan.cc, plan.d_rows, plan.w_rows) != (
            cc, Ndk.shape[0], Nwk.shape[0]) or plan.n_chunks.shape != (
            cd.shape[0],):
        raise ValueError("plan was built for other entries, tables or cc")
    if Ndk.dtype == torch.int16 and Ndk.data_ptr() % 4:
        raise ValueError("an int16 Ndk must start on a 4-byte boundary "
                         "(its atomics work on aligned 32-bit words)")
    NE, C = cd.shape
    K = Ndk.shape[1]
    lib = _lib()
    with torch.cuda.device(dev):
        offsets = plan.offsets_on(dev)
        nk_run = nk.clone()
        bar = torch.zeros(1, dtype=torch.int64, device=dev)
        err = lib.cgs_step(
            Ndk.data_ptr(), int(Ndk.dtype == torch.int16), Nwk.data_ptr(),
            nk_run.data_ptr(), z.data_ptr(), cd.data_ptr(), cw.data_ptr(),
            od.data_ptr(), ow.data_ptr(),
            u.data_ptr() if u is not None else None,
            seeds.data_ptr() if seeds is not None else None,
            offsets.data_ptr(), bar.data_ptr(), NE, C, K, cc, d_tile, w_tile,
            float(alpha), float(beta), float(vbeta),
            int(bool(exact_gathers)),
            torch.cuda.current_stream(dev).cuda_stream)
        if err == _TOO_LARGE:
            raise RuntimeError(f"cgs_step: the card cannot hold cc={cc} "
                               "blocks at once for one cooperative launch")
        build.check(err, "cgs_step launch")
    LAUNCHES["cgs_entry_update"] += 1
    return nk_run - nk


def cgs_entry_update(Db, Wb, nk, z, cd, cw, *, alpha, beta, vbeta, cc,
                     exact_gathers=True, u=None, seed2=None):
    """K4 on one entry → new ``(Db', Wb', z', dnk)``, the reference's
    functional contract: ``Db [d_tile, K]`` f32/int16, ``Wb [w_tile, K]``
    f32, ``nk [K]``, ``z/cd/cw [C]`` int32, and either ``u [C, K]`` or
    ``seed2 [2]`` int32 (Philox).  The inputs are not modified."""
    dev = Db.device
    Db2, Wb2, z2 = Db.clone(), Wb.clone(), z.clone()
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    dnk = cgs_step(
        Db2, Wb2, nk, z2[None], cd[None], cw[None], zero, zero,
        alpha=alpha, beta=beta, vbeta=vbeta, d_tile=Db.shape[0],
        w_tile=Wb.shape[0], cc=cc, exact_gathers=exact_gathers,
        u=None if u is None else u[None],
        seeds=None if seed2 is None else seed2.reshape(1, 2))
    return Db2, Wb2, z2, dnk
