"""Registry of the port's Hopper kernels K1-K8, and their bounds: the port
of ``harp_tpu.ops.kernel_registry``.

Each kernel registers, under the reference's name, a **build function** that
takes a ``device`` and returns ``(fn, args)`` at a small registered
shape: ``fn`` is the port's wrapper with its keyword arguments bound,
``args`` its seeded inputs on that device.  On the CPU the wrapper runs
its plain version; on the card it launches the kernel (once a call, as
:data:`KERNEL_INFO`'s ``launches`` says) and :func:`plain_of` gives the
plain version of the same call, to hold it against within the kernel's
class of agreement (``tol``).

Registration requires the kernel's work at that shape, each a positive
int: ``flops`` (the operations the Hopper kernel does), ``min_hbm_bytes``
(its inputs read once and its outputs written once) and ``smem_bytes``
(the dynamic shared memory a block takes on an H100, from the wrapper's
own plan or the source's launch configuration: the card's counterpart of
the reference's ``vmem_bytes``; it must fit the card's 227 KiB opt-in
limit).  The counts are the Hopper kernels', not the TPU formulation's:
each entry's comment says how they differ from the reference's.

The bounds of ``chip_smoke.py``'s kernels line live here too
(:func:`bound_ms` and the ``k*_bound_ms`` functions): the least time the
card could take for a call, the larger of its bytes over the HBM rate and
its operations over the peak of their type (:mod:`harp_tpu_torch.utils.
roofline` holds the rates).  K3's, K4's and K7's work depends on the data,
so their bounds take counts made from the call's inputs (:func:`k3_work`,
:func:`k4_work`, a nonzero-weight count).

Build functions import the wrappers lazily: importing this module builds and
launches nothing.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Callable

import numpy as np

from harp_tpu_torch.utils.roofline import (HBM_BYTES_S, PEAK_OPS, SFU_OPS_S,
                                           SMEM_UPDATES_S)

#: the H100's opt-in shared memory a block (232,448 bytes) and its SMs:
#: the card the registered ``smem_bytes`` are planned for
H100_SMEM_OPTIN, H100_SMS = 227 * 1024, 132

# name -> build function(device) returning (fn, args)
KERNELS: dict[str, Callable[[Any], tuple[Callable, tuple[Any, ...]]]] = {}

#: name -> {"flops", "min_hbm_bytes", "smem_bytes"} at the build function's shape
KERNEL_WORK: dict[str, dict] = {}

#: name -> {"kernel": "K1".."K8", "module", "counter" (its LAUNCHES key),
#: "launches" (a call's), "plain" (the plain version's name in module),
#: "tol" (rtol, atol), "source", "replaces"}
KERNEL_INFO: dict[str, dict] = {}

_WORK_FIELDS = ("flops", "min_hbm_bytes", "smem_bytes")


def register_kernel(name: str, *, flops: int, min_hbm_bytes: int,
                    smem_bytes: int, kernel: str, module: str, counter: str,
                    plain: str, tol: tuple[float, float], source: str,
                    replaces: str, launches: int = 1):
    """Register a kernel's build function with its work at its registered shape.

    The work fields are mandatory: a kernel that cannot state its
    operations, HBM floor and shared memory at its own shape raises here,
    when this module is imported."""
    work = {"flops": flops, "min_hbm_bytes": min_hbm_bytes,
            "smem_bytes": smem_bytes}
    for k in _WORK_FIELDS:
        v = work[k]
        if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
            raise ValueError(
                f"kernel {name!r}: work field {k}={v!r} must be a positive "
                "int — declare the kernel's work at its registered shape "
                "(see the module docstring)")
    if smem_bytes > H100_SMEM_OPTIN:
        raise ValueError(f"kernel {name!r}: {smem_bytes} bytes of shared "
                         f"memory exceed the H100's {H100_SMEM_OPTIN}")

    def deco(build):
        KERNELS[name] = build
        KERNEL_WORK[name] = work
        KERNEL_INFO[name] = {"kernel": kernel, "module": module,
                             "counter": counter, "launches": launches,
                             "plain": plain, "tol": tol, "source": source,
                             "replaces": replaces}
        return build
    return deco


def wrapper_module(name: str):
    """The module of ``name``'s wrapper (its ``LAUNCHES`` counts it)."""
    return importlib.import_module(KERNEL_INFO[name]["module"])


def plain_of(name: str, fn: functools.partial) -> Callable:
    """The plain version of the registered call ``fn``: the same bound
    keywords, on the same arguments."""
    plain = getattr(wrapper_module(name), KERNEL_INFO[name]["plain"])
    return functools.partial(plain, *fn.args, **fn.keywords)


# ---- bounds ---------------------------------------------------------------

def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the larger of ``nbytes`` at the HBM
    rate and ``ops`` at the peak of ``kind`` ("int8", "bf16", "f32")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound_of(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k12_bytes(n: int, d: int, k: int, int8: bool) -> int:
    """K1's or K2's inputs read once and outputs written once.  K1 reads
    int8 points and centroids and its f32 scalars (c_scale and c2 a
    centroid, col_scale a feature); K2 reads f32 points and centroids only
    (its wrapper derives c2).  Both write the [k, d] sums, the counts and
    the best-score sum (4 bytes each)."""
    if int8:
        nbytes = n * d + k * d + 4 * (2 * k + d)
    else:
        nbytes = 4 * n * d + 4 * k * d
    return nbytes + 4 * (k * d + k + 1)


def k12_ops(n: int, d: int, k: int) -> int:
    """K1's or K2's operations at (n, d, k): 2 n k d tensor-core MMA
    operations (int8 or bf16) for the scores and n d adds on the CUDA
    cores for the column-owned sums.  The reference counts 4 n d k: its
    sums are a one-hot matmul on the MXU."""
    return 2 * n * k * d + n * d


def k12_bound_ms(n: int, d: int, k: int, int8: bool) -> tuple[float, str]:
    """K1's or K2's least time at (n, d, k): :func:`k12_bytes`, and 2 n k d
    tensor-core operations (int8 or bf16)."""
    return bound_ms(k12_bytes(n, d, k, int8), 2.0 * n * k * d,
                    "int8" if int8 else "bf16")


def distinct_rows(ids, real, tile) -> int:
    """Sum over entries (rows of ``ids`` [NE, C]) of the distinct tile rows
    that the entry's real slots touch."""
    s = np.sort(np.where(real, ids, tile), axis=-1)
    new = np.ones(s.shape, bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return int((new & (s < tile)).sum())


def k3_work(eu, ei, u_tile, i_tile) -> dict:
    """What one rotation step's entries ask of K3, counted from the data:
    slots, real ratings, and the distinct W and H tile rows of each entry
    summed over the entries (rows no rating of an entry touches keep a zero
    gradient and need no apply)."""
    eu, ei = np.asarray(eu), np.asarray(ei)
    real = eu < u_tile
    return {"entries": eu.shape[0], "slots": eu.size,
            "ratings": int(real.sum()),
            "rows": distinct_rows(eu, real, u_tile)
            + distinct_rows(ei, real, i_tile)}


def k3_bytes(work: dict, u_bound: int, h_rows: int, rank: int) -> int:
    """K3's bytes for one step: eu for every slot (4 bytes: it marks the
    pads), ei and ev for the real ratings (8 bytes), ou and oi once, and W
    and H read and written once."""
    return (4 * work["slots"] + 8 * work["ratings"] + 8 * work["entries"]
            + 2 * 4 * (u_bound + h_rows) * rank)


def k3_ops(work: dict, rank: int) -> float:
    """10 f32 flops a rating and rank element (dot 2, the two gradients 3
    each, their two sums 2) plus the apply, 2 a rank element of each
    distinct row an entry touches."""
    return 10.0 * work["ratings"] * rank + 2.0 * work["rows"] * rank


def k3_bound_ms(work, u_bound, h_rows, rank) -> tuple[float, str]:
    """K3's least time for one rotation step: :func:`k3_bytes`, and
    :func:`k3_ops` on the CUDA cores (67 TFLOP/s f32)."""
    return bound_ms(k3_bytes(work, u_bound, h_rows, rank),
                    k3_ops(work, rank), "f32")


def k4_work(ed, d_tile) -> dict:
    """What one rotation step's entries ask of K4, counted from the data."""
    ed = np.asarray(ed)
    real = ed < d_tile
    return {"entries": ed.shape[0], "slots": ed.size,
            "tokens": int(real.sum())}


def k4_bytes(work: dict, ndk_bytes: int, nwk_bytes: int, K: int) -> int:
    """cd for every slot (4 B: it marks the pads), cw and z read and z
    written for the real tokens (12 B), od/ow and the two seed words per
    entry (16 B), nk read and written, and Ndk and the word chunk read and
    written once."""
    return (4 * work["slots"] + 12 * work["tokens"] + 16 * work["entries"]
            + 8 * K + 2 * (ndk_bytes + nwk_bytes))


def k4_bound_ms(work, ndk_bytes, nwk_bytes, K) -> tuple[float, str]:
    """K4's least time for one rotation step: :func:`k4_bytes`, and ~10
    f32 operations per real token and topic (three gathers less the own
    assignment, three prior adds and clamps, the ratio's two products and
    one division, the compare) on the CUDA cores at 67 TFLOP/s beside one
    log each on the special-function units (SFU_OPS_S); the two run side
    by side, so the slower one bounds."""
    el = work["tokens"] * K
    return _bound_of(k4_bytes(work, ndk_bytes, nwk_bytes, K) / HBM_BYTES_S,
                     max(10.0 * el / PEAK_OPS["f32"], el / SFU_OPS_S))


def k5_bytes(n: int, d: int, x_itemsize: int) -> int:
    """x once, y and sw, w and b in; gw and gs out."""
    return n * d * x_itemsize + 8 * n + 8 * d + 8


def k5_bound_ms(n: int, d: int, x_itemsize: int) -> tuple[float, str]:
    """K5's least time: :func:`k5_bytes`, and 4 f32 operations an element
    (the margin's multiply-add, the gradient's)."""
    return bound_ms(k5_bytes(n, d, x_itemsize), 4.0 * n * d, "f32")


def k6_bytes(n_loc: int, N: int, dim: int, dsize: int) -> int:
    """δ once, X, Xl and the row mask in, the block out."""
    return n_loc * N * dsize + 4 * (N * dim + 2 * n_loc * dim + n_loc)


def k6_bound_ms(n_loc: int, N: int, dim: int, dsize: int
                ) -> tuple[float, str]:
    """K6's least time: :func:`k6_bytes`; ~20 f32 operations a pair on
    the CUDA cores and one sqrt and one division a pair on the
    special-function units, side by side."""
    pairs = n_loc * N
    return _bound_of(k6_bytes(n_loc, N, dim, dsize) / HBM_BYTES_S,
                     max(20.0 * pairs / PEAK_OPS["f32"],
                         2.0 * pairs / SFU_OPS_S))


def k7_bytes(n: int, f: int, T: int, R: int, B: int,
             bin_bytes: int = 1) -> int:
    """The bins once, the row codes and weights of every tree in, the [T,
    R, f·B] int32 histogram out."""
    return n * f * bin_bytes + 8 * T * n + 4 * T * R * f * B


def k7_bound_ms(n: int, f: int, T: int, R: int, B: int, nnz: int,
                bin_bytes: int = 1) -> tuple[float, str]:
    """K7's least time for one level: :func:`k7_bytes`, or one
    shared-memory update a weighted increment (a nonzero (tree, sample)
    weight times each feature: ``nnz`` of them), at one 4-byte update per
    bank and clock (SMEM_UPDATES_S), where that is larger."""
    return _bound_of(k7_bytes(n, f, T, R, B, bin_bytes) / HBM_BYTES_S,
                     nnz * f / SMEM_UPDATES_S)


def k8_pairs(n: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps in one folded row of length n."""
    q = np.arange(n, dtype=np.int64)
    if causal:
        lo = np.zeros_like(q) if window is None else np.maximum(
            q - window + 1, 0)
        return int((q - lo + 1).sum())
    if window is None:
        return n * n
    return int((np.minimum(q + window - 1, n - 1)
                - np.maximum(q - window + 1, 0) + 1).sum())


def k8_bound_ms(bh: int, n: int, d: int, bf16: bool, causal: bool,
                window: int | None) -> tuple[float, str]:
    """K8's least time: q, k, v read and o written once; 4·d flops (the two
    products) for each kept pair, at the tensor-core rate for bf16 and the
    CUDA cores' f32 rate for f32."""
    nbytes = 4 * bh * n * d * (2 if bf16 else 4)
    ops = 4.0 * d * k8_pairs(n, causal, window) * bh
    return bound_ms(nbytes, ops, "bf16" if bf16 else "f32")


# ---- the registered shapes ------------------------------------------------

def _gen(seed: int):
    import torch

    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _on(device, *xs):
    return tuple(x.to(device) for x in xs)


# kmeans.partials at (n=128, d=256, k=8), f32 points: K2.  flops =
# k12_ops; bytes = k12_bytes; smem = the main kernel's block in the fused
# plan that km::make_plan (csrc/kmeans_tiles.cuh) makes for this shape on
# an H100, as the plan's smem field reads it there (chip_smoke.py's phase
# 44 holds this figure to the card's plan).
_KM_N, _KM_D, _KM_K = 128, 256, 8


@register_kernel("kmeans.partials",
                 flops=k12_ops(_KM_N, _KM_D, _KM_K),
                 min_hbm_bytes=k12_bytes(_KM_N, _KM_D, _KM_K, False),
                 smem_bytes=218_528,
                 kernel="K2", module="harp_tpu_torch.ops.kmeans_kernel",
                 counter="kmeans_partials", plain="kmeans_partials_plain",
                 # sums within 1e-5 · max|x| · max count (|x| < 8, 128
                 # points), inertia in f32 order: PERF.md §2's K2 class
                 tol=(1e-5, 1e-2),
                 source="harp_tpu_torch/csrc/kmeans_partials.cu",
                 replaces="harp_tpu/ops/kmeans_kernel.py:110")
def _kmeans_f32(device):
    import torch

    from harp_tpu_torch.ops.kmeans_kernel import kmeans_partials

    g = _gen(1)
    pts = torch.randn((_KM_N, _KM_D), generator=g)
    cents = pts[torch.randperm(_KM_N, generator=g)[:_KM_K]] + 0.1
    return functools.partial(kmeans_partials), _on(device, pts, cents)


# kmeans.partials_int8 at (n=128, d=256, k=8): K1.  flops = k12_ops;
# bytes = k12_bytes (int8 points read once); smem = the fused plan's main
# block on an H100, as for K2 (int8 tiles: a smaller block).
@register_kernel("kmeans.partials_int8",
                 flops=k12_ops(_KM_N, _KM_D, _KM_K),
                 min_hbm_bytes=k12_bytes(_KM_N, _KM_D, _KM_K, True),
                 smem_bytes=83_424,
                 kernel="K1", module="harp_tpu_torch.ops.kmeans_kernel",
                 counter="kmeans_partials_int8",
                 plain="kmeans_partials_int8_plain",
                 # sums and counts exact, best_sum in f32 order (rtol 1e-5)
                 tol=(1e-5, 0.0),
                 source="harp_tpu_torch/csrc/kmeans_partials_int8.cu",
                 replaces="harp_tpu/ops/kmeans_kernel.py:249")
def _kmeans_int8(device):
    import torch

    from harp_tpu_torch.models.kmeans import _quantize_centroids
    from harp_tpu_torch.ops.kmeans_kernel import kmeans_partials_int8
    from harp_tpu_torch.parallel.collective import quantize_to_int8

    g = _gen(2)
    x = torch.randn((_KM_N, _KM_D), generator=g)
    cents = x[torch.randperm(_KM_N, generator=g)[:_KM_K]] + 0.1
    q, scale = quantize_to_int8(x, x.abs().amax(0))
    args = (q, *_quantize_centroids(cents, scale), scale)
    return functools.partial(kmeans_partials_int8), _on(device, *args)


# lda.cgs_entry_update through its step entry point cgs_step (the main
# path's call: one cooperative launch a step) at (K=64, 128 × 128 tiles,
# one entry of C=256 tokens, all real, cc=128, Philox draws): K4.  flops =
# 10 f32 operations a (token, topic) on the CUDA cores (the logs run on
# the SFUs beside them; the reference counts 14K, with its one-hot delta
# matmuls); bytes = k4_bytes; smem = the -log(u) row of K floats a block
# (csrc/lda_cgs_entry.cu, cgs_step's launch).
_LDA_K, _LDA_T, _LDA_C, _LDA_CC = 64, 128, 256, 128
_LDA_WORK = {"entries": 1, "slots": _LDA_C, "tokens": _LDA_C}


@register_kernel("lda.cgs_entry_update",
                 flops=10 * _LDA_C * _LDA_K,
                 min_hbm_bytes=k4_bytes(_LDA_WORK, 4 * _LDA_T * _LDA_K,
                                        4 * _LDA_T * _LDA_K, _LDA_K),
                 smem_bytes=4 * _LDA_K,
                 kernel="K4", module="harp_tpu_torch.ops.lda_kernel",
                 counter="cgs_entry_update", plain="cgs_step_plain",
                 tol=(0.0, 0.0),  # bit-equal: Philox on both arms
                 source="harp_tpu_torch/csrc/lda_cgs_entry.cu",
                 replaces="harp_tpu/ops/lda_kernel.py:190")
def _lda_cgs(device):
    import torch

    from harp_tpu_torch.ops.lda_kernel import cgs_step

    g = _gen(3)
    K, T, C = _LDA_K, _LDA_T, _LDA_C
    z = torch.randint(0, K, (1, C), generator=g, dtype=torch.int32)
    cd = torch.randint(0, T, (1, C), generator=g, dtype=torch.int32)
    cw = torch.randint(0, T, (1, C), generator=g, dtype=torch.int32)
    Ndk = torch.zeros((T, K))
    Nwk = torch.zeros((T, K))
    Ndk.index_put_((cd[0].long(), z[0].long()), torch.ones(C), accumulate=True)
    Nwk.index_put_((cw[0].long(), z[0].long()), torch.ones(C), accumulate=True)
    nk = Nwk.sum(0)
    zero = torch.zeros(1, dtype=torch.int32)
    seeds = torch.tensor([[12345, 678]], dtype=torch.int32)
    fn = functools.partial(cgs_step, alpha=0.5, beta=0.1, vbeta=0.1 * T,
                           d_tile=T, w_tile=T, cc=_LDA_CC, seeds=seeds.to(
                               device))
    return fn, _on(device, Ndk, Nwk, nk, z, cd, cw, zero, zero)


# mfsgd.sgd_tile_update at (R=64, 256 × 256 tiles, W and H of 512 rows,
# four entries on the 2 × 2 tile pairs, C=256 real ratings each with
# distinct W rows and distinct H rows): K3, bf16 compute.  flops = k3_ops
# (10 a rating and rank element + 2 a distinct row's; the reference counts
# 6·R a rating slot); bytes = k3_bytes; smem = mfsgd_kernel.block_bytes on
# a cluster of mfsgd_kernel.CLUSTER blocks.
_MF_R, _MF_TILE, _MF_NE, _MF_C = 64, 256, 4, 256
_MF_WORK = {"entries": _MF_NE, "slots": _MF_NE * _MF_C,
            "ratings": _MF_NE * _MF_C, "rows": _MF_NE * 2 * _MF_C}


def _mf_smem() -> int:
    from harp_tpu_torch.ops.mfsgd_kernel import CLUSTER, block_bytes

    return block_bytes(_MF_TILE, _MF_TILE, _MF_R, _MF_C, CLUSTER)


@register_kernel("mfsgd.sgd_tile_update",
                 flops=int(k3_ops(_MF_WORK, _MF_R)),
                 min_hbm_bytes=k3_bytes(_MF_WORK, 2 * _MF_TILE, 2 * _MF_TILE,
                                        _MF_R),
                 smem_bytes=_mf_smem(),
                 kernel="K3", module="harp_tpu_torch.ops.mfsgd_kernel",
                 counter="sgd_tile_update", plain="sgd_tile_update_plain",
                 tol=(1e-4, 1e-5),  # W, H; se in another f32 order
                 source="harp_tpu_torch/csrc/mfsgd_tile_update.cu",
                 replaces="harp_tpu/ops/mfsgd_kernel.py:133")
def _mfsgd_tile(device):
    import torch

    from harp_tpu_torch.ops.mfsgd_kernel import LevelSchedule, sgd_tile_update

    rng = np.random.default_rng(4)
    R, t, NE, C = _MF_R, _MF_TILE, _MF_NE, _MF_C
    eu = np.stack([rng.permutation(t)[:C] for _ in range(NE)]).astype(np.int32)
    ei = np.stack([rng.permutation(t)[:C] for _ in range(NE)]).astype(np.int32)
    ev = rng.normal(size=(NE, C)).astype(np.float32)
    ou = (np.array([0, 0, 1, 1]) * t).astype(np.int32)
    oi = (np.array([0, 1, 0, 1]) * t).astype(np.int32)
    W = rng.uniform(0, R ** -0.5, (2 * t, R)).astype(np.float32)
    H = rng.uniform(0, R ** -0.5, (2 * t, R)).astype(np.float32)
    sched = LevelSchedule.build(eu, ei, ou, oi, t, t, 2 * t, 2 * t, device)
    fn = functools.partial(sgd_tile_update, lr=0.01, reg=0.05, u_tile=t,
                           i_tile=t, compute_dtype=torch.bfloat16,
                           schedule=sched)
    return fn, tuple(torch.from_numpy(a).to(device)
                     for a in (W, H, eu, ei, ev, ou, oi))


# flash_attention at ([BH=2, N=256, D=128], causal, f32): K8's simt arm.
# flops = 4·D a kept (query, key) pair (the two products) over the causal
# pairs, as the reference; bytes = q, k, v in and o out (f32); smem =
# csrc/flash_attention.cu's simt_smem_bytes<RQ=8, DC=2>(128): (16·RQ + kBK)
# rows of q/k at D + 4, kBK rows of v at 64·DC + 4 and the [16·RQ, kBK +
# 16] probabilities, f32, kBK = 64.
_FA_BH, _FA_N, _FA_D = 2, 256, 128


@register_kernel("flash_attention",
                 flops=4 * _FA_D * k8_pairs(_FA_N, True, None) * _FA_BH,
                 min_hbm_bytes=4 * 4 * _FA_BH * _FA_N * _FA_D,
                 smem_bytes=4 * ((16 * 8 + 64) * (_FA_D + 4)
                                 + 64 * (64 * 2 + 4) + 16 * 8 * (64 + 16)),
                 kernel="K8", module="harp_tpu_torch.ops.flash_attention",
                 counter="flash_attention", plain="flash_attention_plain",
                 tol=(2e-4, 2e-5),  # the reference's own f32 gate
                 source="harp_tpu_torch/csrc/flash_attention.cu",
                 replaces="harp_tpu/ops/flash_attention.py:100")
def _flash(device):
    import torch

    from harp_tpu_torch.ops.flash_attention import flash_attention

    g = _gen(5)
    q, k, v = (torch.randn((_FA_BH, _FA_N, _FA_D), generator=g)
               for _ in range(3))
    return (functools.partial(flash_attention, causal=True),
            _on(device, q, k, v))


# svm.kernel_row at (n=512, d=128), f32 x: K5.  flops = 4·n·d f32 on the
# CUDA cores (as the reference's two dots); bytes = k5_bytes (x read once,
# row-major, no lane padding); smem = the row arm's [kWarps=16, d] f32
# partial sums (csrc/svm_pegasos_grad.cu: d/4 = 32 16-byte chunks a row).
_SVM_N, _SVM_D = 512, 128


@register_kernel("svm.kernel_row",
                 flops=4 * _SVM_N * _SVM_D,
                 min_hbm_bytes=k5_bytes(_SVM_N, _SVM_D, 4),
                 smem_bytes=16 * _SVM_D * 4,
                 kernel="K5", module="harp_tpu_torch.ops.svm_kernel",
                 counter="pegasos_grad", plain="pegasos_grad_plain",
                 # gs exact (margins exact on the grids below), gw within
                 # 1e-5 · Σ sw|x| (~400 here) in f32 order
                 tol=(1e-5, 4e-3),
                 source="harp_tpu_torch/csrc/svm_pegasos_grad.cu",
                 replaces="harp_tpu/ops/svm_kernel.py:103")
def _svm_kernel_row(device):
    import torch

    from harp_tpu_torch.ops.svm_kernel import pegasos_grad

    g = _gen(6)
    n, d = _SVM_N, _SVM_D
    # x on a grid of 1/32 and w of 2^-9: every margin exact in f32 whatever
    # the order of its sum, so the violators and gs agree exactly
    x = (torch.randn((n, d), generator=g) * 32).round().clamp(-128, 127) / 32
    w = (torch.randn(d, generator=g) * (2.0 / d ** 0.5) * 512).round().clamp(
        -255, 255) / 512
    y = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    sw = torch.ones(n)
    b = torch.tensor(0.125)
    return functools.partial(pegasos_grad), _on(device, w, b, x, y, sw)


# wdamds.smacof_dist at (N=256, n_loc=32, dim=2), f32 δ: K6.  flops = 20
# f32 operations a pair on the CUDA cores (plus a sqrt and a division on
# the SFUs); the reference counts two MXU matmuls at the padded dimp=128,
# 4·n_loc·N·128; bytes = k6_bytes at the true dim; smem =
# csrc/wdamds_smacof_bx.cu's smem_bytes(ch=256, dim=2): 256 records of 4
# floats and 2 × 32 rows × (kMaxDim + 1) partial floats.
_MDS_N, _MDS_NLOC, _MDS_DIM = 256, 32, 2


@register_kernel("wdamds.smacof_dist",
                 flops=20 * _MDS_NLOC * _MDS_N,
                 min_hbm_bytes=k6_bytes(_MDS_NLOC, _MDS_N, _MDS_DIM, 4),
                 smem_bytes=4 * (_MDS_N * 4 + 2 * 32 * 9),
                 kernel="K6", module="harp_tpu_torch.ops.wdamds_kernel",
                 counter="smacof_bx", plain="smacof_bx_plain",
                 tol=(1e-4, 1e-5),
                 source="harp_tpu_torch/csrc/wdamds_smacof_bx.cu",
                 replaces="harp_tpu/ops/wdamds_kernel.py:114")
def _wdamds_smacof_dist(device):
    import torch

    from harp_tpu_torch.ops.wdamds_kernel import smacof_bx

    g = _gen(7)
    N, nl, dim = _MDS_N, _MDS_NLOC, _MDS_DIM
    X = torch.randn((N, dim), generator=g)
    delta = torch.rand((nl, N), generator=g) * 2
    rm = torch.ones(nl)
    return (functools.partial(smacof_bx, eps=1e-9),
            _on(device, delta, rm, X[:nl].clone(), X) + (float(N),))


# rf.hist_bins at (n=512 samples, f=16 features, B=32 bins, T=2 trees,
# R=8 row codes), uint8 bins, every weight nonzero: K7.  flops = one
# shared-memory update a (tree, sample, feature) with a nonzero weight,
# T·n·f (the reference counts its one-hot int8 MXU dot, 2·n·R·f·B);
# bytes = k7_bytes; smem = rf_kernel.plan's layout on an H100.
_RF_N, _RF_F, _RF_B, _RF_T, _RF_R = 512, 16, 32, 2, 8


def _rf_smem() -> int:
    from harp_tpu_torch.ops.rf_kernel import plan

    return plan(_RF_T, _RF_N, _RF_F, _RF_B, _RF_R, 1, H100_SMEM_OPTIN,
                H100_SMS).smem


@register_kernel("rf.hist_bins",
                 flops=_RF_T * _RF_N * _RF_F,
                 min_hbm_bytes=k7_bytes(_RF_N, _RF_F, _RF_T, _RF_R, _RF_B),
                 smem_bytes=_rf_smem(),
                 kernel="K7", module="harp_tpu_torch.ops.rf_kernel",
                 counter="hist_bins", plain="hist_bins_plain",
                 tol=(0.0, 0.0),  # int32 counts: bit-equal
                 source="harp_tpu_torch/csrc/rf_hist_bins.cu",
                 replaces="harp_tpu/ops/rf_kernel.py:102")
def _rf_hist_bins(device):
    import torch

    from harp_tpu_torch.ops.rf_kernel import hist_bins

    g = _gen(8)
    n, f, B, T, R = _RF_N, _RF_F, _RF_B, _RF_T, _RF_R
    bins = torch.randint(0, B, (n, f), generator=g).to(torch.uint8)
    rc = torch.randint(0, R, (T, n), generator=g, dtype=torch.int32)
    w = torch.randint(1, 4, (T, n), generator=g, dtype=torch.int32)
    return (functools.partial(hist_bins, n_node_classes=R, n_bins=B),
            _on(device, bins, rc, w))


def run_on_copies(fn: Callable, args: tuple) -> tuple:
    """``fn`` on copies of the tensors of ``args`` (K4 updates its tables
    in place): the outputs, then every tensor argument as the call left
    it, flattened to a tuple of tensors."""
    import torch

    copies = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                   for a in args)
    out = fn(*copies)
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(outs) + tuple(a for a in copies
                               if isinstance(a, torch.Tensor))


def agree(name: str, got: tuple, want: tuple) -> tuple[bool, float]:
    """(every tensor of ``got`` within the entry's ``tol`` of ``want``'s,
    the largest absolute difference), in f32."""
    rtol, atol = KERNEL_INFO[name]["tol"]
    ok, err = True, 0.0
    for a, b in zip(got, want, strict=True):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        ok = ok and bool((diff <= atol + rtol * b.abs()).all())
    return ok, err
