"""Roofline annotation on the H100's peaks: the port of
``harp_tpu.utils.roofline``.

A measured rate reads as a fraction of what the card can do.  Each graded
config has an analytic work model (operations and least HBM bytes per
unit of its throughput metric); paired with a benchmark row it gives the
achieved TFLOP/s and GB/s, the percent of peak for both, and the wall the
row is against.  :data:`WORK_MODELS` is the reference's map, key for
key, and its work models are the reference's (lower-bound byte models:
inputs read once, outputs written once; the dominant kernels' operation
counts) with one exception: a KMeans row whose route runs K1 or K2 counts
those kernels' operations, from :mod:`harp_tpu_torch.ops.kernel_registry`,
not the reference's one-hot sums matmul.

The other difference is the peak a row is held to.  The reference holds every
f32 dot to the bf16 peak, because XLA runs one as a single bf16 pass.
The port's peak comes from the route the row ran (:func:`route_peak`):

- ``quantize="int8"`` runs K1's s8 MMAs: ``int8_ops``;
- f32 KMeans with ``use_pallas`` runs K2's bf16 MMAs, and a bf16 dtype or
  an MLP with ``half_precision`` runs bf16 GEMMs: ``bf16_flops``;
- everything else is f32 on the CUDA cores: ``torch.matmul`` with TF32
  off (``models/kmeans.py``, the MLP), K3's and K4's f32 arithmetic, the
  dense paths' torch ops: ``f32_flops``.

The card's rates live here, in one place: :data:`H100_PEAKS` (NVIDIA's
H100 SXM data sheet, dense), with :data:`HBM_BYTES_S` and
:data:`PEAK_OPS` the same figures under the names the kernels' bounds
use, and the two rates the data sheet has no line for
(:data:`SFU_OPS_S`, :data:`SMEM_UPDATES_S`).  A card set below its
700 W power limit runs slower than these peaks.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit;
# the key names are the reference's
H100_PEAKS = {
    "bf16_flops": 989e12,   # tensor-core bf16 FLOP/s
    "int8_ops": 1979e12,    # tensor-core int8 OP/s
    "f32_flops": 67e12,     # f32 FLOP/s on the CUDA cores (TF32 off)
    "hbm_gbs": 3.35e12,     # HBM3 bandwidth, bytes/s
}

#: the same figures under the names of the kernels' bounds
#: (:mod:`harp_tpu_torch.ops.kernel_registry`)
HBM_BYTES_S = H100_PEAKS["hbm_gbs"]
PEAK_OPS = {"int8": H100_PEAKS["int8_ops"], "bf16": H100_PEAKS["bf16_flops"],
            "f32": H100_PEAKS["f32_flops"]}
#: special-function (MUFU) results a second: 16 a clock an SM (CUDA C++
#: Programming Guide, arithmetic throughput, compute capability 9.0) x 132
#: SMs x 1.98 GHz boost clock
SFU_OPS_S = 16 * 132 * 1.98e9
#: shared-memory accesses a second: 32 banks of 4 bytes, one access a bank
#: and clock (CUDA C++ Programming Guide, shared memory of compute
#: capability 9.0) x 132 SMs x 1.98 GHz: at most one 4-byte atomic update
#: a bank and clock
SMEM_UPDATES_S = 32 * 132 * 1.98e9


def route_peak(r: dict) -> str:
    """The peak key of the route a benchmark row ran (module docstring)."""
    if r.get("quantize") == "int8":
        return "int8_ops"
    if r.get("use_pallas"):
        return "bf16_flops"  # K2: f32 KMeans on bf16 MMAs
    if r.get("half_precision") or str(r.get("dtype", "")) in (
            "bfloat16", "bf16", "float16"):
        return "bf16_flops"
    return "f32_flops"


def _kmeans_work(r):
    """Per iteration: distance matmul 2ndk + one-hot sums 2nkd, or on the
    routes whose sums are no one-hot matmul (int8: K1, or the int8 matmul
    path's index adds; f32 with ``use_pallas``: K2) K1's and K2's count,
    :func:`~harp_tpu_torch.ops.kernel_registry.k12_ops` (2ndk + nd);
    min bytes = points read once
    (dtype-sized) + assignments written once (int32).  ``iters_per_sec``
    is a whole-mesh rate, so the per-card comparison divides by
    ``num_workers``; the streaming benchmark's ``iters_per_sec_ex_gen``
    (the chunk generation subtracted) is preferred when present."""
    from harp_tpu_torch.ops.kernel_registry import k12_ops

    n, d, k = r["n"], r["d"], r["k"]
    kernel_route = r.get("quantize") == "int8" or bool(r.get("use_pallas"))
    dsize = 1 if r.get("quantize") == "int8" else 4
    metric = ("iters_per_sec_ex_gen"
              if r.get("iters_per_sec_ex_gen") is not None
              else "iters_per_sec")
    return {
        "flops": float(k12_ops(n, d, k)) if kernel_route
        else 4.0 * n * d * k,
        "bytes": n * d * dsize + 4.0 * n,
        "per": (metric, 1.0 / r.get("num_workers", 1)),
        "peak": route_peak(r),
    }


def _mfsgd_work(r):
    """Per update (one rating): dot(W_u, H_i) + two axpy rows ≈ 6·rank
    FLOPs; min bytes = both rows read + written = 16·rank."""
    rank = r.get("rank", 64)
    return {"flops": 6.0 * rank, "bytes": 16.0 * rank,
            "per": ("updates_per_sec_per_chip", 1.0),
            "peak": route_peak(r)}


def _lda_work(r):
    """Per token: K-wide posterior (two logs + the draw ≈ 10K flops) +
    the count deltas ≈ 4K; min bytes = 3 K-rows read + 2 written."""
    K = r["n_topics"]
    return {"flops": 14.0 * K, "bytes": 20.0 * K,
            "per": ("tokens_per_sec_per_chip", 1.0),
            "peak": route_peak(r)}


def _mlp_work(r):
    """Per sample: ≈ 6·params FLOPs (fwd 2P + bwd 4P), MNIST-shape MLP
    (784·512 + 512·256 + 256·10 ≈ 535k params); min bytes per sample =
    16·params/batch (4 param-sized streams of 4 B, amortized over the
    batch).  ``samples_per_sec`` is whole-mesh: divided by num_workers."""
    params = 535_818
    return {"flops": 6.0 * params,
            "bytes": 16.0 * params / r.get("batch", 8192),
            "per": ("samples_per_sec", 1.0 / r.get("num_workers", 1)),
            "peak": route_peak(r)}


# configs without a trustworthy closed-form model (irregular access
# patterns dominate) are intentionally absent: no number beats a wrong one.
# The reference's map, key for key; the carry rows' byte floor reads as
# the algorithmic traffic rate (a run's rows amortize), as there.
WORK_MODELS = {
    "kmeans": _kmeans_work,
    "kmeans_int8": _kmeans_work,
    "kmeans_int8_fused": _kmeans_work,
    "kmeans_hier_psum": _kmeans_work,
    "kmeans_stream": _kmeans_work,
    "kmeans_stream_int8": _kmeans_work,
    "mfsgd": _mfsgd_work,
    "mfsgd_scatter": _mfsgd_work,
    "mfsgd_pallas": _mfsgd_work,
    "mfsgd_carry": _mfsgd_work,
    "mfsgd_chunked_rotate": _mfsgd_work,
    "lda": _lda_work,
    "lda_carry": _lda_work,
    "lda_exprace": _lda_work,
    "lda_fast": _lda_work,
    "lda_pallas": _lda_work,
    "lda_pallas_approx": _lda_work,
    "lda_pallas_carry": _lda_work,
    "lda_pallas_hot": _lda_work,
    "lda_pallas_approx_hot": _lda_work,
    "lda_rotate_int8": _lda_work,
    "lda_planner_wire": _lda_work,
    "lda_scale": _lda_work,
    "lda_scale_1m": _lda_work,
    "lda_scale_1m_pallas": _lda_work,
    "lda_scatter": _lda_work,
    "mlp": _mlp_work,
}


def annotate(config: str, result: dict, peaks: dict = H100_PEAKS) -> dict:
    """Add roofline fields to a benchmark result dict (returns a copy).

    Adds ``achieved_tflops``, ``achieved_gbs``, ``pct_peak_flops``,
    ``pct_peak_bw``, ``roofline_peak`` (the peak key the row is held to)
    and ``bound`` ("compute" | "memory": whichever wall is closer).
    Configs without a work model, and rows without the shape fields or
    the metric, pass through unchanged.
    """
    model = WORK_MODELS.get(config)
    if model is None:
        return dict(result)
    try:
        w = model(result)
    except KeyError:  # the row lacks the shape fields (partial/error record)
        return dict(result)
    metric, scale = w["per"]
    if metric not in result:
        return dict(result)
    rate = float(result[metric]) * scale          # units/s
    flops_s = rate * w["flops"]
    bytes_s = rate * w["bytes"]
    pf = 100.0 * flops_s / peaks[w["peak"]]
    pb = 100.0 * bytes_s / peaks["hbm_gbs"]
    out = dict(result)
    out.update({
        "achieved_tflops": round(flops_s / 1e12, 3),
        "achieved_gbs": round(bytes_s / 1e9, 2),
        "pct_peak_flops": round(pf, 2),
        "pct_peak_bw": round(pb, 2),
        "roofline_peak": w["peak"],
        "bound": "compute" if pf >= pb else "memory",
    })
    return out
