"""KMeans — k=100 on 1M×300 dense, the port of ``harp_tpu.models.kmeans``.

Harp's ``edu.iu.kmeans`` apps: every worker assigns its shard of points to
the nearest centroids, produces partial sums and counts, and the partials
meet in an ``allreduce`` (or Harp's ``regroupallgather``: push, normalize
the owned block, pull) so every worker starts the next iteration with the
same centroids.

On the card each iteration is one pass over the worker's points: the
default f32 path is ``_partials_block`` (``torch.matmul`` for the score and
one-hot products, as the reference leaves them to XLA), ``use_pallas=True``
runs kernel K2 and ``quantize="int8"`` runs kernel K1 by default
(:mod:`harp_tpu_torch.ops.kmeans_kernel`).  The Lloyd loop is a Python loop
that never waits for the device: one worker's allreduce is the identity, and
NCCL's is enqueued on the same stream.

f32 products on the card run in full f32: :func:`fit` and
:func:`benchmark` set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (both process-wide flags)
before they run on a CUDA device, since TF32 keeps about three decimal
digits and would move assignments.

The streaming form (``models.kmeans_stream``) takes its chunk partials from
:func:`chunk_partials`, with the same routing.

``psum_schedule="hier"`` sums the partials in two stages
(``collective.allreduce_hier``: within groups of workers, then across
them); on one worker both schedules are the identity.

``fit(ckpt_dir=...)`` runs the iterations in ``ckpt_every``-iteration
chunks under :func:`harp_tpu_torch.utils.fault.run_with_recovery`, with the
centroids checkpointed between chunks; a crashed run, or a rerun on the
same directory, resumes from the latest chunk and ends on the same bits as
an uninterrupted run (each chunk is the same iterations on the same
operands).

Telemetry: a plain ``fit`` is one dispatch (``kmeans.fit`` on the flight
recorder: the whole Lloyd loop) and one readback (the inertia and the
centroids together); with telemetry on it is one superstep-timeline run of
one superstep, and its per-worker point counts (each worker's shard, known
on the host) land on the skew ledger.  The checkpointed form is one run
with a superstep a chunk.  The CLI ends in the run report
(``report.maybe_emit``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from harp_tpu_torch.ops import kmeans_kernel
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import (WorkerMesh, num_workers,
                                         resolve_mesh, worker_id)
from harp_tpu_torch.utils import flightrec, skew, steptrace, telemetry
from harp_tpu_torch.utils.timing import device_sync



@dataclasses.dataclass
class KMeansConfig:
    """Harp knob parity: numMapTasks → worker count, pointsPerFile → shard."""

    k: int = 100
    iters: int = 10
    dtype: Any = torch.float32  # bf16 points keep f32 accumulation
    block_points: int = 0  # >0: score points in blocks to bound [n, k]
    # Harp's two app variants: "allreduce" = one allreduce of the partials;
    # "regroupallgather" = push (reduce-scatter) the partials, normalize the
    # owned centroid block, pull (allgather) — identical results
    variant: str = "allreduce"
    # fused kernel: None = auto, ON for quantize="int8" (K1), OFF for f32
    # (the matmul path); True selects K2 on the f32 path
    use_pallas: bool | None = None
    # opt-in int8 points: per-feature symmetric scales, exact int32 sums
    quantize: str | None = None
    # the partials allreduce's schedule: one allreduce, or "hier", the
    # two-stage allreduce_hier (floats reassociate across its stages)
    psum_schedule: str = "one_shot"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {self.quantize!r}")
        if self.quantize and self.block_points:
            raise ValueError("quantize='int8' is incompatible with "
                             "block_points (the int8 paths are single-"
                             "block; use_pallas selects the fused kernel)")
        if self.variant not in ("allreduce", "regroupallgather"):
            raise ValueError(
                f"variant must be 'allreduce' or 'regroupallgather', "
                f"got {self.variant!r}")
        if self.psum_schedule not in ("one_shot", "hier"):
            raise ValueError(
                f"psum_schedule must be 'one_shot' or 'hier', "
                f"got {self.psum_schedule!r}")


def _partials_block(points, centroids, c2):
    """Per-block partials: (sums [k, d] f32, counts [k] f32, inertia).

    Scores come from ``x @ cᵀ`` and the per-cluster sums from
    ``one_hotᵀ @ x``, both ``torch.matmul`` with f32 accumulation.  |x|^2
    is dropped from the argmin and re-added only to the inertia."""
    k = c2.shape[0]
    xf = points.to(torch.float32)
    scores = c2[None, :] - 2.0 * (xf @ centroids.to(torch.float32).T)
    assign = torch.argmin(scores, dim=1)
    best = scores.gather(1, assign[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    inertia = (xf ** 2).sum() + best.sum()
    sums = onehot.to(torch.float32).T @ xf
    # summed in the one-hot's dtype, as the reference does (bf16 rounds)
    counts = onehot.sum(0).to(torch.float32)
    return sums, counts, inertia


# one worker-local cluster may sum at most 2^31/127 int8 contributions
# before the exact int32 accumulator could wrap
_INT8_SUM_ROW_LIMIT = (1 << 31) // 127


def _clip_round_int8(values, scale):
    """The int8 rounding rule (numpy): round half to even, clip to ±127."""
    return np.clip(np.round(values / scale), -127, 127).astype(np.int8)


def _check_int8_chunk_rows(rows_per_worker, limit):
    """The exact-int32 accumulation guard for streamed chunks.  ``limit``
    is required: callers resolve their module's ``_INT8_SUM_ROW_LIMIT``
    at call time (tests shrink it to exercise the guard)."""
    if rows_per_worker > limit:
        raise ValueError(
            f"quantize='int8': {rows_per_worker} chunk rows/worker "
            f"exceeds the {limit} exact-int32 accumulation "
            "bound — use a smaller chunk_points")


def quantize_points_int8(points):
    """Per-feature symmetric int8 quantization: (q int8 [n, d], scale [d]).

    ``points ≈ q * scale[None, :]`` with per-entry error ≤ scale/2.  Host
    numpy, so a large matrix is quantized before it is sharded."""
    points = np.asarray(points, np.float32)
    scale = np.maximum(np.abs(points).max(0), 1e-30) / 127.0
    return _clip_round_int8(points, scale), scale.astype(np.float32)


def _quantize_centroids(centroids, col_scale):
    """Per-iteration centroid requantization shared by the int8 matmul path
    and kernel K1: centroids enter the quantized-feature coordinates
    (``cs = c · col_scale``), each row gets its own symmetric scale, and
    ``c2`` stays in the original space.
    Returns (c_q [k, d] int8, c_scale [k] f32, c2 [k] f32)."""
    cf = centroids.to(torch.float32)
    cs = cf * col_scale[None, :]
    c_q, c_scale_col = C.quantize_to_int8(cs, cs.abs().amax(1, keepdim=True))
    return c_q, c_scale_col[:, 0], (cf ** 2).sum(-1)


def _partials_block_int8(pts_q, col_scale, centroids, c2, x2=None):
    """Quantized twin of :func:`_partials_block`: exact integer dots and
    sums, dequantized once per [k, d] / [k] output.  ``x2``: the hoisted
    iteration-invariant sum of |x|^2 (taken here when not given)."""
    k, d = centroids.shape
    c_q, c_scale, _ = _quantize_centroids(centroids, col_scale)
    dots = kmeans_kernel.exact_int_dot(pts_q, c_q).to(torch.float32)
    scores = c2[None, :] - 2.0 * (dots * c_scale[None, :])
    assign = torch.argmin(scores, dim=1)
    best = scores.gather(1, assign[:, None])[:, 0]
    if x2 is None:
        x2 = _hoisted_x2((pts_q, col_scale))
    sums_i = torch.zeros((k, d), dtype=torch.int32, device=pts_q.device)
    sums_i.index_add_(0, assign, pts_q.to(torch.int32))
    counts = torch.bincount(assign, minlength=k).to(torch.int32)
    return (sums_i.to(torch.float32) * col_scale[None, :],
            counts.to(torch.float32), x2 + best.sum())


def _use_pallas(cfg: KMeansConfig) -> bool:
    """Resolved use_pallas: None means the fused kernel for int8 (K1) and
    the matmul path for f32."""
    if cfg.use_pallas is None:
        return cfg.quantize == "int8"
    return cfg.use_pallas


def epoch_operands(centroids, quantize=None, col_scale=None) -> tuple:
    """The centroid operands of every :func:`chunk_partials` call of one
    epoch, taken once an epoch: ``(c_q, c_scale, c2, col_scale)`` for
    int8 (the centroids requantized, as K1 takes them), else
    ``(centroids, c2)``."""
    with telemetry.span("kmeans.operands"):
        if quantize == "int8":
            return (*_quantize_centroids(centroids, col_scale), col_scale)
        return centroids, (centroids.to(torch.float32) ** 2).sum(-1)


def chunk_partials(points, operands, quantize=None, x2=None):
    """One streamed chunk's partials → (sums [k, d], counts [k], inertia),
    routed as :func:`_use_pallas` routes a shard by default: K1 for int8
    chunks, ``_partials_block`` for float ones.  ``points`` is this
    worker's rows of the chunk, possibly none (then nothing launches);
    ``operands`` come from :func:`epoch_operands`.  ``x2``: an int8
    chunk's sum of |x|^2 where its quantization gave it (the fused pass of
    ``kmeans_kernel.quantize_rows_int8``), else taken here."""
    if points.shape[0] == 0:
        k, d = operands[0].shape
        return (torch.zeros((k, d), device=points.device),
                torch.zeros((k,), device=points.device),
                torch.zeros((), device=points.device))
    if quantize == "int8":
        c_q, c_scale, c2, col_scale = operands
        with telemetry.span("kmeans.partials"):
            sums, counts, best_sum = kmeans_kernel.kmeans_partials_int8(
                points, c_q, c_scale, c2, col_scale)
        if x2 is None:
            with telemetry.span("kmeans.x2"):
                x2 = _hoisted_x2((points, col_scale))
        return sums, counts, best_sum + x2
    centroids, c2 = operands
    with telemetry.span("kmeans.partials"):
        return _partials_block(points, centroids, c2)


def kmeans_step(points, centroids, cfg: KMeansConfig, x2=None):
    """One Lloyd iteration on this worker's shard → (new_centroids, inertia).

    ``points`` is the shard, or ``(pts_q, col_scale)`` for int8; ``x2`` the
    hoisted sum of |x|^2 (int8 paths)."""
    nw = num_workers()
    if cfg.quantize == "int8":
        pts_q, col_scale = points
        if _use_pallas(cfg):
            if x2 is None:
                raise ValueError("the fused int8 path needs the hoisted x2")
            c_q, c_scale, c2 = _quantize_centroids(centroids, col_scale)
            sums, counts, best_sum = kmeans_kernel.kmeans_partials_int8(
                pts_q, c_q, c_scale, c2, col_scale)
            partial_inertia = best_sum + x2
        else:
            c2 = (centroids.to(torch.float32) ** 2).sum(-1)
            sums, counts, partial_inertia = _partials_block_int8(
                pts_q, col_scale, centroids, c2, x2=x2)
        return _combine_partials(sums, counts, partial_inertia, centroids,
                                 cfg, nw)
    n = points.shape[0]
    block = cfg.block_points
    if _use_pallas(cfg):
        if block:
            raise ValueError("block_points has no effect with use_pallas "
                             "(the kernel picks its own tile size)")
        sums, counts, partial_inertia = kmeans_kernel.kmeans_partials(
            points, centroids)
    elif block <= 0 or block >= n:
        c2 = (centroids.to(torch.float32) ** 2).sum(-1)
        sums, counts, partial_inertia = _partials_block(points, centroids, c2)
    else:
        if n % block:
            raise ValueError("block_points must divide the local shard size")
        c2 = (centroids.to(torch.float32) ** 2).sum(-1)
        parts = [_partials_block(b, centroids, c2)
                 for b in points.split(block)]
        sums = torch.stack([p[0] for p in parts]).sum(0)
        counts = torch.stack([p[1] for p in parts]).sum(0)
        partial_inertia = torch.stack([p[2] for p in parts]).sum()
    return _combine_partials(sums, counts, partial_inertia, centroids, cfg, nw)


def _normalize_centroids(sums, counts, old):
    """An empty cluster keeps its old centroid — the one empty-cluster
    policy, shared by both variants."""
    new = sums / torch.clamp_min(counts[:, None], 1.0)
    return torch.where(counts[:, None] > 0, new,
                       old.to(new.dtype)).to(old.dtype)


def _combine_partials(sums, counts, partial_inertia, centroids, cfg, nw):
    """The collective + normalize tail every partials formulation shares."""
    if cfg.variant == "regroupallgather" and sums.shape[0] % nw == 0:
        # Harp's regroup + allgather: push the partials so worker w owns
        # centroid block w, normalize it locally, pull the blocks
        my_sums, my_counts = C.push((sums, counts))
        kb = sums.shape[0] // nw
        me = worker_id()
        cent_blk = centroids[me * kb:(me + 1) * kb]
        new_centroids = C.pull(_normalize_centroids(my_sums, my_counts,
                                                    cent_blk))
        return new_centroids, C.allreduce(partial_inertia)
    allreduce = C.allreduce_hier if cfg.psum_schedule == "hier" \
        else C.allreduce
    sums, counts, inertia = allreduce((sums, counts, partial_inertia))
    return _normalize_centroids(sums, counts, centroids), inertia


def _effective_variant(variant: str, k: int, num_workers: int) -> str:
    """The variant that will actually run — the two-phase form needs
    ``k % num_workers == 0`` and falls back to allreduce (loudly)."""
    if variant == "regroupallgather" and k % num_workers != 0:
        logging.getLogger("harp_tpu_torch").warning(
            "kmeans: k=%d not divisible by %d workers — regroupallgather "
            "falls back to the (equivalent) allreduce path", k, num_workers)
        return "allreduce"
    return variant


def kmeanspp_init(points, k, seed=0, sample=50_000):
    """k-means++ seeding (Arthur & Vassilvitskii) on a host subsample of
    ``sample`` rows (host numpy, the reference's procedure)."""
    pts = np.asarray(points, np.float32)
    rng = np.random.default_rng(seed)
    if len(pts) > sample:
        pts = pts[rng.choice(len(pts), size=sample, replace=False)]
    centers = [pts[rng.integers(len(pts))]]
    d2 = ((pts - centers[0]) ** 2).sum(1)
    for _ in range(k - 1):
        # float64 so the probabilities pass numpy's sum-to-one check
        d2_64 = d2.astype(np.float64)
        total = float(d2_64.sum())
        if total <= 0.0:
            # fewer than k distinct rows: uniform picks (empty clusters keep
            # their old centroid)
            nxt = pts[rng.integers(len(pts))]
        else:
            nxt = pts[rng.choice(len(pts), p=d2_64 / total)]
        centers.append(nxt)
        d2 = np.minimum(d2, ((pts - nxt) ** 2).sum(1))
    return np.stack(centers)


def _exact_f32(device: torch.device) -> None:
    """Full-f32 products on the card (TF32 off for matmul and cuDNN)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _hoisted_x2(points):
    """Iteration-invariant sum of |x|^2 of the int8 shard, taken once."""
    pts_q, col_scale = points
    return ((pts_q.to(torch.float32) * col_scale[None, :]) ** 2).sum()


def fit(points, k=100, iters=10, mesh: WorkerMesh | None = None, seed=0,
        dtype=torch.float32, block_points=0, use_pallas=None,
        variant="allreduce", quantize=None, init="random",
        psum_schedule="one_shot", ckpt_dir: str | None = None,
        ckpt_every: int = 5, max_restarts: int = 3, fault=None,
        device=None):
    """Host driver → (centroids [k, d] numpy f32, inertia float).

    ``points``: the global [n, d] host array (numpy or a CPU tensor); every
    worker passes the same one and shards it on dim 0.  Initialization
    (``init``): "random" picks k distinct random rows with the integer
    ``seed``, or the first k points when ``seed=None``; "kmeans++" uses
    :func:`kmeanspp_init`.  Runs on this worker's card unless ``device``
    (or ``mesh``) says otherwise; raises without a card.

    With ``ckpt_dir`` the iterations run in ``ckpt_every``-iteration
    chunks, the centroids checkpointed after each (:func:`_fit_ckpt`);
    ``fault`` (a :class:`~harp_tpu_torch.utils.fault.FaultInjector`)
    needs ``ckpt_dir``."""
    if fault is not None and ckpt_dir is None:
        raise ValueError(
            "fault injection requires ckpt_dir (recovery restarts from "
            "checkpoints; without one the injector would be silently "
            "ignored)")
    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    variant = _effective_variant(variant, k, mesh.num_workers)
    cfg = KMeansConfig(k=k, iters=iters, dtype=dtype,
                       block_points=block_points, use_pallas=use_pallas,
                       variant=variant, quantize=quantize,
                       psum_schedule=psum_schedule)
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    n = points.shape[0]
    if init == "kmeans++":
        init_c = kmeanspp_init(points, k, seed=0 if seed is None else seed)
    elif init == "random":
        if seed is None:
            init_idx = np.arange(k)
        else:
            init_idx = np.random.default_rng(seed).choice(n, size=k,
                                                          replace=False)
        init_c = np.asarray(points[np.sort(init_idx)])
    else:
        raise ValueError(f"init must be 'random' or 'kmeans++', got {init!r}")
    centroids = mesh.replicated(np.asarray(init_c, np.float32)).to(dtype)
    x2 = None
    if quantize == "int8":
        if -(-n // mesh.num_workers) > _INT8_SUM_ROW_LIMIT:
            raise ValueError(
                f"quantize='int8': {n} points over {mesh.num_workers} workers "
                f"exceeds the {_INT8_SUM_ROW_LIMIT} rows/worker exact-int32 "
                "accumulation bound — use more workers or the f32 path")
        q, scale = quantize_points_int8(points)
        pts = (mesh.shard_array(q, 0), mesh.replicated(scale))
        x2 = _hoisted_x2(pts)
    else:
        pts = mesh.shard_array(np.asarray(points, np.float32), 0).to(dtype)
    if ckpt_dir is not None:
        return _fit_ckpt(mesh, cfg, pts, centroids, x2, iters, ckpt_dir,
                         ckpt_every=ckpt_every, max_restarts=max_restarts,
                         fault=fault)
    def lloyd(c):
        inertia = torch.zeros((), dtype=torch.float32, device=mesh.device)
        for _ in range(iters):
            c, inertia = kmeans_step(pts, c, cfg, x2=x2)
        return c, inertia

    fit_fn = flightrec.track(lloyd, "kmeans.fit")
    rows = (pts[0] if quantize == "int8" else pts).shape[0]
    # the whole Lloyd loop is ONE superstep: one dispatch, one readback
    with telemetry.span("kmeans.fit", iters=iters, k=k), \
            telemetry.ledger.run("kmeans.fit", steps=iters), \
            steptrace.run("kmeans.fit"), \
            steptrace.superstep("kmeans.fit", 0):
        t0 = time.perf_counter()
        centroids, inertia = fit_fn(centroids)
        st = flightrec.readback(torch.cat([
            inertia.reshape(1), centroids.to(torch.float32).reshape(-1)]))
        # every worker's shard is ``rows`` points (shard_array splits
        # evenly), so the per-worker counts need no device work
        skew.record_execution("kmeans.fit", [rows] * mesh.num_workers,
                              unit="points",
                              wall_s=time.perf_counter() - t0)
    return st[1:].reshape(k, -1), float(st[0])


def _fit_ckpt(mesh, cfg, pts, centroids, x2, iters, ckpt_dir, *,
              ckpt_every=5, max_restarts=3, fault=None):
    """The recovery-looped fit: chunks of ``ckpt_every`` iterations under
    :func:`~harp_tpu_torch.utils.fault.run_with_recovery`, the centroids
    and the last inertia (so a resume with nothing left still reports it)
    checkpointed after each chunk."""
    from harp_tpu_torch.utils.checkpoint import CheckpointManager
    from harp_tpu_torch.utils.fault import to_device, run_with_recovery

    mgr = CheckpointManager(ckpt_dir)
    lens = [min(ckpt_every, iters - s) for s in range(0, iters, ckpt_every)]
    dev = mesh.device

    def make_state():
        return {"centroids": centroids,
                "inertia": torch.zeros((), dtype=torch.float32, device=dev)}

    def step(ci, state):
        with steptrace.superstep("kmeans.fit_ckpt", ci):
            c = to_device(state["centroids"], dev, centroids.dtype)
            inertia = state["inertia"]
            for _ in range(lens[ci]):
                c, inertia = kmeans_step(pts, c, cfg, x2=x2)
            return {"centroids": c, "inertia": inertia}

    with telemetry.span("kmeans.fit_ckpt", iters=iters, k=cfg.k), \
            telemetry.ledger.run("kmeans.fit_ckpt", steps=iters), \
            steptrace.run("kmeans.fit_ckpt"):
        final = run_with_recovery(make_state, step, len(lens), mgr,
                                  ckpt_every=1, max_restarts=max_restarts,
                                  fault=fault)
    c = to_device(final["centroids"], "cpu", torch.float32)
    return c.numpy(), float(to_device(final["inertia"], "cpu"))


def benchmark(n=1_000_000, d=300, k=100, iters=10, mesh=None,
              dtype=torch.float32, warmup=2, seed=0, use_pallas=None,
              variant="allreduce", quantize=None, psum_schedule="one_shot",
              device=None):
    """Iterations per second on the graded 1M×300 k=100 config.

    Points and centroids are drawn on the device from explicit
    ``torch.Generator``\\ s (centroids from ``seed``, worker w's points from
    ``seed + 1 + w``).  ``max(warmup, 1)`` untimed iterations run first;
    the timed window holds ``iters`` iterations as a Python loop with one
    synchronize at its end."""
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    _exact_f32(dev)
    variant = _effective_variant(variant, k, mesh.num_workers)
    cfg = KMeansConfig(k=k, iters=1, dtype=dtype, use_pallas=use_pallas,
                       variant=variant, quantize=quantize,
                       psum_schedule=psum_schedule)
    nw = mesh.num_workers
    n = (n // nw) * nw
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centroids = torch.randn((k, d), generator=gen, device=dev).to(dtype)
    gen.manual_seed(seed + 1 + mesh.rank)
    points = torch.randn((n // nw, d), generator=gen, device=dev).to(dtype)
    x2 = None
    if quantize == "int8":
        if n // nw > _INT8_SUM_ROW_LIMIT:
            raise ValueError(
                f"quantize='int8': {n // nw} rows/worker exceeds the "
                f"{_INT8_SUM_ROW_LIMIT} exact-int32 accumulation bound")
        # per-feature |max| over every worker's shard
        amax = C.allreduce(points.abs().amax(0).to(torch.float32),
                           C.Combiner.MAX)
        points = C.quantize_to_int8(points.to(torch.float32), amax)
        x2 = _hoisted_x2(points)

    def run(c, n_iters):
        inertia = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            c, inertia = kmeans_step(points, c, cfg, x2=x2)
        return c, inertia

    with telemetry.ledger.run("kmeans.benchmark", steps=max(warmup, 1)):
        device_sync(run(centroids, max(warmup, 1))[1])
    t0 = time.perf_counter()
    with telemetry.span("kmeans.benchmark", iters=iters), \
            telemetry.ledger.run("kmeans.benchmark", steps=iters):
        _, inertia = run(centroids, iters)
        inertia_val = device_sync(inertia)
    dt = time.perf_counter() - t0
    return {
        "iters_per_sec": iters / dt,
        "points_per_sec": n * iters / dt,
        "sec_per_iter": dt / iters,
        "inertia": inertia_val,
        "n": n, "d": d, "k": k, "num_workers": nw,
        "dtype": str(dtype).removeprefix("torch."),
        "variant": variant,  # the variant that actually ran
        "quantize": quantize,
        "use_pallas": _use_pallas(cfg),
        "psum_schedule": psum_schedule,
    }


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu KMeans on PyTorch (edu.iu.kmeans parity)")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=300)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--variant", default="allreduce",
                   choices=["allreduce", "regroupallgather"],
                   help="Harp app variant: one allreduce, or the explicit "
                        "regroup (reduce-scatter) + allgather two-phase form")
    p.add_argument("--init", choices=["random", "kmeans++"], default="random",
                   help="centroid seeding: Harp's random rows, or kmeans++")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="opt-in int8 points (a quarter of the f32 bytes; "
                        "runs kernel K1)")
    p.add_argument("--psum-schedule", choices=["one_shot", "hier"],
                   default="one_shot",
                   help="partials-allreduce schedule: one allreduce "
                        "(default) or the two-stage allreduce_hier")
    p.add_argument("--bench", action="store_true",
                   help="synthetic benchmark mode (points drawn on the device)")
    p.add_argument("--input", default=None, metavar="FILE_OR_GLOB",
                   help="CSV/whitespace point files (one point per row) "
                        "instead of synthetic points")
    p.add_argument("--ckpt-dir", default=None,
                   help="fit with checkpoint/resume: iterations run in "
                        "--ckpt-every chunks with the centroids "
                        "checkpointed between them; a rerun on the same "
                        "directory resumes from the latest chunk")
    p.add_argument("--ckpt-every", type=int, default=5,
                   help="iterations per checkpointed chunk")
    p.add_argument("--resume", action="store_true",
                   help="require a resume: --ckpt-dir must already hold a "
                        "checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    from harp_tpu_torch.report import maybe_emit
    from harp_tpu_torch.utils.fault import resolve_resume

    resumed_from = resolve_resume(args.ckpt_dir, args.resume)
    mesh = WorkerMesh(args.device)
    if args.bench:
        out = benchmark(args.n, args.d, args.k, args.iters, mesh=mesh,
                        dtype=dtype, variant=args.variant,
                        quantize=args.quantize,
                        psum_schedule=args.psum_schedule)
        print(benchmark_json("kmeans_bench", out, mesh.device))
        maybe_emit("kmeans_bench")
    else:
        if args.input:
            from harp_tpu_torch.native.datasource import load_csv_glob

            try:
                pts = load_csv_glob(args.input)
            except ValueError as e:
                raise SystemExit(str(e))
        else:
            rng = np.random.default_rng(0)
            pts = rng.normal(size=(args.n, args.d)).astype(np.float32)
        _, inertia = fit(pts, args.k, args.iters, mesh=mesh, dtype=dtype,
                         variant=args.variant, quantize=args.quantize,
                         init=args.init, psum_schedule=args.psum_schedule,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
        print(benchmark_json("kmeans_cli", {
            "k": args.k, "iters": args.iters, "n": pts.shape[0],
            "d": pts.shape[1], "inertia": inertia,
            "ckpt_dir": args.ckpt_dir, "resumed_from": resumed_from},
            mesh.device))
        maybe_emit("kmeans")
    return 0


if __name__ == "__main__":
    main()
