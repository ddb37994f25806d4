"""Streaming (blocked-epoch) KMeans, the 1B-point north-star path: the port
of ``harp_tpu.models.kmeans_stream``.

The north-star metric is KMeans iterations/s at 1B points, k = 1000.  1B ×
300 f32 is 1.2 TB (int8: 300 GB): it cannot live on one card, and Harp
never needed it to, since each mapper streamed its HDFS split through
memory.  Here only the centroids [k, d] and the partial accumulators
[k, d] + [k] stay on the card, and the points stream through it in chunks:

- **Real data** (:func:`fit_streaming`, :func:`fit_streaming_local`,
  :func:`fit_streaming_files`): host chunks (numpy, ``np.memmap``, a text
  file through the native reader, or a directory of split files) go
  through the ingest pipeline (:class:`harp_tpu_torch.ingest.
  IngestPipeline`): read, prep (cast to the wire dtype, or quantize to
  int8) into a pinned staging buffer, and an asynchronous H2D copy on a
  side stream, so chunk j+1's transfer overlaps chunk j's compute.  Each
  worker accumulates its partials on its card; one ``allreduce`` an epoch,
  not a chunk, merges them: Harp's regroup + allgather at epoch
  granularity.  ``quantize="int8"`` ships int8 chunks (a quarter of the
  f32 bytes; per-feature scales from one chunked host pass) whose partials
  run on kernel K1; float chunks take ``_partials_block`` (``torch.matmul``)
  as the resident fit's default does (``models.kmeans.chunk_partials``).
- **Synthetic at full scale** (:func:`benchmark_streaming`): chunk j of
  worker w is regenerated on the card from a generator seeded by (seed, w,
  j) alone, so every epoch revisits the same points (regeneration stands in
  for re-reading a file split) and the 1B × 300, k = 1000 configuration
  runs on one card in bounded memory.  A Python loop over epochs and
  chunks takes the place of the reference's one fused program.  The int8
  twin quantizes each generated chunk and takes its sum of |x|^2 in one
  pass on the card (``kmeans_kernel.quantize_rows_int8``).

The reference pads a ragged tail chunk to its static shape and masks the
padding; PyTorch has no static-shape rule and K1 takes any row count, so
the tail ships at its true rows, with the masked reference's results.
Peak device memory is set by ``chunk_points``: the chunk, its [chunk, k]
score matrix and, on the f32 path, ``_partials_block``'s one-hot (measured
on the card: ``PERF.md``).

``ckpt_dir`` puts the epoch loop on :func:`harp_tpu_torch.utils.fault.
fit_epochs` (the centroids and the inertia history checkpointed every
``ckpt_every`` epochs); a resumed run ends on the uninterrupted run's bits.
``.parquet`` inputs stream through :class:`~harp_tpu_torch.native.
datasource.ParquetPoints`.

With telemetry on, each epoch's chunk loop is held to a warn-mode flight
budget: nothing is built or captured after the first epoch (the staging
ring's copies are not counted as placements, so H2D is not bounded).  The
CLI's ``--elastic``/``--max-worker-loss`` run the elastic Lloyd loop
(:func:`harp_tpu_torch.elastic.apps.kmeans_stream_elastic_fit`) on a
host-sized synthetic corpus.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from harp_tpu_torch.ingest import IngestPipeline, Shipped, StagingRing
from harp_tpu_torch.models.kmeans import (_INT8_SUM_ROW_LIMIT,
                                          _check_int8_chunk_rows,
                                          _clip_round_int8, _exact_f32,
                                          _normalize_centroids,
                                          chunk_partials, epoch_operands,
                                          kmeanspp_init)
from harp_tpu_torch.ops import kmeans_kernel
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.utils import flightrec, telemetry
from harp_tpu_torch.utils.timing import device_sync


@dataclasses.dataclass
class StreamConfig:
    # epoch counts are arguments (fit_streaming(iters=...)), not config
    k: int = 1000
    # rows per streamed chunk across all workers (rounded up to a multiple
    # of the worker count); bounds peak device memory
    chunk_points: int = 262_144
    dtype: Any = torch.float32
    quantize: str | None = None  # None | "int8" (host-quantized chunks)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.chunk_points < 1:
            raise ValueError(
                f"chunk_points must be >= 1, got {self.chunk_points}")
        if self.quantize not in (None, "int8"):
            raise ValueError(
                f"quantize must be None or 'int8', got {self.quantize!r}")


def _validate_explicit_init(init, k, d):
    """The one explicit-``[k, d]``-init check of every fit variant."""
    arr = np.asarray(init, np.float32)
    if arr.ndim != 2 or arr.shape[0] != k or arr.shape[1] != d:
        raise ValueError(f"explicit init must be [k={k}, d={d}], "
                         f"got shape {arr.shape}")
    return arr


def _topup_rows(rows, count, rng):
    """Pad ``rows`` to exactly ``count`` by uniform resampling (equal
    allgather shapes across workers; no positional bias)."""
    if rows.shape[0] >= count:
        return rows[:count]
    extra = rng.choice(rows.shape[0], size=count - rows.shape[0])
    return np.concatenate([rows, rows[np.sort(extra)]], 0)


def _init_centroids(points, n, k, seed, init):
    """``kmeans.fit``'s seeding, memmap-safe: only the selected rows are
    ever read.  ``init`` may also be an explicit ``[k, d]`` array."""
    if not isinstance(init, str):
        return _validate_explicit_init(init, k, points.shape[1])
    if init == "kmeans++":
        # D² seeding on a uniform subsample of at most 50,000 rows: exact
        # kmeans++ needs k full passes over the source
        rng = np.random.default_rng(0 if seed is None else seed)
        idx = np.sort(rng.choice(n, size=min(n, 50_000), replace=False))
        return kmeanspp_init(np.asarray(points[idx], np.float32), k,
                             seed=0 if seed is None else seed)
    if init != "random":
        raise ValueError(f"init must be 'random' or 'kmeans++', got {init!r}")
    if seed is None:
        idx = np.arange(k)
    else:
        idx = np.sort(np.random.default_rng(seed).choice(n, size=k,
                                                         replace=False))
    return np.asarray(points[idx], np.float32)


def _int8_amax(points, n, chunk):
    """Per-feature |max| over a source in one chunked host pass (a memmap
    never loads more than one chunk)."""
    amax = np.zeros(points.shape[1], np.float32)
    for lo in range(0, n, chunk):
        blk = np.asarray(points[lo:lo + chunk], np.float32)
        np.maximum(amax, np.abs(blk).max(0), out=amax)
    return amax


def _amax_to_scales(amax):
    """The int8 scale rule, in one place for every streaming path."""
    return np.maximum(amax, 1e-30) / 127.0


def _int8_scales(points, n, chunk):
    return _amax_to_scales(_int8_amax(points, n, chunk))


def _gather(mesh: WorkerMesh, arr) -> np.ndarray:
    """Every worker's host array ``arr``, stacked in rank order (a
    collective: every worker calls it, in the same order)."""
    x = mesh.replicated(np.ascontiguousarray(arr))
    return C.allgather(x, tiled=False).cpu().numpy()


# wire-dtype codes for the cross-worker agreement (0 = ship the compute
# dtype); only narrow float formats have a code
_WIRE_CODES = {"float16": 1, "bfloat16": 2}
_WIRE_FROM_CODE = {1: torch.float16, 2: torch.bfloat16}
_FLOATS = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def _resolve_wire_dtype(wire, dtype, src_dtype, mesh: WorkerMesh):
    """The H2D payload dtype (a torch dtype) of the float streaming paths.

    ``wire="auto"`` ships the source dtype when it is a narrower float
    than the compute ``dtype``: f16 disk data crosses as f16 and widens on
    the card, bit-identical to the host cast (widening is exact) at half
    the bytes.  Anything else (f32 or int sources, a mixed file set:
    ``src_dtype=None``) ships the compute dtype.  An explicit dtype forces
    the wire; narrower than the source is a lossy opt-in.  ``wire=None``
    ships the compute dtype.  With several workers "auto" gathers a code
    from each and falls back to the compute dtype unless all agree."""
    if wire is None:
        return dtype
    if isinstance(wire, str) and wire == "auto":
        name = np.dtype(src_dtype).name if src_dtype is not None else None
        code = _WIRE_CODES.get(name, 0)
        if mesh.num_workers > 1:
            codes = _gather(mesh, np.array([code], np.int64)).reshape(-1)
            code = int(codes[0]) if (codes == codes[0]).all() else 0
        w = _WIRE_FROM_CODE[code] if code else dtype
        return w if w.itemsize < dtype.itemsize else dtype
    if isinstance(wire, torch.dtype):
        name = str(wire).removeprefix("torch.")
    else:
        name = wire if isinstance(wire, str) else np.dtype(wire).name
    if name not in _FLOATS:
        raise ValueError(f"wire_dtype must be a float dtype, got {name}")
    return _FLOATS[name]


def _stage(dst: torch.Tensor, rows, scales) -> None:
    """Write host ``rows`` into the staging view ``dst``, quantized with
    ``scales`` (int8) or cast to ``dst``'s dtype: the chain's one host
    copy (a read-only memmap slice is read here, not copied before)."""
    if scales is not None:
        dst.numpy()[...] = _clip_round_int8(np.asarray(rows, np.float32),
                                            scales)
    elif dst.dtype == torch.bfloat16:  # numpy has no bfloat16: torch casts
        dst.copy_(torch.from_numpy(np.array(rows, np.float32)))
    else:
        np.copyto(dst.numpy(), rows, casting="unsafe")


def _ring_pipeline(mesh, read_rows, rows_cap, d, quantize, scales, wire,
                   prefetch, tag):
    """The staged chain: ``read_rows(j)`` (this worker's rows of chunk j,
    a lazy view where the source allows) → :func:`_stage` into pinned
    buffer ``j % slots`` → the async H2D copy
    (:class:`harp_tpu_torch.ingest.StagingRing`).  ``prefetch`` is the
    pipeline's depth (1 = the same chain inline)."""
    depth = max(1, prefetch)
    ring = StagingRing(rows_cap, (d,), torch.int8 if quantize == "int8"
                       else wire, mesh.device, slots=depth + 1)

    def read(j):
        return j, read_rows(j)

    def prep(t):
        j, rows = t
        _stage(ring.host(j, rows.shape[0]), rows, scales)
        return j, rows.shape[0]

    return IngestPipeline(read, prep, lambda t: ring.ship(*t), depth=depth,
                          tag=tag)


def _legacy_pipeline(mesh, read_rows, quantize, scales, wire):
    """``prefetch=0``: the serial chain without staging, kept as the A/B
    incumbent of the pipeline: materialize the rows, quantize or cast,
    and a blocking copy from pageable memory on the compute stream."""

    def put_chunk(j):
        rows = np.asarray(read_rows(j))
        if quantize == "int8":
            host = torch.from_numpy(_clip_round_int8(
                rows.astype(np.float32), scales))
        elif wire == torch.bfloat16:
            host = torch.from_numpy(np.array(rows, np.float32)).to(wire)
        else:
            host = torch.from_numpy(np.array(
                rows, str(wire).removeprefix("torch.")))
        return Shipped(host.to(mesh.device))

    return IngestPipeline(put_chunk, depth=1, tag="kmeans_stream.legacy")


def fit_streaming(points, k=1000, iters=10, chunk_points=262_144,
                  mesh: WorkerMesh | None = None, seed=0,
                  dtype=torch.float32, quantize=None, init="random",
                  return_history=False, ckpt_dir=None, ckpt_every=5,
                  max_restarts=3, fault=None, instrument=None,
                  wire_dtype="auto", prefetch=2, device=None):
    """Blocked-epoch Lloyd over a source too large for the card.

    ``points``: an [n, d] numpy array, ``np.memmap``, or a sequential
    source honouring the slice contract
    (:class:`harp_tpu_torch.native.datasource.CSVPoints`); every worker
    passes the same source and takes its block of every chunk.  The
    semantics are ``kmeans.fit``'s: one epoch assigns every point against
    the epoch-start centroids (full-batch Lloyd, not minibatch); only the
    execution is chunked.  ``init="kmeans++"`` seeds from a uniform
    subsample of at most 50,000 rows.  Returns ``(centroids [k, d],
    inertia)``, plus the per-epoch inertia history with
    ``return_history=True`` (read back once, at the end).

    ``wire_dtype``: the H2D payload (:func:`_resolve_wire_dtype`).
    ``prefetch``: the ingest pipeline's depth.  ``>= 2`` runs read and
    prep on background threads and ships ahead, so chunk j+1's host stages
    and copy overlap chunk j's compute; ``1`` runs the same staged chain
    inline; ``0`` the unstaged serial chain (:func:`_legacy_pipeline`).
    Every depth is bit-exact.  ``instrument``: pass a dict to collect, per
    epoch under ``"epochs"``, ``host_s`` (time blocked in the pipeline),
    ``sync_s`` (the device tail after the last chunk: one extra
    synchronize an epoch), ``epoch_s`` and the pipeline's stats.

    ``ckpt_dir`` checkpoints the centroids every ``ckpt_every`` epochs and
    resumes from the latest (``max_restarts``, ``fault``: the recovery
    loop's, :func:`harp_tpu_torch.utils.fault.fit_epochs`).

    Runs on this worker's card unless ``device`` (or ``mesh``) says
    otherwise; raises without a card."""
    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    n, d = points.shape
    nw, me = mesh.num_workers, mesh.rank
    cfg = StreamConfig(k=k, chunk_points=chunk_points, dtype=dtype,
                       quantize=quantize)
    chunk = -(-min(cfg.chunk_points, n) // nw) * nw
    cl = chunk // nw  # rows of a chunk per worker

    init_c = _init_centroids(points, n, k, seed, init)
    centroids = mesh.replicated(init_c).to(dtype)
    wire = _resolve_wire_dtype(wire_dtype, dtype,
                               getattr(points, "dtype", None), mesh)
    scales = col_scale = None
    if quantize == "int8":
        # the exact-int32 bound applies per chunk (chunks add in f32); the
        # limit resolves at call time so tests can shrink it
        _check_int8_chunk_rows(cl, _INT8_SUM_ROW_LIMIT)
        scales = _int8_scales(points, n, chunk)
        col_scale = mesh.replicated(scales)
    if iters == 0:
        return _init_only(init_c, return_history)
    offsets = list(range(0, n, chunk))

    def read_rows(j):
        # the whole chunk (a sequential source must be read contiguously),
        # then this worker's block of it: a view
        blk = points[offsets[j]:min(offsets[j] + chunk, n)]
        return blk[me * cl:(me + 1) * cl]

    if prefetch == 0:
        pipe = _legacy_pipeline(mesh, read_rows, quantize, scales, wire)
    else:
        pipe = _ring_pipeline(mesh, read_rows, cl, d, quantize, scales,
                              wire, prefetch, "kmeans_stream.ingest")
    return _stream_train(mesh, cfg, pipe, len(offsets), centroids, iters,
                         return_history, instrument, col_scale,
                         ckpt=(ckpt_dir, ckpt_every, max_restarts, fault))


def _init_only(init_c, return_history):
    """``iters=0``: the contract of ``kmeans.fit(iters=0)``."""
    c = np.asarray(init_c, np.float32)
    return (c, 0.0, np.zeros(0, np.float32)) if return_history else (c, 0.0)


def _stream_train(mesh, cfg, pipe, n_chunks, centroids, iters,
                  return_history, instrument, col_scale=None,
                  epoch_reset=None, ckpt=(None, 5, 3, None)):
    """The blocked-epoch loop behind every ``fit_streaming*``: the chunk
    loop over ``pipe.stream(n_chunks)`` with this worker's partials on its
    card, one allreduce an epoch, and the history read back once at the
    end.  ``epoch_reset`` (file splits) rewinds the readers before each
    sweep.  ``ckpt``: ``(ckpt_dir, ckpt_every, max_restarts, fault)`` of
    :func:`harp_tpu_torch.utils.fault.fit_epochs`."""
    from harp_tpu_torch.utils.fault import (check_restored_shapes,
                                            fit_epochs, to_device)

    dev = mesh.device
    k, d = centroids.shape
    history: list = []

    def train_one():
        nonlocal centroids
        ep0 = time.perf_counter()
        sums = torch.zeros((k, d), device=dev)
        counts = torch.zeros((k,), device=dev)
        inertia = torch.zeros((), device=dev)
        if epoch_reset is not None:
            epoch_reset()
        ops = epoch_operands(centroids, cfg.quantize, col_scale)
        # after the first epoch the chunk loop builds and captures nothing
        with flightrec.budget(compiles=None if not history else 0,
                              action="warn", tag="kmeans_stream.ingest"):
            for shipped in pipe.stream(n_chunks):
                x = shipped.get()
                if cfg.quantize != "int8":
                    # a narrow wire widens here: exact, so bit-identical
                    # to the host cast
                    x = x.to(cfg.dtype)
                s, c, i = chunk_partials(x, ops, cfg.quantize)
                sums += s
                counts += c
                inertia += i
        with telemetry.span("kmeans.reduce"):
            s, c, ep_inertia = C.allreduce((sums, counts, inertia))
            centroids = _normalize_centroids(s, c, centroids)
        history.append(ep_inertia)
        if instrument is not None:  # one sync an epoch (docstring)
            t = time.perf_counter()
            device_sync(ep_inertia)
            instrument.setdefault("epochs", []).append({
                "host_s": pipe.stats.blocked_s,
                "sync_s": time.perf_counter() - t,
                "epoch_s": time.perf_counter() - ep0,
                "pipeline": pipe.stats.as_dict()})

    def get_state():
        # live tensors, no sync: fit_epochs asks every epoch
        return {"centroids": centroids, "hist": list(history)}

    def set_state(state):
        nonlocal centroids, history
        check_restored_shapes([("centroids", state["centroids"],
                                centroids)])
        centroids = to_device(state["centroids"], dev, centroids.dtype)
        history = [to_device(h, dev, torch.float32) for h in state["hist"]]

    ckpt_dir, ckpt_every, max_restarts, fault = ckpt
    try:
        fit_epochs(train_one, get_state, set_state, iters, ckpt_dir,
                   ckpt_every=ckpt_every, max_restarts=max_restarts,
                   fault=fault, phase="kmeans_stream.fit")
    finally:
        pipe.close()  # reap the stage threads on every exit path
    final = torch.stack(history).cpu().numpy()  # one readback
    c_host = centroids.to(torch.float32).cpu().numpy()
    if return_history:
        return c_host, float(final[-1]), final
    return c_host, float(final[-1])


def fit_streaming_local(points_local, k=1000, iters=10,
                        chunk_points=262_144, mesh: WorkerMesh | None = None,
                        seed=0, dtype=torch.float32, quantize=None,
                        init="random", return_history=False, ckpt_dir=None,
                        ckpt_every=5, max_restarts=3, fault=None,
                        instrument=None, wire_dtype="auto", prefetch=2,
                        device=None):
    """Blocked-epoch Lloyd where each worker streams only its own split —
    Harp's HDFS-split ingest: no worker reads the whole dataset.

    ``points_local``: this worker's ``[n_local, d]`` rows (ndarray or
    ``np.memmap``); the global row order is rank-major.  The semantics are
    :func:`fit_streaming`'s: with the same explicit ``init`` the two give
    the same clustering up to the order of the f32 partial sums.  Workers
    may stream different chunk counts: the epoch's one collective is its
    final allreduce.

    ``init``: "random" (each worker contributes ⌈k/workers⌉ rows of its
    split, gathered, the first k kept), "kmeans++" (D² seeding on a
    gathered subsample of at most 50,000 rows), or an explicit ``[k, d]``
    array.  ``quantize="int8"`` takes each worker's per-feature |max| over
    its split and the elementwise max over workers: the single-source
    scales of the same global data.  Other knobs as in
    :func:`fit_streaming`."""
    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    nw = mesh.num_workers
    n_local, d = points_local.shape
    if n_local == 0:
        raise ValueError("every worker must hold at least one row "
                         "(this one has an empty split)")
    cfg = StreamConfig(k=k, chunk_points=chunk_points, dtype=dtype,
                       quantize=quantize)
    # before any other collective: collective order must match
    wire = _resolve_wire_dtype(wire_dtype, dtype,
                               getattr(points_local, "dtype", None), mesh)
    n_all = _gather(mesh, np.array([n_local], np.int64)).reshape(-1)
    # chunk rows per worker from global information, so every worker
    # takes the same chunk rows; a short split just streams fewer chunks
    cl = max(1, min(-(-cfg.chunk_points // nw), int(n_all.max())))
    scales = col_scale = None
    if quantize == "int8":
        _check_int8_chunk_rows(cl, _INT8_SUM_ROW_LIMIT)
        amax = _gather(mesh, _int8_amax(points_local, n_local, cl)).max(0)
        scales = _amax_to_scales(amax)
        col_scale = mesh.replicated(scales)

    def local_seed_rows(count, rng_seed):
        """``count`` rows of this split (equal shapes on every worker for
        the gather); a short split is topped up by uniform resampling."""
        rng = np.random.default_rng(0 if rng_seed is None else rng_seed)
        if n_local >= count:
            idx = (np.arange(count) if rng_seed is None
                   else rng.choice(n_local, size=count, replace=False))
        else:
            idx = np.concatenate([np.arange(n_local),
                                  rng.choice(n_local, count - n_local)])
        return np.asarray(points_local[np.sort(idx)], np.float32)

    if not isinstance(init, str):
        init_c = _init_centroids(points_local, n_local, k, seed, init)
    elif init == "random":
        per = -(-k // nw)
        if n_local < per:
            # resampled rows would be duplicate centroids: clusters that
            # stay empty for good
            raise ValueError(
                f"init='random' needs >= ceil(k/workers) = {per} rows per "
                f"worker split, this one has {n_local}; pass an explicit "
                "[k, d] init array instead")
        init_c = _gather(mesh, local_seed_rows(per, seed)).reshape(-1, d)[:k]
    elif init == "kmeans++":
        per = -(-min(50_000, int(n_all.sum())) // nw)
        sub = _gather(mesh, local_seed_rows(
            per, 0 if seed is None else seed)).reshape(-1, d)
        init_c = kmeanspp_init(sub, k, seed=0 if seed is None else seed)
    else:
        raise ValueError(f"init must be 'random', 'kmeans++' or a [k, d] "
                         f"array, got {init!r}")
    centroids = mesh.replicated(np.asarray(init_c, np.float32)).to(dtype)
    if iters == 0:
        return _init_only(init_c, return_history)
    pipe = _ring_pipeline(
        mesh, lambda j: points_local[j * cl:min((j + 1) * cl, n_local)], cl,
        d, quantize, scales, wire, prefetch, "kmeans_stream.local")
    return _stream_train(mesh, cfg, pipe, -(-n_local // cl), centroids,
                         iters, return_history, instrument, col_scale,
                         ckpt=(ckpt_dir, ckpt_every, max_restarts, fault))


def fit_streaming_files(paths, k=1000, iters=10, chunk_points=262_144,
                        mesh: WorkerMesh | None = None, seed=0,
                        dtype=torch.float32, quantize=None, init="random",
                        return_history=False, ckpt_dir=None, ckpt_every=5,
                        max_restarts=3, fault=None, instrument=None,
                        reader_chunk_rows=65_536, info=None,
                        wire_dtype="auto", prefetch=2, device=None):
    """Blocked-epoch Lloyd over a directory of file splits — Harp's input
    shape: files are dealt to workers by the size-balanced
    ``multi_file_splits`` rule and each worker streams only its own (npy
    memmaps, or text through the native reader), so every file is read by
    exactly one worker.

    ``paths``: the resolved file list (``harp_tpu_torch.fileformat.
    list_files`` for a glob or directory; sorted here for a deterministic
    assignment).  ``info``: a dict to receive ``n_total`` and ``d``.  The
    semantics are :func:`fit_streaming`'s on the same rows (in another,
    worker-major, order, which Lloyd does not see).  A worker may own no
    file (more workers than files): it streams nothing and adds zeros.
    String seeding needs rows on every worker; an explicit ``init`` does
    not.  ``init`` as in :func:`fit_streaming_local`, drawn by
    ``FileSplits.sample``."""
    from harp_tpu_torch.native.datasource import FileSplits

    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    fs = FileSplits(sorted(paths), mesh.num_workers, [mesh.rank],
                    chunk_rows=reader_chunk_rows)
    try:
        return _fit_streaming_files(fs, paths, k, iters, chunk_points, mesh,
                                    seed, dtype, quantize, init,
                                    return_history, instrument, info,
                                    wire_dtype, prefetch,
                                    (ckpt_dir, ckpt_every, max_restarts,
                                     fault))
    finally:
        fs.close()  # also on iters=0 and on a raise: no descriptor leaks


def _fit_streaming_files(fs, paths, k, iters, chunk_points, mesh, seed,
                         dtype, quantize, init, return_history, instrument,
                         info, wire_dtype, prefetch, ckpt):
    nw, me = mesh.num_workers, mesh.rank
    cfg = StreamConfig(k=k, chunk_points=chunk_points, dtype=dtype,
                       quantize=quantize)
    # before the other gathers: collective order must match
    wire = _resolve_wire_dtype(wire_dtype, dtype, fs.dtype, mesh)
    rows = _gather(mesh, np.array([fs.rows(me)], np.int64)).reshape(-1)
    n_total = int(rows.sum())
    if n_total == 0:
        raise ValueError(f"{len(paths)} input files contain no rows")
    # the feature dim must agree across workers too (each FileSplits sees
    # only its own files); a worker without files adopts the global d
    d_all = _gather(mesh, np.array([fs.cols], np.int64)).reshape(-1)
    d = int(d_all.max())
    if np.any((d_all != 0) & (d_all != d)):
        raise ValueError(
            f"input files disagree on column count across workers "
            f"({sorted(set(int(v) for v in d_all if v))}) — a ragged mix "
            "would silently misalign features")
    cl = max(1, min(-(-cfg.chunk_points // nw), int(rows.max())))
    if info is not None:
        info.update({"n_total": n_total, "d": d})
    scales = col_scale = None
    if quantize == "int8":
        _check_int8_chunk_rows(cl, _INT8_SUM_ROW_LIMIT)
        local_amax = fs.amax()
        if local_amax.shape[0] != d:  # a worker without files: zeros
            local_amax = np.zeros(d, np.float32)
        scales = _amax_to_scales(_gather(mesh, local_amax).max(0))
        col_scale = mesh.replicated(scales)

    if not isinstance(init, str):
        init_c = _validate_explicit_init(init, k, d)
    elif init in ("random", "kmeans++"):
        if (rows == 0).any():
            raise ValueError(
                f"worker(s) {np.flatnonzero(rows == 0).tolist()} own no "
                "rows under the file assignment — string seeding has "
                "nothing to sample there; pass an explicit [k, d] init "
                "array (or use fewer workers)")
        per = -(-(k if init == "random" else min(50_000, n_total)) // nw)
        if init == "random" and (rows < per).any():
            # every worker sees the gathered counts, so all raise together
            short = np.flatnonzero(rows < per).tolist()
            raise ValueError(
                f"init='random' needs >= ceil(k/workers) = {per} rows per "
                f"worker; worker(s) {short} hold fewer — pass an explicit "
                "[k, d] init array instead")
        rng = np.random.default_rng((0 if seed is None else seed, me))
        mine = _topup_rows(fs.sample(per, rng=rng), per, rng)
        gathered = _gather(mesh, mine).reshape(-1, d)
        init_c = (gathered[:k] if init == "random" else
                  kmeanspp_init(gathered, k, seed=0 if seed is None else seed))
    else:
        raise ValueError(f"init must be 'random', 'kmeans++' or a [k, d] "
                         f"array, got {init!r}")
    centroids = mesh.replicated(np.asarray(init_c, np.float32)).to(dtype)
    if iters == 0:
        return _init_only(init_c, return_history)
    # a stateful sequential source: the read stage runs on one thread in
    # submission order, so the file cursors advance as in a serial loop
    pipe = _ring_pipeline(mesh, lambda j: fs.next_block(me, cl), cl, d,
                          quantize, scales, wire, prefetch,
                          "kmeans_stream.files")
    return _stream_train(mesh, cfg, pipe, -(-fs.rows(me) // cl), centroids,
                         iters, return_history, instrument, col_scale,
                         epoch_reset=fs.reset, ckpt=ckpt)


def _chunk_seed(seed: int, worker: int, j: int) -> int:
    return int(np.random.SeedSequence([seed, worker, j]).generate_state(
        1, np.uint64)[0])


def _make_chunk_gen(seed: int, worker: int, rows: int, d: int, dtype,
                    device):
    """The chunk generator, shared by the benchmark's run and its gen-only
    twin so the two time the same generation: chunk j is drawn from a
    generator seeded by (seed, worker, j) alone, the same every epoch."""
    g = torch.Generator(device=device)

    def gen(j):
        g.manual_seed(_chunk_seed(seed, worker, j))
        return torch.randn((rows, d), generator=g, device=device,
                           dtype=dtype)

    return gen


def _synthetic_run(centroids, n_iters, gen, n_chunks, cfg, col_scale):
    """``n_iters`` Lloyd epochs over ``n_chunks`` generated chunks a
    worker → (centroids, last epoch's inertia); never waits for the card
    (one worker's allreduce is the identity, NCCL's is enqueued)."""
    dev = centroids.device
    k, d = centroids.shape
    inertia = torch.zeros((), device=dev)
    for _ in range(n_iters):
        ops = epoch_operands(centroids, cfg.quantize, col_scale)
        sums = torch.zeros((k, d), device=dev)
        counts = torch.zeros((k,), device=dev)
        part = torch.zeros((), device=dev)
        for j in range(n_chunks):
            x, x2 = gen(j), None
            if cfg.quantize == "int8":
                # the generated chunk to its int8 chunk and its sum of
                # |x|^2 in one pass (a bf16 chunk widens to f32 exactly)
                with telemetry.span("kmeans_stream.quantize"):
                    x, x2 = kmeans_kernel.quantize_rows_int8(
                        x.to(torch.float32), col_scale)
            s, c, i = chunk_partials(x, ops, cfg.quantize, x2=x2)
            sums += s
            counts += c
            part += i
        with telemetry.span("kmeans.reduce"):
            s, c, inertia = C.allreduce((sums, counts, part))
            centroids = _normalize_centroids(s, c, centroids)
    return centroids, inertia


def _gen_only_run(n_iters, gen, n_chunks, device):
    """The calibration twin of :func:`_synthetic_run`: the same generation,
    with a running sum in place of the Lloyd partials."""
    acc = torch.zeros((), device=device)
    for _ in range(n_iters):
        for j in range(n_chunks):
            acc += gen(j).to(torch.float32).sum()
    return C.allreduce(acc)


def benchmark_streaming(n=100_000_000, d=300, k=1000, iters=3,
                        chunk_points=262_144, mesh=None, seed=0,
                        dtype=torch.float32, warmup=1, calibrate_gen=False,
                        quantize=None, device=None):
    """Iterations/s of the blocked-epoch formulation at north-star scale.

    The data is regenerated on the card (:func:`_make_chunk_gen`), so
    ``n`` is bounded by compute, not by device or host memory.
    ``chunk_points`` is clipped to ``n`` and an epoch is
    ``max(1, n // chunk)`` whole chunks: the returned ``n`` is the points
    an epoch really holds.  ``max(warmup, 1)`` untimed epochs run first;
    the timed window holds ``iters`` epochs and ends in one synchronize.
    The int8 twin quantizes each chunk on the card with a static 5σ
    |max| (the points are N(0, 1) per feature).  On the card the result
    holds ``peak_mem_bytes``, the timed window's peak allocation.

    ``calibrate_gen``: also time a generation-only twin and report
    ``gen_sec_per_iter`` and ``iters_per_sec_ex_gen`` (:func:`_ex_gen_fields`):
    an upper estimate of the compute rate without the generation."""
    mesh = resolve_mesh(mesh, device)
    dev = mesh.device
    _exact_f32(dev)
    nw = mesh.num_workers
    cfg = StreamConfig(k=k, chunk_points=-(-min(chunk_points, n) // nw) * nw,
                       dtype=dtype, quantize=quantize)
    n_chunks = max(1, n // cfg.chunk_points)
    n_eff = n_chunks * cfg.chunk_points
    rows = cfg.chunk_points // nw
    col_scale = None
    if quantize == "int8":
        _check_int8_chunk_rows(rows, _INT8_SUM_ROW_LIMIT)
        col_scale = mesh.replicated(
            _amax_to_scales(np.full(d, 5.0, np.float32)))
    gen = _make_chunk_gen(seed, mesh.rank, rows, d, dtype, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    centroids = torch.randn((k, d), generator=g, device=dev).to(dtype)

    def run(n_iters):
        return _synthetic_run(centroids, n_iters, gen, n_chunks, cfg,
                              col_scale)

    device_sync(run(max(warmup, 1))[1])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with telemetry.span("kmeans_stream.benchmark", iters=iters):
        _, inertia = run(iters)
        inertia_val = device_sync(inertia)
    dt = time.perf_counter() - t0
    out = {
        "iters_per_sec": iters / dt,
        "points_per_sec": n_eff * iters / dt,
        "sec_per_iter": dt / iters,
        "inertia": inertia_val,
        "n": n_eff, "d": d, "k": k, "chunk_points": cfg.chunk_points,
        "n_chunks": n_chunks, "num_workers": nw,
        "dtype": str(dtype).removeprefix("torch."), "quantize": quantize,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev) if cuda
                           else None),
    }
    if calibrate_gen:
        device_sync(_gen_only_run(max(warmup, 1), gen, n_chunks, dev))
        t0 = time.perf_counter()
        device_sync(_gen_only_run(iters, gen, n_chunks, dev))
        out.update(_ex_gen_fields(dt, time.perf_counter() - t0, iters))
    return out


def _ex_gen_fields(dt: float, gen_dt: float, iters: int) -> dict:
    """Calibration post-processing: a generation time that eats (nearly)
    the whole run makes the subtraction noise, so the "ex-gen" rate is
    None rather than an absurd number."""
    fields = {"gen_sec_per_iter": gen_dt / iters}
    if gen_dt >= 0.9 * dt:
        fields["iters_per_sec_ex_gen"] = None
        fields["gen_calibration"] = ("invalid: gen time >= 90% of total "
                                     "(RNG overlaps compute, or timing noise)")
    else:
        fields["iters_per_sec_ex_gen"] = iters / (dt - gen_dt)
    return fields


def benchmark_ingest(points, k=1000, iters=2, chunk_points=262_144,
                     mesh=None, dtype=torch.float32, quantize=None, seed=0,
                     disk_bytes=None, compare_synthetic=False,
                     wire_dtype="auto", prefetch=2, device=None):
    """End-to-end rate of :func:`fit_streaming` on a real source: disk
    read, host prep and the H2D copy, with the card's compute behind them
    (:func:`benchmark_streaming` measures the formulation on regenerated
    data).

    ``points``: any ``fit_streaming`` source.  ``disk_bytes``: the on-disk
    bytes an epoch (the file size); defaults to ``n*d*itemsize`` where the
    source has a dtype, else the f32 size.  Fields:

    - ``points_per_sec``: points × epochs over the whole wall (centroid
      init included; the per-epoch fields exclude it);
    - ``host_sec_per_epoch`` / ``host_gb_per_sec``: time blocked in the
      pipeline and the disk bytes over it;
    - ``sync_sec_per_epoch``: the device tail after the last chunk;
    - ``overlap_efficiency``: the pipeline's
      (:class:`harp_tpu_torch.ingest.IngestStats`);
    - ``device_hidden_fraction``: host_s / (host_s + sync_s);
    - ``ingest_bound_fraction``: host_s / epoch_s;
    - ``wire_dtype`` / ``wire_gb_per_epoch``: the H2D payload;
    - with ``compare_synthetic``: the synthetic formulation at the same
      shapes."""
    mesh = resolve_mesh(mesh, device)
    n, d = points.shape
    wire = _resolve_wire_dtype(wire_dtype, dtype,
                               getattr(points, "dtype", None), mesh)
    inst: dict = {}
    t0 = time.perf_counter()
    _, inertia = fit_streaming(points, k=k, iters=iters,
                               chunk_points=chunk_points, mesh=mesh,
                               seed=seed, dtype=dtype, quantize=quantize,
                               instrument=inst, wire_dtype=wire_dtype,
                               prefetch=prefetch)
    wall = time.perf_counter() - t0
    eps = inst["epochs"]
    host = sum(e["host_s"] for e in eps) / len(eps)
    sync = sum(e["sync_s"] for e in eps) / len(eps)
    epoch = sum(e["epoch_s"] for e in eps) / len(eps)
    if disk_bytes is None:
        itemsize = getattr(getattr(points, "dtype", None), "itemsize", 4)
        disk_bytes = n * d * itemsize
    wire_item = 1 if quantize == "int8" else wire.itemsize
    out = {
        "points_per_sec": n * iters / wall,
        "epoch_sec": epoch,
        "host_sec_per_epoch": host,
        "host_gb_per_sec": disk_bytes / 1e9 / host if host else None,
        "sync_sec_per_epoch": sync,
        "overlap_efficiency": eps[-1]["pipeline"]["overlap_efficiency"],
        "device_hidden_fraction": (host / (host + sync)
                                   if host + sync else None),
        "ingest_bound_fraction": host / epoch if epoch else None,
        "disk_gb_per_epoch": disk_bytes / 1e9,
        "inertia": float(inertia),
        "n": n, "d": d, "k": k, "iters": iters,
        "chunk_points": chunk_points, "quantize": quantize,
        "wire_dtype": ("int8" if quantize == "int8"
                       else str(wire).removeprefix("torch.")),
        "wire_gb_per_epoch": n * d * wire_item / 1e9,
        "num_workers": mesh.num_workers,
        "source": type(points).__name__,
        "kind": "ingest",
        "prefetch_depth": prefetch,
        "pipeline": eps[-1]["pipeline"],
    }
    if compare_synthetic:
        syn = benchmark_streaming(n=n, d=d, k=k, iters=iters,
                                  chunk_points=chunk_points, mesh=mesh,
                                  dtype=dtype, seed=seed)
        out["synthetic_sec_per_epoch"] = syn["sec_per_iter"]
        out["synthetic_points_per_sec"] = syn["points_per_sec"]
    return out


def _elastic_main(args) -> int:
    """``--elastic``: the corpus is materialized (a repartition relabels
    rows), so it pairs with a host-sized synthetic ``--n``."""
    from harp_tpu_torch.elastic.apps import kmeans_stream_elastic_fit
    from harp_tpu_torch.report import maybe_emit
    from harp_tpu_torch.utils.metrics import benchmark_json

    if args.input:
        raise SystemExit(
            "--elastic pairs with the synthetic corpus; use --n/--d (file "
            "inputs ride the non-elastic streaming fit)")
    if args.quantize or args.dtype != "float32":
        raise SystemExit("--elastic runs the f32 Lloyd epoch; drop "
                         "--quantize/--dtype")
    mesh = WorkerMesh(args.device)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(args.n, args.d)).astype(np.float32)
    ad = kmeans_stream_elastic_fit(
        pts, k=args.k, iters=args.iters, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        max_worker_loss=max(args.max_worker_loss, 0), mesh=mesh,
        chunk_rows=-(-args.chunk // mesh.num_workers))
    print(benchmark_json("kmeans_stream_elastic_cli", {
        "k": args.k, "iters": args.iters, "n": args.n, "d": args.d,
        "inertia": None if ad.sat_out else ad.metric(),
        "n_workers": ad.mesh.num_workers if ad.mesh.is_member else 0,
        "worker_losses": ad.losses, "ckpt_dir": args.ckpt_dir},
        mesh.device))
    maybe_emit("kmeans_stream")
    return 0


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu streaming KMeans on PyTorch (the 1B-point "
                    "north-star path)")
    p.add_argument("--n", type=int, default=100_000_000)
    p.add_argument("--d", type=int, default=300)
    p.add_argument("--k", type=int, default=1000)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--chunk", type=int, default=262_144)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--input", default=None, metavar="NPY_PARQUET_CSV_OR_GLOB",
                   help="stream a .npy file (np.memmap), a .parquet file "
                        "(pyarrow row groups), a CSV/text file (native "
                        "streaming reader) or a glob/directory of "
                        "split files (dealt to workers size-balanced, each "
                        "streaming only its own) instead of the synthetic "
                        "benchmark")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8 chunks (a quarter of the f32 bytes; kernel K1)")
    p.add_argument("--wire-dtype", default="auto",
                   choices=["auto", "none", "float16", "bfloat16",
                            "float32"],
                   help="H2D payload for --input streaming: auto ships "
                        "narrow-float sources as they are (bit-identical); "
                        "none ships the compute dtype; an explicit dtype "
                        "forces the wire (narrower than the source is "
                        "lossy)")
    p.add_argument("--init", choices=["random", "kmeans++"],
                   default="random")
    p.add_argument("--prefetch", type=int, default=2,
                   help="ingest pipeline depth for --input streaming: >= 2 "
                        "overlaps read, prep and copy; 1 = the staged chain "
                        "inline; 0 = the unstaged serial chain")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint/resume for --input runs: a rerun on "
                        "the same directory resumes from the latest epoch")
    p.add_argument("--ckpt-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="require a resume: --ckpt-dir must already hold a "
                        "checkpoint")
    p.add_argument("--elastic", action="store_true",
                   help="elastic Lloyd: take mid-run skew_trigger findings "
                        "between sweeps (rebalance point packs) and "
                        "checkpoint mesh-independent centroids")
    p.add_argument("--max-worker-loss", type=int, default=0,
                   help="elastic: survive up to N permanent worker losses "
                        "by shrinking to the survivors and replaying the "
                        "repartition plan from the last checkpoint "
                        "(implies --elastic; needs --ckpt-dir to resume)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    if args.elastic or args.max_worker_loss:
        return _elastic_main(args)
    from harp_tpu_torch.utils.fault import resolve_resume

    resumed_from = resolve_resume(args.ckpt_dir, args.resume)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    wire = {"auto": "auto", "none": None}.get(args.wire_dtype,
                                              args.wire_dtype)
    mesh = WorkerMesh(args.device)

    if not args.input:
        if args.ckpt_dir is not None:
            raise SystemExit("--ckpt-dir checkpoints --input runs (the "
                             "synthetic benchmark is not resumable)")
        print(benchmark_json("kmeans_stream_cli", benchmark_streaming(
            args.n, args.d, args.k, args.iters, args.chunk, mesh=mesh,
            dtype=dtype, quantize=args.quantize), mesh.device))
        return 0
    from harp_tpu_torch.fileformat import list_files
    from harp_tpu_torch.native.datasource import CSVPoints, ParquetPoints

    # a literal path wins over glob expansion ('data[v2].npy' is a file)
    paths = ([args.input] if os.path.isfile(args.input)
             else list_files(args.input))
    if not paths:
        raise SystemExit(f"{args.input}: no input files matched")
    kw = dict(dtype=dtype, quantize=args.quantize, init=args.init,
              mesh=mesh, wire_dtype=wire, prefetch=args.prefetch,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    if len(paths) > 1:  # a split directory: per-worker file streams
        info: dict = {}
        _, inertia = fit_streaming_files(paths, args.k, args.iters,
                                         args.chunk, info=info, **kw)
        n_rows, d_cols = info["n_total"], info["d"]
    else:
        if paths[0].endswith(".npy"):
            pts = np.load(paths[0], mmap_mode="r")
        elif paths[0].endswith((".parquet", ".pq")):
            pts = ParquetPoints(paths[0], chunk_rows=args.chunk)
        else:  # text: the native streaming reader, never materialised
            pts = CSVPoints(paths[0], chunk_rows=args.chunk)
        _, inertia = fit_streaming(pts, args.k, args.iters, args.chunk, **kw)
        n_rows, d_cols = int(pts.shape[0]), int(pts.shape[1])
    print(benchmark_json("kmeans_stream_fit_cli", {
        "k": args.k, "iters": args.iters, "n": n_rows, "d": d_cols,
        "files": len(paths), "inertia": float(inertia),
        "ckpt_dir": args.ckpt_dir, "resumed_from": resumed_from},
        mesh.device))
    return 0


if __name__ == "__main__":
    main()
