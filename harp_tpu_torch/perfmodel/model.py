"""The offline cost model, priced on the H100: the port of
``harp_tpu.perfmodel.model``.

The contract is the reference's.  Each config's unit (a Lloyd iteration,
a rating update, a Gibbs token, a sample, a SMACOF iteration) is priced
as an additive :class:`Price` of four terms, compute + memory + wire +
overhead; ``bound`` names the largest, and the terms sum exactly to
``predicted_s``.  The sum, not the max: the port's iterations run their
phases in sequence on one stream, so the model charges each.  It is a
RANKING model: absolute seconds are graded only to a loose band, the
ordering of configs against every card row committed in
``H100_EVIDENCE.jsonl`` (:mod:`harp_tpu_torch.perfmodel.grade`).

Every rate is the card's:

- **compute**: operations at the peak of their type (:data:`~harp_tpu_
  torch.utils.roofline.PEAK_OPS`: int8 tensor cores for K1, bf16 for K2,
  f32 CUDA cores for the plain f32 routes and K3-K6), transcendentals at
  ``SFU_OPS_S``.  On a kernel route the work is the registry's own count
  (:mod:`harp_tpu_torch.ops.kernel_registry`: ``k12_ops``, ``k3_ops``,
  ``k4_bytes``, ``k5_bytes``, ``k6_bytes``), so the model and the bounds
  of ``PERF.md`` count one work;
- **memory**: bytes at ``HBM_BYTES_S``.  A plain-torch route counts the
  intermediates the port's own code writes: each op's operands read and
  its result written, from a replay of the route's ops at a small shape
  on the CPU (:func:`count_ops`; the coefficients below are pinned, and
  ``tests/test_torch_perfmodel.py`` counts them again);
- **wire**: :func:`wire_cost_s`, the planner's own site price;
- **overhead**: the card's :data:`~harp_tpu_torch.utils.flightrec.
  CALIBRATED_OVERHEADS` times the host launches and readbacks a unit
  pays (counted from the route's ops the same way), plus the two
  mechanism terms the kernels' dependency chains pay (:data:`K3_ENTRY_
  SYNC_S`, :data:`K4_CHUNK_SYNC_S`).  Host prep and H2D are charged only
  where the committed metric times them (SVM's and WDA-MDS's fit stage
  their data; the KMeans, MF-SGD and LDA benchmarks do not).

Families whose wall the model has no term for are absent from
:data:`CONFIG_MODELS`: RF's fit is host-bound (numpy binning, idle 0.99),
and so are subgraph counting and the serve plane; ``predict --top`` lists
them as unpriced.  No number beats a wrong one.

Every calibrated constant cites its evidence row: config, card, power
limit and date.
"""

from __future__ import annotations

import dataclasses
import math

from harp_tpu_torch.ops import kernel_registry as KR
from harp_tpu_torch.utils.flightrec import CALIBRATED_OVERHEADS
from harp_tpu_torch.utils.roofline import HBM_BYTES_S, PEAK_OPS, SFU_OPS_S

#: frozen vocabularies (the reference's)
BOUNDS = ("compute", "memory", "wire", "overhead")
RATES_SOURCES = ("declared", "probed")

# ---------------------------------------------------------------------------
# Route constants: host launches and intermediate bytes of the port's code
# ---------------------------------------------------------------------------
# Counted with count_ops on the CPU (the plain routes run the same torch ops
# on the card); a kernel route's launches are its wrapper's, read from the
# wrapper (allocations launch nothing; each zeros, copy and reduction does).

#: ``_partials_block`` + ``kmeans_step`` + ``_combine_partials``: ops an
#: f32 iteration (count_ops: 24 on the CPU, one of them the aminmax of
#: one_hot's bounds check, which a CUDA tensor skips)
KMEANS_F32_LAUNCHES = 23
#: bytes an f32 iteration writes and reads per (point, centroid) and per
#: (point, feature): the [n, k] scores (mm out, ×2, − c2), the argmin,
#: one_hot's int64 [n, k] and its f32 cast, the one-hotᵀ @ x read and the
#: counts' sum: 52 n·k; x read by both matmuls, |x|² written and summed:
#: 20 n·d; the [n] argmin, gather and best sum: 30 n
KMEANS_F32_NK_BYTES, KMEANS_F32_ND_BYTES, KMEANS_F32_N_BYTES = 52.0, 20.0, 30.0
#: K1's iteration: _quantize_centroids (10), the wrapper (two zeros, the
#: launch, three casts and the best-sum reduction: 7), the x2 add and
#: _combine_partials (11)
KMEANS_K1_LAUNCHES = 28
#: K2's iteration: bf16_centroids (4), the wrapper (zeros, two CUDA
#: launches at k = 100, a cast, the best-sum reduction: 5), the c2 and
#: _combine_partials (11)
KMEANS_K2_LAUNCHES = 20
#: a streamed int8 chunk: randn, the fused quantize and |x|² pass
#: (kmeans_kernel.quantize_rows_int8: 1), K1's wrapper (7), the three
#: accumulations
STREAM_INT8_CHUNK_LAUNCHES = 12
#: a streamed f32 chunk: randn, _partials_block (22), the accumulations
STREAM_F32_CHUNK_LAUNCHES = 26
#: bytes an int8 chunk element moves around K1: randn's f32 write (4),
#: the fused pass's f32 read and int8 write (4 + 1)
STREAM_INT8_ELEM_BYTES = 9.0
#: special-function results an element of randn (the Box-Muller log, sqrt
#: and sincos a pair of outputs)
STREAM_GEN_SFU_PER_ELEM = 2.0

#: the dense MF-SGD (K3's plain version, a level at a time): ops a level
#: (count_ops: 70.4-71.1 over three shapes) and bytes a slot and rank
#: element (193.6-226.6: the gathers, the bf16 roundings, the gradient
#: products, the masked index_add_ and the tile applies)
MFSGD_DENSE_LAUNCHES_PER_LEVEL = 70
MFSGD_DENSE_BYTES_PER_SLOT_RANK = 200.0
#: K3's rotation step: the wrapper (two clones, three zeros, the launch,
#: two sums) and the pipeline's step (rotate, adds)
MFSGD_K3_LAUNCHES_PER_STEP = 13

#: the dense LDA (``_sample_entry_tiles`` an entry): ops an entry
#: (count_ops: 46.2-46.4) and bytes a slot and topic (205.5-217.8: the
#: Gumbel draws, the doc and word row gathers, the posterior passes, the
#: argmax, the count deltas)
LDA_DENSE_LAUNCHES_PER_ENTRY = 46
LDA_DENSE_BYTES_PER_SLOT_TOPIC = 210.0
#: special-function results a slot and topic of the dense arm: the
#: exponential draw's log and the Gumbel's −log
LDA_DENSE_SFU_PER_SLOT_TOPIC = 2.0
#: K4's rotation step: seeds, the launch, the Nk allreduce and adds, the
#: pipeline's step
LDA_K4_LAUNCHES_PER_STEP = 14

#: SVM's plain Pegasos step: ops (count_ops: 19) and bytes: x read by
#: both products (8 n·d) and the [n] vectors (165 a sample)
SVM_PLAIN_LAUNCHES_PER_STEP = 19
SVM_PLAIN_N_BYTES = 165.0
#: K5's step: the launch and the w, b updates
SVM_K5_LAUNCHES_PER_STEP = 8

#: WDA-MDS's plain SMACOF iteration: ops (count_ops: 29) and bytes a
#: (row, column) pair (117: distances, the guarded ratio, the B·X product)
WDAMDS_PLAIN_LAUNCHES_PER_ITER = 29
WDAMDS_PLAIN_PAIR_BYTES = 117.0
#: K6's iteration: the launch, the slice, the reshard
WDAMDS_K6_LAUNCHES_PER_ITER = 10

# ---------------------------------------------------------------------------
# Calibrated mechanism constants (each cites its evidence row)
# ---------------------------------------------------------------------------

#: K3 (csrc/mfsgd_tile_update.cu) runs an entry on a cluster of CLUSTER
#: blocks once its two predecessors (same W tile, same H tile) have
#: applied.  An entry's time is a fixed part, the wait on its
#: predecessors' flags, the staging of its sorted ratings and the apply
#: (K3_ENTRY_SYNC_S), and its two passes over the ratings (by W row, then
#: by H row), each split over the cluster's K3_WORKERS workers (16 lanes
#: a worker, 512 threads a block), a worker taking its ratings in sequence
#: through L2 (K3_RATING_S a rating).  A step lasts its critical path of
#: entries, or its entries over the clusters that run side by side
#: (K3_CLUSTERS), whichever is longer.  Both constants solve the two
#: path-bound rows at 256 × 256 tiles (mfsgd_pallas, 8.64 ms a step over
#: 593 entries of 349 ratings) and 512 × 512 (the mfsgd_pallas_tile sweep,
#: 10.32 ms over 297 entries of 1,367) (H100_EVIDENCE.jsonl, NVIDIA H100
#: 80GB HBM3, 700.00 W, 2026-10-18); the sweep's 128 × 128 point (113,610
#: entries: bound by throughput, not by the path) is the prediction.
K3_ENTRY_SYNC_S = 7.0e-06
K3_RATING_S = 0.63e-06
K3_WORKERS = 2 * 512 // 16
K3_CLUSTERS = 132 // 2
#: K4 walks an entry's chunks with a grid barrier on each side of each
#: chunk's deltas: the two barriers of one chunk, from the lda_pallas
#: row's step (0.18534 s) over its 44,530 modeled chunks, less the
#: modeled compute, memory and launches (H100_EVIDENCE.jsonl, lda_pallas,
#: NVIDIA H100 80GB HBM3, 700.00 W, 2026-10-18); the lda_pallas_tile
#: sweep's 128 and 256 points are predictions.
K4_CHUNK_SYNC_S = 4.14e-06


# ---------------------------------------------------------------------------
# Price: the per-config term sheet
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Price:
    """One config's predicted per-unit time, with the term breakdown."""

    config: str
    metric: str              # the throughput metric 1/predicted_s predicts
    compute_s: float
    memory_s: float
    wire_s: float
    overhead_s: float

    @property
    def predicted_s(self) -> float:
        return (self.compute_s + self.memory_s + self.wire_s
                + self.overhead_s)

    @property
    def predicted_rate(self) -> float:
        return 1.0 / self.predicted_s

    @property
    def bound(self) -> str:
        terms = self.terms()
        return max(BOUNDS, key=lambda b: terms[f"{b}_s"])

    def terms(self) -> dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "wire_s": self.wire_s, "overhead_s": self.overhead_s}


def _mk_price(config, metric, *, ops=None, sfu=0.0, hbm_bytes=0.0,
              wire_s=0.0, launches=0.0, readbacks=0.0, h2d_bytes=0.0,
              sync_s=0.0, units=1.0) -> Price:
    """The four terms of ``units`` units of work, per unit: ``ops``
    {kind: operations} at PEAK_OPS[kind], ``sfu`` results, ``hbm_bytes``,
    host ``launches``/``readbacks`` at the calibrated costs, ``h2d_bytes``
    staged, and ``sync_s`` of the kernels' own waits (no priced config
    captures a graph in its timed window, so ``compile_s`` is charged
    nowhere)."""
    ovh = CALIBRATED_OVERHEADS
    compute = (sum(n / PEAK_OPS[kind] for kind, n in (ops or {}).items())
               + sfu / SFU_OPS_S)
    memory = hbm_bytes / HBM_BYTES_S
    overhead = (launches * ovh["dispatch_s"] + readbacks * ovh["readback_s"]
                + h2d_bytes / ovh["h2d_gbs"] + sync_s)
    u = float(units)
    return Price(config, metric, compute / u, memory / u, wire_s / u,
                 overhead / u)


def wire_cost_s(topo, primitive: str, schedule: str,
                sheet_bytes: int) -> float:
    """Price one (collective site, schedule) pair on a topology: THE shared
    wire oracle (``plan.planner._site_cost`` delegates here).  The sheet's
    bytes are a program run's, so the topology sees amplification 1."""
    from harp_tpu_torch.plan.planner import predicted_bytes

    if schedule == "hier_psum":
        return topo.hier_stage_cost_s(sheet_bytes)
    return topo.cost_s(primitive, predicted_bytes(schedule, sheet_bytes))


def _wire_schedule(wire: str | None) -> str:
    return {None: "keep", "exact": "keep", "bf16": "wire_bf16",
            "int8": "wire_int8"}[wire]


def _nw(row) -> int:
    return max(int(row.get("num_workers") or 1), 1)


def _ceil(a: float, b: float) -> int:
    return -(-int(a) // int(b))


def _poisson_ceil_mean(lam: float, c: int) -> float:
    """E[ceil(N / c)] for N ~ Poisson(lam), counting only N > 0 (an empty
    entry runs nothing)."""
    if lam <= 0:
        return 0.0
    hi = int(lam + 12.0 * math.sqrt(lam) + 12)
    total, logp = 0.0, -lam                    # log P(N = 0)
    for n in range(1, hi + 1):
        logp += math.log(lam) - math.log(n)
        total += math.exp(logp) * -(-n // c)
    return total


def _slots(lam: float, cap: int, pairs: float) -> int:
    """The partition's slots an entry, C = min(cap, 8·ceil(max count /
    8)) (``partition_ratings_tiles``), with the largest of ``pairs``
    Poisson(lam) counts taken at lam + sqrt(2 ln pairs · lam)."""
    mx = lam + math.sqrt(2.0 * math.log(max(pairs, 2.0)) * max(lam, 1.0))
    return int(min(cap, max(8, 8 * math.ceil(mx / 8))))


# ---------------------------------------------------------------------------
# Family models
# ---------------------------------------------------------------------------

def _price_kmeans(row, topo, *, route="f32", hier=False, config,
                  metric="iters_per_sec"):
    """Per Lloyd iteration over the local shard (``models.kmeans.
    benchmark``: points on the card, one synchronize a window)."""
    n = float(row.get("n", 1_000_000)) / _nw(row)
    d = int(row.get("d", 300))
    k = int(row.get("k", 100))
    ni = int(n)
    if route == "k1":
        ops = {"int8": float(KR.k12_ops(ni, d, k))}
        hbm = float(KR.k12_bytes(ni, d, k, True))
        launches = KMEANS_K1_LAUNCHES
    elif route == "k2":
        ops = {"bf16": float(KR.k12_ops(ni, d, k))}
        hbm = float(KR.k12_bytes(ni, d, k, False))
        launches = KMEANS_K2_LAUNCHES
    else:
        ops = {"f32": 4.0 * n * d * k}
        hbm = (KMEANS_F32_NK_BYTES * n * k + KMEANS_F32_ND_BYTES * n * d
               + KMEANS_F32_N_BYTES * n)
        launches = KMEANS_F32_LAUNCHES
    psum_bytes = int(4 * (k * d + k + 1))
    wire = (topo.hier_stage_cost_s(psum_bytes) if hier
            else wire_cost_s(topo, "psum", "keep", psum_bytes))
    iters = float(row.get("iters", 10))
    return _mk_price(config, metric,
                     ops={kk: v * iters for kk, v in ops.items()},
                     hbm_bytes=hbm * iters, wire_s=wire * iters,
                     launches=launches * iters, readbacks=1.0, units=iters)


def _price_kmeans_stream(row, topo, *, quantize=None, config,
                         metric="iters_per_sec"):
    """Per blocked epoch (``models.kmeans_stream.benchmark_streaming``):
    each chunk generated on the card, quantized (int8), then K1 (int8) or
    ``_partials_block`` (f32), and one allreduce an epoch."""
    nw = _nw(row)
    n = float(row.get("n", 100_000_000))
    d = int(row.get("d", 300))
    k = int(row.get("k", 1000))
    chunk = int(row.get("chunk_points", 262_144))
    rows = chunk // nw
    chunks = max(1, int(n) // chunk)
    el = float(rows) * d
    sfu = STREAM_GEN_SFU_PER_ELEM * el
    if quantize == "int8":
        ops = {"int8": float(KR.k12_ops(rows, d, k))}
        hbm = STREAM_INT8_ELEM_BYTES * el + KR.k12_bytes(rows, d, k, True)
        launches = STREAM_INT8_CHUNK_LAUNCHES
    else:
        ops = {"f32": 4.0 * rows * d * k}
        hbm = (4.0 * el + KMEANS_F32_NK_BYTES * rows * k
               + KMEANS_F32_ND_BYTES * el + KMEANS_F32_N_BYTES * rows)
        launches = STREAM_F32_CHUNK_LAUNCHES
    wire = wire_cost_s(topo, "psum", "keep", int(4 * (k * d + k + 1)))
    iters = float(row.get("iters", 2))
    return _mk_price(config, metric,
                     ops={kk: v * chunks * iters for kk, v in ops.items()},
                     sfu=sfu * chunks * iters,
                     hbm_bytes=hbm * chunks * iters, wire_s=wire * iters,
                     launches=(launches * chunks + KMEANS_K1_LAUNCHES) * iters,
                     readbacks=1.0, units=iters)


def mfsgd_geometry(row, *, algo="pallas") -> dict:
    """One rotation step's tiles, entries, slots and critical path on a
    worker, from the uniform synthetic ratings' expectation (the
    benchmark's ``synthetic_ratings``): ``R_t × C_t`` tile pairs of
    ``lam`` ratings each, one entry a pair while ``lam`` stays under the
    entry cap, and a critical path of ``R_t + C_t − 1`` entries (the
    wavefront of the W-tile and H-tile chains)."""
    nw = _nw(row)
    users = int(row.get("n_users", 138_493))
    items = int(row.get("n_items", 26_744))
    nnz = float(row.get("nnz", 20_000_000))
    nc = int(row.get("rotate_chunks", 2))
    auto = 256 if algo == "pallas" else 512
    ut = int(row.get("u_tile") or auto)
    it = int(row.get("i_tile") or auto)
    cap = int(row.get("entry_cap", 2048))
    # the partition pads each worker's users and each H chunk's items to
    # whole tiles
    r_t = _ceil(users, nw * ut)
    c_t = _ceil(items, nw * nc * it)
    steps = nw * nc                          # rotation steps an epoch
    ratings = nnz / nw / steps               # a worker's, a step
    lam = ratings / (r_t * c_t)
    full = nnz * (ut / users) * (it / items)  # a full tile pair's mean
    per_pair = max(1, math.ceil(full / cap))
    slots = _slots(full / per_pair, cap, r_t * c_t * steps * nw)
    return {"u_tile": ut, "i_tile": it, "row_tiles": r_t,
            "col_tiles": c_t, "steps": steps, "ratings": ratings,
            "lam": lam, "entries": r_t * c_t * per_pair,
            "levels": (r_t + c_t - 1) * per_pair, "slots": slots}


def _price_mfsgd(row, topo, *, algo="dense", config,
                 metric="updates_per_sec_per_chip"):
    """Per rating update.  ``pallas`` (K3): one launch a step whose entries
    run in dataflow order; a step lasts the longer of its critical path
    and its entries over the clusters side by side, an entry its fixed
    part (K3_ENTRY_SYNC_S, overhead) and its two rating passes
    (K3_RATING_S a rating of a worker, memory: row reads through L2), with
    K3's HBM floor (``k3_bytes``) and operations (``k3_ops``) beside.
    ``dense`` (K3's plain version): a level at a time, every level ~70
    host launches."""
    g = mfsgd_geometry(row, algo=algo)
    rank = int(row.get("rank", 64))
    work = {"entries": g["entries"], "slots": g["entries"] * g["slots"],
            "ratings": g["ratings"],
            "rows": g["entries"] * (
                g["u_tile"] * (1 - math.exp(-g["lam"] / g["u_tile"]))
                + g["i_tile"] * (1 - math.exp(-g["lam"] / g["i_tile"])))}
    ops = {"f32": KR.k3_ops(work, rank)}
    if algo == "pallas":
        chain = max(g["levels"], g["entries"] / K3_CLUSTERS)
        per_entry = g["ratings"] / g["entries"]
        passes_s = 2 * math.ceil(per_entry / K3_WORKERS) * K3_RATING_S
        w_rows = _ceil(int(row.get("n_users", 138_493)), _nw(row))
        h_rows = g["col_tiles"] * g["i_tile"]
        hbm = (KR.k3_bytes(work, w_rows, h_rows, rank)
               + chain * passes_s * HBM_BYTES_S)
        launches = MFSGD_K3_LAUNCHES_PER_STEP
        sync = chain * K3_ENTRY_SYNC_S
    else:
        hbm = MFSGD_DENSE_BYTES_PER_SLOT_RANK * work["slots"] * rank
        launches = MFSGD_DENSE_LAUNCHES_PER_LEVEL * g["levels"]
        sync = 0.0
    n_items = int(row.get("n_items", 26_744))
    # one H chunk a hop
    rot = wire_cost_s(topo, "ppermute", _wire_schedule(row.get(
        "rotate_wire")), int(n_items * rank * 4 / g["steps"]))
    return _mk_price(config, metric, ops=ops, hbm_bytes=hbm, wire_s=rot,
                     launches=launches, sync_s=sync, units=g["ratings"])


def lda_geometry(row, *, algo="pallas") -> dict:
    """One rotation step's doc and word tiles, entries, slots, chunk width
    and chunks on a worker, from the i.i.d. benchmark corpus's expectation
    (``benchmark_corpus``: docs of ``tokens_per_doc`` uniform words)."""
    from harp_tpu_torch.ops.lda_kernel import chunk_width

    nw = _nw(row)
    docs = int(row.get("n_docs", 100_000))
    vocab = int(row.get("vocab_size", 50_000))
    K = int(row.get("n_topics", 1000))
    tpd = int(row.get("tokens_per_doc", 100))
    n_tok = float(row.get("n_tokens", docs * tpd))
    nc = int(row.get("rotate_chunks", 2))
    dt = int(row.get("d_tile") or 512)
    wt = int(row.get("w_tile") or 512)
    cap = int(row.get("entry_cap", 2048))
    d_t = _ceil(docs, nw * dt)
    w_t = _ceil(vocab, nw * nc * wt)
    steps = nw * nc
    tokens = n_tok / nw / steps
    lam = tokens / (d_t * w_t)
    full = dt * (n_tok / docs) * wt / vocab  # a full tile pair's mean
    per_pair = max(1, math.ceil(full / cap))
    slots = _slots(full / per_pair, cap, d_t * w_t * steps * nw)
    entries = d_t * w_t * per_pair
    geo = {"d_tile": dt, "w_tile": wt, "steps": steps, "tokens": tokens,
           "lam": lam, "entries": entries, "slots": slots, "K": K,
           "doc_tiles": d_t, "word_tiles": w_t}
    if algo == "pallas":
        slots = 256 * _ceil(slots, 256)      # lda._PALLAS_C padding
        geo["slots"] = slots
        freq = n_tok / vocab
        cc = chunk_width(K, dt, wt, slots, "float32", True,
                         (tpd, int(freq + 6 * math.sqrt(freq) + 1)))
        geo["cc"] = cc
        geo["chunks"] = d_t * w_t * _poisson_ceil_mean(lam, cc)
    return geo


def _price_lda(row, topo, *, algo="dense", config,
               metric="tokens_per_sec_per_chip"):
    """Per Gibbs token.  ``pallas`` (K4): one cooperative launch a step
    walking every entry's chunks, two grid barriers a chunk
    (K4_CHUNK_SYNC_S); ~10 f32 operations a (token, topic) beside one log
    on the SFUs.  ``dense``: an entry at a time against one snapshot,
    Gumbel draws, ~46 host launches an entry."""
    g = lda_geometry(row, algo=algo)
    K = g["K"]
    tok = g["tokens"]
    if algo == "pallas":
        work = {"entries": g["entries"], "slots": g["entries"] * g["slots"],
                "tokens": tok}
        ndk = 4 * g["doc_tiles"] * g["d_tile"] * K
        nwk = 4 * g["word_tiles"] * g["w_tile"] * K
        el = tok * K
        ops = {"f32": 10.0 * el} if 10.0 * el / PEAK_OPS["f32"] >= \
            el / SFU_OPS_S else {}
        sfu = 0.0 if ops else el
        hbm = KR.k4_bytes(work, ndk, nwk, K)
        launches = LDA_K4_LAUNCHES_PER_STEP
        sync = g["chunks"] * K4_CHUNK_SYNC_S
    else:
        slots = g["entries"] * g["slots"]
        ops = {"f32": 10.0 * slots * K}
        sfu = LDA_DENSE_SFU_PER_SLOT_TOPIC * slots * K
        hbm = LDA_DENSE_BYTES_PER_SLOT_TOPIC * slots * K
        launches = LDA_DENSE_LAUNCHES_PER_ENTRY * g["entries"]
        sync = 0.0
    vocab = int(row.get("vocab_size", 50_000))
    rot = wire_cost_s(topo, "ppermute", _wire_schedule(row.get(
        "rotate_wire")), int(vocab * K * 4 / g["steps"]))
    nk = wire_cost_s(topo, "psum", "keep", 4 * K)
    return _mk_price(config, metric, ops=ops, sfu=sfu, hbm_bytes=hbm,
                     wire_s=rot + nk, launches=launches, sync_s=sync,
                     units=tok)


def _price_svm(row, topo, *, algo="xla", config, metric="samples_per_sec"):
    """Per training sample of a fit (``models.svm.benchmark``: the metric
    is n over ``fit``'s seconds, which stage x and y on the card).  Each
    of the outer_rounds × inner_steps Pegasos steps reads the shard:
    twice on the plain route (two products), once through K5."""
    nw = _nw(row)
    n = float(row.get("n", 500_000))
    d = float(row.get("d", 128))
    n_loc = n / nw
    steps = (float(row.get("inner_steps", 200))
             * float(row.get("outer_rounds", 5)))
    if algo == "pallas":
        hbm = steps * KR.k5_bytes(int(n_loc), int(d), 4)
        launches = steps * SVM_K5_LAUNCHES_PER_STEP
    else:
        hbm = steps * (8.0 * n_loc * d + SVM_PLAIN_N_BYTES * n_loc)
        launches = steps * SVM_PLAIN_LAUNCHES_PER_STEP
    sv = float(row.get("sv_per_worker", 256))
    wire = float(row.get("outer_rounds", 5)) * (
        wire_cost_s(topo, "all_to_all", _wire_schedule(row.get("sv_wire")),
                    int(sv * d * 4 * nw))
        + wire_cost_s(topo, "psum", "keep", int(d * 4)))
    return _mk_price(config, metric, ops={"f32": steps * 4.0 * n_loc * d},
                     hbm_bytes=hbm, wire_s=wire, launches=launches,
                     readbacks=1.0, h2d_bytes=n_loc * (d * 4.0 + 4.0),
                     units=n)


def _price_wdamds(row, topo, *, algo="xla", config, metric="iters_per_sec"):
    """Per SMACOF iteration (``models.wdamds.benchmark``: iters over one
    ``mds`` call's seconds, which stage the [n, n] δ on the card)."""
    nw = _nw(row)
    n = int(row.get("n", 4096))
    dim = int(row.get("dim", 3))
    iters = float(row.get("iters", 30))
    n_loc = n // nw
    pairs = float(n_loc) * n
    if algo == "pallas":
        hbm = float(KR.k6_bytes(n_loc, n, dim, 4))
        launches = WDAMDS_K6_LAUNCHES_PER_ITER
        sfu = 2.0 * pairs
    else:
        hbm = WDAMDS_PLAIN_PAIR_BYTES * pairs
        launches = WDAMDS_PLAIN_LAUNCHES_PER_ITER
        sfu = 2.0 * pairs
    wire = (wire_cost_s(topo, "all_to_all", _wire_schedule(row.get(
        "coord_wire")), int(n * dim * 4))
            + wire_cost_s(topo, "psum", "keep", 4))
    return _mk_price(config, metric, ops={"f32": 20.0 * pairs * iters},
                     sfu=sfu * iters, hbm_bytes=hbm * iters,
                     wire_s=wire * iters, launches=launches * iters,
                     readbacks=1.0, h2d_bytes=float(n_loc) * n * 4.0,
                     units=iters)


# ---------------------------------------------------------------------------
# The config table
# ---------------------------------------------------------------------------

#: config -> (family, variant kwargs): the reference's names where the
#: port runs the same arm, ``kmeans_pallas`` for K2 (the reference runs it
#: under ``use_pallas=True`` too).  RF (``rf_dense_hist``,
#: ``rf_hist_pallas``), subgraph and serve are host-bound without a term
#: here, so they are absent (:data:`UNPRICED`).
CONFIG_MODELS = {
    "kmeans": ("kmeans", {}),
    "kmeans_int8": ("kmeans", {"route": "k1"}),
    "kmeans_pallas": ("kmeans", {"route": "k2"}),
    "kmeans_hier_psum": ("kmeans", {"hier": True}),
    "kmeans_stream": ("kmeans_stream", {}),
    "kmeans_stream_int8": ("kmeans_stream", {"quantize": "int8"}),
    "mfsgd": ("mfsgd", {"algo": "dense"}),
    "mfsgd_pallas": ("mfsgd", {"algo": "pallas"}),
    "lda": ("lda", {"algo": "dense"}),
    "lda_pallas": ("lda", {"algo": "pallas"}),
    "svm": ("svm", {}),
    "svm_kernel_pallas": ("svm", {"algo": "pallas"}),
    "wdamds": ("wdamds", {}),
    "wdamds_dist_pallas": ("wdamds", {"algo": "pallas"}),
}

#: configs the collector measures that the model does not price, and why
UNPRICED = {
    "rf_dense_hist": "host-bound fit (numpy binning, idle 0.99): no term",
    "rf_hist_pallas": "host-bound fit (numpy binning, idle 0.99): no term",
}

_FAMILY_FNS = {"kmeans": _price_kmeans, "kmeans_stream": _price_kmeans_stream,
               "mfsgd": _price_mfsgd, "lda": _price_lda, "svm": _price_svm,
               "wdamds": _price_wdamds}

#: the graded full shapes where they differ from the family defaults
#: (the ``row.get`` defaults above are each benchmark's own); the
#: collector runs every config at these
FULL_SHAPES = {
    "kmeans_stream": {"n": 100_000_000, "k": 1000, "iters": 2},
    "kmeans_stream_int8": {"n": 100_000_000, "k": 1000, "iters": 2},
}


def price(config: str, row: dict | None = None, topo=None) -> Price:
    """Price one config: predicted per-unit seconds + term breakdown.

    ``row`` supplies shape fields (a committed evidence row works as is);
    absent fields fall back to the graded full shapes.  Raises
    ``KeyError`` for an unpriced config: callers that prune must surface
    that, never swallow it."""
    if config not in CONFIG_MODELS:
        raise KeyError(f"{config!r} has no cost model (unpriced — see "
                       "CONFIG_MODELS and UNPRICED)")
    if topo is None:
        from harp_tpu_torch.plan.topology import single_card

        topo = single_card()
    family, kw = CONFIG_MODELS[config]
    merged = dict(FULL_SHAPES.get(config) or {})
    merged.update({k: v for k, v in (row or {}).items() if v is not None})
    return _FAMILY_FNS[family](merged, topo, config=config, **kw)


# ---------------------------------------------------------------------------
# kind:"model" rows
# ---------------------------------------------------------------------------

#: driver program -> the configs that run it
PROGRAM_CONFIGS = {
    "kmeans.fit": ("kmeans", "kmeans_int8", "kmeans_pallas"),
    "mfsgd.epoch": ("mfsgd", "mfsgd_pallas"),
    "lda.epoch": ("lda", "lda_pallas"),
    "rf.grow": ("rf_dense_hist",),
    "rf.grow_pallas": ("rf_hist_pallas",),
    "svm.train": ("svm",),
    "svm.train_pallas": ("svm_kernel_pallas",),
    "wdamds.smacof": ("wdamds",),
    "wdamds.smacof_pallas": ("wdamds_dist_pallas",),
    "subgraph.count": (),
    "serve.kmeans_assign": (),
}


def price_sheet(program: str, sheet: dict, topo) -> Price:
    """Price one program's ledger sheet: the wire term summed over every
    site ("keep", fail-closed like the planner) plus one dispatch and one
    readback.  Compute and memory are 0: a sheet knows wires, not work;
    the config models carry those."""
    wire = 0.0
    for e in sheet.get("collectives") or []:
        amped = int(round(float(e["per_shard_bytes"]) * max(
            float(e.get("amplification") or 1), 1.0)))
        wire += wire_cost_s(topo, e["primitive"], "keep", amped)
    ovh = (CALIBRATED_OVERHEADS["dispatch_s"]
           + CALIBRATED_OVERHEADS["readback_s"])
    return Price(program, "program_runs_per_sec", 0.0, 0.0, wire, ovh)


def model_row(p: Price, topo, *, program: str | None = None,
              config: str | None = None) -> dict:
    """One serializable ``kind: "model"`` record (the caller stamps its
    provenance)."""
    terms = {k: round(v, 15) for k, v in p.terms().items()}
    return {
        "kind": "model",
        "program": program,
        "config": config,
        "configs": sorted(PROGRAM_CONFIGS.get(program, ()))
        if program else ([config] if config else []),
        "topology": topo.name,
        "rates_source": topo.rates_source,
        "metric": p.metric,
        "predicted_s": round(sum(terms.values()), 15),
        "predicted_rate": round(p.predicted_rate, 4),
        "bound": max(BOUNDS, key=lambda b: terms[f"{b}_s"]),
        "terms": terms,
    }


def rank_candidates(pairs: dict, topo, rows: dict | None = None) -> dict:
    """Predicted speedup per candidate: ``pairs`` maps candidate →
    incumbent; both sides are priced at the same shape (the incumbent's
    committed row when ``rows`` has one, else the full shape).  Unpriced
    candidates are absent: the caller reports them."""
    out = {}
    for cand, inc in pairs.items():
        if cand not in CONFIG_MODELS or inc not in CONFIG_MODELS:
            continue
        shape = (rows or {}).get(inc)
        t_inc = price(inc, shape, topo).predicted_s
        t_cand = price(cand, shape, topo).predicted_s
        out[cand] = round(t_inc / t_cand, 4)
    return out


# ---------------------------------------------------------------------------
# Shared-memory pre-sizer
# ---------------------------------------------------------------------------

def presize(kernel: str, **shape) -> dict:
    """A tile that fits the card's shared memory for a kernel with a tile
    choice, from the kernel's own byte model, ranked by the cost model.

    - ``mfsgd.sgd_tile_update`` (K3): square tiles whose
      ``mfsgd_kernel.block_bytes`` on a cluster of ``CLUSTER`` blocks fits
      the opt-in (``kernel_registry.H100_SMEM_OPTIN`` unless ``optin=``),
      the predicted fastest of them;
    - ``rf.hist_bins`` (K7): ``rf_kernel.plan`` at the shape (its feature
      slice, trees a block, ring depth and shared bytes), or None when
      one feature's histogram does not fit;
    - ``kmeans.partials_int8`` (K1) and ``kmeans.partials`` (K2): their
      tiles are chosen in C++ (``csrc/kmeans_tiles.cuh``,
      ``km::make_plan``); this asks the library's plan
      (``kmeans_kernel.plan``) and so needs the card: on the CPU it
      raises ``RuntimeError``.

    Any other kernel has no tile choice here: ``KeyError`` names it."""
    if kernel == "mfsgd.sgd_tile_update":
        from harp_tpu_torch.ops.mfsgd_kernel import CLUSTER, block_bytes

        rank = int(shape.get("rank", 64))
        optin = int(shape.get("optin", KR.H100_SMEM_OPTIN))
        fits, smem = [], {}
        for t in (64, 128, 256, 512, 1024):
            g = mfsgd_geometry({**shape, "u_tile": t, "i_tile": t})
            smem[t] = block_bytes(t, t, rank, g["slots"], CLUSTER)
            if smem[t] <= optin:
                fits.append(t)
        if not fits:
            return {"kernel": kernel, "tile": None, "fits": [],
                    "reason": "no square tile's block fits the opt-in "
                              f"{optin} bytes of shared memory"}
        best = min(fits, key=lambda t: price(
            "mfsgd_pallas", {**shape, "u_tile": t, "i_tile": t})
            .predicted_s)
        return {"kernel": kernel, "tile": best, "fits": fits,
                "smem_bytes": smem[best], "optin": optin,
                "smem_model": "mfsgd_kernel.block_bytes on CLUSTER blocks"}
    if kernel == "rf.hist_bins":
        from harp_tpu_torch.ops import rf_kernel

        T = int(shape.get("n_trees", 32))
        n = int(shape.get("n", 200_000))
        f = int(shape.get("features", 64))
        B = int(shape.get("n_bins", 32))
        R = int(shape.get("n_node_classes", 2 ** (int(shape.get(
            "depth", 6)) - 1) * int(shape.get("n_classes", 2))))
        optin = int(shape.get("optin", KR.H100_SMEM_OPTIN))
        p = rf_kernel.plan(T, n, f, B, R, int(shape.get("itemsize", 1)),
                           optin, int(shape.get("sms", KR.H100_SMS)))
        if p is None:
            return {"kernel": kernel, "plan": None,
                    "reason": f"one feature's [{R}, {B}] int32 histogram "
                              f"does not fit {optin} bytes"}
        return {"kernel": kernel, "plan": {
            "fs": p.fs, "tg": p.tg, "ns": p.ns, "chunk": p.chunk,
            "nchunks": p.nchunks, "smem": p.smem}, "optin": optin,
            "smem_model": "rf_kernel.plan / rf_kernel.layout"}
    if kernel in ("kmeans.partials_int8", "kmeans.partials"):
        import torch

        from harp_tpu_torch.ops import kmeans_kernel as KK

        dev = torch.device(shape.get("device", "cuda"))
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"presize({kernel!r}): K1 and K2 choose their tiles in C++ "
                "(csrc/kmeans_tiles.cuh, km::make_plan) from the card's "
                "shared memory; the plan is the library's "
                "(kmeans_kernel.plan) and needs a CUDA device")
        name = ("kmeans_partials_int8" if kernel.endswith("int8")
                else "kmeans_partials")
        p = KK.plan(name, dev, int(shape["n"]), int(shape["d"]),
                    int(shape["k"]))
        return {"kernel": kernel, "tile": p.tile_rows, "fused": p.fused,
                "smem_bytes": p.smem, "grid": p.grid,
                "smem_model": "km::make_plan (kmeans_kernel.plan)"}
    raise KeyError(f"no pre-size model for kernel {kernel!r}: it has no "
                   "tile choice to size (K1/K2, K3 and K7 have)")


# ---------------------------------------------------------------------------
# The route counter
# ---------------------------------------------------------------------------

_NO_TRAFFIC = frozenset((
    "view", "t", "transpose", "expand", "_unsafe_view", "detach", "alias",
    "unsqueeze", "squeeze", "select", "slice", "reshape", "as_strided",
    "permute", "lift_fresh", "empty", "empty_like", "empty_strided",
    "_local_scalar_dense", "set_", "resize_"))


def count_ops(fn, *args, **kwargs) -> tuple[int, int, object]:
    """``(ops, bytes, result)`` of ``fn(*args, **kwargs)``: the torch ops
    it dispatches that move data (views and allocations do not), and the
    bytes they touch, each operand read once and each result written once.
    The counts behind the plain routes' launch and byte constants."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    import torch

    class _Count(TorchDispatchMode):
        ops = 0
        nbytes = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if str(func.overloadpacket).split(".")[-1] in _NO_TRAFFIC:
                return out
            ts = [x for x in tree_flatten((a, kw, out))[0]
                  if isinstance(x, torch.Tensor)]
            self.ops += 1
            self.nbytes += sum(x.numel() * x.element_size() for x in ts)
            return out

    with _Count() as c:
        res = fn(*args, **kwargs)
    return c.ops, c.nbytes, res
