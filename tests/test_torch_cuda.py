"""Kernels K1-K8 against their plain versions on the card.

These need an NVIDIA card with ``nvcc``; elsewhere each test skips (the
fixture decides, never the import).  On the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest configures JAX, which the card's
machine does not have; this file imports only torch and the port.)
"""

import dataclasses
import os
import re
import tempfile
import warnings

import numpy as np
import pytest
import torch

from harp_tpu_torch.ops import flash_attention as K8
from harp_tpu_torch.ops import kmeans_kernel as KK
from harp_tpu_torch.ops import lda_kernel as K4
from harp_tpu_torch.ops import mfsgd_kernel as K3
from harp_tpu_torch.ops import rf_kernel as K7
from harp_tpu_torch.ops import svm_kernel as K5
from harp_tpu_torch.ops import wdamds_kernel as K6
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.models import lda as LD
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.models import rf as RF
from harp_tpu_torch.models import svm as SV
from harp_tpu_torch.models import wdamds as WD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1-K8 have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _blobs(n, d, k, seed=0, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    pts = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)).astype(
        np.float32) * 0.5
    return pts.astype(np.float32), centers


def _int8_args(pts, centers, dev):
    q, scale = KM.quantize_points_int8(pts)
    q, scale = torch.from_numpy(q).to(dev), torch.from_numpy(scale).to(dev)
    c_q, c_scale, c2 = KM._quantize_centroids(
        torch.from_numpy(centers).to(dev), scale)
    return q, c_q, c_scale, c2, scale


# (n, d, k): ragged n, d not a multiple of 4 or of the 32-byte MMA k-step
# (13, 40, 300), k not a multiple of a 16-centroid pair, a k whose sums do
# not fit in shared memory (the two-pass path: assignments, then sums by
# centroid range), d < 32, d = 1040 (K1's exactness limit) fused and
# two-pass, k = 1, k just past one centroid pair (17) and one streamed chunk
# of 64 (65), and n below one tile
SHAPES = [(1000, 40, 7), (4099, 13, 37), (3000, 300, 100), (2049, 300, 1000),
          (700, 1040, 20), (1500, 1040, 300), (1000, 24, 1), (2000, 64, 17),
          (2000, 64, 65), (10, 300, 100), (5, 5, 3)]


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_k1_matches_plain_exactly(dev, n, d, k):
    pts, centers = _blobs(n, d, min(k, 50))
    centers = np.concatenate([centers, np.random.default_rng(1).normal(
        size=(k - len(centers), d)).astype(np.float32) * 8])
    args = _int8_args(pts, centers, dev)
    before = KK.LAUNCHES["kmeans_partials_int8"]
    s1, n1, b1 = KK.kmeans_partials_int8(*args)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["kmeans_partials_int8"] == before + 1
    s2, n2, b2 = KK.kmeans_partials_int8_plain(*args)
    # integer sums and counts are exact on both sides: equal bit for bit
    assert torch.equal(n1, n2) and torch.equal(s1, s2)
    # the best-score sum differs only in f32 summation order
    torch.testing.assert_close(b1, b2, rtol=1e-5, atol=1e-3)
    # bit-identical reruns of all three outputs
    s3, n3, b3 = KK.kmeans_partials_int8(*args)
    assert torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(b1, b3)


def test_k1_ties_go_to_the_lowest_index(dev):
    pts = np.random.default_rng(0).normal(size=(500, 24)).astype(np.float32)
    centers = np.tile(pts[:1], (70, 1))  # 70 identical centroids, 3 tiles
    _, counts, _ = KK.kmeans_partials_int8(*_int8_args(pts, centers, dev))
    assert counts[0] == 500 and counts[1:].sum() == 0


# (d, k) of the tie tests: 19 centroid pairs in one warp's sequence (fused,
# d = 24), five streamed chunks of 64 (two-pass, d = 300), and pairs split
# over the warps that share an M-tile, merged across warps in shared memory
# (fused at d = 300 for K2 and d = 1040 for both)
TIE_SHAPES = [(24, 300), (300, 300), (300, 100), (1040, 40)]


@pytest.mark.parametrize("d,k", TIE_SHAPES)
def test_k1_ties_span_pairs_warps_and_chunks(dev, d, k):
    """k identical centroids: every point goes to centroid 0."""
    pts = np.random.default_rng(0).normal(size=(700, d)).astype(np.float32)
    centers = np.tile(pts[:1], (k, 1))
    args = _int8_args(pts, centers, dev)
    sums, counts, _ = KK.kmeans_partials_int8(*args)
    assert counts[0] == 700 and counts[1:].sum() == 0
    s2, _, _ = KK.kmeans_partials_int8_plain(*args)
    assert torch.equal(sums, s2)


@pytest.mark.parametrize("d", [13, 300])
def test_k1_takes_an_unaligned_view(dev, d):
    """A contiguous view of the points at an odd row offset: its base is
    not 16-byte (for d = 13 not even 4-byte) aligned."""
    pts, centers = _blobs(2001, d, 40)
    q, c_q, c_scale, c2, scale = _int8_args(pts, centers, dev)
    view = q[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    args = (view, c_q, c_scale, c2, scale)
    s1, n1, b1 = KK.kmeans_partials_int8(*args)
    s2, n2, b2 = KK.kmeans_partials_int8_plain(*args)
    assert torch.equal(n1, n2) and torch.equal(s1, s2)
    torch.testing.assert_close(b1, b2, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("k", [100, 1000])
def test_k12_launches_a_call(dev, k):
    """CUDA launches of one call, from a captured graph: K1 is one launch
    when its sums fit in shared memory (k = 100 at d = 300), else pack,
    main and range; K2 adds the ordered reduce of its slabs."""
    pts, centers = _blobs(3000, 300, k)
    args = _int8_args(pts, centers, dev)
    x = torch.from_numpy(pts).to(dev)
    c = torch.from_numpy(centers).to(dev)
    fused = k == 100
    for name, fn, want in (
            ("kmeans_partials_int8", lambda: KK.kmeans_partials_int8(*args),
             1 if fused else 3),
            ("kmeans_partials", lambda: KK.kmeans_partials(x, c),
             2 if fused else 4)):
        assert KK.plan(name, dev, 3000, 300, k).fused == fused
        with torch.cuda.stream(_side()):
            fn()
        torch.cuda.synchronize()
        nodes = _graph_nodes(fn)
        ours = [n for n in nodes if "kernel" in n and "at6native" not in n
                and "at::native" not in n]
        assert len(ours) == want, (name, ours)


def test_k12_plans_of_two_shapes_do_not_cap_each_other(dev, monkeypatch):
    """Each shape's plan is made once and reused by its launches: a small
    shape's plan made between two launches of a large one (fused, ~200 KB
    of shared memory) leaves the large one launchable, and a launch given
    another shape's plan raises rather than run it."""
    monkeypatch.setattr(KK, "_PLANS", {})
    big, small = (3000, 300, 100), (500, 13, 3)
    for n, d, k in (big, small, big):
        pts, centers = _blobs(n, d, k)
        args = _int8_args(pts, centers, dev)
        s1, n1, _ = KK.kmeans_partials_int8(*args)
        s2, n2, _ = KK.kmeans_partials_int8_plain(*args)
        assert torch.equal(s1, s2) and torch.equal(n1, n2)
        x, c = torch.from_numpy(pts).to(dev), torch.from_numpy(centers).to(dev)
        _, n1, _ = KK.kmeans_partials(x, c)
        _, n2, _ = KK.kmeans_partials_plain(x, c)
        assert torch.equal(n1, n2)
    index = torch.cuda.current_device()
    assert len({p.handle for p in KK._PLANS.values()}) == 4
    for name in ("kmeans_partials_int8", "kmeans_partials"):
        KK._PLANS[(name, index, *big, False)] = \
            KK._PLANS[(name, index, *small, False)]
    with pytest.raises(RuntimeError, match="CUDA error"):
        KK.kmeans_partials_int8(*args)
    with pytest.raises(RuntimeError, match="CUDA error"):
        KK.kmeans_partials(x, c)


@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(dev, n, d, k, dtype):
    pts, centers = _blobs(n, d, k)
    x = torch.from_numpy(pts).to(dev, dtype)
    c = torch.from_numpy(centers).to(dev)
    s1, n1, i1 = KK.kmeans_partials(x, c)
    s2, n2, i2 = KK.kmeans_partials_plain(x, c)
    # separated blobs: every assignment is unambiguous, so counts are equal
    assert torch.equal(n1, n2)
    # the sums add the same bf16 values in another f32 order
    scale = float(x.float().abs().max()) * float(n1.max())
    assert float((s1 - s2).abs().max()) <= 1e-5 * scale
    x2 = float((x.double() ** 2).sum())
    assert abs(float(i1) - float(i2)) <= 1e-5 * x2
    # bit-identical reruns: no float atomics anywhere
    s3, n3, i3 = KK.kmeans_partials(x, c)
    assert torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(i1, i3)


def test_k2_ties_go_to_the_lowest_index(dev):
    x = torch.randn(300, 24, device=dev)
    c = x[:1].repeat(70, 1)
    _, counts, _ = KK.kmeans_partials(x, c)
    assert counts[0] == 300 and counts[1:].sum() == 0


@pytest.mark.parametrize("d,k", TIE_SHAPES)
def test_k2_ties_span_pairs_warps_and_chunks(dev, d, k):
    x = torch.randn(700, d, device=dev)
    c = x[:1].repeat(k, 1)  # k identical centroids
    sums, counts, _ = KK.kmeans_partials(x, c)
    assert counts[0] == 700 and counts[1:].sum() == 0
    s2, _, _ = KK.kmeans_partials_plain(x, c)
    scale = float(x.abs().max()) * 700
    assert float((sums - s2).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("d", [13, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_takes_an_unaligned_view(dev, d, dtype):
    pts, centers = _blobs(2001, d, 40)
    x = torch.from_numpy(pts).to(dev, dtype)[1:]
    assert x.is_contiguous()
    c = torch.from_numpy(centers).to(dev)
    s1, n1, i1 = KK.kmeans_partials(x, c)
    s2, n2, i2 = KK.kmeans_partials_plain(x, c)
    assert torch.equal(n1, n2)
    scale = float(x.float().abs().max()) * float(n1.max())
    assert float((s1 - s2).abs().max()) <= 1e-5 * scale
    x2 = float((x.double() ** 2).sum())
    assert abs(float(i1) - float(i2)) <= 1e-5 * x2


def test_fit_runs_each_kernel_once_per_iteration(dev):
    pts, _ = _blobs(4096, 32, 8)
    KK.reset_launches()
    KM.fit(pts, k=8, iters=3, seed=0, quantize="int8")
    KM.fit(pts, k=8, iters=4, seed=0, use_pallas=True)
    KM.fit(pts, k=8, iters=2, seed=0)
    assert KK.LAUNCHES == {"kmeans_partials_int8": 3, "kmeans_partials": 4}


def _k3_entries(tile, cap, rank, dev, nu=200, ni=120, nnz=5000, seed=0):
    u, i, v = MF.synthetic_ratings(nu, ni, nnz, seed=seed)
    eu, ei, ev, ou, oi, _, _, ub, ib = MF.partition_ratings_tiles(
        u, i, v, nu, ni, 1, tile, tile, cap, n_slices=1)
    ent = [torch.from_numpy(a[0].copy()).to(dev) for a in (eu, ei, ev, ou, oi)]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    W = torch.rand((ub, rank), generator=g, device=dev) / 4
    H = torch.rand((ib, rank), generator=g, device=dev) / 4
    return W, H, ent


@pytest.mark.parametrize("rank", [8, 64, 100])
@pytest.mark.parametrize("tile,cap", [(8, 16), (16, 64), (32, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(dev, rank, tile, cap, dtype):
    W, H, ent = _k3_entries(tile, cap, rank, dev)
    kw = dict(lr=0.05, reg=0.02, u_tile=tile, i_tile=tile,
              compute_dtype=dtype)
    before = K3.LAUNCHES["sgd_tile_update"]
    W1, H1, se1, c1 = K3.sgd_tile_update(W, H, *ent, **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["sgd_tile_update"] == before + 1
    W2, H2, se2, c2 = K3.sgd_tile_update_plain(W, H, *ent, **kw)
    # the gradient sums are added in another f32 order (the plain
    # version's index_add_ is unordered): the reference's tolerance for
    # dense vs pallas
    torch.testing.assert_close(W1, W2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(H1, H2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(se1, se2, rtol=1e-5, atol=0)
    assert float(c1) == float(c2) == float((ent[0] < tile).sum())
    assert not torch.equal(W1, W)


def test_k3_refuses_accumulators_beyond_shared_memory(dev):
    """The accumulators are split over a cluster's blocks: tiles of 512 x
    cluster rows need 2 x 128 KB a block at rank 64, past any block's
    shared memory."""
    tile = 512 * K3.CLUSTER
    W, H, ent = _k3_entries(tile, 16, 64, dev)
    with pytest.raises(ValueError, match="shared memory"):
        K3.sgd_tile_update(W, H, *ent, lr=0.1, reg=0.0, u_tile=tile,
                           i_tile=tile)


def _graph_nodes(fn):
    """The nodes (their DOT text) of the CUDA graph that one call of ``fn``
    captures on a side stream: the CUDA launches the call makes, counted
    without torch.profiler, which can drop device records.  ``fn`` must
    have run once on that stream first (``_side``), so that nothing is
    planned or created while the graph is captured."""
    g = torch.cuda.CUDAGraph(keep_graph=True)  # kept for debug_dump
    with torch.cuda.graph(g, stream=_side()):
        fn()
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it dumps
        path = os.path.join(d, "graph.dot")
        g.debug_dump(path)
        with open(path) as f:
            text = f.read()
    nodes = re.split(r'(?="graph_\d+_node_\d+"\s*\[)', text)[1:]
    assert nodes, text[:2000]
    return nodes


_SIDE = []


def _side():
    """One side stream for the graph captures (and their warm-up calls)."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    return _SIDE[0]


def _k3_chain_entries(dev, rank, shape, seed=0):
    """Entries built by hand.  ``deep``: 40 entries on one tile pair (8 x
    8 tiles, C = 32, some entries cut short by pads), a chain of width 1.
    ``wide``: 300 entries on the diagonal tile pairs (k, k), then 300 on
    (k, k + 1): two levels of 300 ready entries, more than the grid has
    clusters."""
    rng = np.random.default_rng(seed)
    tile, C = 8, 32
    if shape == "deep":
        NE, nt = 40, 1
        ou = oi = np.zeros(NE, np.int32)
    else:
        NE, nt = 600, 300
        k = np.arange(nt)
        ou = np.concatenate([k, k]).astype(np.int32) * tile
        oi = np.concatenate([k, (k + 1) % nt]).astype(np.int32) * tile
    eu = rng.integers(0, tile, (NE, C)).astype(np.int32)
    ei = rng.integers(0, tile, (NE, C)).astype(np.int32)
    ev = rng.normal(size=(NE, C)).astype(np.float32)
    cut = rng.integers(1, C + 1, NE)
    pad = np.arange(C)[None, :] >= cut[:, None]
    eu[pad], ei[pad], ev[pad] = tile, tile, 0.0
    W = rng.uniform(0, 0.25, (nt * tile, rank)).astype(np.float32)
    H = rng.uniform(0, 0.25, (nt * tile, rank)).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return T(W), T(H), [T(a) for a in (eu, ei, ev, ou, oi)], tile


@pytest.mark.parametrize("shape", ["deep", "wide"])
@pytest.mark.parametrize("rank", [13, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_dataflow_order_matches_plain(dev, shape, rank, dtype):
    """A chain of width 1 (every entry waits for the one before) and a
    step wider than the grid, rank 13 (4-byte chunks) and 64 (128-bit
    chunks): one CUDA launch a call, the plain version's results."""
    W, H, ent, tile = _k3_chain_entries(dev, rank, shape)
    kw = dict(lr=0.05, reg=0.02, u_tile=tile, i_tile=tile,
              compute_dtype=dtype)
    sched = K3.LevelSchedule.build(*ent[:2], *ent[3:], tile, tile,
                                   W.shape[0], H.shape[0], dev)
    assert (sched.n_levels, sched.max_width) == (
        (40, 1) if shape == "deep" else (2, 300))
    before = K3.LAUNCHES["sgd_tile_update"]
    W1, H1, se1, c1 = K3.sgd_tile_update(W, H, *ent, schedule=sched, **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES["sgd_tile_update"] == before + 1
    with torch.cuda.stream(_side()):
        K3.sgd_tile_update(W, H, *ent, schedule=sched, **kw)
    torch.cuda.synchronize()
    nodes = _graph_nodes(
        lambda: K3.sgd_tile_update(W, H, *ent, schedule=sched, **kw))
    assert sum("sgd_step_kernel" in n for n in nodes) == 1  # one launch
    W2, H2, se2, c2 = K3.sgd_tile_update_plain(W, H, *ent, schedule=sched,
                                               **kw)
    torch.testing.assert_close(W1, W2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(H1, H2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(se1, se2, rtol=1e-5, atol=0)
    assert float(c1) == float(c2) == float((ent[0] < tile).sum())
    W3, H3, _, _ = K3.sgd_tile_update(W, H, *ent, schedule=sched, **kw)
    torch.testing.assert_close(W3, W1, rtol=1e-5, atol=1e-6)  # reruns
    torch.testing.assert_close(H3, H1, rtol=1e-5, atol=1e-6)


def test_k3_runs_tiles_past_one_blocks_shared_memory(dev):
    """512 x 512 tiles at rank 64 (256 KB of accumulators, more than one
    block's shared memory) run on a cluster and match the plain version."""
    W, H, ent = _k3_entries(512, 64, 64, dev, nu=1100, ni=600, nnz=3000)
    kw = dict(lr=0.05, reg=0.02, u_tile=512, i_tile=512,
              compute_dtype=torch.float32)
    W1, H1, se1, _ = K3.sgd_tile_update(W, H, *ent, **kw)
    W2, H2, se2, _ = K3.sgd_tile_update_plain(W, H, *ent, **kw)
    torch.testing.assert_close(W1, W2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(H1, H2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(se1, se2, rtol=1e-5, atol=0)


def test_mfsgd_pallas_launches_k3_once_per_rotation_step(dev):
    u, i, v = MF.synthetic_ratings(300, 200, 6000, seed=1)
    cfg = MF.MFSGDConfig(rank=16, algo="pallas", u_tile=16, i_tile=16,
                         entry_cap=64)
    m = MF.MFSGD(300, 200, cfg)
    m.set_ratings(u, i, v)
    K3.reset_launches()
    r = m.train_epochs(3)
    assert K3.LAUNCHES == {"sgd_tile_update": 2 * 3}
    assert r[-1] < r[0]


def _k4_step(dev, K, dtype, NE=6, C=512, DR=32, WR=32, seed=0, hi=40):
    rng = np.random.default_rng(seed)
    Ndk = torch.from_numpy(rng.integers(0, hi, (3 * DR, K)).astype(
        np.int16 if dtype == torch.int16 else np.float32)).to(dev)
    Nwk = torch.from_numpy(rng.integers(0, hi, (2 * WR, K)).astype(
        np.float32)).to(dev)
    nk = Nwk.sum(0) + 100
    ids = lambda hi_: torch.from_numpy(  # noqa: E731
        rng.integers(0, hi_, (NE, C)).astype(np.int32)).to(dev)
    cd, cw, z = ids(DR), ids(WR), ids(K)
    cd[1, 300:] = DR  # trailing pads
    cd[2] = DR        # an entry without a token
    od = torch.from_numpy(rng.integers(0, 3, NE).astype(np.int32) * DR).to(dev)
    ow = torch.from_numpy(rng.integers(0, 2, NE).astype(np.int32) * WR).to(dev)
    return Ndk, Nwk, nk, z, cd, cw, od, ow


@pytest.mark.parametrize("K", [8, 13, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("arm", ["injected", "philox"])
@pytest.mark.parametrize("exact", [True, False])
def test_k4_step_matches_plain_bit_for_bit(dev, K, dtype, arm, exact):
    """Both arms, f32 and int16 doc counts (the int16 CAS atomics), exact
    and bf16-rounded gathers, K not a multiple of 4: the step's tables,
    topics and dNk equal the plain version's bit for bit."""
    Ndk, Nwk, nk, z, cd, cw, od, ow = _k4_step(dev, K, dtype,
                                               hi=40 if exact else 3000)
    NE, C = cd.shape
    g = torch.Generator(device=dev)
    g.manual_seed(K)
    drawn = ({"u": torch.rand((NE, C, K), generator=g, device=dev)
              .clamp_min(2.0 ** -25)} if arm == "injected" else
             {"seeds": torch.randint(-2 ** 31, 2 ** 31 - 1, (NE, 2),
                                     dtype=torch.int32, generator=g,
                                     device=dev)})
    kw = dict(alpha=0.1, beta=0.01, vbeta=0.5, d_tile=32, w_tile=32, cc=128,
              exact_gathers=exact, **drawn)
    a = [t.clone() for t in (Ndk, Nwk, z)]
    b = [t.clone() for t in (Ndk, Nwk, z)]
    before = K4.LAUNCHES["cgs_entry_update"]
    d1 = K4.cgs_step(a[0], a[1], nk, a[2], cd, cw, od, ow, **kw)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["cgs_entry_update"] == before + 1
    d2 = K4.cgs_step_plain(b[0], b[1], nk, b[2], cd, cw, od, ow, **kw)
    for x, y in zip(a + [d1], b + [d2]):
        assert torch.equal(x, y)
    assert not torch.equal(a[2], z)
    assert torch.equal(a[2][2], z[2]) and torch.equal(a[2][1, 300:],
                                                      z[1, 300:])
    assert int(a[0].double().sum()) == int(Ndk.double().sum())  # no leak


def test_k4_entry_wrapper_and_reruns(dev):
    """The single-entry wrapper leaves its inputs alone, and reruns of the
    step (atomics in any order) give the same tables."""
    Ndk, Nwk, nk, z, cd, cw, od, ow = _k4_step(dev, 64, torch.int16)
    Db, Wb = Ndk[:32].clone(), Nwk[:32].clone()
    seed2 = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    out = K4.cgs_entry_update(Db, Wb, nk, z[0], cd[0], cw[0], alpha=0.1,
                              beta=0.01, vbeta=0.5, cc=128, seed2=seed2)
    ref = K4.cgs_entry_update(Db.cpu(), Wb.cpu(), nk.cpu(), z[0].cpu(),
                              cd[0].cpu(), cw[0].cpu(), alpha=0.1, beta=0.01,
                              vbeta=0.5, cc=128, seed2=seed2.cpu())
    for x, y in zip(out, ref):  # the card against the CPU's plain version
        assert torch.equal(x.cpu(), y)
    assert torch.equal(Db, Ndk[:32]) and torch.equal(Wb, Nwk[:32])
    seeds = torch.arange(12, dtype=torch.int32, device=dev).reshape(6, 2)
    runs = []
    for _ in range(2):
        t = [x.clone() for x in (Ndk, Nwk, z)]
        K4.cgs_step(t[0], t[1], nk, t[2], cd, cw, od, ow, alpha=0.1,
                    beta=0.01, vbeta=0.5, d_tile=32, w_tile=32, cc=128,
                    seeds=seeds)
        runs.append(t)
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cc", [128, 256])
@pytest.mark.parametrize("arm", ["injected", "philox"])
def test_k4_many_chunks_per_entry_in_one_launch(dev, cc, arm):
    """C = 2048: 8 or 16 chunks an entry, across five entries (one of them
    cut short by trailing pads, one without a token), int16 doc counts:
    the one cooperative launch walks them all and equals the plain version
    bit for bit."""
    Ndk, Nwk, nk, z, cd, cw, od, ow = _k4_step(dev, 100, torch.int16, NE=5,
                                               C=2048, seed=cc)
    cd[1, :1000], cd[1, 1000:] = cd[0, :1000], 32
    NE, C = cd.shape
    g = torch.Generator(device=dev)
    g.manual_seed(cc)
    drawn = ({"u": torch.rand((NE, C, 100), generator=g, device=dev)
              .clamp_min(2.0 ** -25)} if arm == "injected" else
             {"seeds": torch.randint(-2 ** 31, 2 ** 31 - 1, (NE, 2),
                                     dtype=torch.int32, generator=g,
                                     device=dev)})
    kw = dict(alpha=0.1, beta=0.01, vbeta=0.5, d_tile=32, w_tile=32, cc=cc,
              **drawn)
    plan = K4.EntryPlan.build(cd, cw, od, ow, 32, 32, Ndk.shape[0],
                              Nwk.shape[0], cc)
    assert plan.chunks == 3 * (C // cc) + -(-1000 // cc)
    a = [t.clone() for t in (Ndk, Nwk, z)]
    b = [t.clone() for t in (Ndk, Nwk, z)]
    before = K4.LAUNCHES["cgs_entry_update"]
    d1 = K4.cgs_step(a[0], a[1], nk, a[2], cd, cw, od, ow, plan=plan, **kw)
    torch.cuda.synchronize()
    assert K4.LAUNCHES["cgs_entry_update"] == before + 1
    d2 = K4.cgs_step_plain(b[0], b[1], nk, b[2], cd, cw, od, ow, **kw)
    for x, y in zip(a + [d1], b + [d2]):
        assert torch.equal(x, y)
    assert int((a[2] != z).sum()) > C  # many topics moved


def test_k4_refuses_a_grid_the_card_cannot_hold(dev):
    """cc blocks must all be resident for the step's grid barriers: a chunk
    of 8192 slots cannot be, and the wrapper raises (no other path)."""
    Ndk, Nwk, nk, z, cd, cw, od, ow = _k4_step(dev, 8, torch.float32, NE=3,
                                               C=8192)
    seeds = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="cannot hold"):
        K4.cgs_step(Ndk, Nwk, nk, z, cd, cw, od, ow, alpha=0.1, beta=0.01,
                    vbeta=0.5, d_tile=32, w_tile=32, cc=8192, seeds=seeds)


def test_lda_pallas_launches_k4_once_per_rotation_step(dev):
    d, w = LD.synthetic_corpus(96, 64, 4, 50, seed=0)
    cfg = LD.LDAConfig(n_topics=8, algo="pallas", d_tile=16, w_tile=16,
                       entry_cap=64)
    m = LD.LDA(96, 64, cfg, seed=1)
    m.set_tokens(d, w)
    ll0 = m.log_likelihood()
    K4.reset_launches()
    m.sample_epochs(3)
    assert K4.LAUNCHES == {"cgs_entry_update": 2 * 3}
    assert m.log_likelihood() > ll0
    Ndk = m.doc_topic_table()
    assert Ndk.sum() == m.n_tokens and (Ndk >= 0).all()


# ---- K5: Pegasos hinge gradient ------------------------------------------------

def _k5_inputs(n, d, dtype, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=dev).to(dtype)
    y = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0, 1.0)
    sw = (torch.rand(n, generator=g, device=dev) < 0.9).to(torch.float32)
    w = torch.randn(d, generator=g, device=dev) * (0.5 / d ** 0.5)
    return w, torch.tensor(0.1, device=dev), x, y, sw


# (n, d): ragged tiles, d not a multiple of 32, a tall narrow case, and a d
# whose w and accumulator do not fit in shared memory (the global arm)
K5_SHAPES = [(1000, 128), (4099, 13), (700, 3000), (50, 40_000)]


@pytest.mark.parametrize("n,d", K5_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain(dev, n, d, dtype):
    args = _k5_inputs(n, d, dtype, dev)
    before = K5.LAUNCHES["pegasos_grad"]
    gw1, gs1 = K5.pegasos_grad(*args)
    torch.cuda.synchronize()
    assert K5.LAUNCHES["pegasos_grad"] == before + 1
    gw2, gs2 = K5.pegasos_grad_plain(*args)
    # 0/1 weights and ±1 labels: gs is a small integer on both sides
    assert float(gs1) == float(gs2) == round(float(gs2))
    # gw adds the same products in another f32 order
    x = args[2].float()
    bound = 1e-5 * (args[4] @ x.abs()) + 1e-6
    assert bool(((gw1 - gw2).abs() <= bound).all())
    gw3, gs3 = K5.pegasos_grad(*args)  # no float atomics: reruns bit-equal
    assert torch.equal(gw1, gw3) and torch.equal(gs1, gs3)


@pytest.mark.parametrize("n,d", [(1000, 128), (4099, 13)])
def test_k5_bf16_rounds_coef_before_the_gradient(dev, n, d):
    """Fractional weights make coef's bf16 rounding show in gw."""
    w, b, x, y, _ = _k5_inputs(n, d, torch.bfloat16, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    sw = torch.rand(n, generator=g, device=dev)
    gw1, gs1 = K5.pegasos_grad(w, b, x, y, sw)
    gw2, gs2 = K5.pegasos_grad_plain(w, b, x, y, sw)
    xf = x.float()
    bound = 1e-5 * (sw @ xf.abs()) + 1e-6
    assert bool(((gw1 - gw2).abs() <= bound).all())
    assert abs(float(gs1) - float(gs2)) <= 1e-5 * float(sw.sum()) + 1e-6
    # a kernel that skipped the rounding of coef would fall outside the bound
    wc = w.to(torch.bfloat16).float()
    coef = torch.where(y * (xf @ wc + b) < 1.0, sw, torch.zeros_like(sw)) * y
    assert bool(((coef @ xf - gw2).abs() > bound).any())


def test_k5_plans_of_two_shapes_do_not_cap_each_other(dev):
    """Each shape's plan is asked once; a small d's plan may not lower the
    shared memory a large d's launches take (w and the accumulator in
    shared memory at d = 20,000: 160 KB)."""
    for d in (20_000, 13, 20_000):
        args = _k5_inputs(300, d, torch.float32, dev)
        gw1, gs1 = K5.pegasos_grad(*args)
        gw2, gs2 = K5.pegasos_grad_plain(*args)
        bound = 1e-5 * (args[4] @ args[2].abs()) + 1e-6
        assert float(gs1) == float(gs2)
        assert bool(((gw1 - gw2).abs() <= bound).all())
    idx = torch.device(dev).index or 0
    assert {(300, 20_000, idx), (300, 13, idx)} <= set(K5._PLANS)


def _k5_unaligned(n, d, dtype, dev, seed=0):
    """The inputs of :func:`_k5_inputs` with x a contiguous [n, d] view
    that starts one element into its storage: not 16-byte aligned."""
    w, b, x, y, sw = _k5_inputs(n, d, dtype, dev, seed)
    flat = torch.empty(n * d + 1, dtype=dtype, device=dev)
    flat[1:] = x.reshape(-1)
    xu = flat[1:].view(n, d)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    return w, b, xu, y, sw


@pytest.mark.parametrize("n,d,layout", [(4099, 13, "unaligned"),
                                        (4099, 128, "unaligned"),
                                        (3001, 127, "aligned"),
                                        (3001, 129, "aligned"),
                                        (500_256, 128, "aligned")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_one_launch_at_every_layout(dev, n, d, layout, dtype):
    """An x that is not 16-byte aligned (d = 13 and 128), d = 127 / 129
    (no 16-byte chunks) and the main path's shape: gs equal, gw within
    the f32-order bound, reruns bit-equal, and one CUDA launch a call (no
    second reduction kernel)."""
    make = _k5_unaligned if layout == "unaligned" else _k5_inputs
    args = make(n, d, dtype, dev)
    before = K5.LAUNCHES["pegasos_grad"]
    gw1, gs1 = K5.pegasos_grad(*args)
    torch.cuda.synchronize()
    assert K5.LAUNCHES["pegasos_grad"] == before + 1
    with torch.cuda.stream(_side()):  # makes the stream's ticket counter
        K5.pegasos_grad(*args)
    torch.cuda.synchronize()
    nodes = _graph_nodes(lambda: K5.pegasos_grad(*args))
    assert len(nodes) == 1 and ("rows_kernel" in nodes[0]
                                or "tile_kernel" in nodes[0]), nodes
    gw2, gs2 = K5.pegasos_grad_plain(*args)
    assert float(gs1) == float(gs2) == round(float(gs2))
    bound = 1e-5 * (args[4] @ args[2].float().abs()) + 1e-6
    assert bool(((gw1 - gw2).abs() <= bound).all())
    gw3, gs3 = K5.pegasos_grad(*args)
    assert torch.equal(gw1, gw3) and torch.equal(gs1, gs3)


def test_svm_fit_launches_k5_once_per_step(dev):
    x, y = SV.synthetic_data(3000, 16, seed=1)
    K5.reset_launches()
    m = SV.SVM(SV.SVMConfig(algo="pallas")).fit(x, y)
    assert K5.LAUNCHES == {"pegasos_grad": 200 * 5}
    assert m.accuracy(x, y) > 0.9
    ref = SV.SVM(SV.SVMConfig(algo="pallas"), device="cpu").fit(x, y)
    np.testing.assert_allclose(m.w, ref.w, rtol=1e-3, atol=1e-5)


# ---- K6: SMACOF row block ----------------------------------------------------------

def _k6_inputs(n_loc, N, dim, dtype, dev, pad=0, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N, 4)).astype(np.float32)
    delta = np.sqrt(((pts[:n_loc, None] - pts[None]) ** 2).sum(-1))
    X = torch.from_numpy(rng.normal(size=(N, dim)).astype(np.float32)).to(dev)
    rm = torch.ones(n_loc, device=dev)
    if pad:
        rm[-pad:] = 0
    return (torch.from_numpy(delta).to(dev, dtype), rm,
            X[:n_loc].contiguous(), X)


# (n_loc, N, dim, n_real, masked rows): the benchmark's block, ragged N,
# masked columns, and an N past one shared-memory chunk
K6_SHAPES = [(512, 4096, 3, 4096, 0), (100, 1000, 2, 990, 3),
             (37, 20_000, 3, 19_999, 1), (64, 300, 8, 300, 0)]


@pytest.mark.parametrize("n_loc,N,dim,n_real,pad", K6_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain(dev, n_loc, N, dim, n_real, pad, dtype):
    args = _k6_inputs(n_loc, N, dim, dtype, dev, pad)
    before = K6.LAUNCHES["smacof_bx"]
    a = K6.smacof_bx(*args, float(n_real), eps=1e-9)
    torch.cuda.synchronize()
    assert K6.LAUNCHES["smacof_bx"] == before + 1
    b = K6.smacof_bx_plain(*args, float(n_real), eps=1e-9)
    # the distance and row sums are added in another f32 order
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert torch.equal(a, K6.smacof_bx(*args, float(n_real), eps=1e-9))
    if pad:
        assert bool((a[-pad:] == 0).all())


def test_k6_refuses_a_dim_past_its_registers(dev):
    args = _k6_inputs(16, 64, 9, torch.float32, dev)
    with pytest.raises(ValueError, match="dim"):
        K6.smacof_bx(*args, 64.0, eps=1e-9)


# (n_loc, N, dim, dtype): n_loc not a multiple of the 32- or 16-row tile,
# N not a multiple of the 16-byte load (4 f32, 8 bf16: element loads), a
# bf16 N that is a multiple of 4 but not of 8, and dim 5 (2 rows a warp)
K6_RAGGED = [(37, 4099, 3, torch.float32), (70, 4100, 3, torch.bfloat16),
             (33, 4097, 3, torch.bfloat16), (45, 4104, 5, torch.float32),
             (4096, 4096, 3, torch.float32), (4096, 4096, 3, torch.bfloat16)]


@pytest.mark.parametrize("n_loc,N,dim,dtype", K6_RAGGED)
def test_k6_ragged_rows_and_loads_match_plain(dev, n_loc, N, dim, dtype):
    args = _k6_inputs(n_loc, N, dim, dtype, dev, pad=1)
    a = K6.smacof_bx(*args, float(N - 2), eps=1e-9)
    b = K6.smacof_bx_plain(*args, float(N - 2), eps=1e-9)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert torch.equal(a, K6.smacof_bx(*args, float(N - 2), eps=1e-9))
    assert bool((a[-1] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_takes_an_unaligned_delta(dev, dtype):
    """A delta whose base is not 16-byte aligned takes element loads."""
    delta, rm, Xl, X = _k6_inputs(100, 1024, 3, dtype, dev)
    flat = torch.empty(delta.numel() + 1, dtype=dtype, device=dev)
    flat[1:] = delta.reshape(-1)
    du = flat[1:].view(delta.shape)
    assert du.is_contiguous() and du.data_ptr() % 16 != 0
    a = K6.smacof_bx(du, rm, Xl, X, 1024.0, eps=1e-9)
    torch.testing.assert_close(
        a, K6.smacof_bx_plain(delta, rm, Xl, X, 1024.0, eps=1e-9),
        rtol=1e-4, atol=1e-5)
    assert torch.equal(a, K6.smacof_bx(du, rm, Xl, X, 1024.0, eps=1e-9))


def test_k6_plans_of_two_shapes_do_not_cap_each_other(dev):
    """Each shape's plan is asked once; a small N's plan may not lower the
    shared memory a large N's launches take (records of 20,000 columns at
    dim 3 walk 128 KB chunks)."""
    for n_loc, N in ((37, 20_000), (16, 300), (37, 20_000)):
        args = _k6_inputs(n_loc, N, 3, torch.float32, dev)
        torch.testing.assert_close(
            K6.smacof_bx(*args, float(N), eps=1e-9),
            K6.smacof_bx_plain(*args, float(N), eps=1e-9), rtol=1e-4,
            atol=1e-5)
    idx = torch.device(dev).index or 0
    assert {(37, 20_000, 3, idx), (16, 300, 3, idx)} <= set(K6._PLANS)


def test_mds_launches_k6_once_per_iteration(dev):
    delta = WD.benchmark_delta(300, 1)
    K6.reset_launches()
    X, stress = WD.mds(delta, WD.MDSConfig(dim=3, iters=30, algo="pallas"))
    assert K6.LAUNCHES == {"smacof_bx": 30}
    _, ref = WD.mds(delta, WD.MDSConfig(dim=3, iters=30), device="cpu")
    np.testing.assert_allclose(stress, ref, rtol=1e-3)


# ---- K7: RF label histograms -------------------------------------------------------

@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k7_is_bit_equal_to_plain(dev, level, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(level)
    T, n, f, B, C_ = 5, 7001, 9, 32, 3
    R = 2 ** level * C_
    bins = torch.randint(0, B, (n, f), generator=g, device=dev).to(dtype)
    rc = torch.randint(0, R + 1, (T, n), generator=g, device=dev,
                       dtype=torch.int32)  # R: an out-of-range code
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g).clamp(
        0, 127).to(torch.int32)
    before = K7.LAUNCHES["hist_bins"]
    h1 = K7.hist_bins(bins, rc, w, R, B)
    torch.cuda.synchronize()
    assert K7.LAUNCHES["hist_bins"] == before + 1
    assert torch.equal(h1, K7.hist_bins_plain(bins, rc, w, R, B))
    assert torch.equal(h1, K7.hist_bins(bins, rc, w, R, B))


def _k7_inputs(T, n, f, B, R, dtype, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bins = torch.randint(0, B, (n, f), generator=g, device=dev).to(dtype)
    rc = torch.randint(0, R, (T, n), generator=g, device=dev,
                       dtype=torch.int32)
    w = torch.poisson(torch.ones((T, n), device=dev), generator=g).clamp(
        0, 127).to(torch.int32)
    return bins, rc, w


def _k7_check(bins, rc, w, R, B):
    before = K7.LAUNCHES["hist_bins"]
    h1 = K7.hist_bins(bins, rc, w, R, B)
    torch.cuda.synchronize()
    assert K7.LAUNCHES["hist_bins"] == before + 1
    assert torch.equal(h1, K7.hist_bins_plain(bins, rc, w, R, B))
    assert torch.equal(h1, K7.hist_bins(bins, rc, w, R, B))
    return h1


@pytest.mark.parametrize("level", [0, 5])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k7_main_path_width_is_bit_equal(dev, level, dtype):
    """f = 64 features, 32 trees, 32 bins, 2 classes at levels 0 and 5."""
    _k7_check(*_k7_inputs(32, 20_000, 64, 32, 2 ** level * 2, dtype, dev,
                          level), 2 ** level * 2, 32)


@pytest.mark.parametrize("f", [9, 13, 72])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k7_features_not_a_multiple_of_the_vector_width(dev, f, dtype):
    _k7_check(*_k7_inputs(6, 5001, f, 32, 16, dtype, dev, f), 16, 32)


@pytest.mark.parametrize("f", [64, 13])
def test_k7_takes_bins_that_are_not_16_byte_aligned(dev, f):
    """A contiguous [n, f] view one byte into its storage: element loads."""
    bins, rc, w = _k7_inputs(4, 3001, f, 32, 8, torch.uint8, dev)
    flat = torch.empty(bins.numel() + 1, dtype=torch.uint8, device=dev)
    flat[1:] = bins.reshape(-1)
    bu = flat[1:].view(bins.shape)
    assert bu.is_contiguous() and bu.data_ptr() % 16 != 0
    _k7_check(bu, rc, w, 8, 32)


def test_k7_all_zero_weights_give_zero_counts(dev):
    bins, rc, w = _k7_inputs(32, 20_000, 64, 32, 64, torch.uint8, dev)
    h = _k7_check(bins, rc, torch.zeros_like(w), 64, 32)
    assert not bool(h.any())


def test_k7_takes_R_up_to_its_shared_memory_limit(dev):
    """The largest R whose one-feature histogram the planner fits runs
    bit-equal; the next power of two past it raises."""
    K7.hist_bins(*_k7_inputs(1, 64, 2, 32, 2, torch.uint8, dev), 2, 32)
    optin, sms = K7._CARDS[torch.cuda.current_device()]
    R = 1
    while K7.plan(2, 5000, 3, 32, 2 * R, 1, optin, sms) is not None:
        R *= 2
    lo, hi = R, 2 * R  # the limit lies in [lo, hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if K7.plan(2, 5000, 3, 32, mid, 1, optin, sms) is None:
            hi = mid
        else:
            lo = mid
    _k7_check(*_k7_inputs(2, 5000, 3, 32, lo, torch.uint8, dev), lo, 32)
    bins, rc, w = _k7_inputs(2, 100, 3, 32, 2, torch.uint8, dev)
    with pytest.raises(ValueError, match="shared memory"):
        K7.hist_bins(bins, rc, w, 2 * hi, 32)


# pinned plans (fs, tg, ns, nchunks): W = 32 over two passes, 16, 8, 4 and
# 1 lanes an item, a ragged last slice (24), one sub-tile a slot and 64,
# owner stores (one chunk) and atomic flushes, uint8 and int32 bins
K7_PINS = [(64, 2, 2, 1), (64, 2, 2, 5), (32, 1, 8, 3), (16, 4, 4, 1),
           (8, 8, 1, 2), (4, 1, 64, 1), (1, 3, 4, 4), (24, 2, 4, 2)]


@pytest.mark.parametrize("fs,tg,ns,nchunks", K7_PINS)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_k7_every_plan_is_bit_equal(dev, fs, tg, ns, nchunks, dtype):
    T, n, f, B, R = 7, 9001, 64, 32, 8
    bins, rc, w = _k7_inputs(T, n, f, B, R, dtype, dev, fs)
    lib = K7._lib()
    optin, sms = K7._card(lib, torch.cuda.current_device())
    p = K7.plan(T, n, f, B, R, bins.element_size(), optin, sms, fs=fs,
                tg=tg, ns=ns, nchunks=nchunks)
    assert p.smem <= optin and (p.ns, p.nchunks) == (ns, nchunks)
    assert p.w == min(32, 1 << (fs - 1).bit_length())
    # the launch refuses a layout with a region too small for its contents
    for bad in ({"smem": p.smem - 16}, {"counts_at": p.counts_at - 16},
                {"slot": p.slot - 16}, {"rcw_at": p.rcw_at - 16}):
        with pytest.raises(RuntimeError, match="CUDA error"):
            K7.launch(lib, dataclasses.replace(p, **bad), bins, rc, w, R, B)
    ref = K7.hist_bins_plain(bins, rc, w, R, B)
    h = K7.launch(lib, p, bins, rc, w, R, B)
    assert torch.equal(h, ref)
    assert torch.equal(h, K7.launch(lib, p, bins, rc, w, R, B))


def test_k7_plans_of_two_shapes_do_not_cap_each_other(dev):
    """Each shape's plan is made once; a small shape's plan between two
    launches of a large one (~195 KB of shared memory) leaves the large
    one launchable."""
    big, small = (32, 20_000, 64, 32, 64), (3, 500, 5, 7, 2)
    for T, n, f, B, R in (big, small, big):
        _k7_check(*_k7_inputs(T, n, f, B, R, torch.uint8, dev), R, B)
    idx = torch.cuda.current_device()
    assert {(*big, 1, idx), (*small, 1, idx)} <= set(K7._PLANS)
    assert K7._PLANS[(*big, 1, idx)].smem > 100_000


def test_k7_refuses_a_histogram_past_shared_memory(dev):
    bins = torch.zeros((100, 2), dtype=torch.uint8, device=dev)
    rc = torch.zeros((1, 100), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        K7.hist_bins(bins, rc, rc, 2 ** 16, 32)


def test_rf_fit_launches_k7_once_per_level_and_equals_dense(dev):
    x, y = RF.synthetic_classification(5000, 16, seed=2)
    forests = {}
    for algo in ("pallas", "dense", "scatter"):
        K7.reset_launches()
        m = RF.RandomForest(RF.RFConfig(n_trees=8, max_depth=6,
                                        hist_algo=algo)).fit(x, y)
        forests[algo] = m.forest
        assert K7.LAUNCHES == {"hist_bins": 6 if algo == "pallas" else 0}
    assert m.accuracy(x, y) > 0.9
    for algo in ("dense", "scatter"):
        for a, b in zip(forests["pallas"], forests[algo]):
            np.testing.assert_array_equal(a, b)


# ---- K8: flash attention -------------------------------------------------------

# (causal, window) on N = 256 and the ragged N = 200 (a partial 64-row
# tile); bf16 at D = 16, 64, 128 takes the tensor-core path, bf16 at D = 24
# and every f32 case the CUDA-core one
# f32 within the reference's own gate; bf16 within two bf16 steps of each
# entry's size or its row's RMS (flash_attention.row_scaled_error)
K8_MASKS = [(False, None), (True, None), (True, 40), (False, 40)]


def _k8_inputs(bh, n, d, dtype, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn((bh, n, d), generator=g, device=dev).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("causal,window", K8_MASKS)
@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("d", [16, 24, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_matches_plain(dev, causal, window, n, d, dtype):
    q, k, v = _k8_inputs(3, n, d, dtype, dev, seed=d + n)
    kw = {"causal": causal, "window": window, "block_q": 64, "block_k": 64}
    if n % 64:
        kw.update(block_q=n, block_k=n)
    before = K8.LAUNCHES["flash_attention"]
    o1 = K8.flash_attention(q, k, v, **kw)
    o2 = K8.flash_attention_plain(q, k, v, **kw)
    o3 = K8.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K8.LAUNCHES["flash_attention"] == before + 2
    assert o1.dtype == dtype and o1.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(o1, o2, rtol=2e-4, atol=2e-5)
    else:
        assert K8.row_scaled_error(o1, o2) <= K8.BF16_ROW_TOL
    assert torch.equal(o1, o3)


# the redesigned paths (wgmma for bf16, the register-tiled SIMT kernel for
# f32) at ragged N, N under one 128-query tile, and windows smaller and
# larger than a 64-key tile
K8_NEW_MASKS = [(True, None), (True, 40), (True, 300), (False, None),
                (False, 300)]


@pytest.mark.parametrize("causal,window", K8_NEW_MASKS)
@pytest.mark.parametrize("n", [100, 1000, 4099])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_new_paths_match_plain_at_ragged_n(dev, causal, window, n, d,
                                              dtype):
    q, k, v = _k8_inputs(2, n, d, dtype, dev, seed=n + d)
    kw = {"causal": causal, "window": window, "block_q": n, "block_k": n}
    path = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = K8.PATH_LAUNCHES[path]
    o1 = K8.flash_attention(q, k, v, **kw)
    o3 = K8.flash_attention(q, k, v, **kw)
    o2 = K8.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K8.PATH_LAUNCHES[path] == before + 2
    assert o1.dtype == dtype and o1.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(o1, o2, rtol=2e-4, atol=2e-5)
    else:
        assert K8.row_scaled_error(o1, o2) <= K8.BF16_ROW_TOL
    assert torch.equal(o1, o3)


def test_k8_paths_by_dtype_and_head_dim(dev):
    """bf16 at D 64 and 128 runs wgmma, and f32 or bf16 at any other D the
    SIMT kernel; a launch counts on its own path only."""
    expect = {(torch.bfloat16, 128): "wgmma", (torch.bfloat16, 64): "wgmma",
              (torch.bfloat16, 32): "simt",
              (torch.bfloat16, 16): "simt", (torch.bfloat16, 24): "simt",
              (torch.float32, 128): "simt", (torch.float32, 64): "simt"}
    for (dtype, d), path in expect.items():
        assert K8.kernel_path(dtype, d) == path
        q, k, v = _k8_inputs(1, 128, d, dtype, dev)
        before = dict(K8.PATH_LAUNCHES)
        K8.flash_attention(q, k, v, causal=True)
        after = dict(K8.PATH_LAUNCHES)
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == path) for p in after}


def test_k8_matches_dense_attention_at_d256(dev):
    q, k, v = _k8_inputs(2, 128, 256, torch.float32, dev, seed=3)
    o = K8.flash_attention(q, k, v, causal=True, scale=0.05)
    ref = K8.reference_attention(q, k, v, causal=True, scale=0.05)
    torch.testing.assert_close(o, ref, rtol=2e-4, atol=2e-5)


def test_k8_refuses_bad_head_dims_and_layouts(dev):
    for d in (12, 264):
        q = torch.zeros((1, 64, d), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            K8.flash_attention(q, q, q)
    q = torch.zeros((1, 64, 32), device=dev)
    t = torch.zeros((1, 32, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K8.flash_attention(t, q, q)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(64 * 32 + 1, device=dev)
        K8.flash_attention(flat[1:].view(1, 64, 32), q, q)
