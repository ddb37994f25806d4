"""The port's KMeans partials (plain versions of K1 and K2) against
harp_tpu's Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import kmeans as JKM
from harp_tpu.ops import kmeans_kernel as JK
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.ops import kmeans_kernel as KK


def _blobs(n, d, k, seed=0, spread=8.0):
    """Well-separated clusters: assignment is unambiguous under bf16
    scoring (the reference test's generator)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    assign = rng.integers(0, k, n)
    assign[:k] = np.arange(k)
    pts = centers[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.1
    return pts.astype(np.float32), centers


def _int8_both(pts, centers):
    """Quantized operands for both packages from the same numpy inputs."""
    q, scale = JKM.quantize_points_int8(pts)
    jargs = (jnp.asarray(q), *JKM._quantize_centroids(
        jnp.asarray(centers), jnp.asarray(scale)), jnp.asarray(scale))
    targs = (torch.from_numpy(q), *KM._quantize_centroids(
        torch.from_numpy(centers), torch.from_numpy(scale)),
        torch.from_numpy(scale))
    return jargs, targs


# (n, d, k): k below, at and above the TPU's 128-row centroid pad; n whose
# largest supported TPU tile is small (the port takes any n)
INT8_SHAPES = [(512, 40, 7), (256, 16, 5), (384, 24, 130), (1000, 12, 3)]


@pytest.mark.parametrize("n,d,k", INT8_SHAPES)
def test_k1_plain_matches_reference_kernel(n, d, k):
    pts, centers = _blobs(n, d, k)
    jargs, targs = _int8_both(pts, centers)
    js, jn, jb = JK.kmeans_partials_int8(*jargs, interpret=True)
    ts, tn, tb = KK.kmeans_partials_int8(*targs)
    # exact integer sums and counts, one f32 dequantizing multiply each
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # best_sum: the same scores summed in another order
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-5)


def test_k1_plain_ragged_n_matches_the_int8_matmul_path():
    """The port takes n = 1001 (no TPU tile divides it); the reference's
    int8 matmul path, which the TPU kernel reproduces bit for bit, takes
    any n too."""
    pts, centers = _blobs(1001, 20, 6, seed=4)
    jargs, targs = _int8_both(pts, centers)
    q, c_q, c_scale, c2, scale = jargs
    js, jn, ji = JKM._partials_block_int8(q, scale, jnp.asarray(centers), c2)
    ts, tn, tb = KK.kmeans_partials_int8(*targs)
    x2 = ((targs[0].float() * targs[4]) ** 2).sum()
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # inertia = sum|x|^2 + sum of best scores nearly cancels; each side sums
    # its terms in f32 in its own order, so the gap scales with sum|x|^2
    assert abs(float(tb + x2) - float(ji)) <= 1e-5 * float(x2)


def test_k1_ties_go_to_the_lowest_index():
    pts = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    centers = np.tile(pts[:1], (40, 1))  # 40 identical centroids
    jargs, targs = _int8_both(pts, centers)
    _, tn, _ = KK.kmeans_partials_int8(*targs)
    _, jn, _ = JK.kmeans_partials_int8(*jargs, interpret=True)
    assert tn[0] == 64 and tn[1:].sum() == 0
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


K2_SHAPES = [(512, 40, 7), (256, 16, 5), (384, 24, 130)]


@pytest.mark.parametrize("n,d,k", K2_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_reference_kernel(n, d, k, dtype):
    pts, centers = _blobs(n, d, k, seed=1)
    jx = jnp.asarray(pts, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(pts).to(getattr(torch, dtype))
    js, jn, ji = JK.kmeans_partials(jx, jnp.asarray(centers), interpret=True)
    ts, tn, ti = KK.kmeans_partials(tx, torch.from_numpy(centers))
    # separated blobs: identical assignments under bf16 scoring
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # both add the same bf16-rounded points in f32, in different orders
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    # the same |x|^2 + c2 - 2 x.c decomposition, which nearly cancels,
    # summed in f32 in another order: the gap scales with sum |x|^2, and
    # 1e-5 of it is far inside the reference's own bound of 4e-3
    x2 = float((tx.double() ** 2).sum())
    assert abs(float(ti) - float(ji)) <= 1e-5 * x2


def test_k2_ties_go_to_the_lowest_index():
    pts = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    c = np.tile(pts[:1], (4, 1))
    _, counts, _ = KK.kmeans_partials(torch.from_numpy(pts),
                                      torch.from_numpy(c))
    assert counts[0] == 64 and counts[1:].sum() == 0


def test_quantize_points_int8_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(300, 11)) * rng.uniform(0.1, 50, 11)).astype(
        np.float32)
    x[:, 4] = 0.0  # an all-zero feature takes the 1e-30 floor
    q, s = KM.quantize_points_int8(x)
    jq, js = JKM.quantize_points_int8(x)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert q.dtype == np.int8 and s.dtype == np.float32


def test_quantize_centroids_bit_equal_to_reference():
    rng = np.random.default_rng(1)
    c = (rng.normal(size=(9, 13)) * 5).astype(np.float32)
    scale = rng.uniform(0.01, 1.0, 13).astype(np.float32)
    cq, cs, c2 = KM._quantize_centroids(torch.from_numpy(c),
                                        torch.from_numpy(scale))
    jcq, jcs, jc2 = JKM._quantize_centroids(jnp.asarray(c), jnp.asarray(scale))
    np.testing.assert_array_equal(cq.numpy(), np.asarray(jcq))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs))
    # |c|^2 is a 13-term f32 sum: equal up to the order of its additions
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), rtol=1e-6)


def test_exact_int_dot_is_exact_past_the_f32_range():
    """d = 1100 (127^2 * d > 2^24) switches the product to f64."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, size=(5, 1100)).astype(np.int8)
    b = rng.integers(-127, 128, size=(3, 1100)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64).T
    got = KK.exact_int_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_run_plain_versions_without_counting():
    pts, centers = _blobs(128, 8, 3)
    _, targs = _int8_both(pts, centers)
    before = dict(KK.LAUNCHES)
    a = KK.kmeans_partials_int8(*targs)
    b = KK.kmeans_partials_int8_plain(*targs)
    x, c = torch.from_numpy(pts), torch.from_numpy(centers)
    e = KK.kmeans_partials(x, c)
    f = KK.kmeans_partials_plain(x, c)
    assert KK.LAUNCHES == before
    for u, v in zip(a + e, b + f):
        assert torch.equal(u, v)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_k1_wrapper_rejects_bad_arguments(bad):
    pts, centers = _blobs(64, 8, 3)
    _, targs = _int8_both(pts, centers)
    q, c_q, c_scale, c2, scale = targs
    if bad == "dtype":
        q = q.to(torch.int32)
    elif bad == "shape":
        c2 = c2[:2]
    elif bad == "contiguity":
        q = torch.cat([q, q], 1)[:, ::2]
    else:
        c_q = c_q.to("meta")
    with pytest.raises((TypeError, ValueError)):
        KK.kmeans_partials_int8(q, c_q, c_scale, c2, scale)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_k2_wrapper_rejects_bad_arguments(bad):
    x = torch.zeros(16, 4)
    c = torch.zeros(3, 4)
    if bad == "dtype":
        x = x.to(torch.float64)
    elif bad == "shape":
        c = torch.zeros(3, 5)
    else:
        x = torch.zeros(4, 16).T
    with pytest.raises((TypeError, ValueError)):
        KK.kmeans_partials(x, c)
