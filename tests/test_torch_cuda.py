"""Kernels K1 and K2 against their plain versions on the card.

These need an NVIDIA card with ``nvcc``; elsewhere each test skips (the
fixture decides, never the import).  On the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest configures JAX, which the card's
machine does not have; this file imports only torch and the port.)
"""

import numpy as np
import pytest
import torch

from harp_tpu_torch.ops import kmeans_kernel as KK
from harp_tpu_torch.models import kmeans as KM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels K1/K2 have no CPU mode)")
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


# (n, d, k): ragged n, d not a multiple of 4 (byte-assembled loads), k not a
# multiple of the 32-centroid tile, and a k whose sums do not fit on chip
SHAPES = [(1000, 40, 7), (4099, 13, 37), (3000, 300, 100), (2049, 300, 1000)]


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


def test_k1_ties_go_to_the_lowest_index(dev):
    pts = np.random.default_rng(0).normal(size=(500, 24)).astype(np.float32)
    centers = np.tile(pts[:1], (70, 1))  # 70 identical centroids, 3 tiles
    _, counts, _ = KK.kmeans_partials_int8(*_int8_args(pts, centers, dev))
    assert counts[0] == 500 and counts[1:].sum() == 0


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
    s3, _, i3 = KK.kmeans_partials(x, c)
    assert torch.equal(s1, s3) and torch.equal(i1, i3)


def test_k2_ties_go_to_the_lowest_index(dev):
    x = torch.randn(300, 24, device=dev)
    c = x[:1].repeat(70, 1)
    _, counts, _ = KK.kmeans_partials(x, c)
    assert counts[0] == 300 and counts[1:].sum() == 0


def test_fit_runs_each_kernel_once_per_iteration(dev):
    pts, _ = _blobs(4096, 32, 8)
    KK.reset_launches()
    KM.fit(pts, k=8, iters=3, seed=0, quantize="int8")
    KM.fit(pts, k=8, iters=4, seed=0, use_pallas=True)
    KM.fit(pts, k=8, iters=2, seed=0)
    assert KK.LAUNCHES == {"kmeans_partials_int8": 3, "kmeans_partials": 4}
