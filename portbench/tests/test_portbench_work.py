"""The frozen work counts against hand arithmetic, at each cell's size."""

from __future__ import annotations

import json

import pytest

from portbench import harness
from portbench.work import counts

ROOT = harness.ROOT


def _cfg(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def _trf(name):
    return json.loads((ROOT / f"portbench/traffic/{name}.json").read_text())


def test_peaks_are_the_data_sheet():
    assert counts.PEAKS["bf16_flops"] == 989e12
    assert counts.PEAKS["int8_ops"] == 1979e12
    assert counts.PEAKS["f32_flops"] == 67e12
    assert counts.PEAKS["hbm_bytes_s"] == 3.35e12


def test_k1_chunk():
    w = counts.k1_chunk(262_144, 300, 1000)
    assert w["ops"] == 157_286_400_000  # 2 x 262,144 x 300 x 1000
    assert w["bytes"] == 262_144 * 300 + 300_000 + 4 * 2300 + 4 * 301_001
    # operations bound it: 1.5729e11 / 1.979e15 s = 79.48 us
    assert w["bound_s"] == pytest.approx(7.9478e-5, rel=1e-4)


@pytest.mark.parametrize("traffic,precision,n,bound", [
    ("int8_n1e9", "int8", 999_817_216, 0.30328),
    ("f32_n1e8", "f32", 99_876_864, 0.89487)])
def test_lloyd_epoch(traffic, precision, n, bound):
    cfg, trf = _cfg("kmeans-stream-d300-k1000"), _trf(traffic)
    assert trf["precision"] == precision
    points = trf["chunks"] * cfg["chunk_points"]
    assert points == n
    w = counts.lloyd_epoch(points, cfg["d"], cfg["k"], precision)
    assert w["ops"] == 2 * n * 300 * 1000 + n * 300
    if precision == "int8":
        assert w["ops"] == pytest.approx(6.0e14, rel=1e-3)
    assert w["bound_s"] == pytest.approx(bound, rel=1e-4)


def test_mfsgd_epoch():
    cfg = _cfg("mfsgd-ml20m-r64")
    w = counts.mfsgd_epoch(cfg["nnz"], 138_493, 26_744, 64)
    assert w["ops"] == 12 * 64 * 20_000_263  # 1.536e10
    assert w["bytes"] == 12 * 20_000_263 + 8 * 64 * (138_493 + 26_744)
    # operations bound it: 1.5360e10 / 6.7e13 s = 0.229 ms
    assert w["bound_s"] == pytest.approx(2.2926e-4, rel=1e-4)


def test_lda_sweep():
    """K4's least time a sweep: 7 f32 operations a real token and topic
    (the conditional's arithmetic; gathers are bytes), or the tables and
    tokens moved once; padded slots are no work."""
    from portbench.work import lda

    cfg = _cfg("lda-enwiki1m-k1000")
    n, K = 100_000_000, cfg["n_topics"]
    D, V = cfg["n_docs"], cfg["vocab_size"]
    assert lda.OPS_PER_TOKEN_TOPIC == 7
    w = lda.cgs_sweep(n, K, D, V, 2)
    assert w["ops"] == 7 * n * 1000  # 7e11
    assert w["bytes"] == 2 * 1000 * (131_072 * 2 + 1_000_000 * 4) + 16 * n
    # operations bound it: 7e11 / 6.7e13 s = 10.45 ms (bytes 3.02 ms)
    assert w["bound_s"] == pytest.approx(1.0448e-2, rel=1e-4)
    assert w["bound_s"] > w["bytes"] / counts.PEAKS["hbm_bytes_s"]
    f32 = lda.cgs_sweep(n, K, D, V, 4)
    assert f32["bytes"] - w["bytes"] == 2 * 1000 * 131_072 * 2
    assert lda.cgs_sweep(n // 2, K, 1, 1, 2)["ops"] == w["ops"] // 2
    # the tables bound a sweep of few tokens
    few = lda.cgs_sweep(1000, K, D, V, 2)
    assert few["bound_s"] == pytest.approx(
        few["bytes"] / counts.PEAKS["hbm_bytes_s"])
