"""The port's streaming KMeans (harp_tpu_torch.models.kmeans_stream)
against harp_tpu's on the same seeded inputs.

Tolerances, and why:

- int8: assignments are exact on both sides (integer dots, the same
  rounding and scale rule), so the counts of every chunk are equal; the
  dequantized f32 partials add in another order (the reference masks a
  padded tail, the port ships the tail at its true rows), so centroids
  agree within rtol/atol 1e-5.
- f32: the same sums in another f32 order: centroids within rtol/atol
  1e-5, as the resident fit's test (tests/test_torch_kmeans.py).
- inertia is sum|x|^2 + sum of best scores, which nearly cancels: the gap
  is bounded by 1e-5 of sum|x|^2, as for the resident fit.
- bf16 compute: one bf16 step (2^-8) apart near a rounding boundary:
  rtol/atol 1e-2, as for the resident fit.
- every prefetch depth, and the f16 wire against the host cast, are
  bit-identical (exact comparisons).
- several workers against one source: the local-split, single-source and
  file-split fits reorder only the f32 partial sums: rtol 1e-5 / atol
  1e-6, the reference's own check of the local split.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import kmeans as JKM
from harp_tpu.models import kmeans_stream as JKS
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.models import kmeans_stream as KS
from harp_tpu_torch.ops import kmeans_kernel as KK
from harp_tpu_torch.parallel.mesh import WorkerMesh
from torch_world import (STREAM_SHAPE, WORLD, run_stream_cases, run_world,
                         stream_points, stream_split)

ITERS = 4
CPU = WorkerMesh("cpu")


def blobs(n=3001, d=12, c=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d))
            + rng.integers(0, c, size=(n, 1)) * 6).astype(np.float32)


def _x2(pts):
    return float((np.asarray(pts, np.float64) ** 2).sum())


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


def _close(c, i, jc, ji, pts, rtol=1e-5):
    np.testing.assert_allclose(c, np.asarray(jc, np.float32), rtol=rtol,
                               atol=rtol)
    assert abs(i - float(ji)) <= 1e-5 * _x2(pts)


PATHS = {"f32": ({}, {}), "int8": ({"quantize": "int8"}, {"quantize": "int8"}),
         "bf16": ({"dtype": torch.bfloat16}, {"dtype": jnp.bfloat16})}


@pytest.mark.parametrize("chunk", [700, 256, 5000])
@pytest.mark.parametrize("path", list(PATHS))
def test_fit_streaming_matches_reference(jmesh1, path, chunk):
    pts = blobs()
    kw, jkw = PATHS[path]
    init = pts[:8].copy()
    c, i, h = KS.fit_streaming(pts, k=8, iters=ITERS, chunk_points=chunk,
                               mesh=CPU, init=init, return_history=True,
                               **kw)
    jc, ji, jh = JKS.fit_streaming(pts, k=8, iters=ITERS, chunk_points=chunk,
                                   mesh=jmesh1, init=init,
                                   return_history=True, **jkw)
    assert c.shape == (8, 12) and c.dtype == np.float32 and h.shape == (4,)
    _close(c, i, jc, ji, pts, rtol=1e-2 if path == "bf16" else 1e-5)
    assert np.all(np.abs(h - np.asarray(jh)) <= 1e-5 * _x2(pts) +
                  (1e-2 * np.abs(h) if path == "bf16" else 0))


@pytest.mark.parametrize("chunk", [700, 1000])
def test_int8_chunk_counts_equal_reference(chunk):
    """One epoch's chunk partials from the same centroids: the port's
    (K1's plain version, the tail at its true rows) and the reference's
    (the padded tail masked) have equal counts, chunk by chunk."""
    pts = blobs(seed=3)
    n, d = pts.shape
    scales = KS._int8_scales(pts, n, chunk)
    np.testing.assert_array_equal(scales, JKS._int8_scales(pts, n, chunk))
    cent = pts[::97][:9]
    ops = KM.epoch_operands(torch.from_numpy(cent), "int8",
                            torch.from_numpy(scales))
    jc2 = (jnp.asarray(cent) ** 2).sum(-1)
    for lo in range(0, n, chunk):
        blk = pts[lo:lo + chunk]
        q = KM._clip_round_int8(blk, scales)
        _, counts, _ = KM.chunk_partials(torch.from_numpy(q), ops, "int8")
        pad = np.zeros((chunk, d), np.int8)
        pad[:len(q)] = q
        mask = (np.arange(chunk) < len(q)).astype(np.float32)
        _, jcounts, _ = JKM._partials_block_int8(
            jnp.asarray(pad), jnp.asarray(scales), jnp.asarray(cent), jc2,
            mask=jnp.asarray(mask))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("path", ["f32", "int8", "f16-source"])
def test_every_prefetch_depth_is_bit_identical(path):
    pts = blobs(n=2100, d=10, seed=5)
    kw = {"quantize": "int8"} if path == "int8" else {}
    if path == "f16-source":
        pts = pts.astype(np.float16)
    outs = [KS.fit_streaming(pts, k=6, iters=3, chunk_points=400, mesh=CPU,
                             seed=3, prefetch=p, return_history=True, **kw)
            for p in (0, 1, 2, 4)]
    for c, i, h in outs[1:]:
        np.testing.assert_array_equal(c, outs[0][0])
        np.testing.assert_array_equal(h, outs[0][2])
        assert i == outs[0][1]


def test_f16_wire_is_bit_identical_to_the_host_cast(jmesh1):
    pts16 = blobs(n=1200, d=12).astype(np.float16)
    c_auto, i_auto = KS.fit_streaming(pts16, k=5, iters=4, chunk_points=512,
                                      mesh=CPU, seed=7)
    c_host, i_host = KS.fit_streaming(pts16, k=5, iters=4, chunk_points=512,
                                      mesh=CPU, seed=7, wire_dtype=None)
    c_f32, i_f32 = KS.fit_streaming(pts16.astype(np.float32), k=5, iters=4,
                                    chunk_points=512, mesh=CPU, seed=7)
    np.testing.assert_array_equal(c_auto, c_host)
    np.testing.assert_array_equal(c_auto, c_f32)
    assert i_auto == i_host == i_f32
    jc, ji = JKS.fit_streaming(pts16, k=5, iters=4, chunk_points=512,
                               mesh=jmesh1, seed=7)
    _close(c_auto, i_auto, jc, ji, pts16)


def test_bf16_wire_matches_reference(jmesh1):
    """A forced bf16 wire on f32 data (lossy, opt-in): both packages round
    the same values to bf16 (round to nearest even) before the f32 math."""
    pts = blobs(n=900, d=8, seed=2)
    init = pts[:4].copy()
    c, i = KS.fit_streaming(pts, k=4, iters=3, chunk_points=300, mesh=CPU,
                            init=init, wire_dtype="bfloat16")
    jc, ji = JKS.fit_streaming(pts, k=4, iters=3, chunk_points=300,
                               mesh=jmesh1, init=init,
                               wire_dtype=jnp.bfloat16)
    _close(c, i, jc, ji, pts)


def test_resolve_wire_dtype_rules():
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16

    def r(wire, dtype, src):
        return KS._resolve_wire_dtype(wire, dtype, src, CPU)

    assert r("auto", f32, np.float16) == f16
    assert r("auto", f32, np.float32) == f32
    assert r("auto", f32, np.int16) == f32
    assert r("auto", f32, None) == f32  # a mixed or unknown source
    assert r("auto", f16, np.float16) == f16  # never wider than compute
    assert r("auto", bf16, np.float16) == bf16  # never as wide as compute
    assert r(None, f32, np.float16) == f32
    for wire in (np.float16, "float16", torch.float16):
        assert r(wire, f32, np.float32) == f16
    assert r("bfloat16", f32, np.float32) == bf16
    for bad in (np.int8, "int8", torch.int32):
        with pytest.raises(ValueError, match="float"):
            r(bad, f32, np.float32)


@pytest.mark.parametrize("entry", ["fit_streaming", "local", "files",
                                   "benchmark"])
def test_int8_rejects_a_wrap_prone_chunk(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(KS, "_INT8_SUM_ROW_LIMIT", 4)
    pts = blobs(n=512, d=4)
    kw = dict(k=4, iters=1, chunk_points=512, mesh=CPU, quantize="int8",
              init=pts[:4].copy())
    with pytest.raises(ValueError, match="accumulation bound"):
        if entry == "fit_streaming":
            KS.fit_streaming(pts, **kw)
        elif entry == "local":
            KS.fit_streaming_local(pts, **kw)
        elif entry == "files":
            np.save(tmp_path / "a.npy", pts)
            KS.fit_streaming_files([str(tmp_path / "a.npy")], **kw)
        else:
            KS.benchmark_streaming(n=512, d=4, k=4, iters=1, mesh=CPU,
                                   quantize="int8")


@pytest.mark.parametrize("init,seed", [("random", 0), ("random", None),
                                       ("kmeans++", 4)])
def test_seeding_matches_reference(jmesh1, init, seed):
    pts = blobs(n=1500, d=5, seed=8)
    c, i = KS.fit_streaming(pts, k=7, iters=0, mesh=CPU, seed=seed,
                            init=init)
    jc, ji = JKS.fit_streaming(pts, k=7, iters=0, mesh=jmesh1, seed=seed,
                               init=init)
    np.testing.assert_array_equal(c, jc)
    assert i == ji == 0.0
    c, _ = KS.fit_streaming_local(pts, k=7, iters=0, mesh=CPU, seed=seed,
                                  init=init)
    jc, _ = JKS.fit_streaming_local(pts, k=7, iters=0, mesh=jmesh1,
                                    seed=seed, init=init)
    np.testing.assert_array_equal(c, jc)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_fit_streaming_local_one_worker_matches_reference(jmesh1, quantize):
    pts = blobs(n=3100, seed=9)
    init = pts[:8].copy()
    c, i, h = KS.fit_streaming_local(pts, k=8, iters=ITERS, chunk_points=512,
                                     mesh=CPU, init=init, quantize=quantize,
                                     return_history=True)
    jc, ji = JKS.fit_streaming_local(pts, k=8, iters=ITERS, chunk_points=512,
                                     mesh=jmesh1, init=init,
                                     quantize=quantize)
    _close(c, i, jc, ji, pts)
    # and the single-source fit, as the reference's own check
    sc, si = KS.fit_streaming(pts, k=8, iters=ITERS, chunk_points=512,
                              mesh=CPU, init=init, quantize=quantize)
    np.testing.assert_allclose(c, sc, rtol=1e-5, atol=1e-6)
    assert abs(i - si) <= 1e-5 * _x2(pts)


def test_fit_streaming_local_validates():
    pts = blobs(n=64, d=3)
    with pytest.raises(ValueError, match="init must be"):
        KS.fit_streaming_local(pts, k=4, iters=1, mesh=CPU, init="grid")
    with pytest.raises(ValueError, match="explicit init"):
        KS.fit_streaming_local(pts, k=4, iters=1, mesh=CPU,
                               init=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="at least one row"):
        KS.fit_streaming_local(pts[:0], k=4, iters=1, mesh=CPU)
    with pytest.raises(ValueError, match="rows per"):
        KS.fit_streaming_local(pts[:3], k=4, iters=1, mesh=CPU,
                               init="random")


def _write_splits(tmp_path, pts, n_files, fmt):
    paths = []
    bounds = np.linspace(0, len(pts), n_files + 1).astype(int)
    for i in range(n_files):
        blk = pts[bounds[i]:bounds[i + 1]]
        p = tmp_path / f"split_{i}.{fmt}"
        if fmt == "npy":
            np.save(p, blk)
        else:
            np.savetxt(p, blk, fmt="%.6f", delimiter=",")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("fmt,n_files", [("csv", 5), ("npy", 3), ("npy", 1)])
def test_fit_streaming_files_matches_single_source(jmesh1, tmp_path, fmt,
                                                   n_files, quantize):
    """File splits give the single-source fit on the rows they hold (CSV:
    the parsed rows), and the reference's file-split fit."""
    pts = blobs(n=2600, d=10, seed=4)
    paths = _write_splits(tmp_path, pts, n_files, fmt)
    src = np.concatenate([np.load(p) if fmt == "npy" else
                          np.loadtxt(p, delimiter=",", dtype=np.float32,
                                     ndmin=2) for p in paths])
    init = src[:6].copy()
    kw = dict(k=6, iters=ITERS, chunk_points=512, init=init,
              quantize=quantize)
    info = {}
    cf, i_f = KS.fit_streaming_files(paths, mesh=CPU, info=info, **kw)
    assert info == {"n_total": 2600, "d": 10}
    cs, i_s = KS.fit_streaming(src, mesh=CPU, **kw)
    np.testing.assert_allclose(cf, cs, rtol=1e-5, atol=1e-5)
    assert abs(i_f - i_s) <= 1e-5 * _x2(src)
    jc, ji = JKS.fit_streaming_files(paths, mesh=jmesh1, **kw)
    _close(cf, i_f, jc, ji, src)


def test_fit_streaming_files_depths_bit_identical_and_validates(tmp_path):
    pts = blobs(n=1300, d=10)
    paths = _write_splits(tmp_path, pts, 3, "npy")
    outs = [KS.fit_streaming_files(paths, k=5, iters=3, chunk_points=256,
                                   mesh=CPU, init=pts[:5].copy(),
                                   prefetch=p) for p in (1, 3)]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    empty = tmp_path / "empty.npy"
    np.save(empty, np.zeros((0, 10), np.float32))
    with pytest.raises(ValueError, match="no rows"):
        KS.fit_streaming_files([str(empty)], k=2, iters=1, mesh=CPU)
    c, _ = KS.fit_streaming_files(paths, k=5, iters=0, mesh=CPU, seed=2)
    assert c.shape == (5, 10) and np.isin(c[:, 0], pts[:, 0]).all()


@pytest.mark.parametrize("source", ["memmap", "csv"])
def test_file_sources_feed_fit_streaming(tmp_path, source):
    from harp_tpu_torch.native.datasource import CSVPoints

    pts = blobs(n=2000, d=6, seed=6)
    if source == "memmap":
        np.save(tmp_path / "p.npy", pts)
        src = np.load(tmp_path / "p.npy", mmap_mode="r")
        ref = pts
    else:
        np.savetxt(tmp_path / "p.csv", pts, fmt="%.6f", delimiter=",")
        src = CSVPoints(str(tmp_path / "p.csv"), chunk_rows=333)
        ref = np.loadtxt(tmp_path / "p.csv", delimiter=",", dtype=np.float32)
    for prefetch in (0, 2):
        c, i = KS.fit_streaming(src, k=6, iters=3, chunk_points=700,
                                mesh=CPU, seed=2, prefetch=prefetch)
        rc, ri = KS.fit_streaming(ref, k=6, iters=3, chunk_points=700,
                                  mesh=CPU, seed=2, prefetch=prefetch)
        np.testing.assert_array_equal(c, rc)
        assert i == ri


def test_history_and_instrument():
    pts = blobs(n=2048, d=8)
    inst: dict = {}
    c, i, h = KS.fit_streaming(pts, k=4, iters=3, chunk_points=512,
                               mesh=CPU, seed=1, instrument=inst,
                               return_history=True)
    assert h.shape == (3,) and h[-1] == i and np.all(np.diff(h) <= 1e-3 * i)
    eps = inst["epochs"]
    assert len(eps) == 3
    for e in eps:
        assert e["host_s"] > 0 and e["sync_s"] >= 0
        assert e["epoch_s"] >= e["host_s"]
        assert e["pipeline"]["chunks"] == 4
    c0, i0, h0 = KS.fit_streaming(pts, k=4, iters=0, mesh=CPU, seed=1,
                                  return_history=True)
    assert i0 == 0.0 and h0.shape == (0,) and c0.shape == (4, 8)


def test_config_validation_and_unported_paths(tmp_path):
    with pytest.raises(ValueError, match="k must"):
        KS.StreamConfig(k=0)
    with pytest.raises(ValueError, match="chunk_points"):
        KS.StreamConfig(chunk_points=0)
    with pytest.raises(ValueError, match="quantize"):
        KS.StreamConfig(quantize="int4")
    pts = blobs(n=64, d=3)
    for fn in (KS.fit_streaming, KS.fit_streaming_local):
        # checkpoints are ported: fault without ckpt_dir is refused, and a
        # checkpointed fit ends on the plain fit's bits
        with pytest.raises(ValueError, match="ckpt_dir"):
            fn(pts, k=2, iters=1, mesh=CPU, fault=object())
        want = fn(pts, k=2, iters=2, mesh=CPU)
        got = fn(pts, k=2, iters=2, mesh=CPU,
                 ckpt_dir=str(tmp_path / fn.__name__))
        np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(NotImplementedError, match="item 8"):
        KS.main(["--elastic", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--input"):
        KS.main(["--ckpt-dir", str(tmp_path), "--device", "cpu"])


# ---- the synthetic benchmark -------------------------------------------------

def test_chunk_generation_repeats_across_epochs():
    gen = KS._make_chunk_gen(3, 0, 64, 5, torch.float32, "cpu")
    a, b, a2 = gen(0), gen(1), gen(0)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    other = KS._make_chunk_gen(3, 1, 64, 5, torch.float32, "cpu")
    assert not torch.equal(other(0), a)  # another worker, other points
    # the benchmark's epochs see the same data: two runs of one epoch from
    # the same state agree bit for bit
    r1 = KS.benchmark_streaming(n=4096, d=8, k=4, iters=1, chunk_points=1024,
                                mesh=CPU, warmup=1)
    r2 = KS.benchmark_streaming(n=4096, d=8, k=4, iters=1, chunk_points=1024,
                                mesh=CPU, warmup=2)
    assert r1["inertia"] == r2["inertia"]


def test_benchmark_streaming_converges_and_int8_tracks_f32():
    kw = dict(n=65536, d=16, k=16, chunk_points=8192, mesh=CPU, warmup=1)
    f1 = KS.benchmark_streaming(iters=1, **kw)
    q1 = KS.benchmark_streaming(iters=1, quantize="int8", **kw)
    q6 = KS.benchmark_streaming(iters=6, quantize="int8", **kw)
    assert f1["n"] == 65536 and f1["n_chunks"] == 8
    assert q1["quantize"] == "int8" and f1["peak_mem_bytes"] is None
    # int8 rounding moves a few assignments: within the 5 % of the
    # reference's own test of this formulation
    assert abs(q1["inertia"] - f1["inertia"]) / f1["inertia"] < 0.05
    assert q6["inertia"] < q1["inertia"]
    small = KS.benchmark_streaming(n=1000, d=4, k=3, iters=1, mesh=CPU)
    assert small["chunk_points"] == 1000 and small["n"] == 1000


@pytest.mark.parametrize("dt,gen_dt", [(10.0, 2.0), (10.0, 9.5),
                                       (1.0, 0.89), (3.0, 0.0)])
def test_ex_gen_fields_match_reference(dt, gen_dt):
    assert KS._ex_gen_fields(dt, gen_dt, 3) == JKS._ex_gen_fields(dt, gen_dt,
                                                                  3)


def test_calibrate_gen_runs():
    out = KS.benchmark_streaming(n=8192, d=8, k=4, iters=2,
                                 chunk_points=2048, mesh=CPU,
                                 calibrate_gen=True)
    assert out["gen_sec_per_iter"] > 0 and "iters_per_sec_ex_gen" in out


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_benchmark_ingest_reports_pipeline_fields(tmp_path, dtype):
    pts = blobs(n=2048, d=16).astype(dtype)
    np.save(tmp_path / "pts.npy", pts)
    src = np.load(tmp_path / "pts.npy", mmap_mode="r")
    out = KS.benchmark_ingest(src, k=4, iters=2, chunk_points=512, mesh=CPU,
                              prefetch=2)
    assert out["kind"] == "ingest" and out["prefetch_depth"] == 2
    assert out["wire_dtype"] == dtype and out["source"] == "memmap"
    assert out["wire_gb_per_epoch"] == 2048 * 16 * pts.itemsize / 1e9
    assert 0.0 <= out["overlap_efficiency"] <= 1.0
    assert out["pipeline"]["chunks"] == 4 and np.isfinite(out["inertia"])
    ref = KS.fit_streaming(pts.astype(np.float32), k=4, iters=2,
                           chunk_points=512, mesh=CPU)[1]
    assert out["inertia"] == ref  # the f16 wire: bit-identical


def test_cli_on_the_cpu(tmp_path, capsys):
    assert KS.main(["--n", "65536", "--d", "16", "--k", "8", "--iters", "2",
                    "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["config"] == "kmeans_stream_cli" and row["backend"] == "cpu"
    assert row["n"] == 65536 and np.isfinite(row["inertia"])
    pts = blobs(n=900, d=6)
    np.save(tmp_path / "a.npy", pts[:500])
    np.save(tmp_path / "b.npy", pts[500:])
    for inp in (str(tmp_path / "a.npy"), str(tmp_path)):
        assert KS.main(["--input", inp, "--k", "3", "--iters", "2",
                        "--chunk", "256", "--device", "cpu"]) == 0
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["config"] == "kmeans_stream_fit_cli"
        assert row["n"] == (500 if inp.endswith(".npy") else 900)
    with pytest.raises(SystemExit):
        KS.main(["--input", str(tmp_path / "none*.npy"), "--device", "cpu"])


def test_stream_int8_launches_k1_once_a_chunk(monkeypatch):
    """The int8 chain's partials go through K1's wrapper once a chunk an
    epoch (on the CPU the wrapper takes its plain version)."""
    calls = []
    wrapped = KK.kmeans_partials_int8

    def count(*a):
        calls.append(a[0].shape[0])
        return wrapped(*a)

    monkeypatch.setattr(KK, "kmeans_partials_int8", count)
    pts = blobs(n=2100, d=6)
    KS.fit_streaming(pts, k=4, iters=3, chunk_points=500, mesh=CPU,
                     quantize="int8", seed=0)
    assert calls == [500, 500, 500, 500, 100] * 3


# ---- four workers ----------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pts = stream_points()
    tmp = tmp_path_factory.mktemp("stream")
    paths = _write_splits(tmp, pts, STREAM_SHAPE["files"], "npy")
    return pts, run_world(run_stream_cases, tmp, pts, paths)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("variant", ["local", "single", "files"])
def test_world_matches_reference_single_source(world, jmesh1, variant,
                                               quantize):
    pts, res = world
    s = STREAM_SHAPE
    jc, ji, jh = JKS.fit_streaming(pts, k=s["k"], iters=s["iters"],
                                   chunk_points=s["chunk"], mesh=jmesh1,
                                   init=pts[:s["k"]].copy(),
                                   quantize=quantize, return_history=True)
    x2 = _x2(pts)
    for r in res:
        c, i, h = r[f"{variant}-{quantize}"]
        np.testing.assert_array_equal(c, res[0][f"{variant}-{quantize}"][0])
        np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-5, atol=1e-6)
        # inertia nearly cancels: bounded by 1e-5 of sum|x|^2 (docstring)
        assert np.all(np.abs(h - np.asarray(jh)) <= 1e-5 * x2)
    assert not any(r["_jax_imported"] for r in res)


def test_world_f16_local_splits_agree_on_the_wire(world):
    """Every worker's split is f16, so all ship f16: the fit equals the
    f32 fit of the same (widened) values."""
    pts, res = world
    s = STREAM_SHAPE
    want = KS.fit_streaming(pts.astype(np.float16).astype(np.float32),
                            k=s["k"], iters=s["iters"],
                            chunk_points=s["chunk"], mesh=CPU,
                            init=pts[:s["k"]].copy())
    for r in res:
        np.testing.assert_allclose(r["local-f16"][0], want[0], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_world_string_seeding_gathers_every_split(world, init):
    pts, res = world
    s = STREAM_SHAPE
    k, d = s["k"], s["d"]
    if init == "random":
        per = -(-k // WORLD)
        rows = [stream_split(pts, r, WORLD) for r in range(WORLD)]
        want = np.concatenate([
            x[np.sort(np.random.default_rng(1).choice(len(x), per,
                                                      replace=False))]
            for x in rows])[:k]
    else:
        per = -(-min(50_000, len(pts)) // WORLD)
        subs = []
        for r in range(WORLD):
            x = stream_split(pts, r, WORLD)
            rng = np.random.default_rng(1)
            idx = (rng.choice(len(x), per, replace=False) if len(x) >= per
                   else np.concatenate([np.arange(len(x)),
                                        rng.choice(len(x), per - len(x))]))
            subs.append(x[np.sort(idx)])
        want = JKM.kmeanspp_init(np.concatenate(subs).reshape(-1, d), k,
                                 seed=1)
    for r in res:
        np.testing.assert_array_equal(r[f"init-{init}"], want)
