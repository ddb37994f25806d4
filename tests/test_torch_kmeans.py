"""The port's KMeans against harp_tpu's, from the same explicit init.

One worker: ``fit`` on the CPU against the reference's ``fit`` on a
one-device mesh, for every path.  Four workers: one gloo world of spawned
processes runs every variant, compared with each other and with the
reference on a four-device mesh.  Tolerances, and why:

- int8: assignments are exact on both sides (integer dots, the same
  rounding rule), so on one worker the centroids are bit-equal; across four
  workers the dequantized f32 partials are added in another order (rtol
  1e-6).
- f32 and bf16-scored (use_pallas) paths: the same sums in another f32
  order: centroids within rtol/atol 1e-5.
- inertia is sum|x|^2 + sum of best scores, which nearly cancels; each
  side sums in f32 in its own order, so the gap is bounded by 1e-5 of
  sum|x|^2 (the reference allows 4e-3 of it for bf16 scoring).
- bf16 points: centroids are rounded to bf16 at the end of each step, and
  near a rounding boundary the two sides may land one bf16 step (2^-8)
  apart: rtol 1e-2.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from harp_tpu.models import kmeans as JKM
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import convert
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.ops import kmeans_kernel as KK
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from torch_world import KMEANS_CASES, WORLD, run_kmeans_cases, run_world

ITERS = 4


def blobs(n_per=64, k=4, d=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 10
    pts = np.concatenate(
        [centers[i] + rng.normal(size=(n_per, d)) for i in range(k)]
    ).astype(np.float32)
    rng.shuffle(pts)
    return pts


def _x2(pts):
    return float((pts.astype(np.float64) ** 2).sum())


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


CPU = WorkerMesh("cpu")

ONE_WORKER_PATHS = {
    "f32": {},
    "f32-use_pallas": {"use_pallas": True},
    "int8": {"quantize": "int8"},
    "int8-matmul": {"quantize": "int8", "use_pallas": False},
    "bf16": {"dtype": "bfloat16"},
    "f32-block_points": {"block_points": 64},
    "f32-regroupallgather": {"variant": "regroupallgather"},
}


def _dtype_kw(kw, lib):
    kw = dict(kw)
    if "dtype" in kw:
        kw["dtype"] = getattr(lib, kw["dtype"])
    return kw


@pytest.mark.parametrize("path", list(ONE_WORKER_PATHS))
def test_fit_matches_reference_on_one_worker(jmesh1, path):
    pts = blobs(n_per=128, k=8, d=6, seed=2)
    kw = ONE_WORKER_PATHS[path]
    c, inertia = KM.fit(pts, k=8, iters=ITERS, mesh=CPU, seed=None,
                        **_dtype_kw(kw, torch))
    jc, ji = JKM.fit(pts, k=8, iters=ITERS, mesh=jmesh1, seed=None,
                     **_dtype_kw(kw, jnp))
    jc = np.asarray(jc, np.float32)
    assert c.shape == jc.shape == (8, 6)
    if path == "int8":
        np.testing.assert_array_equal(c, jc)
    elif path == "bf16":
        np.testing.assert_allclose(c, jc, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(c, jc, rtol=1e-5, atol=1e-5)
    assert abs(inertia - ji) <= 1e-5 * _x2(pts)


def test_int8_step_assignments_match_reference_exactly(jmesh1):
    """One int8 step's counts (the assignments, summed) from the same
    converted state are equal on both sides."""
    pts = blobs(n_per=96, k=6, d=7, seed=5)
    q, scale = JKM.quantize_points_int8(pts)
    init = pts[::50][:6]
    state = convert.kmeans_state_from_numpy(
        {"centroids": init, "col_scale": scale}, "cpu")
    qc, qs, c2 = KM._quantize_centroids(state["centroids"], state["col_scale"])
    _, counts, _ = KK.kmeans_partials_int8(torch.from_numpy(q), qc, qs, c2,
                                           state["col_scale"])
    jqc, jqs, jc2 = JKM._quantize_centroids(jnp.asarray(init),
                                            jnp.asarray(scale))
    _, jcounts, _ = JKM._partials_block_int8(
        jnp.asarray(q), jnp.asarray(scale), jnp.asarray(init), jc2)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_step_from_converted_state_matches_reference(jmesh1):
    """Both packages start from the reference's fitted state (through
    convert) and take one more step."""
    pts = blobs(n_per=64, k=4, seed=1)
    jc, _ = JKM.fit(pts, k=4, iters=2, mesh=jmesh1, seed=None)
    state = convert.kmeans_state_from_numpy({"centroids": np.asarray(jc)},
                                            "cpu")
    assert state["centroids"].dtype == torch.float32
    cfg = KM.KMeansConfig(k=4, iters=1)
    c, inertia = KM.kmeans_step(torch.from_numpy(pts), state["centroids"],
                                cfg)
    jcfg = JKM.KMeansConfig(k=4, iters=1)
    step = jax.jit(jmesh1.shard_map(
        lambda p, c: JKM.kmeans_step(p, c, jcfg),
        in_specs=(jmesh1.spec(0), P()), out_specs=(P(), P())))
    jc2, ji = step(jnp.asarray(pts), jnp.asarray(jc))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc2), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(inertia) - float(ji)) <= 1e-5 * _x2(pts)


def test_convert_checks_shapes():
    with pytest.raises(ValueError, match="centroids"):
        convert.kmeans_state_from_numpy({"centroids": np.zeros(3)}, "cpu")
    with pytest.raises(ValueError, match="col_scale"):
        convert.kmeans_state_from_numpy(
            {"centroids": np.zeros((2, 3)), "col_scale": np.ones(4)}, "cpu")


@pytest.mark.parametrize("variant", ["allreduce", "regroupallgather"])
def test_empty_cluster_keeps_its_centroid(jmesh1, variant):
    """A centroid that captures no points survives unchanged (no NaN), on
    both sides."""
    pts = np.ones((16, 3), np.float32)
    init = np.concatenate([np.ones((1, 3), np.float32),
                           np.arange(1, 4, dtype=np.float32)[:, None]
                           * 1e5 * np.ones((3, 3), np.float32)])
    cfg = KM.KMeansConfig(k=4, iters=1, variant=variant)
    c, _ = KM.kmeans_step(torch.from_numpy(pts), torch.from_numpy(init), cfg)
    jcfg = JKM.KMeansConfig(k=4, iters=1, variant=variant)
    step = jax.jit(jmesh1.shard_map(
        lambda p, c: JKM.kmeans_step(p, c, jcfg),
        in_specs=(jmesh1.spec(0), P()), out_specs=(P(), P())))
    jc = np.asarray(step(jnp.asarray(pts), jnp.asarray(init))[0])
    assert not torch.isnan(c).any()
    np.testing.assert_array_equal(c.numpy()[1:], init[1:])
    np.testing.assert_array_equal(c.numpy(), jc)


def test_indivisible_k_falls_back_to_allreduce(caplog):
    assert KM._effective_variant("regroupallgather", 3, 4) == "allreduce"
    assert "falls back" in caplog.text
    assert KM._effective_variant("regroupallgather", 8, 4) == \
        "regroupallgather"
    assert KM._effective_variant("allreduce", 3, 4) == "allreduce"


def test_ledger_bytes_per_iteration_match_the_hand_sheet():
    """sums + counts + inertia per iteration: k*d*4 + k*4 + 4 bytes, one
    execution per Lloyd iteration (the sheet tests/test_telemetry.py pins
    for the reference)."""
    n, d, k, iters = 512, 16, 8, 3
    pts = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    for kw in ({}, {"quantize": "int8"}, {"use_pallas": True}):
        with telemetry.scope():
            KM.fit(pts, k=k, iters=iters, mesh=CPU, seed=0, **kw)
            tag = telemetry.ledger.summary()["kmeans.fit"]
        per_iter = k * d * 4 + k * 4 + 4
        assert tag["executions"] == iters
        assert tag["bytes_per_execution"] == per_iter
        assert tag["total_bytes"] == per_iter * iters
        assert [v["verb"] for v in tag["verbs"]] == ["allreduce"]
        assert tag["verbs"][0]["calls"] == iters
        assert [(r["span"], r["iters"]) for r in telemetry.tracer.records] \
            == [("kmeans.fit", iters)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pts = blobs(n_per=64, k=8, d=6, seed=4)
    return pts, run_world(run_kmeans_cases, tmp_path_factory.mktemp("km"),
                          pts, ITERS)


def test_world_workers_agree_and_skip_jax(world):
    _, res = world
    assert [w["rank"] for w in res] == list(range(WORLD))
    assert all(w["num_workers"] == WORLD for w in res)
    assert [w["is_master"] for w in res] == [True] + [False] * (WORLD - 1)
    assert not any(w["_jax_imported"] for w in res)
    for cid, _ in KMEANS_CASES:
        for w in res[1:]:
            np.testing.assert_array_equal(w[cid]["centroids"],
                                          res[0][cid]["centroids"])


@pytest.mark.parametrize("cid,kw", KMEANS_CASES,
                         ids=[c for c, _ in KMEANS_CASES])
def test_world_matches_reference_on_four_workers(world, jmesh4, cid, kw):
    pts, res = world
    c, inertia = res[0][cid]["centroids"], res[0][cid]["inertia"]
    jc, ji = JKM.fit(pts, iters=ITERS, mesh=jmesh4, seed=None, **kw)
    rtol = 1e-6 if kw.get("quantize") else 1e-5
    np.testing.assert_allclose(c, np.asarray(jc), rtol=rtol, atol=rtol)
    assert abs(inertia - ji) <= 1e-5 * _x2(pts)


@pytest.mark.parametrize("k", [8, 3])
def test_world_regroupallgather_matches_allreduce(world, k):
    _, res = world
    suffix = "" if k == 8 else "-k3"
    a = res[0]["allreduce" + suffix]
    b = res[0]["regroupallgather" + suffix]
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=1e-5,
                               atol=1e-5)
    assert abs(a["inertia"] - b["inertia"]) <= 1e-5 * abs(a["inertia"])


def test_world_ledger_sheets(world):
    """Per worker and iteration: allreduce moves the full partials
    (k*d*4 + k*4 + 4); regroupallgather pushes them, pulls its k/4 block of
    centroids and allreduces the inertia; k=3 falls back to allreduce."""
    k, d = 8, 6
    for w in world[1]:
        sheets = {cid: {v["verb"]: v["payload_bytes"] // ITERS
                        for v in w[cid]["ledger"]["verbs"]}
                  for cid, _ in KMEANS_CASES}
        assert sheets["allreduce"] == {"allreduce": k * d * 4 + k * 4 + 4}
        assert sheets["regroupallgather"] == {
            "push": k * d * 4 + k * 4, "pull": (k // WORLD) * d * 4,
            "allreduce": 4}
        assert sheets["regroupallgather-k3"] == {
            "allreduce": 3 * d * 4 + 3 * 4 + 4}
        # two stages of the whole partials tree
        assert sheets["hier"] == sheets["int8-hier"] == {
            "allreduce_hier": 2 * (k * d * 4 + k * 4 + 4)}


@pytest.mark.parametrize("q", [None, "int8"])
def test_world_hier_matches_one_shot(world, q):
    """The reference's test_kmeans_hier_psum_matches_one_shot on the port:
    the two-stage sum reassociates floats only (int8's int32 sums are
    exact)."""
    _, res = world
    a = res[0]["int8-allreduce" if q else "allreduce"]
    b = res[0]["int8-hier" if q else "hier"]
    assert abs(a["inertia"] - b["inertia"]) <= 1e-5 * abs(a["inertia"])
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"variant": "regroupallgather"}],
                         ids=["f32", "int8", "regroupallgather"])
def test_hier_on_one_worker_is_bit_equal_to_one_shot(kw):
    """One worker: both schedules are the identity (regroupallgather keeps
    its own path, as in the reference)."""
    pts = blobs(n_per=64, k=4, d=5, seed=9)
    a = KM.fit(pts, k=4, iters=3, mesh=CPU, seed=1, **kw)
    b = KM.fit(pts, k=4, iters=3, mesh=CPU, seed=1, psum_schedule="hier",
               **kw)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


def test_cli_takes_the_hier_schedule(capsys):
    assert KM.main(["--n", "512", "--d", "4", "--k", "4", "--iters", "2",
                    "--psum-schedule", "hier", "--device", "cpu"]) in (0,
                                                                       None)
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["backend"] == "cpu" and np.isfinite(row["inertia"])


def test_config_validation():
    with pytest.raises(ValueError, match="variant"):
        KM.KMeansConfig(k=2, variant="nope")
    with pytest.raises(ValueError, match="quantize"):
        KM.KMeansConfig(k=2, quantize="int4")
    with pytest.raises(ValueError, match="block_points"):
        KM.KMeansConfig(k=2, quantize="int8", block_points=8)
    with pytest.raises(ValueError, match="k must be"):
        KM.KMeansConfig(k=0)
    with pytest.raises(ValueError, match="psum_schedule"):
        KM.KMeansConfig(k=2, psum_schedule="ring")
    assert KM.KMeansConfig(k=2, psum_schedule="hier").psum_schedule == "hier"


def test_use_pallas_auto_per_path():
    assert KM._use_pallas(KM.KMeansConfig(quantize="int8"))
    assert not KM._use_pallas(KM.KMeansConfig())
    assert not KM._use_pallas(KM.KMeansConfig(quantize="int8",
                                              use_pallas=False))
    assert KM._use_pallas(KM.KMeansConfig(use_pallas=True))


@pytest.mark.parametrize("kw", [{"ckpt_dir": "x"}, {"fault": object()}],
                         ids=["ckpt_dir", "fault"])
def test_unported_options_raise_naming_the_roadmap(kw, tmp_path):
    """Both options are ported: ``ckpt_dir`` gives the plain fit's bits,
    and ``fault`` without ``ckpt_dir`` is refused (the reference's rule)."""
    pts = blobs()
    if "fault" in kw:
        with pytest.raises(ValueError, match="ckpt_dir"):
            KM.fit(pts, k=4, iters=1, mesh=CPU, **kw)
        return
    want = KM.fit(pts, k=4, iters=3, mesh=CPU)
    got = KM.fit(pts, k=4, iters=3, mesh=CPU, ckpt_dir=str(tmp_path / "x"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_kmeanspp_init_matches_reference():
    pts = blobs(n_per=50, k=5, seed=7)
    np.testing.assert_array_equal(KM.kmeanspp_init(pts, 5, seed=3),
                                  JKM.kmeanspp_init(pts, 5, seed=3))


def test_fit_rejects_unknown_init():
    with pytest.raises(ValueError, match="init"):
        KM.fit(blobs(), k=4, iters=1, mesh=CPU, init="nope")


def test_int8_row_limit_guard(monkeypatch):
    monkeypatch.setattr(KM, "_INT8_SUM_ROW_LIMIT", 100)
    with pytest.raises(ValueError, match="exact-int32"):
        KM.fit(blobs(), k=4, iters=1, mesh=CPU, quantize="int8")


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"use_pallas": True},
                                {"dtype": torch.bfloat16}],
                         ids=["f32", "int8", "use_pallas", "bf16"])
def test_benchmark_reports_on_the_cpu(kw):
    with telemetry.scope():
        out = KM.benchmark(n=1001, d=8, k=4, iters=3, warmup=2,
                           device="cpu", **kw)
        tag = telemetry.ledger.summary()["kmeans.benchmark"]
        setup = telemetry.ledger.volume("(untagged)")
    assert out["n"] == 1001 and out["iters_per_sec"] > 0
    assert np.isfinite(out["inertia"])
    assert out["use_pallas"] == bool(kw.get("quantize") or
                                     kw.get("use_pallas"))
    assert tag["executions"] == 2 + 3
    assert tag["total_bytes"] == (4 * 8 * 4 + 4 * 4 + 4) * 5
    # set-up outside the timed runs: the int8 per-feature |max| allreduce
    assert setup == (8 * 4 if kw.get("quantize") else 0)


def test_cli_prints_one_benchmark_json_row(capsys):
    assert KM.main(["--n", "512", "--d", "6", "--k", "4", "--iters", "2",
                    "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1
    row = rows[0]
    assert row["config"] == "kmeans_cli" and row["backend"] == "cpu"
    assert row["n"] == 512 and np.isfinite(row["inertia"])
    assert "date" in row and "commit" in row


def test_cli_module_entry_bench_row():
    out = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "kmeans", "--bench",
         "--quantize", "int8", "--n", "2048", "--d", "8", "--k", "4",
         "--iters", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["config"] == "kmeans_bench" and row["quantize"] == "int8"
    assert row["backend"] == "cpu" and row["use_pallas"] is True
