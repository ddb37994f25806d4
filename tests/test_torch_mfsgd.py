"""The port's MF-SGD against harp_tpu's, from the same injected factors.

Host prep: ``partition_ratings`` and ``partition_ratings_tiles`` give
arrays bit-equal to the reference's.  Training: both packages start from
the same W and H (the reference's through its mesh, the port's through
``convert.mfsgd_state_from_numpy``) and run two ``train_epoch`` calls, then
``train_epochs(3)``, with ``compute_dtype`` f32 unless a case says bf16.
One worker runs in this process; four workers run as one spawned gloo
world against a four-device mesh.  Tolerance, the reference's own for
dense vs pallas (the same update in another f32 summation order): W and H
``rtol 1e-4, atol 1e-5``, RMSEs ``rtol 1e-5``.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import mfsgd as JMF
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import convert
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.ops import mfsgd_kernel as K
from harp_tpu_torch.utils import telemetry
from torch_world import (MFSGD_CASES, MFSGD_SHAPE, WORLD, mfsgd_case_inputs,
                         run_mfsgd_cases, run_world)

S = MFSGD_SHAPE
HP = dict(lr=0.02, reg=0.01)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _reference(jm, kw, u, i, v, W0, H0, compute_dtype=jnp.float32):
    cfg = JMF.MFSGDConfig(rank=S["rank"], compute_dtype=compute_dtype,
                          **HP, **kw)
    m = JMF.MFSGD(S["n_users"], S["n_items"], cfg, jm, seed=0)
    m.set_ratings(u, i, v)
    m.W, m.H = jm.shard_array(W0, 0), jm.shard_array(H0, 0)
    r2 = [m.train_epoch() for _ in range(2)]
    W2, H2 = np.asarray(m.W), np.asarray(m.H)
    r5 = m.train_epochs(3)
    return {"rmse": r2 + r5, "W2": W2, "H2": H2, "W": np.asarray(m.W),
            "H": np.asarray(m.H), "factors": m.factors(),
            "predict_rmse": m.predict_rmse(u, i, v)}


def _check(got, ref):
    np.testing.assert_allclose(got["rmse"], ref["rmse"], rtol=1e-5)
    for k in ("W2", "H2", "W", "H"):
        _close(got[k], ref[k])
    for a, b in zip(got["factors"], ref["factors"]):
        assert a.shape == b.shape
        _close(a, b)
    np.testing.assert_allclose(got["predict_rmse"], ref["predict_rmse"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


# ---- host prep ----------------------------------------------------------------

@pytest.mark.parametrize("n_workers,n_slices", [(1, 2), (4, 8), (4, 16)])
def test_partition_ratings_tiles_is_bit_equal(n_workers, n_slices):
    u, i, v = MF.synthetic_ratings(500, 300, 5000, seed=4)
    a = MF.partition_ratings_tiles(u, i, v, 500, 300, n_workers, 16, 8, 32,
                                   n_slices=n_slices)
    b = JMF.partition_ratings_tiles(u, i, v, 500, 300, n_workers, 16, 8, 32,
                                    n_slices=n_slices)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype


@pytest.mark.parametrize("chunk", [8, 64, 32768])
def test_partition_ratings_is_bit_equal(chunk):
    u, i, v = MF.synthetic_ratings(500, 300, 5000, seed=5)
    a = MF.partition_ratings(u, i, v, 500, 300, 4, chunk, n_slices=8)
    b = JMF.partition_ratings(u, i, v, 500, 300, 4, chunk, n_slices=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_synthetic_ratings_and_bounds_match_reference():
    for x, y in zip(MF.synthetic_ratings(50, 40, 300, seed=2),
                    JMF.synthetic_ratings(50, 40, 300, seed=2)):
        np.testing.assert_array_equal(x, y)
    assert MF._dense_bounds(138_493, 26_744, 1, 2, 256, 256) == \
        JMF._dense_bounds(138_493, 26_744, 1, 2, 256, 256)
    for algo in ("pallas", "dense", "scatter"):
        assert MF.tiles(MF.MFSGDConfig(algo=algo)) == \
            JMF.tiles(JMF.MFSGDConfig(algo=algo))


# ---- one worker ---------------------------------------------------------------

ONE_WORKER = [(cid, kw, "f32") for cid, kw in MFSGD_CASES] + [
    ("pallas-bf16", MFSGD_CASES[0][1], "bf16"),
    ("dense-chunks1", {**MFSGD_CASES[1][1], "rotate_chunks": 1}, "f32")]


@pytest.mark.parametrize("cid,kw,dt", ONE_WORKER,
                         ids=[c for c, _, _ in ONE_WORKER])
def test_one_worker_matches_reference(jmesh1, cid, kw, dt):
    u, i, v, W0, H0 = mfsgd_case_inputs(kw, 1)
    td, jd = {"f32": (torch.float32, jnp.float32),
              "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
    ref = _reference(jmesh1, kw, u, i, v, W0, H0, compute_dtype=jd)
    cfg = MF.MFSGDConfig(rank=S["rank"], compute_dtype=td, **HP, **kw)
    m = MF.MFSGD(S["n_users"], S["n_items"], cfg, device="cpu",
                 state=convert.mfsgd_state_from_numpy({"W": W0, "H": H0},
                                                      "cpu"))
    m.set_ratings(u, i, v)
    r2 = [m.train_epoch() for _ in range(2)]
    W2, H2 = m.W.numpy().copy(), m.H.numpy().copy()
    r5 = m.train_epochs(3)
    _check({"rmse": r2 + r5, "W2": W2, "H2": H2, "W": m.W.numpy(),
            "H": m.H.numpy(), "factors": m.factors(),
            "predict_rmse": m.predict_rmse(u, i, v)}, ref)
    assert r5[-1] < r2[0]  # it learns


# ---- four workers ---------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_mfsgd_cases, tmp_path_factory.mktemp("mf"),
                     timeout=240.0)


@pytest.mark.parametrize("cid,kw", MFSGD_CASES,
                         ids=[c for c, _ in MFSGD_CASES])
def test_four_workers_match_reference(world, jmesh4, cid, kw):
    u, i, v, W0, H0 = mfsgd_case_inputs(kw, WORLD)
    ref = _reference(jmesh4, kw, u, i, v, W0, H0)
    res = [w[cid] for w in world]
    got = {"rmse": res[0]["rmse"], "factors": res[0]["factors"],
           "predict_rmse": res[0]["predict_rmse"]}
    for k in ("W2", "H2", "W", "H"):  # worker shards, in rank order
        got[k] = np.concatenate([r[k] for r in res])
    _check(got, ref)
    for r in res[1:]:  # every worker reports the same combined numbers
        assert r["rmse"] == res[0]["rmse"]
        np.testing.assert_array_equal(r["factors"][0], res[0]["factors"][0])


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- API, config, entry points ---------------------------------------------------

def _small_model(algo="pallas", **kw):
    cfg = MF.MFSGDConfig(rank=4, algo=algo, **(
        {"chunk": 64} if algo == "scatter" else
        {"u_tile": 8, "i_tile": 8, "entry_cap": 16}), **kw)
    m = MF.MFSGD(96, 64, cfg, device="cpu", seed=1)
    u, i, v = MF.synthetic_ratings(96, 64, 2000, rank=4, noise=0.05, seed=1)
    m.set_ratings(u, i, v)
    return m, (u, i, v)


def test_ledger_sheet_per_epoch_on_one_worker():
    """One worker: the ring hops move nothing, so an epoch's wire is the
    per-worker count's allgather (4 bytes) and the (se, cnt) allreduce
    (8 bytes)."""
    m, _ = _small_model()
    with telemetry.scope():
        m.train_epoch()
        m.train_epochs(3)
        tag = telemetry.ledger.summary()["mfsgd.epochs"]
        spans = [r["span"] for r in telemetry.tracer.records]
    assert tag["executions"] == 4 and tag["total_bytes"] == 4 * 12
    assert sorted((r["verb"], r["payload_bytes"]) for r in tag["verbs"]) == \
        [("allgather", 16), ("allreduce", 32)]
    assert spans == ["mfsgd.epoch", "mfsgd.epochs"]


def test_train_epochs_reads_back_once_and_launches_no_kernel_on_cpu():
    m, (u, i, v) = _small_model()
    K.reset_launches()
    rmses = m.train_epochs(4)
    assert len(rmses) == 4 and rmses[-1] < rmses[0]
    assert K.LAUNCHES == {"sgd_tile_update": 0}
    assert m.train_epochs(0) == []
    assert np.isfinite(m.predict_rmse(u, i, v))
    W, H = m.factors()
    assert W.shape == (96, 4) and H.shape == (64, 4)


def test_init_is_seeded_and_uniform():
    a, _ = _small_model()
    b, _ = _small_model()
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert 0 <= float(a.W.min()) and float(a.W.max()) < 0.5


def test_config_validation_matches_reference():
    for kw, err in (({"algo": "nope"}, "algo"),
                    ({"rotate_chunks": 0}, "rotate_chunks"),
                    ({"rotate_wire": "f16"}, "rotate_wire"),
                    ({"algo": "pallas", "carry_w": True}, "carry_w")):
        with pytest.raises(ValueError, match=err):
            MF.MFSGDConfig(**kw)
        with pytest.raises(ValueError, match=err):
            JMF.MFSGDConfig(**kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        MF.MFSGDConfig(compute_dtype=torch.float16)
    assert MF.MFSGDConfig().algo == JMF.MFSGDConfig().algo == "pallas"
    with pytest.raises(ValueError, match="scatter-only"):
        MF._make_config(8, 64, "dense")


@pytest.mark.parametrize("what", ["carry_w", "fit-ckpt", "fit-fault",
                                  "--ckpt-dir", "--resume", "--input",
                                  "--elastic", "--max-worker-loss"])
def test_unported_options_raise_naming_the_roadmap(what, tmp_path):
    """carry_w still raises naming its ROADMAP item; the checkpoint, input
    and elastic options are ported, and each case checks its ported
    behaviour instead."""
    if what == "fit-ckpt":
        (a, _), (b, _) = _small_model(), _small_model()
        assert a.fit(2) == b.fit(2, str(tmp_path / "c"))
        np.testing.assert_array_equal(a.W.numpy(), b.W.numpy())
        return
    if what == "fit-fault":
        with pytest.raises(ValueError, match="ckpt_dir"):
            _small_model()[0].fit(1, fault=object())
        return
    if what in ("--ckpt-dir", "--resume", "--input"):
        want = {"--ckpt-dir": (RuntimeError, "device='cpu'"),
                "--resume": (SystemExit, "requires --ckpt-dir"),
                "--input": (SystemExit, "no input files")}[what]
        arg = {"--ckpt-dir": [str(tmp_path / "c")],
               "--input": [str(tmp_path / "none*.txt")]}.get(what, [])
        dev = [] if what == "--ckpt-dir" else ["--device", "cpu"]
        with pytest.raises(want[0], match=want[1]):
            MF.main([what, *arg, *dev])
        return
    if what in ("--elastic", "--max-worker-loss"):
        # the elastic loop on a small synthetic corpus (one worker)
        arg = {"--max-worker-loss": ["1"]}.get(what, [])
        assert MF.main([what, *arg, "--users", "64", "--items", "32",
                        "--nnz", "800", "--rank", "4", "--epochs", "1",
                        "--u-tile", "16", "--i-tile", "16", "--device",
                        "cpu"]) == 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MF.MFSGDConfig(algo="dense", carry_w=True)


def test_fit_and_state_checks():
    m, _ = _small_model("dense")
    assert len(m.fit(2)) == 2
    with pytest.raises(RuntimeError, match="set_ratings"):
        MF.MFSGD(96, 64, MF.MFSGDConfig(rank=4), device="cpu").train_epoch()
    with pytest.raises(ValueError, match="state"):
        MF.MFSGD(96, 64, MF.MFSGDConfig(rank=4), device="cpu", state={
            "W": torch.zeros(3, 4), "H": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="ranks differ"):
        convert.mfsgd_state_from_numpy({"W": np.zeros((2, 3)),
                                        "H": np.zeros((2, 4))}, "cpu")
    with pytest.raises(ValueError, match="rows, rank"):
        convert.mfsgd_state_from_numpy({"W": np.zeros(3),
                                        "H": np.zeros((2, 4))}, "cpu")


@pytest.mark.parametrize("algo", ["pallas", "dense", "scatter"])
def test_benchmark_reports_on_the_cpu(algo):
    out = MF.benchmark(n_users=300, n_items=200, nnz=4000, rank=8, epochs=2,
                       algo=algo, device="cpu",
                       **({} if algo == "scatter" else
                          {"u_tile": 16, "i_tile": 16, "entry_cap": 32}))
    ref_keys = {"updates_per_sec_per_chip", "sec_per_epoch",
                "rmse_first_epoch", "rmse_final", "prep_sec", "nnz", "rank",
                "num_workers", "algo"}
    assert set(out) == ref_keys
    assert out["updates_per_sec_per_chip"] > 0 and out["algo"] == algo
    assert out["rmse_final"] < out["rmse_first_epoch"]


def test_cli_module_entry_row():
    out = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "mfsgd", "--users", "300",
         "--items", "200", "--nnz", "3000", "--rank", "8", "--epochs", "2",
         "--algo", "pallas", "--u-tile", "16", "--i-tile", "16",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["config"] == "mfsgd_cli" and row["backend"] == "cpu"
    assert row["algo"] == "pallas" and np.isfinite(row["rmse_final"])
