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

import collections
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
        recs = telemetry.tracer.records
    assert tag["executions"] == 4 and tag["total_bytes"] == 4 * 12
    assert sorted((r["verb"], r["payload_bytes"]) for r in tag["verbs"]) == \
        [("allgather", 16), ("allreduce", 32)]
    assert [r["span"] for r in recs if r["depth"] == 0] == [
        "mfsgd.epoch", "mfsgd.epochs"]
    # inside: each of the 4 epochs' steps (a K3 call and a hop each), its
    # combine, and each call's one readback
    steps = 4 * MF.rotate_chunks_resolved(m.cfg)
    assert collections.Counter(r["span"] for r in recs if r["depth"]) == {
        "rotate.step": steps, "rotate.hop": steps, "mfsgd.k3": steps,
        "mfsgd.combine": 4, "mfsgd.readback": 2}
    assert {r["path"] for r in recs if r["span"] == "mfsgd.k3"} == {
        "mfsgd.epoch/rotate.step/mfsgd.k3",
        "mfsgd.epochs/rotate.step/mfsgd.k3"}


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
    """carry_w, the checkpoint, input and elastic options are ported, and
    each case checks its ported behaviour instead of a raise."""
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
    # carry_w: ported; the config, _make_config and benchmark take it and
    # train the plain chain
    assert MF.MFSGDConfig(algo="dense", carry_w=True).carry_w
    assert MF._make_config(8, None, "dense", carry_w=True).carry_w
    kw = dict(n_users=300, n_items=200, nnz=4000, rank=8, epochs=2,
              algo="dense", u_tile=16, i_tile=16, entry_cap=32,
              device="cpu")
    on, off = MF.benchmark(carry_w=True, **kw), MF.benchmark(**kw)
    assert (on["rmse_first_epoch"], on["rmse_final"]) == \
        (off["rmse_first_epoch"], off["rmse_final"])


def _carry_pair(carry_w: bool, n_users=130, n_items=90):
    cfg = MF.MFSGDConfig(rank=4, algo="dense", u_tile=8, i_tile=8,
                         entry_cap=16, compute_dtype=torch.float32,
                         lr=0.02, reg=0.01, carry_w=carry_w)
    m = MF.MFSGD(n_users, n_items, cfg, device="cpu", seed=3)
    u, i, v = MF.synthetic_ratings(n_users, n_items, 3000, rank=4,
                                   noise=0.05, seed=3)
    m.set_ratings(u, i, v)
    return m.train_epochs(3), m.W.numpy(), m.H.numpy()


@pytest.mark.parametrize("n", [1, WORLD])
def test_carry_w_chain_is_the_plain_chain(world, n):
    """carry_w on and off train one chain, bit for bit (the reference pins
    the same for its two paths, tests/test_mfsgd.py); the reference's
    carry chain itself is the "dense-carry_w" case above."""
    if n == 1:
        on, off = _carry_pair(True), _carry_pair(False)
        assert on[0] == off[0]
        for a, b in zip(on[1:], off[1:]):
            np.testing.assert_array_equal(a, b)
        return
    for w in world:
        on, off = w["dense-carry_w"], w["dense"]
        assert on["rmse"] == off["rmse"]
        for k in ("W2", "H2", "W", "H"):
            np.testing.assert_array_equal(on[k], off[k])


def test_carry_w_exact_for_overlapping_tile_offsets():
    """The reference's overlapping-offset case (tests/test_mfsgd.py: u-runs
    at offsets 0 -> 4 -> 0 over 8-row tiles): the port's block update, on
    a schedule that runs the entries one after another in entry order as
    the reference's scan does, is the same with carry_w on and off, bit
    for bit, and within the dense tolerance of the reference's carry and
    non-carry chains.  The level schedule's builder refuses such
    offsets."""
    rng = np.random.default_rng(11)
    UR = IR = 8
    cap = 4
    W0 = rng.normal(size=(24, 3)).astype(np.float32)
    H0 = rng.normal(size=(16, 3)).astype(np.float32)
    ou = np.array([0, 0, 4, 4, 0], np.int32)
    oi = np.array([0, 8, 0, 8, 0], np.int32)
    eu = rng.integers(0, UR, (5, cap)).astype(np.int32)
    ei = rng.integers(0, IR, (5, cap)).astype(np.int32)
    ev = rng.normal(size=(5, cap)).astype(np.float32)
    with pytest.raises(ValueError, match="not multiples"):
        K.LevelSchedule.build(eu, ei, ou, oi, UR, IR, 24, 16, "cpu")
    # the reference's scan: each entry a level of its own, in entry order
    sort, n_real = K.entry_sorts(eu, ei, UR, IR)
    prev = np.arange(-1, 4, dtype=np.int32)
    sched = K.LevelSchedule(torch.arange(5, dtype=torch.int32),
                            np.arange(6, dtype=np.int32),
                            torch.from_numpy(np.stack([prev, prev], 1)),
                            torch.from_numpy(sort), torch.from_numpy(n_real))
    assert sched.n_levels == 5 and sched.max_width == 1
    got, ref = {}, {}
    for carry in (False, True):
        kw = dict(rank=3, algo="dense", u_tile=UR, i_tile=IR,
                  entry_cap=cap, lr=0.05, reg=0.01, carry_w=carry)
        cfg = MF.MFSGDConfig(compute_dtype=torch.float32, **kw)
        block = tuple(torch.from_numpy(a) for a in (eu, ei, ev, ou, oi))
        got[carry] = [np.asarray(x) for x in MF._tile_block_update(
            torch.from_numpy(W0), torch.from_numpy(H0), block, cfg, sched)]
        jcfg = JMF.MFSGDConfig(compute_dtype=jnp.float32, **kw)
        ref[carry] = [np.asarray(x) for x in jax.jit(
            lambda W, H, b, c=jcfg: JMF._tile_block_update(W, H, b, c))(
            jnp.asarray(W0), jnp.asarray(H0),
            tuple(jnp.asarray(a) for a in (eu, ei, ev, ou, oi)))]
    for a, b in zip(got[True], got[False]):
        np.testing.assert_array_equal(a, b)
    for carry in (False, True):
        _close(got[carry][0], ref[carry][0])
        _close(got[carry][1], ref[carry][1])
        np.testing.assert_allclose(got[carry][2], ref[carry][2], rtol=1e-5)
        assert got[carry][3] == ref[carry][3] == 5 * cap


def test_carry_w_rejections_keep_the_reference_text():
    for algo in ("scatter", "pallas"):
        with pytest.raises(ValueError) as a:
            MF.MFSGDConfig(algo=algo, carry_w=True)
        with pytest.raises(ValueError) as b:
            JMF.MFSGDConfig(algo=algo, carry_w=True)
        assert str(a.value) == str(b.value)
        with pytest.raises(ValueError) as a:
            MF._make_config(8, None, algo, carry_w=True)
        with pytest.raises(ValueError) as b:
            JMF._make_config(8, None, algo, carry_w=True)
        assert str(a.value) == str(b.value) and "dense-only" in str(a.value)
        with pytest.raises(ValueError, match="dense-only"):
            MF.benchmark(n_users=16, n_items=8, nnz=32, rank=4, algo=algo,
                         carry_w=True, device="cpu")


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
