"""The port's CCD++ against harp_tpu's, on the same ratings and factors.

The initial W and H are the reference's (its ``jax.random`` draws, carried
over by ``convert.ccd_state_from_numpy``); both packages partition the
same ratings by user range — 130 users over four workers is ragged (33,
33, 33, 31 rows, the last range padded) — and train three epochs.  W, H
and the per-epoch RMSEs agree within rtol 1e-4 (atol 1e-6): the per-user
and per-item sums add in another f32 order (``index_add_`` against
``segment_sum``).
"""

import jax
import numpy as np
import pytest

from harp_tpu.models import ccd as JC
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import convert
from harp_tpu_torch.models import ccd as CC
from harp_tpu_torch.models.mfsgd import synthetic_ratings
from harp_tpu_torch.utils import telemetry
from torch_world import CCD_SHAPE, WORLD, ccd_ratings, run_ccd_cases, run_world

RTOL, ATOL = 1e-4, 1e-6


def _reference(jm):
    """(W0, H0, the model after three epochs, its RMSEs)."""
    s = CCD_SHAPE
    m = JC.CCD(s["n_users"], s["n_items"],
               JC.CCDConfig(rank=s["rank"], reg=s["reg"]), jm, seed=0)
    W0, H0 = np.asarray(m.W).copy(), np.asarray(m.H).copy()
    m.set_ratings(*ccd_ratings())
    return W0, H0, m, m.train_epochs(s["epochs"])


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def ref4():
    return _reference(JaxMesh(jax.devices()[:WORLD]))


@pytest.fixture(scope="module")
def world(tmp_path_factory, ref4):
    return run_world(run_ccd_cases, tmp_path_factory.mktemp("ccd"),
                     ref4[0], ref4[1])


def _port(W0, H0, **kw):
    s = CCD_SHAPE
    m = CC.CCD(s["n_users"], s["n_items"],
               CC.CCDConfig(rank=s["rank"], reg=s["reg"]), device="cpu",
               state=convert.ccd_state_from_numpy({"W": W0, "H": H0}, "cpu"),
               **kw)
    m.set_ratings(*ccd_ratings())
    return m


def test_one_worker_matches_reference(jmesh1):
    W0, H0, ref, rmses = _reference(jmesh1)
    m = _port(W0, H0)
    got = m.train_epochs(CCD_SHAPE["epochs"])
    np.testing.assert_allclose(got, rmses, rtol=RTOL)
    np.testing.assert_allclose(m.W.numpy(), np.asarray(ref.W), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(m.H.numpy(), np.asarray(ref.H), rtol=RTOL,
                               atol=ATOL)
    assert got[-1] < got[0]


def test_four_workers_match_reference(world, ref4):
    _, _, ref, rmses = ref4
    W = np.asarray(ref.W)
    rows = W.shape[0] // WORLD
    assert W.shape[0] == WORLD * 33
    for r, w in enumerate(world):
        np.testing.assert_allclose(w["rmses"], rmses, rtol=RTOL)
        np.testing.assert_allclose(w["W"], W[r * rows:(r + 1) * rows],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(w["H"], np.asarray(ref.H), rtol=RTOL,
                                   atol=ATOL)
        # H is replicated: every worker holds the same bits
        np.testing.assert_array_equal(w["H"], world[0]["H"])


def test_four_worker_ledger_sheet(world):
    """One allreduce of (num_i, den_i), 2 x n_items f32, a coordinate, and
    one of (se, cnt) an epoch."""
    s = CCD_SHAPE
    for w in world:
        (rec,) = w["ledger"]["verbs"]
        assert rec["verb"] == "allreduce"
        assert rec["calls"] == s["epochs"] * (s["rank"] + 1)
        assert rec["payload_bytes"] == s["epochs"] * (
            s["rank"] * 2 * s["n_items"] * 4 + 8)
        assert not w["_jax_imported"]


def test_train_epochs_protocol_and_compile_epochs_trains_nothing():
    u, i, v = synthetic_ratings(128, 96, 4000, rank=4, noise=0.02, seed=0)
    m = CC.CCD(128, 96, CC.CCDConfig(rank=8), device="cpu", seed=0)
    m.set_ratings(u, i, v)
    w_before = m.W.clone()
    m.compile_epochs(3)
    assert bool((m.W == w_before).all())
    r1 = m.train_epoch()
    rs = m.train_epochs(3)
    assert rs[-1] < r1 and all(np.isfinite(rs))


def test_fit_equals_epoch_by_epoch():
    u, i, v = synthetic_ratings(64, 48, 2000, rank=2, seed=0)
    a = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu", seed=1)
    b = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu", seed=1)
    a.set_ratings(u, i, v)
    b.set_ratings(u, i, v)
    assert a.fit(3) == b.train_epochs(3)
    assert bool((a.W == b.W).all() and (a.H == b.H).all())


def test_new_ratings_of_another_width_train():
    m = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu", seed=0)
    m.set_ratings(*synthetic_ratings(64, 48, 2000, rank=2, seed=0))
    m.train_epochs(2)
    m.set_ratings(*synthetic_ratings(64, 48, 900, rank=2, seed=1))
    assert all(np.isfinite(m.train_epochs(2)))


def test_converges():
    u, i, v = synthetic_ratings(128, 96, 8_000, rank=4, noise=0.01, seed=0)
    m = CC.CCD(128, 96, CC.CCDConfig(rank=8, reg=0.02), device="cpu", seed=0)
    m.set_ratings(u, i, v)
    first = m.train_epoch()
    last = m.fit(8)[-1]
    assert last < 0.6 * first, (first, last)


def test_errors_and_unported_paths():
    m = CC.CCD(16, 16, CC.CCDConfig(rank=4), device="cpu")
    for call in (m.train_epoch, lambda: m.train_epochs(2),
                 lambda: m.compile_epochs(2), lambda: m.fit(1)):
        with pytest.raises(RuntimeError, match="set_ratings"):
            call()
    # checkpoints are ported: fault without a checkpoint directory is
    # refused
    m.set_ratings(*synthetic_ratings(16, 16, 200, rank=2, seed=0))
    with pytest.raises(ValueError, match="ckpt_dir"):
        m.fit(2, fault=lambda epoch: None)
    with pytest.raises(ValueError, match="must be"):
        CC.CCD(16, 16, CC.CCDConfig(rank=4), device="cpu",
               state={"W": np.zeros((16, 3)), "H": np.zeros((16, 4))})
    with pytest.raises(ValueError, match="ranks differ"):
        convert.ccd_state_from_numpy({"W": np.zeros((16, 3)),
                                      "H": np.zeros((16, 4))}, "cpu")


def test_benchmark_and_cli_rows(capsys):
    with telemetry.scope():
        out = CC.benchmark(n_users=500, n_items=200, nnz=20_000, rank=8,
                           epochs=2, device="cpu")
    assert {"coord_updates_per_sec", "sec_per_epoch", "rmse_first",
            "rmse_final", "rank", "nnz", "num_workers"} <= set(out)
    assert out["rmse_final"] < out["rmse_first"]
    CC.main(["--nnz", "20000", "--rank", "4", "--epochs", "1",
             "--device", "cpu"])
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"ccd_cli"' in row and '"backend": "cpu"' in row
