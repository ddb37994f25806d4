"""The port's WDA-MDS against harp_tpu's, from the same start.

Both packages draw X0 from ``np.random.default_rng(seed)`` and shard the
same Δ (50 points: ragged over four workers).  ``mds`` runs on one worker
(in this process) and on four (one spawned gloo world against a
four-device mesh), both algos, the three ``coord_wire``\\ s and a bf16 Δ.
The stress is held to the reference's own gate for its two arms, ``rtol
1e-3`` (tests/test_wdamds_kernel.py), and the coordinates to 1e-3 of their
scale.
"""

import jax
import numpy as np
import pytest

from harp_tpu.models import wdamds as JW
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import convert
from harp_tpu_torch.models import wdamds as W
from harp_tpu_torch.utils import telemetry
from torch_world import (MDS_CASES, MDS_SHAPE, WORLD, mds_delta,
                         run_mds_cases, run_world)

S = MDS_SHAPE


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_mds_cases, tmp_path_factory.mktemp("mds"))


def _reference(jm, kw):
    return JW.mds(mds_delta(), JW.MDSConfig(dim=S["dim"], iters=S["iters"],
                                            **kw), jm, seed=0)


def _check(X, stress, ref):
    Xr, sr = ref
    np.testing.assert_allclose(stress, sr, rtol=1e-3)
    assert np.abs(X - Xr).max() <= 1e-3 * np.abs(Xr).max()


@pytest.mark.parametrize("cid,kw", MDS_CASES, ids=[c for c, _ in MDS_CASES])
def test_one_worker_matches_reference(jmesh1, cid, kw):
    with telemetry.scope():
        X, stress = W.mds(mds_delta(), W.MDSConfig(dim=S["dim"],
                                                   iters=S["iters"], **kw),
                          device="cpu", seed=0)
        led = telemetry.ledger.summary()["wdamds.mds"]
    _check(X, stress, _reference(jmesh1, kw))
    # one reshard of the [50, 2] block an iteration, and the stress
    (rec,) = [r for r in led["verbs"] if r["verb"] == "reshard"]
    width = {"exact": 4, "bf16": 2, "int8": 1}[kw.get("coord_wire", "exact")]
    assert rec["calls"] == S["iters"]
    assert rec["payload_bytes"] == S["iters"] * 50 * 2 * width


@pytest.mark.parametrize("cid,kw", MDS_CASES, ids=[c for c, _ in MDS_CASES])
def test_four_workers_match_reference(world, jmesh4, cid, kw):
    ref = _reference(jmesh4, kw)
    for w in world:  # every worker ends with all coordinates and the stress
        _check(w[cid]["X"], w[cid]["stress"], ref)
        np.testing.assert_array_equal(w[cid]["X"], world[0][cid]["X"])
        # 52 padded rows over 4 workers: a [13, 2] block an iteration
        (rec,) = [r for r in w[cid]["ledger"]["verbs"]
                  if r["verb"] == "reshard"]
        width = {"exact": 4, "bf16": 2, "int8": 1}[
            kw.get("coord_wire", "exact")]
        assert rec["payload_bytes"] == S["iters"] * 13 * 2 * width


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


def test_stress_falls_and_pallas_agrees_with_xla():
    delta = mds_delta()
    one = W.mds(delta, W.MDSConfig(dim=2, iters=1), device="cpu")[1]
    out = {a: W.mds(delta, W.MDSConfig(dim=2, iters=40, algo=a),
                    device="cpu") for a in ("xla", "pallas")}
    assert out["xla"][1] < one
    np.testing.assert_allclose(out["pallas"][1], out["xla"][1], rtol=1e-4)


def test_state_from_the_reference_gives_its_stress(jmesh1):
    """The reference's embedding, carried over and run zero iterations,
    has the reference's stress in the port."""
    delta = mds_delta()
    Xr, sr = _reference(jmesh1, {})
    state = convert.mds_state_from_numpy({"X": Xr}, "cpu")
    X, stress = W.mds(delta, W.MDSConfig(dim=2, iters=0), device="cpu",
                      X0=state["X"])
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_allclose(stress, sr, rtol=1e-5)


def test_benchmark_delta_is_the_references():
    """The reference builds its Δ inline in ``benchmark``: this recipe."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        W.benchmark_delta(64, 0),
        np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)))


def test_weighted_path_raises():
    with pytest.raises(NotImplementedError, match="item 4"):
        W.mds(mds_delta(), device="cpu", weights=np.ones((50, 50)))
    with pytest.raises(ValueError, match="coord_wire"):
        W.MDSConfig(coord_wire="fp8")
