"""The port's weighted WDA-MDS (``mds(weights=...)``, the CG-solved SMACOF
of ``wsmacof``) against harp_tpu's ``make_wsmacof_fn``, on the same Δ,
weights and start.

Parity: the stress within rtol 1e-3 and X within atol 1e-3, on one worker
and on a spawned 4-worker gloo world.  The parity inputs
(``torch_world.wmds_inputs``) keep each CG guard away from its edge: in
f32 a guard's threshold could otherwise flip on rounding noise between
the packages, so the weight graph is connected (the curvature gate never
closes) and 15 iterations of 10 CG steps stop well before convergence
(the residual stays far above both freeze thresholds).  The behaviour
cases are the reference's own (``tests/test_apps_extra.py``): unit
weights give the unweighted stress, zero weights hide corrupted δ, a
disconnected weight graph and a long run past convergence stay finite,
and the weight checks raise.
"""

import jax
import numpy as np
import pytest

from harp_tpu.models import wdamds as JW
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.models import wdamds as W
from torch_world import (WMDS_SHAPE, WORLD, run_mds_weighted_cases,
                         run_world, wmds_inputs)

RTOL_STRESS, ATOL_X = 1e-3, 1e-3


def _cfgs():
    s = WMDS_SHAPE
    kw = dict(dim=s["dim"], iters=s["iters"], cg_iters=s["cg_iters"])
    return JW.MDSConfig(**kw), W.MDSConfig(**kw)


def _reference(n_dev):
    delta, w = wmds_inputs()
    return JW.mds(delta, _cfgs()[0], JaxMesh(jax.devices()[:n_dev]), seed=0,
                  weights=w)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_mds_weighted_cases,
                     tmp_path_factory.mktemp("wmds"))


def test_one_worker_matches_reference():
    delta, w = wmds_inputs()
    X_ref, s_ref = _reference(1)
    X, s = W.mds(delta, _cfgs()[1], device="cpu", seed=0, weights=w)
    np.testing.assert_allclose(s, s_ref, rtol=RTOL_STRESS)
    np.testing.assert_allclose(X, X_ref, atol=ATOL_X)


def test_four_workers_match_reference(world):
    X_ref, s_ref = _reference(WORLD)
    s = WMDS_SHAPE
    for w in world:
        np.testing.assert_allclose(w["stress"], s_ref, rtol=RTOL_STRESS)
        np.testing.assert_allclose(w["X"], X_ref, atol=ATOL_X)
        np.testing.assert_array_equal(w["X"], world[0]["X"])
        assert not w["_jax_imported"]
        # per iteration: one allgather of B(X)X's rows and one each CG
        # step, plus V·x0's; one stress allreduce
        verbs = {r["verb"]: r for r in w["ledger"]["verbs"]}
        assert verbs["allgather"]["calls"] == s["iters"] * (
            2 + s["cg_iters"])
        assert verbs["allreduce"]["calls"] == 1


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


def test_unit_weights_match_the_unweighted_path():
    delta = _cloud(48, 0)
    cfg = W.MDSConfig(dim=3, iters=30, cg_iters=12)
    _, s_u = W.mds(delta, cfg, device="cpu", seed=1)
    _, s_w = W.mds(delta, cfg, device="cpu", seed=1,
                   weights=np.ones_like(delta))
    # the same objective: CG against the closed form (the reference's
    # tolerance)
    assert abs(s_w - s_u) < 0.05 * max(s_u, 1e-3) + 1e-3, (s_u, s_w)


def test_zero_weights_ignore_corrupted_entries():
    rng = np.random.default_rng(1)
    delta = _cloud(48, 1)
    corrupt = delta.copy()
    ii, jj = np.triu_indices(48, k=1)
    sel = rng.choice(len(ii), size=80, replace=False)
    corrupt[ii[sel], jj[sel]] = corrupt[jj[sel], ii[sel]] = 50.0
    w = np.ones_like(delta)
    w[ii[sel], jj[sel]] = w[jj[sel], ii[sel]] = 0.0
    cfg = W.MDSConfig(dim=3, iters=40, cg_iters=12)
    Xw, _ = W.mds(corrupt, cfg, device="cpu", seed=1, weights=w)
    Xu, _ = W.mds(corrupt, cfg, device="cpu", seed=1)

    def true_stress(X):
        d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
        return ((delta - d) ** 2)[np.triu_indices(48, k=1)].sum()

    assert true_stress(Xw) < 0.3 * true_stress(Xu)


def test_disconnected_weight_graph_stays_finite():
    delta = _cloud(48, 3)
    w = np.zeros_like(delta)
    w[:24, :24] = 1.0
    w[24:, 24:] = 1.0
    X, stress = W.mds(delta, W.MDSConfig(dim=3, iters=60, cg_iters=12),
                      device="cpu", seed=1, weights=w)
    assert np.isfinite(X).all() and np.isfinite(stress)
    d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    for sl in (slice(0, 24), slice(24, 48)):
        err = np.abs(delta[sl, sl] - d[sl, sl])
        assert err.mean() < 0.15 * delta[sl, sl].mean(), err.mean()


def test_long_run_past_convergence_stays_finite():
    delta = _cloud(32, 4)
    X, stress = W.mds(delta, W.MDSConfig(dim=3, iters=300, cg_iters=10),
                      device="cpu", seed=2, weights=np.ones_like(delta))
    assert np.isfinite(X).all() and np.isfinite(stress)
    d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
    iu = np.triu_indices(32, 1)
    assert np.abs(delta - d)[iu].mean() < 0.05 * delta[iu].mean()


def test_weight_checks_and_zeroed_diagonal():
    d = np.ones((8, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        W.mds(d, device="cpu", weights=np.ones((4, 4), np.float32))
    with pytest.raises(ValueError, match="nonnegative"):
        W.mds(d, device="cpu", weights=-np.ones((8, 8), np.float32))
    # the diagonal's weight never counts: any diagonal gives the same run
    delta = _cloud(12, 6)
    cfg = W.MDSConfig(dim=2, iters=5)
    w = np.ones_like(delta)
    a = W.mds(delta, cfg, device="cpu", weights=w)
    np.fill_diagonal(w, 7.0)
    b = W.mds(delta, cfg, device="cpu", weights=w)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


def test_start_from_a_converted_state():
    """X0 from ``convert.mds_state_from_numpy`` starts the weighted run
    as the same array does, and the reference's embedding resumes."""
    from harp_tpu_torch import convert

    delta, w = wmds_inputs()
    X_ref, _ = _reference(1)
    st = convert.mds_state_from_numpy({"X": X_ref}, "cpu")
    cfg = W.MDSConfig(dim=2, iters=3)
    a = W.mds(delta, cfg, device="cpu", weights=w, X0=st["X"])
    b = W.mds(delta, cfg, device="cpu", weights=w, X0=X_ref)
    np.testing.assert_array_equal(a[0], b[0])
