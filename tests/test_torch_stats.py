"""The port's stats suite against harp_tpu.models.stats, on the same
seeded inputs, on one worker and on a spawned 4-worker gloo world (203
rows: ragged, the last worker's block padded).

Tolerances, each app's (the two packages add in another f32 order):

- moments, covariance, regression coefficients and intercepts, and naive
  Bayes log-probabilities: rtol 1e-5, atol 1e-6; NB predictions equal
  (the regression rows are centered: ``torch_world.stats_inputs``);
- PCA: eigenvalues rtol 1e-4, components equal up to sign (atol 1e-4);
- TSQR and SVD: Q·R reconstructs X within 1e-5 relative; |R| and the
  singular values within rtol 1e-4 (atol 1e-4 of the largest); Q and the
  singular vectors equal up to the sign of each column (atol 1e-4).  The
  signs come from each package's LAPACK and are not normalised;
- ALS (the reference's seeded H start): rmse_history rtol 1e-4, H and W
  atol 1e-4;
- the CLI's JSON: rtol 1e-4 (atol 1e-6), except a fit's RMSE (rtol 1e-2:
  a residual of 0.3 % of |y| amplifies 1e-5 coefficient differences) and
  TSQR's residual (below 1e-5 in both).
"""

import json

import jax
import numpy as np
import pytest

from harp_tpu.models import stats as JS
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.parallel.mesh import use_mesh
from harp_tpu_torch.models import stats as S
from torch_world import WORLD, run_stats_cases, run_world, stats_inputs

TIGHT = dict(rtol=1e-5, atol=1e-6)


def _reference(jm) -> dict:
    inp = stats_inputs()
    x = inp["x"]
    out = {"moments": JS.moments(x, jm), "cov": JS.covariance(x, jm),
           "pca": JS.pca(x, mesh=jm),
           "nb": JS.naive_bayes_fit(np.abs(x), inp["cls"], 3, mesh=jm),
           "lin": JS.linear_regression(inp["xr"], inp["y"], mesh=jm),
           "lin2": JS.linear_regression(inp["xr"], inp["y2"], mesh=jm),
           "ridge": JS.ridge_regression(inp["xr"], inp["y"], l2=2.0,
                                        mesh=jm),
           "ridge0": JS.ridge_regression(inp["xr"], inp["y2"], l2=2.0,
                                         fit_intercept=False, mesh=jm),
           "qr": JS.tsqr(x, jm), "svd": JS.svd(x, jm),
           "als": JS.als(inp["users"], inp["items"], inp["vals"], 37, 23,
                         rank=4, iters=3, mesh=jm)}
    out["nb_pred"] = JS.naive_bayes_predict(out["nb"], np.abs(x))
    return out


def _cols_up_to_sign(a, b, atol=1e-4):
    """Columns of ``a`` equal those of ``b`` up to each column's sign."""
    for j in range(b.shape[1]):
        s = np.sign(a[:, j] @ b[:, j]) or 1.0
        np.testing.assert_allclose(s * a[:, j], b[:, j], atol=atol)


def _check(got: dict, want: dict):
    x = stats_inputs()["x"]
    assert sorted(got["moments"]) == sorted(want["moments"])
    for k in want["moments"]:
        np.testing.assert_allclose(got["moments"][k], want["moments"][k],
                                   **TIGHT, err_msg=k)
    for a, b in zip(got["cov"], want["cov"]):
        np.testing.assert_allclose(a, b, **TIGHT)
    np.testing.assert_allclose(got["pca"][1], want["pca"][1], rtol=1e-4)
    _cols_up_to_sign(got["pca"][0].T, want["pca"][0].T)
    for k in want["nb"]:
        np.testing.assert_allclose(got["nb"][k], want["nb"][k], **TIGHT)
    np.testing.assert_array_equal(got["nb_pred"], want["nb_pred"])
    for key in ("lin", "lin2", "ridge"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, **TIGHT, err_msg=key)
    np.testing.assert_allclose(got["ridge0"][0], want["ridge0"][0], **TIGHT)
    assert got["ridge0"][1] is None
    q, r = got["qr"]
    assert q.shape == x.shape and r.shape == (6, 6)
    assert np.linalg.norm(q @ r - x) / np.linalg.norm(x) < 1e-5
    top = np.abs(want["qr"][1]).max()
    np.testing.assert_allclose(np.abs(r), np.abs(want["qr"][1]), rtol=1e-4,
                               atol=1e-4 * top)
    _cols_up_to_sign(q, want["qr"][0])
    u, s, vt = got["svd"]
    np.testing.assert_allclose(s, want["svd"][1], rtol=1e-4)
    _cols_up_to_sign(u, want["svd"][0])
    _cols_up_to_sign(vt.T, want["svd"][2].T)
    W, H, hist = got["als"]
    np.testing.assert_allclose(hist, want["als"][2], rtol=1e-4)
    np.testing.assert_allclose(H, want["als"][1], atol=1e-4)
    np.testing.assert_allclose(W, want["als"][0], atol=1e-4)
    assert hist[-1] < hist[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_stats_cases, tmp_path_factory.mktemp("stats"))


def test_one_worker_matches_reference():
    from torch_world import stats_results

    _check(stats_results(S, stats_inputs(), "cpu"),
           _reference(JaxMesh(jax.devices()[:1])))


def test_four_workers_match_reference(world):
    want = _reference(JaxMesh(jax.devices()[:WORLD]))
    for w in world:
        _check(w, want)
        assert not w["_jax_imported"]
    # every worker ends with the same replicated results
    for w in world[1:]:
        np.testing.assert_array_equal(w["als"][1], world[0]["als"][1])
        np.testing.assert_array_equal(w["qr"][0], world[0]["qr"][0])


def test_tsqr_refuses_a_short_block(world):
    for w in world:
        assert "tall-skinny" in w["tsqr_error"]
    with pytest.raises(ValueError, match="tall-skinny"):
        S.tsqr(np.ones((5, 6), np.float32), device="cpu")


def test_tensor_inputs_stay_tensors():
    import torch

    x = stats_inputs()["x"]
    a = S.covariance(torch.from_numpy(x), device="cpu")
    b = S.covariance(x, device="cpu")
    np.testing.assert_array_equal(a[1], b[1])


def _write_inputs(tmp_path):
    inp = stats_inputs(1)
    x, y = inp["x"], inp["y"]
    np.savetxt(tmp_path / "xy_0.csv", np.c_[x[:100], y[:100]],
               delimiter=",", fmt="%.9e")
    np.savetxt(tmp_path / "xy_1.csv", np.c_[x[100:], y[100:]],
               delimiter=",", fmt="%.9e")
    np.savetxt(tmp_path / "nb.csv", np.c_[np.abs(x), inp["cls"]],
               delimiter=",", fmt="%.9e")
    with open(tmp_path / "r.txt", "w") as f:
        for u, i, v in zip(inp["users"], inp["items"], inp["vals"]):
            f.write(f"{u} {i} {v:.6f}\n")


ALGOS = ["pca", "cov", "moments", "naive", "linreg", "ridge", "qr", "svd",
         "als"]


def _cli_rows(tmp_path, capsys, algo, with_input):
    args = [algo, "--n", "3000", "--d", "12"]
    if with_input:
        _write_inputs(tmp_path)
        src = {"als": "r.txt", "naive": "nb.csv"}.get(algo, "xy_*.csv")
        args += ["--input", str(tmp_path / src)]
    with use_mesh(JaxMesh(jax.devices()[:1])):  # the port's one worker
        JS.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    S.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


@pytest.mark.parametrize("with_input", [False, True], ids=["synthetic",
                                                           "input"])
@pytest.mark.parametrize("algo", ALGOS)
def test_cli_json_matches_reference(tmp_path, capsys, algo, with_input):
    got, want = _cli_rows(tmp_path, capsys, algo, with_input)
    assert got["config"] == want["config"] == "stats_cli"
    assert got["backend"] == "cpu"
    keys = set(want) - {"config", "date", "backend", "n_devices", "commit",
                        "jax", "device_kind", "platform", "devices",
                        "n_hosts", "host"}
    assert keys <= set(got), (keys, set(got))
    for k in keys:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        elif k == "rel_resid":  # f32 rounding noise, both tiny
            assert got[k] < 1e-5 and want[k] < 1e-5
        elif k == "rmse_history":  # rounded to 4 places by the CLI
            np.testing.assert_allclose(got[k], want[k], atol=1.5e-4)
        elif k == "fit_rmse":
            # the residual of a fit to 0.3 % of |y|: a 1e-5 relative
            # coefficient difference (f32 sums in another order) moves it
            # by up to 0.4 %
            np.testing.assert_allclose(got[k], want[k], rtol=1e-2)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_cli_input_checks(tmp_path):
    bad = tmp_path / "frac.csv"
    np.savetxt(bad, np.c_[np.ones((4, 2)), [0.5, 1, 2, 3]], delimiter=",")
    with pytest.raises(SystemExit, match="integers"):
        S.main(["naive", "--input", str(bad), "--device", "cpu"])
    neg = tmp_path / "neg.csv"
    np.savetxt(neg, np.c_[np.ones((4, 2)), [-1, 1, 2, 3]], delimiter=",")
    with pytest.raises(SystemExit, match=">= 0"):
        S.main(["naive", "--input", str(neg), "--device", "cpu"])
    big = tmp_path / "big.csv"
    np.savetxt(big, np.c_[np.ones((2, 2)), [0, 20_000]], delimiter=",")
    with pytest.raises(SystemExit, match="classes"):
        S.main(["naive", "--input", str(big), "--device", "cpu"])
    one = tmp_path / "one.csv"
    np.savetxt(one, np.ones((4, 1)), delimiter=",")
    with pytest.raises(SystemExit, match=">= 2 columns"):
        S.main(["linreg", "--input", str(one), "--device", "cpu"])
    (tmp_path / "pairs.txt").write_text("1 2\n3 4\n")
    with pytest.raises(SystemExit, match="rating"):
        S.main(["als", "--input", str(tmp_path / "pairs.txt"),
                "--device", "cpu"])
    (tmp_path / "negid.txt").write_text("-1 2 1.0\n3 4 2.0\n")
    with pytest.raises(SystemExit, match="negative"):
        S.main(["als", "--input", str(tmp_path / "negid.txt"),
                "--device", "cpu"])
    with pytest.raises(SystemExit, match="no input files"):
        S.main(["cov", "--input", str(tmp_path / "none*.csv"),
                "--device", "cpu"])
