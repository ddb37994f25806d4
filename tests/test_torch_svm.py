"""The port's SVM against harp_tpu's, on the same data.

The inner solves (``_pegasos``, ``_pegasos_pallas``) from the same start,
held to the reference's own tolerance for its two arms (``rtol 1e-4, atol
1e-5``, tests/test_svm_kernel.py); whole fits on one worker (in this
process) and on four (one spawned gloo world against a four-device mesh),
both algos, the three ``sv_wire``\\ s and a bf16 ``x``, held to the
reference's model tolerance (``rtol 1e-3``).  Both packages shard the same
203 rows (ragged over four workers) and exchange the same support vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import svm as JSV
from harp_tpu.models.stats import _shard_rows as j_shard_rows
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import convert
from harp_tpu_torch.models import svm as SV
from harp_tpu_torch.models.stats import _shard_rows
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from torch_world import (SVM_CASES, WORLD, run_svm_cases, run_world,
                         svm_config_kwargs, svm_data)


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_svm_cases, tmp_path_factory.mktemp("svm"))


def _reference_fit(jm, kw):
    x, y = svm_data()
    m = JSV.SVM(JSV.SVMConfig(**svm_config_kwargs(kw)), jm)
    m.fit(x, y)
    return m


def _close(got_w, got_b, ref):
    np.testing.assert_allclose(got_w, ref.w, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got_b, ref.b, rtol=1e-3, atol=1e-6)


# ---- the inner solve ----------------------------------------------------------

def _solve_inputs(seed=3, n=300, d=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(x[:, 0] + 0.1 * rng.normal(size=n)).astype(np.float32)
    y[y == 0] = 1.0
    sw = rng.uniform(0.0, 2.0, n).astype(np.float32)
    w0 = (0.1 * rng.normal(size=d)).astype(np.float32)
    return w0, x, y, sw


@pytest.mark.parametrize("solve", ["_pegasos", "_pegasos_pallas"])
@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_inner_solve_matches_reference(solve, xdt):
    w0, x, y, sw = _solve_inputs()
    cfg = JSV.SVMConfig(inner_steps=12, algo="pallas")
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if xdt == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    wr, br = getattr(JSV, solve)(jnp.asarray(w0), jnp.float32(0.1), xj,
                                 jnp.asarray(y), jnp.asarray(sw), cfg)
    wp, bp = getattr(SV, solve)(torch.from_numpy(w0), torch.tensor(0.1), xt,
                                torch.from_numpy(y), torch.from_numpy(sw),
                                SV.SVMConfig(inner_steps=12, algo="pallas"))
    np.testing.assert_allclose(wp.numpy(), np.asarray(wr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(bp), float(br), rtol=1e-4, atol=1e-6)


def test_support_vector_choice_breaks_ties_as_top_k():
    """Equal scores (duplicate rows, padded rows at +inf) go to the lower
    index, as ``lax.top_k(-score, k)`` takes them."""
    score = np.array([0.5, -1.0, 0.5, np.inf, -1.0, 0.5, np.inf, 0.2,
                      -1.0, 0.5], np.float32)
    for k in (1, 3, 4, 6, 9, 10):
        _, want = jax.lax.top_k(-jnp.asarray(score), k)
        got = SV._most_violating(torch.from_numpy(score), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_step_sizes_round_as_the_reference_does():
    cfg = SV.SVMConfig()
    for t in (0, 1, 7, 199):
        want = np.float32(0.1) / (np.float32(1.0) + np.float32(0.01) * t)
        assert SV._lr(cfg, t) == float(want)


def test_shard_rows_matches_reference(jmesh4, monkeypatch):
    x, y = svm_data()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = j_shard_rows(jmesh4, np.asarray(xb), y)
    monkeypatch.setattr(WorkerMesh, "num_workers", property(lambda s: WORLD))
    for r in range(WORLD):
        monkeypatch.setattr(WorkerMesh, "rank", property(lambda s, r=r: r))
        got = _shard_rows(WorkerMesh("cpu"), torch.from_numpy(x).to(
            torch.bfloat16), y)
        assert got[0].dtype == torch.bfloat16  # bf16 keeps its type
        assert got[1].dtype == got[2].dtype == torch.float32
        for g, a in zip(got, ref):
            block = np.asarray(a).reshape(WORLD, -1, *a.shape[1:])[r]
            np.testing.assert_array_equal(g.to(torch.float32).numpy(),
                                          block.astype(np.float32))


# ---- whole fits ---------------------------------------------------------------

@pytest.mark.parametrize("cid,kw", SVM_CASES, ids=[c for c, _ in SVM_CASES])
def test_one_worker_fit_matches_reference(jmesh1, cid, kw):
    x, y = svm_data()
    ref = _reference_fit(jmesh1, kw)
    with telemetry.scope():
        m = SV.SVM(SV.SVMConfig(**svm_config_kwargs(kw)), device="cpu")
        m.fit(x, y)
        led = telemetry.ledger.summary()["svm.fit"]
    _close(m.w, m.b, ref)
    assert abs(m.accuracy(x, y) - ref.accuracy(x, y)) <= 1 / len(y)
    assert m.accuracy(x, y) > 0.9
    # one reshard a round (k = 16 rows of d = 12, labels and masks) plus
    # the two AVG allreduces of w and b
    rounds = svm_config_kwargs(kw)["outer_rounds"]
    (rec,) = [r for r in led["verbs"] if r["verb"] == "reshard"]
    width = {"exact": 4, "bf16": 2, "int8": 1}[kw.get("sv_wire", "exact")]
    row_w = 2 if kw.get("x_dtype") == "bf16" and width == 4 else width
    assert rec["calls"] == rounds
    assert rec["payload_bytes"] == rounds * 16 * (12 * row_w + 2 * width)


@pytest.mark.parametrize("cid,kw", SVM_CASES, ids=[c for c, _ in SVM_CASES])
def test_four_workers_fit_matches_reference(world, jmesh4, cid, kw):
    ref = _reference_fit(jmesh4, kw)
    for w in world:  # the final AVG allreduce: every worker holds the model
        _close(w[cid]["w"], w[cid]["b"], ref)
        np.testing.assert_array_equal(w[cid]["w"], world[0][cid]["w"])
    x, y = svm_data()
    assert world[0][cid]["acc"] > 0.9
    assert abs(world[0][cid]["acc"] - ref.accuracy(x, y)) <= 1 / len(y)


def test_four_workers_never_launch_or_import_jax(world):
    assert all(w["launches"] == {"pegasos_grad": 0} for w in world)
    assert not any(w["_jax_imported"] for w in world)


def test_state_from_the_reference_predicts_the_same(jmesh1):
    x, y = svm_data()
    ref = _reference_fit(jmesh1, {"algo": "xla"})
    state = convert.svm_state_from_numpy({"w": ref.w, "b": ref.b}, "cpu")
    m = SV.SVM(device="cpu", state=state)
    np.testing.assert_array_equal(m.predict(x), ref.predict(x))
    np.testing.assert_array_equal(m.decision_function(x),
                                  ref.decision_function(x))


def test_unported_paths_raise():
    """The sparse path is ported: its input checks raise as the
    reference's do."""
    with pytest.raises(ValueError, match="±1"):
        SV.SVM(device="cpu").fit_sparse(
            np.zeros((2, 1), np.int32), np.ones((2, 1), np.float32),
            np.ones((2, 1), np.float32), np.array([0.0, 2.0]), 3)
    with pytest.raises(OSError):  # the native reader's, or open()'s
        SV.main(["--libsvm", "no-such-file.txt", "--zero-based",
                 "--device", "cpu"])
    with pytest.raises(ValueError, match="sv_wire"):
        SV.SVMConfig(sv_wire="fp8")
    with pytest.raises(ValueError, match="labels"):
        SV.SVM(device="cpu").fit(np.zeros((4, 2)), np.array([0, 1, 1, 0]))
