"""The port's sparse SVM path (``SVM.fit_sparse`` on padded-ELL rows,
``make_train_fn_ell``, the CLI's ``--libsvm``) against harp_tpu's on the
same rows.

``w`` and ``b`` agree within rtol 1e-3 (atol 1e-5) with the reference's
``fit_sparse``, on one worker and on a spawned 4-worker gloo world, on the
exact and the bf16 support-vector wire: the gradient's per-feature sums
(``index_add_`` against ``segment_sum``) add in another f32 order.  On
dense rows written as ELL the sparse fit agrees with the port's dense fit
within the same tolerance, and the CLI's ``--libsvm`` row matches the
reference's on a seeded file.
"""

import json

import jax
import numpy as np
import pytest

from harp_tpu.models import svm as JS
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.parallel.mesh import use_mesh
from harp_tpu_torch.models import svm as SV
from harp_tpu_torch.native.datasource import csr_to_ell
from torch_world import (SVM_SHAPE, SVM_SPARSE_WIRES, WORLD,
                         run_svm_sparse_cases, run_world, svm_sparse_data)

RTOL, ATOL = 1e-3, 1e-5


def _cfg(mod, wire="exact"):
    s = SVM_SHAPE
    return mod.SVMConfig(inner_steps=s["inner_steps"],
                         outer_rounds=s["outer_rounds"],
                         sv_per_worker=s["sv_per_worker"], sv_wire=wire)


def _reference(n_dev, wire):
    (ids, vals, mask), x, y = svm_sparse_data()
    m = JS.SVM(_cfg(JS, wire), mesh=JaxMesh(jax.devices()[:n_dev]))
    return m.fit_sparse(ids, vals, mask, y, x.shape[1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_svm_sparse_cases, tmp_path_factory.mktemp("svms"))


@pytest.mark.parametrize("wire", SVM_SPARSE_WIRES)
def test_one_worker_matches_reference(wire):
    (ids, vals, mask), x, y = svm_sparse_data()
    ref = _reference(1, wire)
    m = SV.SVM(_cfg(SV, wire), device="cpu").fit_sparse(ids, vals, mask, y,
                                                        x.shape[1])
    np.testing.assert_allclose(m.w, ref.w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.b, ref.b, rtol=RTOL, atol=ATOL)
    assert m.accuracy(x, y) > 0.8


@pytest.mark.parametrize("wire", SVM_SPARSE_WIRES)
def test_four_workers_match_reference(world, wire):
    ref = _reference(WORLD, wire)
    for w in world:
        np.testing.assert_allclose(w[wire]["w"], ref.w, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(w[wire]["b"], ref.b, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(w[wire]["w"], world[0][wire]["w"])
        assert not w["_jax_imported"]


def test_dense_rows_as_ell_match_the_dense_fit():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(150, 10)).astype(np.float32)
    y = np.sign(x @ rng.normal(size=10)).astype(np.float32)
    y[y == 0] = 1.0
    r, c = np.nonzero(x)
    ids, vals, mask = csr_to_ell(np.arange(0, x.size + 1, 10), c, x[r, c])
    dense = SV.SVM(_cfg(SV), device="cpu").fit(x, y)
    sparse = SV.SVM(_cfg(SV), device="cpu").fit_sparse(ids, vals, mask, y,
                                                       10)
    np.testing.assert_allclose(sparse.w, dense.w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sparse.b, dense.b, rtol=RTOL, atol=ATOL)


def test_make_train_fn_ell_is_fit_sparse():
    import torch

    from harp_tpu_torch.models.stats import _shard_rows
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    (ids, vals, mask), x, y = svm_sparse_data()
    mesh = WorkerMesh("cpu")
    idd, vd, md, yd, swd = _shard_rows(mesh, ids, vals, mask, y)
    fn = SV.make_train_fn_ell(mesh, _cfg(SV), x.shape[1], yd.shape[0])
    w, b = fn((idd, vd, md), yd, swd)
    m = SV.SVM(_cfg(SV), device="cpu").fit_sparse(ids, vals, mask, y,
                                                  x.shape[1])
    assert torch.equal(w, torch.from_numpy(m.w)) and float(b) == m.b


def _write_libsvm(path, x, y, zero_based=False):
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for row, lab in zip(x, y):
            nz = np.nonzero(row)[0]
            f.write(f"{int(lab)} " + " ".join(
                f"{j + off}:{row[j]:.7g}" for j in nz) + "\n")


@pytest.mark.parametrize("zero_based", [False, True])
def test_libsvm_cli_matches_reference(tmp_path, capsys, zero_based):
    _, x, y = svm_sparse_data(seed=9, n=300)
    y = np.where(y > 0, 3, 7)  # any two label values
    p = str(tmp_path / "d.svm")
    _write_libsvm(p, x, y, zero_based)
    flag = ["--zero-based"] if zero_based else []
    with use_mesh(JaxMesh(jax.devices()[:1])):  # the port's one worker
        JS.main(["--libsvm", p, *flag])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    SV.main(["--libsvm", p, *flag, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["config"] == want["config"] == "svm_fit_cli"
    for k in ("file", "n", "d", "classes"):
        assert got[k] == want[k], k
    assert abs(got["train_acc"] - want["train_acc"]) <= 1 / 300
    assert got["train_acc"] > 0.8


def test_libsvm_cli_errors(tmp_path):
    p = tmp_path / "three.svm"
    p.write_text("1 1:2.0\n2 2:1.0\n3 1:1.0\n")
    with pytest.raises(SystemExit, match="exactly 2 label values"):
        SV.main(["--libsvm", str(p), "--device", "cpu"])
    z = tmp_path / "z.svm"
    z.write_text("1 0:2.0\n-1 1:1.0\n")
    with pytest.raises(SystemExit, match="zero_based"):
        SV.main(["--libsvm", str(z), "--device", "cpu"])
