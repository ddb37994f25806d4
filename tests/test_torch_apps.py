"""The port's four runnable apps against the reference's, on the CPU.

Each reference app (``examples/<app>.py``) runs as ``tests/test_aux.py``
runs it, in a subprocess, here with ``JAX_PLATFORMS=cpu`` and
``--xla_force_host_platform_device_count=N`` for N = 1 and 4; the port's
app runs through its ``main`` on one worker in this process and on a
spawned gloo world of four.  Their printed results are compared at the
reference's printed precision:

- ``kmeans_app``: ``centroid_norm`` within rtol 1e-5 (the same one-hot
  sums in another f32 order);
- ``mfsgd_app``: ``rmse_first``/``rmse_final`` (rounded to 4 places by
  both) within one unit of the last place, the port started from the
  reference's initial factors (the reference draws them with JAX's
  generator);
- ``pipeline_moe_app``: the first and last loss within half a unit of the
  printed 4th place (plus 1e-6), the same dropped count, and the MoE
  within the reference's rtol 2e-4 / atol 2e-5 of the host reference;
- ``streaming_kmeans_app``: the streamed history and both inertias within
  1e-5 of Σ|x|² (inertia is Σ|x|² plus the best scores, which nearly
  cancel: ``tests/test_torch_kmeans_stream.py``), the CSV byte-equal to
  the reference's writer.

Each app also runs as ``python -m harp_tpu_torch.examples.<app> --device
cpu``.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from harp_tpu.models import mfsgd as JMF
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.examples import streaming_kmeans_app as SA
from torch_apps_world import (APP_ARGS, WORLD, mfsgd_app_kwargs,
                              run_app_cases, run_world, time_limit)

REPO = pathlib.Path(__file__).resolve().parent.parent
APPS = list(APP_ARGS)
NS = (1, WORLD)


def _launch_references() -> dict:
    """Every reference app at N = 1 and 4, and every port app as a module
    on one worker, all started together."""
    procs = {}
    for app in APPS:
        for n in NS:
            env = {**os.environ, "JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS": "--xla_force_host_platform_device_count="
                                f"{n}"}
            procs[("ref", app, n)] = subprocess.Popen(
                [sys.executable, str(REPO / "examples" / f"{app}.py"),
                 *APP_ARGS[app]], cwd=str(REPO), env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        procs[("port", app, 1)] = subprocess.Popen(
            [sys.executable, "-m", f"harp_tpu_torch.examples.{app}",
             *APP_ARGS[app], "--device", "cpu"], cwd=str(REPO), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, (key, stderr[-2000:])
            out[key] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.fixture(scope="module")
def printed():
    with time_limit(260):
        return _launch_references()


def _mf_state(n: int) -> dict:
    """The reference app's initial W and H on an n-device mesh."""
    kw = mfsgd_app_kwargs()
    cfg = JMF.MFSGDConfig(rank=kw["rank"], lr=0.05, algo="dense",
                          u_tile=64, i_tile=64, entry_cap=256)
    m = JMF.MFSGD(kw["users"], kw["items"], cfg,
                  JaxMesh(jax.devices()[:n]), seed=0)
    return {"W": np.asarray(m.W), "H": np.asarray(m.H)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's results: {1: one worker's, 4: every rank's}."""
    tmp = tmp_path_factory.mktemp("apps")
    with time_limit(120):
        one = run_app_cases(0, 1, _mf_state(1), str(tmp / "one"))
    four = run_world(run_app_cases, tmp, _mf_state(WORLD),
                     str(tmp / "four"), timeout=240.0)
    return {1: [one], WORLD: four}


def _ref_dict(text: str) -> dict:
    return ast.literal_eval(text.strip().splitlines()[-1])


@pytest.mark.parametrize("n", NS)
def test_kmeans_app_matches_reference(printed, port, n):
    ref = _ref_dict(printed[("ref", "kmeans_app", n)])
    for got in port[n]:
        got = got["kmeans_app"]
        assert (got["k"], got["iters"]) == (ref["k"], ref["iters"])
        np.testing.assert_allclose(got["centroid_norm"],
                                   ref["centroid_norm"], rtol=1e-5)
    assert len({g["kmeans_app"]["centroid_norm"] for g in port[n]}) == 1


@pytest.mark.parametrize("n", NS)
def test_mfsgd_app_matches_reference(printed, port, n):
    ref = _ref_dict(printed[("ref", "mfsgd_app", n)])
    assert ref["workers"] == n
    for got in port[n]:
        got = got["mfsgd_app"]
        assert got["workers"] == n
        for k in ("rmse_first", "rmse_final"):
            assert abs(got[k] - ref[k]) <= 1e-4 + 1e-9, (k, got, ref)
        assert got["rmse_final"] < got["rmse_first"]


@pytest.mark.parametrize("n", NS)
def test_pipeline_moe_app_matches_reference(printed, port, n):
    text = printed[("ref", "pipeline_moe_app", n)]
    head = re.search(r"pipeline\[(\d+) stages x (\d+) microbatches\] "
                     r"loss (\S+) -> (\S+)", text)
    moe = re.search(r"moe\[(\d+) experts, capacity 8\] == dense reference "
                    r"\(dropped=(\d+)\)", text)
    assert head and moe, text
    assert int(head.group(1)) == int(moe.group(1)) == n
    for got in port[n]:
        got = got["pipeline_moe_app"]
        assert got["workers"] == n
        for key, ref in (("loss_first", head.group(3)),
                         ("loss_final", head.group(4))):
            assert abs(got[key] - float(ref)) <= 5e-5 + 1e-6, (key, got)
        assert got["dropped"] == int(moe.group(2))
        # the app asserts the MoE within rtol 2e-4 / atol 2e-5 of the host
        # reference before it returns
        assert np.isfinite(got["moe_max_abs_err"])
        assert got["loss_final"] < got["loss_first"]


def _sum_sq() -> float:
    a = dict(zip(APP_ARGS["streaming_kmeans_app"][::2],
                 APP_ARGS["streaming_kmeans_app"][1::2]))
    x = SA.blobs(int(a["--n"]), int(a["--d"]), int(a["--k"]))
    return float((x.astype(np.float64) ** 2).sum())


@pytest.mark.parametrize("n", NS)
def test_streaming_kmeans_app_matches_reference(printed, port, n):
    text = printed[("ref", "streaming_kmeans_app", n)]
    hist = ast.literal_eval(re.search(r"streamed inertia per epoch: "
                                      r"(\[.*\])", text).group(1))
    res = re.search(r"resident inertia (\S+) vs streamed (\S+)", text)
    assert f"num_workers={n}" in text and "OK: beyond-HBM" in text
    tol = 1e-5 * _sum_sq()
    for got in port[n]:
        st = got["streaming_kmeans_app"]
        assert st["workers"] == n and st["rel_diff"] < 1e-3
        assert len(st["history"]) == len(hist)
        np.testing.assert_allclose(st["history"], hist, rtol=0, atol=tol)
        assert abs(st["inertia_resident"] - float(res.group(1))) <= tol
        assert abs(st["inertia_streamed"] - float(res.group(2))) <= tol
        # a given directory gives the temporary one's run, bit for bit
        assert got["streaming_workdir"] == st


def test_streaming_csv_is_the_reference_text(tmp_path):
    """The port's writer against the reference app's two write lines,
    which the reference's source must still hold, run on the same points."""
    src = (REPO / "examples" / "streaming_kmeans_app.py").read_text()
    header = 'f.write("# synthetic blobs\\n")'
    row = 'f.write(",".join(f"{v:.9e}" for v in row) + "\\n")'
    assert header in src and row in src
    pts = SA.blobs(50, 7, 3)
    SA.write_csv(str(tmp_path / "port.csv"), pts)
    with open(tmp_path / "ref.csv", "w") as f:
        exec(header)
        for row_ in pts:
            exec(row, {"f": f, "row": row_})
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    back = np.loadtxt(tmp_path / "port.csv", delimiter=",", dtype=np.float32)
    np.testing.assert_array_equal(back, pts)  # f32 round-trips


@pytest.mark.parametrize("app", APPS)
def test_app_runs_as_a_module(printed, port, app):
    """``python -m harp_tpu_torch.examples.<app> --device cpu`` prints
    what ``main`` returns in process (the streaming app prints the
    reference's lines and returns its numbers)."""
    text = printed[("port", app, 1)]
    got = port[1][0][app]
    if app == "pipeline_moe_app":
        assert f"loss {got['loss_first']:.4f} -> {got['loss_final']:.4f}" \
            in text and "== dense reference (dropped=0)" in text
    elif app == "streaming_kmeans_app":
        assert f"resident inertia {got['inertia_resident']:.1f} vs " \
            f"streamed {got['inertia_streamed']:.1f}" in text
    elif app == "kmeans_app":
        assert _ref_dict(text) == got
    else:  # the module run draws its own initial factors
        out = _ref_dict(text)
        assert out["workers"] == 1 and out["rmse_final"] < out["rmse_first"]


def test_children_never_import_jax(port):
    assert not any(w["_jax_imported"] for w in port[WORLD])
