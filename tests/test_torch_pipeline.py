"""The port's pipeline (``parallel/pipeline.py``) and ``broadcast``'s
gradient against harp_tpu's, on the same stages and microbatches.

Four stages on a spawned 4-worker gloo world against the reference's
``pipeline_forward`` / ``pipeline_loss_and_grads`` under ``shard_map`` on
four devices: outputs, the loss and each worker's stage gradients within
rtol 1e-5 / atol 1e-6, the gradients finite.  ``broadcast``'s gradient
(the cotangents summed onto the root, zeros elsewhere) against
``jax.grad`` through the reference's custom-JVP broadcast, on 1 and 4
workers and two roots.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from harp_tpu.parallel import collective as JC
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.parallel.pipeline import pipeline_forward as j_forward
from harp_tpu.parallel.pipeline import pipeline_loss_and_grads as j_lossgrad
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.pipeline import (pipeline_forward,
                                              pipeline_loss_and_grads)
from harp_tpu_torch.utils import telemetry
from torch_world import (BCAST_ROOTS, PIPE_GRAD_M, PIPE_MS, WORLD,
                         bcast_inputs, pipe_loss, pipe_stage,
                         pipeline_inputs, run_pipeline_cases, run_world,
                         time_limit)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


def j_stage(params, h):
    return jax.nn.tanh(h @ params["w"] + params["b"])


def j_loss(outs, targets):
    return ((outs - targets) ** 2).mean()


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_pipeline_cases, tmp_path_factory.mktemp("pipe"))


def _stage_specs(jm):
    return {"w": jm.spec(0), "b": jm.spec(0)}


def _ref_forward(jm, d):
    fn = jax.jit(jm.shard_map(
        lambda p, xx: j_forward(j_stage, jax.tree.map(lambda a: a[0], p),
                                xx),
        in_specs=(_stage_specs(jm), P()), out_specs=P()))
    return np.asarray(fn({"w": d["w"], "b": d["b"]}, d["x"]))


def _ref_lossgrad(jm, d):
    fn = jax.jit(jm.shard_map(
        lambda p, xx, tt: j_lossgrad(
            j_stage, j_loss, jax.tree.map(lambda a: a[0], p), xx, tt),
        in_specs=(_stage_specs(jm), P(), P()),
        out_specs=(P(), _stage_specs(jm))))
    loss, g = fn({"w": d["w"], "b": d["b"]}, d["x"], d["t"])
    n = jm.num_workers
    return (float(loss), np.asarray(g["w"]).reshape(n, *d["w"].shape[1:]),
            np.asarray(g["b"]).reshape(n, *d["b"].shape[1:]))


@pytest.mark.parametrize("m", PIPE_MS)
def test_pipeline_forward_matches_the_reference_on_4_workers(world, jmesh4,
                                                             m):
    ref = _ref_forward(jmesh4, pipeline_inputs(m))
    for r in world:
        np.testing.assert_allclose(r[f"fwd-{m}"], ref, rtol=RTOL, atol=ATOL)


def test_pipeline_loss_and_stage_grads_match_the_reference(world, jmesh4):
    loss, gw, gb = _ref_lossgrad(jmesh4, pipeline_inputs(PIPE_GRAD_M))
    for rank, r in enumerate(world):
        assert abs(r["loss"] - loss) <= RTOL * abs(loss) + ATOL
        assert np.isfinite(r["gw"]).all() and np.isfinite(r["gb"]).all()
        np.testing.assert_allclose(r["gw"], gw[rank], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["gb"], gb[rank], rtol=RTOL, atol=ATOL)


def test_the_port_never_imported_jax(world):
    assert not any(r["_jax_imported"] for r in world)


def _ref_bcast_grad(jm, bi, root):
    """Per worker: y = broadcast(x), d/dx sum(w * y), under shard_map."""
    spec = jm.spec(0)

    def per(x, w):
        def obj(xx):
            return (w * JC.broadcast(xx, root=root)).sum()

        return jax.grad(obj)(x), JC.broadcast(x, root=root)

    fn = jax.jit(jm.shard_map(per, in_specs=(spec, spec),
                              out_specs=(spec, spec)))
    n = jm.num_workers
    g, y = fn(bi["x"][:n].reshape(-1), bi["w"][:n].reshape(-1))
    return np.asarray(g).reshape(n, -1), np.asarray(y).reshape(n, -1)


@pytest.mark.parametrize("root", BCAST_ROOTS)
def test_broadcast_gradient_matches_the_reference_on_4_workers(world,
                                                                jmesh4, root):
    g, y = _ref_bcast_grad(jmesh4, bcast_inputs(), root)
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r[f"bcast-{root}"], y[rank])
        np.testing.assert_allclose(r[f"bcast-grad-{root}"], g[rank],
                                   rtol=RTOL, atol=ATOL)
    # the root holds every worker's cotangent, the others zeros
    bi = bcast_inputs()
    np.testing.assert_allclose(world[root][f"bcast-grad-{root}"],
                               bi["w"].sum(0), rtol=RTOL, atol=ATOL)


def test_broadcast_gradient_matches_the_reference_on_one_worker():
    bi = bcast_inputs(world=1)
    g, y = _ref_bcast_grad(JaxMesh(jax.devices()[:1]), bi, 0)
    x = torch.tensor(bi["x"][0]).requires_grad_()
    out = C.broadcast(x, root=0)
    (torch.tensor(bi["w"][0]) * out).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), y[0])
    np.testing.assert_allclose(x.grad.numpy(), g[0], rtol=RTOL, atol=ATOL)


def test_broadcast_of_bool_and_int_stays_non_differentiable():
    b = C.broadcast(torch.tensor([True, False]), root=0)
    i = C.broadcast(torch.arange(3), root=0)
    assert b.dtype == torch.bool and not b.requires_grad
    assert i.dtype == torch.int64 and not i.requires_grad


def test_one_stage_pipeline_matches_the_reference_and_the_serial_chain():
    """S = 1 (what the card runs): forward and gradients against the
    reference on one device and against plain autograd of the stage."""
    d = pipeline_inputs(3, world=1)
    jm = JaxMesh(jax.devices()[:1])
    ref = _ref_forward(jm, d)
    p = {"w": torch.tensor(d["w"][0]), "b": torch.tensor(d["b"][0])}
    got = pipeline_forward(pipe_stage, p, d["x"], device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    loss, gw, gb = _ref_lossgrad(jm, d)
    l2, g = pipeline_loss_and_grads(pipe_stage, pipe_loss, p, d["x"],
                                    d["t"], device="cpu")
    assert abs(float(l2) - loss) <= RTOL * abs(loss) + ATOL
    np.testing.assert_allclose(g["w"].numpy(), gw[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g["b"].numpy(), gb[0], rtol=RTOL, atol=ATOL)
    pp = {k: v.clone().requires_grad_() for k, v in p.items()}
    pipe_loss(pipe_stage(pp, torch.tensor(d["x"])),
              torch.tensor(d["t"])).backward()
    np.testing.assert_allclose(g["w"].numpy(), pp["w"].grad.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_pipeline_forward_records_its_span():
    d = pipeline_inputs(1, world=1)
    p = {"w": torch.tensor(d["w"][0]), "b": torch.tensor(d["b"][0])}
    with telemetry.scope(True):
        pipeline_forward(pipe_stage, p, d["x"], device="cpu")
        names = [r["span"] for r in telemetry.tracer.records]
    assert names == ["pipeline_forward"]
