"""The port's long-context layer (``harp_tpu_torch.examples.longctx_layer``)
against the reference example's training step, on one and on four workers.

The reference side is the example's own ``layer`` and ``step``
(``examples/longctx_layer.py``) built from harp_tpu's RoPE, ring attention
and allreduce on a 1- or 4-device CPU mesh, fed the same numpy weights and
input.  Tolerance: losses and parameters within rtol 1e-4 / atol 1e-6
after three steps of ``p - 2.0 g`` (f32 products, the ring's partial sums
and the gradient allreduce in other orders; the step size of 2 lets a
first-step difference of a few ulps grow by about one order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from harp_tpu import Combiner
from harp_tpu import collective as JC
from harp_tpu.ops.ring_attention import ring_attention as j_ring
from harp_tpu.ops.rope import apply_rope as j_rope
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.examples import longctx_layer as L
from harp_tpu_torch.parallel.mesh import WorkerMesh
from torch_world import LONGCTX_SHAPE, WORLD, run_longctx_cases, run_world

TOL = {"rtol": 1e-4, "atol": 1e-6}


def reference_run(n_devices, seq, heads, kv_heads, dim, window, steps):
    """The reference example's training loop on ``n_devices``."""
    mesh = JaxMesh(jax.devices()[:n_devices])
    h, g, d = heads, kv_heads, dim
    params, x, teacher = L.init_arrays(seq, h, g, d)

    def layer(params, x):
        b, s, _ = x.shape
        q = j_rope((x @ params["wq"]).reshape(b, s, h, d))
        k = j_rope((x @ params["wk"]).reshape(b, s, g, d))
        v = (x @ params["wv"]).reshape(b, s, g, d)
        o = j_ring(q, k, v, causal=True, window=window)
        return o.reshape(b, s, h * d) @ params["wo"]

    def step(params, x, y):
        def loss_fn(p):
            return ((layer(p, x) - y) ** 2).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads, loss = JC.allreduce((grads, loss), Combiner.AVG)
        return jax.tree.map(lambda p, g: p - 2.0 * g, params, grads), loss

    spec = mesh.spec(1, ndim=3)
    fit = jax.jit(mesh.shard_map(
        step, in_specs=(P(), spec, spec), out_specs=(P(), P())))
    target = np.asarray(jax.jit(mesh.shard_map(
        layer, in_specs=(P(), spec), out_specs=spec))(teacher, x))
    losses = []
    for _ in range(steps):
        params, loss = fit(params, x, target)
        losses.append(float(np.asarray(loss)))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_longctx_cases, tmp_path_factory.mktemp("longctx"))


def _check(losses, params, ref_losses, ref_params):
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v, **TOL)
    assert losses[-1] < losses[0]


def test_layer_matches_the_reference_on_four_workers(world):
    s = LONGCTX_SHAPE
    ref = reference_run(WORLD, **s)
    for w in world:
        _check(w["losses"], w["params"], *ref)
    assert not any(w["_jax_imported"] for w in world)


def test_layer_matches_the_reference_on_one_worker():
    s = LONGCTX_SHAPE
    losses, params = L.run(**s, mesh=WorkerMesh("cpu"))
    _check(losses, {k: v.numpy() for k, v in params.items()},
           *reference_run(1, **s))


def test_init_draws_in_the_reference_example_order():
    """The example draws params, then x, then the teacher from
    default_rng(0) (``examples/longctx_layer.py``)."""
    h, g, d, seq = 4, 2, 8, 16
    rng = np.random.default_rng(0)
    model_d = h * d
    want = [rng.normal(size=s).astype(np.float32) * 0.05
            for s in ((model_d, h * d), (model_d, g * d), (model_d, g * d),
                      (h * d, model_d))]
    x = rng.normal(size=(1, seq, model_d)).astype(np.float32)
    teach = [rng.normal(size=a.shape).astype(np.float32) * 0.05 for a in want]
    params, x2, teacher = L.init_arrays(seq, h, g, d)
    for a, b in zip(want, params.values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(teach, teacher.values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(x, x2)


def test_main_prints_the_reference_dict(capsys):
    out = L.main(["--device", "cpu", "--seq", "64", "--heads", "4",
                  "--kv-heads", "2", "--dim", "8", "--window", "12",
                  "--steps", "2"])
    assert set(out) == {"workers", "seq", "heads", "window", "loss_first",
                        "loss_final"}
    assert out["workers"] == 1 and out["heads"] == "4q/2kv"
    assert str(out) in capsys.readouterr().out
    with pytest.raises(SystemExit):
        L.main(["--device", "cpu", "--steps", "0"])
