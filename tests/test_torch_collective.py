"""The port's collective verbs against harp_tpu's, on four workers.

The port runs in a gloo world of 4 spawned processes (one world for the
whole module); the reference runs the same per-worker inputs through its
verbs on a 4-device CPU mesh.  Integer, bool, MAX/MIN and data-movement
results must be equal bit for bit; float ADD/AVG/MULTIPLY results within
rtol 1e-6, because the gloo ring and XLA add the four values in different
orders (one or two f32 roundings apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.parallel import collective as JC
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel import mesh as M
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from torch_world import (WORLD, case_inputs, collective_cases,
                         run_collective_cases, run_world)

CASES = collective_cases()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_collective_cases, tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(jax.devices()[:WORLD])


def _jax_verb(jmesh, verb, kw, x):
    def f(xl):
        out = JC.barrier() if verb == "barrier" else getattr(JC, verb)(
            xl[0], **kw)
        return out[None]

    fn = jax.jit(jmesh.shard_map(f, in_specs=(jmesh.spec(0),),
                                 out_specs=jmesh.spec(0)))
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_verb_matches_reference(world, jmesh, idx):
    cid, verb, kw, kind, shape = CASES[idx]
    ref = _jax_verb(jmesh, verb, kw, case_inputs(idx, kind, shape))
    got = np.stack([w[cid] for w in world])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    exact = (kind in ("int32", "bool", "bits", None)
             or verb in ("allgather", "broadcast", "pull")
             or kw.get("op") in ("max", "min"))
    if kind == "bits":
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    elif exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


def test_push_rejects_an_indivisible_scatter_dim(world):
    assert all("divisible by the worker count 4" in w["push-indivisible"]
               for w in world)


def test_verbs_take_trees_and_record_bytes_per_call(world):
    for w in world:
        ones, n = w["tree-allreduce"]
        np.testing.assert_array_equal(ones, np.full((4, 2), 4.0, np.float32))
        np.testing.assert_array_equal(n, np.full(3, 4, np.int32))
        by_verb = {v["verb"]: v["payload_bytes"] for v in w["ledger"]["verbs"]}
        # per-worker payloads: (4x2 f32 + 3 int32), push 8x2 f32, pull 2x2
        assert by_verb == {"allreduce": 32 + 12, "push": 64, "pull": 16}
        assert w["ledger"]["executions"] == 1


def test_one_worker_verbs_are_the_identity():
    """With no process group, every verb returns its input's values (and a
    copy, never the input itself), and still records its bytes."""
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    with telemetry.scope():
        for out in (C.allreduce(x), C.allreduce(x, "max"),
                    C.allreduce(x, C.Combiner.MULTIPLY), C.allgather(x),
                    C.broadcast(x), C.reduce(x), C.push(x), C.pull(x)):
            assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
        assert telemetry.ledger.volume() == 8 * 48
    assert C.barrier().item() == 0
    b = torch.tensor([True, False])
    assert C.allreduce(b).dtype == torch.bool
    # AVG divides like pmean: an integer input averages to float32
    assert C.allreduce(torch.tensor([3], dtype=torch.int32), "avg").dtype == \
        torch.float32


def test_telemetry_off_records_nothing():
    telemetry.ledger.reset()
    C.allreduce(torch.ones(3))
    assert telemetry.ledger.volume() == 0


def test_quantize_to_int8_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 9)) * rng.uniform(0.01, 30, 9)).astype(
        np.float32)
    x[3, 2] = 0.0
    for amax in (np.abs(x).max(0), np.abs(x).max(1, keepdims=True),
                 np.float32(np.abs(x).max())):
        q, s = C.quantize_to_int8(torch.from_numpy(x), torch.tensor(amax))
        qj, sj = JC.quantize_to_int8(jnp.asarray(x), jnp.asarray(amax))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("name", ["add", "max", "min", "avg", "multiply"])
def test_combiner_names_match_reference(name):
    assert C.Combiner(name).name == JC.Combiner(name).name
    assert C._as_combiner(name.upper()) is C.Combiner(name)


def test_worker_mesh_shards_contiguous_blocks():
    mesh = WorkerMesh("cpu")
    assert (mesh.num_workers, mesh.rank) == (1, 0)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(mesh.shard_array(x).numpy(), x)
    assert mesh.replicated(x).device.type == "cpu"


def test_current_mesh_follows_set_and_use():
    a, b = WorkerMesh("cpu"), WorkerMesh("cpu")
    M.set_mesh(a)
    try:
        assert M.current_mesh() is a and M.is_master()
        with M.use_mesh(b):
            assert M.current_mesh() is b
        assert M.current_mesh() is a
    finally:
        M.set_mesh(None)
