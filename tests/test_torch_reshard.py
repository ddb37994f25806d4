"""The port's ``reshard`` (identity and blocked → replicated) against
harp_tpu's, on one and four workers.

Four workers run as one spawned gloo world against a four-device mesh; one
worker runs in this process against a one-device mesh.  The exact wire
moves bytes, so it is bit-equal; bf16 is one deterministic cast each way,
so it is bit-equal too; the int8 wire is held within the reference's
one-rounding bound (|max| / 254 an element) and within an ulp of the
reference (the two dequantize ``q · scale`` in their own way).  The
CommLedger holds one ``reshard`` record a call, at the reference's own
byte count of the moving leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.parallel import collective as JC
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils.telemetry import _tree_wire_bytes
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.utils import telemetry
from torch_world import (RESHARD_WIRES, WORLD, reshard_inputs, reshard_tree,
                         run_reshard_cases, run_world)

INPUTS = reshard_inputs()
WIRE_DTYPES = {"exact": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_reshard_cases, tmp_path_factory.mktemp("reshard"))


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


def _spmd(jm, fn, tree):
    spec = jax.tree.map(lambda _: jm.spec(0), tree)
    f = jax.jit(jm.shard_map(
        lambda t: jax.tree.map(lambda y: y[None],
                               fn(jax.tree.map(lambda y: y[0], t))),
        in_specs=(spec,), out_specs=jm.spec(0)))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, tree)))


def _ref(jm, leaves, src, dst, wire="exact"):
    """The reference's reshard of the case tree, per worker, as f32."""
    def fn(t):
        tree = reshard_tree(jnp, dict(zip(("x", "lab", "m", "ids", "h"), t)),
                            jnp.bfloat16)
        return [y.astype(jnp.float32) if jnp.issubdtype(y.dtype, jnp.floating)
                else y for y in JC.reshard(tree, src, dst, wire=wire)]
    return _spmd(jm, fn, tuple(leaves[k] for k in ("x", "lab", "m", "ids",
                                                   "h")))


def _truth(leaves, key, shift=0):
    """What blocked(0) → replicated must give: the workers' blocks joined,
    rolled back by the source's shift."""
    full = np.concatenate(list(leaves[key]), axis=0)
    return np.roll(full, -shift * leaves[key].shape[1], axis=0)


def _bound(x, wire):
    if wire == "bf16":
        return 2.0 ** -8 * np.abs(x) + 1e-30
    return np.abs(x).max() / 254.0 * (1 + 1e-6)


def _moving_bytes(wire):
    tree = (INPUTS["x"][0], INPUTS["lab"][0], INPUTS["m"][0],
            INPUTS["ids"][0], np.asarray(jnp.asarray(INPUTS["h"][0]).astype(
                jnp.bfloat16)))
    return _tree_wire_bytes(tree, WIRE_DTYPES[wire])[0]


@pytest.mark.parametrize("wire", RESHARD_WIRES)
def test_blocked_to_replicated_matches_reference(world, jmesh, wire):
    ref = _ref(jmesh, INPUTS, JC.ShardSpec.blocked(0),
               JC.ShardSpec.replicated(), wire)
    for i, key in enumerate(("x", "lab", "m", "ids", "h")):
        got = np.stack([w[wire][i] for w in world])
        truth = np.stack([_truth(INPUTS, key)] * WORLD)
        if key == "h":  # a bf16 leaf: its own rounding first
            truth = np.asarray(jnp.asarray(truth).astype(jnp.bfloat16)
                               .astype(jnp.float32))
        if wire == "exact" or key == "ids":
            np.testing.assert_array_equal(got, truth)
            np.testing.assert_array_equal(got, ref[i])
        elif wire == "bf16":
            np.testing.assert_array_equal(got, ref[i])
            assert (np.abs(got - truth) <= _bound(truth, wire)).all(), key
        else:
            bound = _bound(truth, wire) + (2.0 ** -8 * np.abs(truth)
                                           if key == "h" else 0)
            assert (np.abs(got - truth) <= bound).all(), key
            np.testing.assert_allclose(got, ref[i], rtol=2.0 ** -8 if
                                       key == "h" else 1e-6)


def test_shifted_source_rolls_back(world, jmesh):
    ref = _ref(jmesh, INPUTS, JC.ShardSpec.blocked(0, shift=1),
               JC.ShardSpec.replicated())
    for i, key in enumerate(("x", "lab", "m", "ids")):
        got = np.stack([w["shift"][i] for w in world])
        np.testing.assert_array_equal(got, ref[i])
        np.testing.assert_array_equal(got[0], _truth(INPUTS, key, shift=1))


def test_blocked_dim1_on_int8_matches_reference(world, jmesh):
    def fn(t):
        return JC.reshard(t, (JC.ShardSpec.blocked(1), JC.ShardSpec.blocked(0)),
                          JC.ShardSpec.replicated(), wire="int8")
    ref = _spmd(jmesh, fn, (INPUTS["col"], INPUTS["x"]))
    for i in range(2):
        got = np.stack([w["dim1"][i] for w in world])
        np.testing.assert_allclose(got, ref[i], rtol=1e-6)
    want = np.concatenate(list(INPUTS["col"]), axis=1)
    assert np.abs(world[0]["dim1"][0] - want).max() <= _bound(want, "int8")


def test_ledger_records_one_reshard_at_the_wire_width(world):
    for w in world:
        led = w["ledger"]
        for wire in RESHARD_WIRES:
            (rec,) = led[wire]["verbs"]
            assert rec["verb"] == "reshard" and rec["calls"] == 1
            assert rec["wire_dtype"] == {"exact": None, "bf16": "bfloat16",
                                         "int8": "int8"}[wire]
            assert rec["payload_bytes"] == _moving_bytes(wire)
        # x f32 [3, 4], lab and m f32 [3], ids int32 [3], h bf16 [2, 3]
        assert led["exact"]["verbs"][0]["payload_bytes"] == 48 + 12 + 12 + \
            12 + 12
        assert led["identity"]["verbs"] == []  # equal layouts move nothing
        assert w["identity"]


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- one worker ---------------------------------------------------------------

def _one_worker(wire):
    leaves = {k: torch.from_numpy(a[0].copy()) for k, a in INPUTS.items()}
    tree = reshard_tree(None, leaves, torch.bfloat16)
    with telemetry.scope():
        with telemetry.ledger.run("r"):
            got = C.reshard(tree, C.ShardSpec.blocked(0),
                            C.ShardSpec.replicated(), wire=wire)
        led = telemetry.ledger.summary()["r"]["verbs"]
    return [x.to(torch.float32).numpy() if x.is_floating_point()
            else x.numpy() for x in got], led


@pytest.mark.parametrize("wire", RESHARD_WIRES)
def test_one_worker_gather_still_rounds_and_records(jmesh1, wire):
    """The reference plans blocked → replicated as a "gather" on one worker
    too, so a narrow wire rounds and records there (unlike the ring hop,
    which moves nothing on one worker)."""
    got, led = _one_worker(wire)
    ref = _ref(jmesh1, {k: a[:1] for k, a in INPUTS.items()},
               JC.ShardSpec.blocked(0), JC.ShardSpec.replicated(), wire)
    (rec,) = led
    assert rec["verb"] == "reshard" and rec["calls"] == 1
    assert rec["payload_bytes"] == _moving_bytes(wire)
    x = INPUTS["x"][0]
    if wire == "exact":
        np.testing.assert_array_equal(got[0], x)
    else:
        assert not np.array_equal(got[0], x)
        assert (np.abs(got[0] - x) <= _bound(x, wire)).all()
    for i in range(4):
        np.testing.assert_allclose(got[i], ref[i][0], rtol=1e-6)


def test_unported_pairs_raise_and_wires_are_checked():
    x = torch.zeros(4, 2)
    with pytest.raises(NotImplementedError, match="item 1"):
        C.reshard(x, C.ShardSpec.replicated(), C.ShardSpec.blocked(0))
    with pytest.raises(NotImplementedError, match="item 1"):
        C.reshard(x, C.ShardSpec.blocked(0), C.ShardSpec.blocked(1))
    with pytest.raises(ValueError, match="wire"):
        C.reshard(x, C.ShardSpec.blocked(0), C.ShardSpec.replicated(),
                  wire="f16")
    with pytest.raises(ValueError, match="ring shift"):
        C.ShardSpec(dim=None, shift=1)
    assert C.reshard(x, C.ShardSpec.blocked(0), C.ShardSpec.blocked(0)) is x
    assert C.RESHARD_WIRES == JC.RESHARD_WIRES
    # the decision table is the reference's, pair by pair
    specs = [C.ShardSpec.replicated()] + [C.ShardSpec.blocked(d, s)
                                          for d in (0, 1) for s in (0, 1, 5)]
    jspecs = [JC.ShardSpec(dim=s.dim, shift=s.shift) for s in specs]
    for n in (1, 4):
        for a, ja in zip(specs, jspecs):
            for b, jb in zip(specs, jspecs):
                assert C._reshard_plan(a, b, n) == JC._reshard_plan(ja, jb, n)
