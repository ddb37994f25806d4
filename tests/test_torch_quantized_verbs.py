"""The port's quantized verbs (``allreduce_quantized``, ``push_quantized``,
``regroup_quantized`` and ``rotate_quantized``) against harp_tpu's, on one
and four workers.

Four workers run as one spawned gloo world against a four-device mesh; one
worker runs in this process.  The moving verbs round once: bf16 is one cast
each way and int8 quantizes against a |max| shared by the workers, so both
are bit-equal to the reference.  The reducing verbs are held to the
reference's own bounds (``tests/test_collective.py``): int8 rounds each
contribution once and sums exactly, so it is bit-equal too; bf16 sums in
bf16, in gloo's order, within rtol 2e-2 / atol 2e-2 of the exact sum.
Int leaves are exact and bool stays bool on every wire; an unknown wire
raises; the CommLedger holds one record a call at the wire's width.
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
from torch_world import (WORLD, as_numpy, quantized_cases, quantized_inputs,
                         quantized_tree, run_quantized_cases, run_world)

CASES = quantized_cases()
WIRES = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_quantized_cases, tmp_path_factory.mktemp("quant"))


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


def _wire(cid):
    return "bf16" if cid.endswith("bf16") else "int8"


def _reference(jm, cid, verb, kw, names, inputs):
    """The reference's verb on every worker's tree: [workers, ...] arrays,
    bf16 widened to f32."""
    jwire = WIRES[_wire(cid)][0]

    def fn(t):
        tree = quantized_tree(jnp, dict(zip(names, (y[0] for y in t))),
                              names, jnp.bfloat16)
        out = getattr(JC, verb)(tree, wire_dtype=jwire, **kw)
        return [(y.astype(jnp.float32) if y.dtype == jnp.bfloat16 else y)[None]
                for y in out]

    f = jax.jit(jm.shard_map(fn, in_specs=([jm.spec(0)] * len(names),),
                             out_specs=[jm.spec(0)] * len(names)))
    return [np.asarray(y) for y in f([jnp.asarray(inputs[k])
                                      for k in names])]


def _truth(verb, kw, names, inputs, nw):
    """What the exact verb gives each worker: [workers, ...] per leaf."""
    out = []
    for k in names:
        x = inputs[k].astype(np.float32) if k == "h" else inputs[k]
        if verb == "allreduce_quantized":
            s = x.sum(0) if x.dtype != bool else x.any(0)
            out.append(np.stack([s] * nw))
        elif verb == "push_quantized":
            sd = kw.get("scatter_dim", 0)
            s = x.sum(0) if x.dtype != bool else x.any(0)
            out.append(np.stack(np.split(s, nw, axis=sd)))
        else:
            out.append(None)  # moving verbs: checked against the reference
    return out


def _check(cid, verb, kw, names, got, ref, truth, nw):
    for i, k in enumerate(names):
        g, r = got[i], ref[i]
        assert g.shape == r.shape and g.dtype == r.dtype, (cid, k)
        if k in ("i", "b") or verb in ("regroup_quantized",
                                       "rotate_quantized") \
                or _wire(cid) == "int8":
            np.testing.assert_array_equal(g, r, err_msg=f"{cid} {k}")
        else:  # bf16 sums: the reference's bound against the exact sum
            np.testing.assert_allclose(g, truth[i], rtol=2e-2, atol=2e-2,
                                       err_msg=f"{cid} {k}")
            np.testing.assert_allclose(r, truth[i], rtol=2e-2, atol=2e-2)
        if truth[i] is not None and _wire(cid) == "int8" and k == "x":
            x = quantized_inputs(nw)[k]
            tol = nw * np.abs(x).max() / 127.0 / 2 + 1e-6
            assert np.abs(g - truth[i]).max() <= tol, cid


@pytest.mark.parametrize("cid,verb,kw,names", CASES,
                         ids=[c[0] for c in CASES])
def test_four_workers_match_reference(world, jmesh4, cid, verb, kw, names):
    inputs = quantized_inputs()
    got = [np.stack([w[cid][i] for w in world]) for i in range(len(names))]
    ref = _reference(jmesh4, cid, verb, kw, names, inputs)
    _check(cid, verb, kw, names, got, ref,
           _truth(verb, kw, names, inputs, WORLD), WORLD)
    # int leaves keep their dtype, bool stays bool, bf16 stays bf16
    want = {"x": "torch.float32", "i": "torch.int32", "b": "torch.bool",
            "h": "torch.bfloat16", "c": "torch.float32"}
    for w in world:
        assert w[cid + "/dtypes"] == [want[k] for k in names]


@pytest.mark.parametrize("cid,verb,kw,names", CASES,
                         ids=[c[0] for c in CASES])
def test_one_worker_matches_reference(jmesh1, cid, verb, kw, names):
    """One worker: the narrow wire still rounds (once), as the
    reference's does; the rotation moves nothing but rounds too."""
    inputs = {k: a[:1] for k, a in quantized_inputs(1).items()}
    leaves = {k: torch.from_numpy(a[0].copy()) for k, a in inputs.items()}
    tree = quantized_tree(None, leaves, names, torch.bfloat16)
    out = getattr(C, verb)(tree, wire_dtype=WIRES[_wire(cid)][1], **kw)
    got = [as_numpy(y)[None] for y in out]
    ref = _reference(jmesh1, cid, verb, kw, names, inputs)
    _check(cid, verb, kw, names, got, ref, _truth(verb, kw, names, inputs, 1),
           1)


def test_int8_scales_ride_one_max_allreduce(world):
    for w in world:
        assert w["six-maxes"] == [(6,)]
    ref = quantized_inputs()["six"].sum(0)
    for j, k in enumerate("abcdef"):
        got = world[0]["six"][k]
        tol = WORLD * np.abs(quantized_inputs()["six"][:, j]).max() / 254
        assert np.abs(got - ref[j]).max() <= tol + 1e-6


def test_ledger_bytes_are_the_reference_records_times_the_calls(world):
    """One record a call, the verb's payload at the wire's width (float
    leaves narrow, int and bool at their own width), as the reference's
    runtime CommLedger records it; ADD for the reducing twins."""
    inputs = quantized_inputs()
    for w in world:
        led = w["ledger"]
        for cid, verb, kw, names in CASES:
            tree = quantized_tree(jnp, {k: inputs[k][0] for k in names},
                                  names, jnp.bfloat16)
            want, n_leaves = _tree_wire_bytes(tree, WIRES[_wire(cid)][0])
            (rec,) = led[cid]["verbs"]
            assert rec["verb"] == verb and rec["calls"] == 1
            assert rec["payload_bytes"] == want and rec["leaves"] == n_leaves
            assert rec["wire_dtype"] == {"bf16": "bfloat16",
                                         "int8": "int8"}[_wire(cid)]
            assert rec["combiner"] == ("add" if verb in (
                "allreduce_quantized", "push_quantized") else None)


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


@pytest.mark.parametrize("verb", ["allreduce_quantized", "push_quantized",
                                  "regroup_quantized", "rotate_quantized"])
def test_unknown_wire_raises(verb):
    with pytest.raises(ValueError, match="wire_dtype"):
        getattr(C, verb)(torch.ones(4), wire_dtype=torch.float16)
    with telemetry.scope():  # raises before recording
        with pytest.raises(ValueError, match="wire_dtype"):
            getattr(C, verb)(torch.ones(4), wire_dtype=torch.float16)
        assert telemetry.ledger.summary() == {}


def test_bf16_leaf_on_the_int8_ring_divides_in_f32(jmesh1):
    """A bf16 leaf on an int8 wire quantizes in f32, as the reference's
    type promotion does; in bf16 the division rounds first and ``q``
    moves by one step on some elements."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(1, 512)) * 7).astype(np.float32)
    h = torch.from_numpy(x[0]).to(torch.bfloat16)
    got = C.rotate_quantized(h, 1, wire_dtype=torch.int8)
    ref = _reference(jmesh1, "r-int8", "rotate_quantized", {"shift": 1},
                     ("h",), {"h": x})[0][0]
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref)
    # the ring hop keeps its values on f32 leaves
    xf = torch.from_numpy(x[0])
    np.testing.assert_array_equal(
        C.rotate_quantized(xf, 1, wire_dtype=torch.int8).numpy(),
        _reference(jmesh1, "r-int8", "rotate_quantized", {"shift": 1},
                   ("x",), {"x": x})[0][0])
