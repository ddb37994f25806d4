"""The port's ``regroup`` verb, ``bucket_by_destination`` and expert-
parallel MoE against harp_tpu's, on one and on four workers.

``regroup`` and ``rotate`` move bytes, so their values and gradients are
compared bit for bit with the reference's ``all_to_all`` and ``ppermute``
on a 4-device CPU mesh; their CommLedger bytes against sheets computed by
hand.  ``bucket_by_destination`` is exact.  ``moe_ffn`` is held to the
reference's own tolerance against ``reference_moe`` (rtol 2e-4 / atol
2e-5, f32 products in another order), and its drop count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from harp_tpu.ops.moe import moe_ffn as j_moe_ffn
from harp_tpu.ops.moe import reference_moe as j_reference_moe
from harp_tpu.parallel import collective as JC
from harp_tpu.parallel.dispatch import bucket_by_destination as j_bucket
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.convert import moe_params_from_numpy
from harp_tpu_torch.ops.moe import moe_ffn, reference_moe
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.dispatch import bucket_by_destination
from harp_tpu_torch.utils import telemetry
from torch_world import (MOE_CASES, MOE_TOKENS, REGROUP_CASES, WORLD,
                         moe_weights, regroup_inputs, run_moe_cases,
                         run_world)

INPUTS = regroup_inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_moe_cases, tmp_path_factory.mktemp("moe"))


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(jax.devices()[:WORLD])


def _spmd(jm, fn, *stacked):
    """``fn`` on every worker's block of the stacked [workers, ...] inputs;
    returns the stacked per-worker results."""
    spec = jm.spec(0)
    f = jax.jit(jm.shard_map(
        lambda *t: fn(*(y[0] for y in t))[None],
        in_specs=(spec,) * len(stacked), out_specs=spec))
    return np.asarray(f(*(jnp.asarray(a) for a in stacked)))


# ---- regroup ---------------------------------------------------------------

@pytest.mark.parametrize("cid,split,concat,dt", REGROUP_CASES,
                         ids=[c[0] for c in REGROUP_CASES])
def test_regroup_matches_the_reference_bit_for_bit(world, jmesh, cid, split,
                                                   concat, dt):
    ref = _spmd(jmesh, lambda x: JC.regroup(x, split_dim=split,
                                            concat_dim=concat), INPUTS[dt])
    got = np.stack([w[cid] for w in world])
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_regroup_and_rotate_gradients_match_the_reference(world, jmesh):
    x, cot = INPUTS["float32"], INPUTS["cot"]

    def regroup_grad(x, c):
        return jax.grad(lambda x: (JC.regroup(x, split_dim=0, concat_dim=1)
                                   * c).sum())(x)

    def rotate_grad(x):
        return jax.grad(lambda y: (JC.rotate(y, 1) * x).sum())(x)

    np.testing.assert_array_equal(
        np.stack([w["grad-regroup"] for w in world]),
        _spmd(jmesh, regroup_grad, x, cot))
    np.testing.assert_array_equal(
        np.stack([w["grad-rotate"] for w in world]),
        _spmd(jmesh, rotate_grad, x))


def test_regroup_ledger_is_the_hand_sheet(world):
    # a tuple of [4, 8, 3] f32 (384 B) and [8, 3] int32 (96 B), then the
    # f32 leaf again: two calls
    for w in world:
        led = w["ledger"]
        (rec,) = led["verbs"]
        assert rec["verb"] == "regroup" and rec["calls"] == 2
        assert rec["payload_bytes"] == (384 + 96) + 384


def test_regroup_on_one_worker_is_a_copy_and_still_records():
    x = torch.from_numpy(INPUTS["float32"][0].copy())
    with telemetry.scope():
        with telemetry.ledger.run("one"):
            y = C.regroup(x, split_dim=1, concat_dim=0)
            z = C.regroup((x, x.to(torch.bool)), split_dim=0)
        led = telemetry.ledger.summary()["one"]
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(z[1], x.to(torch.bool))
    (rec,) = led["verbs"]
    assert rec["calls"] == 2 and rec["payload_bytes"] == 384 + 384 + 96


def test_regroup_rejects_an_indivisible_split(monkeypatch):
    # the check runs before any exchange, so a stand-in world size reaches
    # it in this one process
    monkeypatch.setattr(C, "num_workers", lambda: 4)
    with pytest.raises(ValueError, match="divisible by the worker count 4"):
        C.regroup(torch.zeros(6, 2), split_dim=0)


# ---- bucket_by_destination ---------------------------------------------------

def _both(dest, payloads, capacity, n_dest, valid=None):
    j = j_bucket(jnp.asarray(dest), tuple(jnp.asarray(p) for p in payloads),
                 capacity, n_dest,
                 None if valid is None else jnp.asarray(valid))
    t = bucket_by_destination(
        torch.from_numpy(np.asarray(dest)),
        tuple(torch.from_numpy(np.asarray(p)) for p in payloads), capacity,
        n_dest, None if valid is None else torch.from_numpy(valid))
    for a, b in zip(j[0], t[0]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(j[1:], t[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return t


def test_bucketing_places_items_in_order():
    (buf,), keep, _, dropped = _both(np.array([1, 0, 1, 1, 0]),
                                     (np.array([10., 20, 30, 40, 50],
                                               np.float32),), 3, 2)
    assert int(dropped) == 0 and bool(keep.all())
    np.testing.assert_array_equal(buf[0].numpy(), [20, 50, 0])


def test_bucketing_drops_over_capacity_via_trash_slot():
    (buf,), keep, slot, dropped = _both(np.zeros(5, np.int32),
                                        (np.arange(1, 6, dtype=np.float32),),
                                        2, 2)
    assert int(dropped) == 3 and dropped.dtype == torch.int32
    np.testing.assert_array_equal(slot[2:].numpy(), [2, 2, 2])
    np.testing.assert_array_equal(buf[1].numpy(), [0, 0])


def test_bucketing_multi_payload_and_trailing_dims():
    (ba, bb), _, _, dropped = _both(
        np.array([0, 1]), (np.array([[1., 2], [3, 4]], np.float32),
                           np.array([7, 9], np.int32)), 1, 2)
    assert int(dropped) == 0 and bb.dtype == torch.int32


def test_invalid_items_take_no_slot_and_are_not_dropped():
    valid = np.array([True, False, True, True, False, True])
    (buf,), keep, slot, dropped = _both(
        np.array([0, 0, 0, 1, 1, 0]), (np.arange(6, dtype=np.float32),), 2,
        2, valid)
    assert int(dropped) == 1  # item 5: the third valid item for 0
    np.testing.assert_array_equal(buf[0].numpy(), [0, 2])


# ---- moe_ffn -----------------------------------------------------------------

def _reference_run(jm, w, capacity):
    fn = jax.jit(jm.shard_map(
        lambda xx, wt: j_moe_ffn(xx, wt["gate"], wt["w1"][0], wt["b1"][0],
                                 wt["w2"][0], wt["b2"][0], capacity=capacity),
        in_specs=(jm.spec(0), {"gate": P(), "w1": jm.spec(0),
                               "b1": jm.spec(0), "w2": jm.spec(0),
                               "b2": jm.spec(0)}),
        out_specs=(jm.spec(0), P())))
    y, dropped = fn(w["x"], {k: w[k] for k in ("gate", "w1", "b1", "w2",
                                               "b2")})
    return np.asarray(y), int(dropped)


@pytest.mark.parametrize("cid,make,capacity", MOE_CASES,
                         ids=[c[0] for c in MOE_CASES])
def test_moe_matches_the_reference_on_four_workers(world, jmesh, cid, make,
                                                   capacity):
    w = make()
    y = np.concatenate([r[cid]["y"] for r in world])
    ref_y, ref_dropped = _reference_run(jmesh, w, capacity)
    np.testing.assert_allclose(y, ref_y, rtol=2e-4, atol=2e-5)
    host = j_reference_moe(w["x"], w["gate"], w["w1"], w["b1"], w["w2"],
                           w["b2"], capacity, WORLD)
    np.testing.assert_allclose(y, host, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        reference_moe(w["x"], w["gate"], w["w1"], w["b1"], w["w2"], w["b2"],
                      capacity, WORLD), host, rtol=2e-4, atol=2e-5)
    assert all(r[cid]["dropped"] == ref_dropped for r in world)
    if capacity >= MOE_TOKENS:
        assert ref_dropped == 0
    if cid.startswith("forced"):  # each worker keeps `capacity` of 16
        assert ref_dropped == WORLD * (MOE_TOKENS - capacity)
        assert (~(y == 0).all(-1)).sum() == WORLD * capacity


def test_moe_on_one_worker_matches_the_reference():
    w = moe_weights(2, n_experts=1)
    p = moe_params_from_numpy(w, "cpu", expert=0)
    x = w["x"][:MOE_TOKENS]
    y, dropped = moe_ffn(torch.from_numpy(x), p["gate"], p["w1"], p["b1"],
                         p["w2"], p["b2"], capacity=MOE_TOKENS)
    host = j_reference_moe(x, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"],
                           MOE_TOKENS, 1)
    np.testing.assert_allclose(y.numpy(), host, rtol=2e-4, atol=2e-5)
    assert int(dropped) == 0


def test_moe_rejects_a_gate_for_another_expert_count():
    w = moe_weights(0)
    p = moe_params_from_numpy(w, "cpu", expert=0)
    with pytest.raises(ValueError, match="one expert per worker"):
        moe_ffn(torch.from_numpy(w["x"][:MOE_TOKENS]), p["gate"], p["w1"],
                p["b1"], p["w2"], p["b2"], capacity=4)


def test_moe_params_check_their_shapes():
    w = moe_weights(0)
    w["b2"] = w["b2"][:, :3]
    with pytest.raises(ValueError, match="b2"):
        moe_params_from_numpy(w, "cpu")


def test_nothing_in_the_world_imported_jax(world):
    assert not any(w["_jax_imported"] for w in world)
