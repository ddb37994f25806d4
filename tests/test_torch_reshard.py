"""The port's ``reshard`` (every lowering), ``reshard_reference``,
``match_reshard_rules`` and ``allreduce_hier`` against harp_tpu's, on one
and four workers.

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
from torch_world import (HIER_SIZES, PAIR_SPECS, RESHARD_WIRES, WIRE_PAIRS,
                         WORLD, hier_inputs, pair_block, pair_global,
                         reshard_inputs, reshard_tree, run_reshard_cases,
                         run_world)

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
    """Every pair is ported now (the name is kept from when two raised):
    the wire and chunk checks, and the reference's decision table."""
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="wire"):
        C.reshard(x, C.ShardSpec.blocked(0), C.ShardSpec.replicated(),
                  wire="f16")
    with pytest.raises(ValueError, match="n_chunks"):
        C.reshard(x, C.ShardSpec.blocked(0), C.ShardSpec.replicated(),
                  n_chunks=0)
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


# ---- every lowering ----------------------------------------------------------------

def _jspec(name):
    d, s = PAIR_SPECS[name]
    return JC.ShardSpec.replicated() if d is None else JC.ShardSpec.blocked(
        d, s)


def _ref_pair(jm, g, a, b, wire="exact", extra=False):
    """The reference's reshard (and reshard_reference) of each worker's
    view ``a`` of the global ``g`` into layout ``b``: [workers, ...]."""
    nw = jm.num_workers
    views = np.stack([pair_block(g, PAIR_SPECS[a], r, nw)
                      for r in range(nw)])

    def fn(v):
        y = v[0]
        out = [JC.reshard(y, _jspec(a), _jspec(b), wire=wire)[None]]
        if extra:
            out.append(JC.reshard_reference(y, _jspec(a), _jspec(b))[None])
        return out

    f = jax.jit(jm.shard_map(fn, in_specs=(jm.spec(0),),
                             out_specs=[jm.spec(0)] * (1 + extra)))
    return [np.asarray(r) for r in f(jnp.asarray(views))]


PAIRS = [(a, b) for a in PAIR_SPECS for b in PAIR_SPECS]


@pytest.mark.parametrize("a,b", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_every_pair_is_bit_equal_to_the_reference(world, jmesh, a, b):
    ref, ref_naive = _ref_pair(jmesh, pair_global(), a, b, extra=True)
    got = np.stack([w[f"pair-{a}-{b}"][0] for w in world])
    naive = np.stack([w[f"pair-{a}-{b}"][1] for w in world])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(naive, ref_naive)
    np.testing.assert_array_equal(got, naive)
    # and the layout is right: worker r holds its block of the array
    want = np.stack([pair_block(pair_global(), PAIR_SPECS[b], r, WORLD)
                     for r in range(WORLD)])
    np.testing.assert_array_equal(got, want)


WIRE_CASES = [(w, a, b) for w in ("bf16", "int8") for a, b in WIRE_PAIRS]


@pytest.mark.parametrize("wire,a,b", WIRE_CASES,
                         ids=[f"{w}-{a}-{b}" for w, a, b in WIRE_CASES])
def test_narrow_wires_round_once_on_every_lowering(world, jmesh, wire, a, b):
    """bf16 and int8 on the rotation, all-to-all, gather and fallback
    lowerings: bit-equal to the reference (int8 within an ulp of its
    dequantization), within one rounding of the exact move; the int leaf
    rides exact; the local slice does not round."""
    g = pair_global(kind="normal")
    (ref,) = _ref_pair(jmesh, g, a, b, wire)
    got = np.stack([w[f"wire-{wire}-{a}-{b}"][0] for w in world])
    exact = np.stack([pair_block(g, PAIR_SPECS[b], r, WORLD)
                      for r in range(WORLD)])
    if PAIR_SPECS[a][0] is None:  # replicated -> blocked: a local slice
        np.testing.assert_array_equal(got, exact)
    else:
        assert (np.abs(got - exact) <= _bound(exact if wire == "bf16" else g,
                                              wire)).all()
    if wire == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    ints = np.stack([w[f"wire-{wire}-{a}-{b}"][1] for w in world])
    np.testing.assert_array_equal(ints, exact.astype(np.int32))


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_chunked_rotation_equals_one_hop(world, jmesh, wire):
    for w in world:
        for n_chunks in (2, 4):
            np.testing.assert_array_equal(w[f"chunks-{wire}-{n_chunks}"],
                                          w[f"chunks-{wire}-1"])
    (ref,) = _ref_pair(jmesh, pair_global(kind="normal"), "S0", "S0s1", wire)
    got = np.stack([w[f"chunks-{wire}-2"] for w in world])
    if wire == "exact":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_lowering_errors_name_their_cause(world):
    err = world[0]["errors"]
    assert "does not divide" in err["n_chunks-3"]
    assert "ring rotations only" in err["n_chunks-gather"]
    assert "out of range" in err["out-of-range"]
    assert "does not split" in err["indivisible"]
    assert "must divide" in err["hier-3"]


def test_chunked_and_narrow_ledger_records_follow_the_reference(world):
    """A worker's [8, 4] f32 block of a rotation: the exact hop records the
    block, a 4-chunk pipeline one chunk (the reference's record of one
    hop), int8 one byte and bf16 two bytes an element."""
    per = 8 * WORLD * 4  # [8, 4] f32 rows of the [32, 4] array
    for w in world:
        led = w["ledger-pairs"]

        def rec(tag):
            (r,) = led[tag]["verbs"]
            assert r["verb"] == "reshard" and r["calls"] == 1
            return r["payload_bytes"]

        assert rec("probe-") == per
        assert rec("probe-n_chunks4") == per // 4
        assert rec("probe-wireint8") == per // 4
        assert rec("probe-wirebf16") == per // 2


# ---- allreduce_hier ----------------------------------------------------------------

def _ref_hier(jm, gs):
    inp = hier_inputs(jm.num_workers)

    def fn(t):
        out = JC.allreduce_hier({k: v[0] for k, v in t.items()},
                                group_size=gs)
        return {k: v[None] for k, v in out.items()}

    spec = {k: jm.spec(0) for k in inp}
    f = jax.jit(jm.shard_map(fn, in_specs=(spec,), out_specs=spec))
    return {k: np.asarray(v) for k, v in f({k: jnp.asarray(v)
                                            for k, v in inp.items()}).items()}


@pytest.mark.parametrize("gs", HIER_SIZES, ids=[str(g) for g in HIER_SIZES])
def test_allreduce_hier_is_exact_on_ints_for_every_group(world, jmesh, gs):
    inp = hier_inputs()
    ref = _ref_hier(jmesh, gs)
    for r, w in enumerate(world):
        got = w[f"hier-{gs}"]
        np.testing.assert_array_equal(got["i"], inp["i"].sum(0))
        np.testing.assert_array_equal(got["i"], ref["i"][r])
        np.testing.assert_array_equal(got["b"], inp["b"].any(0))
        assert got["b"].dtype == np.bool_
        np.testing.assert_allclose(got["f"], w["hier-oneshot"]["f"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["f"], ref["f"][r], rtol=1e-6,
                                   atol=1e-6)


def test_allreduce_hier_records_both_stages(world):
    """Two stages of the whole tree under ``allreduce_hier``, a degenerate
    split (1 or 4) included: twice the tree's bytes a call."""
    tree = hier_inputs()
    once = sum(a[0].nbytes for a in tree.values())
    for w in world:
        for gs in HIER_SIZES:
            (rec,) = w["ledger-pairs"][f"hier-{gs}"]["verbs"]
            assert rec["verb"] == "allreduce_hier" and rec["calls"] == 1
            assert rec["payload_bytes"] == 2 * once
            assert rec["combiner"] == "add" and rec["leaves"] == 6


def test_allreduce_hier_on_one_worker_and_its_checks():
    x = {"a": torch.arange(5), "b": torch.tensor([True, False])}
    for gs in (None, 1):
        got = C.allreduce_hier(x, group_size=gs)
        assert torch.equal(got["a"], x["a"]) and got["b"].dtype == torch.bool
    with pytest.raises(ValueError, match="must divide"):
        C.allreduce_hier(x, group_size=2)
    with pytest.raises(ValueError, match="must divide"):
        C.allreduce_hier(x, group_size=0)


# ---- match_reshard_rules, one worker ---------------------------------------------

def test_match_reshard_rules_matches_reference():
    tree = {"model": {"W": np.zeros((8, 4)), "H": np.zeros((8, 4))},
            "lr": np.float32(0.1), "step": np.zeros(()),
            "opt": [np.zeros((4, 2)), np.zeros((1,))]}
    rules = [("model/W", (0, 0)), ("model/H", (0, 1)), ("opt/0", (1, 0)),
             (".*", (None, 0))]

    def spec(lib, d, s):
        return lib.ShardSpec.replicated() if d is None else \
            lib.ShardSpec.blocked(d, s)

    got = C.match_reshard_rules([(r, spec(C, *a)) for r, a in rules], tree)
    ref = JC.match_reshard_rules([(r, spec(JC, *a)) for r, a in rules], tree)
    assert got["model"]["W"] == C.ShardSpec.blocked(0)
    assert got["model"]["H"] == C.ShardSpec.blocked(0, 1)
    assert got["lr"] == got["step"] == got["opt"][1] == C.ShardSpec.replicated()
    flat = telemetry.tree_leaves(got)
    rflat = jax.tree.leaves(ref, is_leaf=lambda s: isinstance(s, JC.ShardSpec))
    assert [(s.dim, s.shift) for s in flat] == [(s.dim, s.shift)
                                                for s in rflat]
    with pytest.raises(ValueError, match="no reshard rule"):
        C.match_reshard_rules([("W", C.ShardSpec.blocked(0))],
                              {"other": np.zeros((4, 4))})


def test_rule_matched_tree_reshards_each_leaf(jmesh1):
    """A spec tree from the rules moves each leaf by its own lowering in
    one call; on one worker every move is the identity or a copy."""
    tree = {"W": torch.arange(8.0).reshape(8, 1),
            "H": torch.arange(4.0).reshape(4, 1)}
    src = C.match_reshard_rules([("W|H", C.ShardSpec.blocked(0))], tree)
    dst = C.match_reshard_rules([("W", C.ShardSpec.blocked(0, 1)),
                                 ("H", C.ShardSpec.replicated())], tree)
    with telemetry.scope():
        with telemetry.ledger.run("t"):
            out = C.reshard(tree, src, dst)
        (rec,) = telemetry.ledger.summary()["t"]["verbs"]
    assert torch.equal(out["W"], tree["W"]) and torch.equal(out["H"],
                                                            tree["H"])
    assert rec["payload_bytes"] == 4 * 4  # H gathers; W's shift is 0 mod 1
