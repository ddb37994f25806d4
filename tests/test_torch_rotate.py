"""The port's rotation verbs and pipeline against harp_tpu's, on four
workers.

The port runs in one gloo world of 4 spawned processes; the reference
runs the same per-worker inputs on a 4-device CPU mesh.  Exact wires move
bytes, so their results are bit-equal; the quantized wires round once per
hop, so they are held within the reference's one-rounding bound (bf16:
2^-8 relative; int8: |max|/254 per element and hop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.parallel import collective as JC
from harp_tpu.parallel import rotate as JR
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel import rotate as R
from harp_tpu_torch.utils import telemetry
from torch_world import (PIPELINE_CASES, ROTATE_SHIFTS, WORLD, pipeline_step,
                         rotate_inputs, run_rotate_cases, run_world)

INPUTS = rotate_inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_rotate_cases, tmp_path_factory.mktemp("rot"))


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


def _spmd(jm, fn, tree):
    """Run ``fn`` on every worker's block of the stacked ``tree``
    ([workers, ...] leaves); returns the stacked per-worker results."""
    spec = jax.tree.map(lambda _: jm.spec(0), tree)
    f = jax.jit(jm.shard_map(
        lambda t: jax.tree.map(lambda y: y[None],
                               fn(jax.tree.map(lambda y: y[0], t))),
        in_specs=(spec,), out_specs=jm.spec(0)))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, tree)))


def _stack(world, key):
    return np.stack([w[key] for w in world])


@pytest.mark.parametrize("shift", ROTATE_SHIFTS)
@pytest.mark.parametrize("dt", ["float32", "int32", "bool"])
def test_rotate_matches_reference(world, jmesh, shift, dt):
    ref = _spmd(jmesh, lambda x: JC.rotate(x, shift), INPUTS[dt])
    got = _stack(world, f"rotate-{shift}-{dt}")
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.roll(INPUTS[dt], shift, axis=0))


def _quantized_bound(x, wire):
    if wire == "bf16":
        return 2.0 ** -8 * np.abs(x) + 1e-30
    return np.abs(x).max() / 254.0 * (1 + 1e-6)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_rotate_quantized_matches_reference(world, jmesh, wire):
    wd = {"bf16": jnp.bfloat16, "int8": jnp.int8}[wire]
    tree = {"big": INPUTS["big"], "small": INPUTS["small"],
            "n": INPUTS["int32"]}
    ref = _spmd(jmesh, lambda t: JC.rotate_quantized(t, wire_dtype=wd), tree)
    got = {k: np.stack([w[f"rq-{wire}"][k] for w in world]) for k in tree}
    np.testing.assert_array_equal(got["n"], ref["n"])  # int leaves exact
    for k in ("big", "small"):  # each float leaf has its own scale
        want = np.roll(tree[k], 1, axis=0)
        bound = _quantized_bound(want, wire)
        assert (np.abs(got[k] - want) <= bound).all(), k
        assert (np.abs(got[k] - ref[k]) <= 2 * bound).all(), k


def test_rotate_quantized_int8_negative_shift(world, jmesh):
    x = INPUTS["float32"]
    ref = _spmd(jmesh, lambda v: JC.rotate_quantized(v, shift=-1,
                                                     wire_dtype=jnp.int8), x)
    got = _stack(world, "rq-int8-shift-1")
    bound = _quantized_bound(x, "int8")
    assert np.abs(got - np.roll(x, -1, axis=0)).max() <= bound
    assert np.abs(got - ref).max() <= 2 * bound


@pytest.mark.parametrize("nc,wire", PIPELINE_CASES,
                         ids=[f"chunks{nc}-{w}" for nc, w in PIPELINE_CASES])
def test_rotate_pipeline_matches_reference(world, jmesh, nc, wire):
    step = pipeline_step(jnp, wire)

    def prog(s):
        acc, out = JR.rotate_pipeline(step, jnp.float32(0.0), s,
                                      n_chunks=nc, wire=wire)
        return acc, out

    ref_acc, ref_sl = _spmd(jmesh, prog, INPUTS["slice"])
    got_acc = np.stack([w[f"pipe-{nc}-{wire}"][0] for w in world])
    got_sl = np.stack([w[f"pipe-{nc}-{wire}"][1] for w in world])
    if wire == "exact":
        np.testing.assert_array_equal(got_acc, ref_acc)
        np.testing.assert_array_equal(got_sl, ref_sl)
        return
    # one rounding per hop on each side: at most nc * n hops a chunk
    per_hop = 2.0 ** -8 if wire == "bf16" else 1 / 254.0
    tol = 2 * nc * WORLD * per_hop * np.abs(ref_sl).max()
    assert np.abs(got_sl - ref_sl).max() <= tol
    np.testing.assert_allclose(got_acc, ref_acc, rtol=nc * WORLD * per_hop)


@pytest.mark.parametrize("nc", [1, 2, 4])
def test_resident_chunk_index_names_the_moving_chunk(world, nc):
    """Chunks carry their global id; every step saw the id that
    resident_chunk_index names."""
    assert [w[f"resident-{nc}"] for w in world] == [0.0] * WORLD


@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_resident_chunk_index_formula_matches_reference(jmesh, monkeypatch,
                                                        nc, shift):
    steps = nc * WORLD

    def prog(x):
        return jnp.stack([JR.resident_chunk_index(jnp.int32(t), nc,
                                                  shift=shift)
                          for t in range(steps)]).astype(jnp.int32)

    ref = _spmd(jmesh, prog, np.zeros((WORLD, 1), np.float32))
    monkeypatch.setattr(R, "num_workers", lambda: WORLD)
    for w in range(WORLD):
        monkeypatch.setattr(R, "worker_id", lambda w=w: w)
        got = [R.resident_chunk_index(t, nc, shift=shift)
               for t in range(steps)]
        assert got == ref[w].tolist()


def test_pipeline_ledger_records_reshard_at_wire_width(world):
    """Per worker, two-chunk pipeline over 4 workers: 8 hops of a [4, 3]
    f32 chunk (48 bytes) — at half and a quarter of that on the bf16 and
    int8 wires, under the verb the reference records at these sites."""
    for w in world:
        led = w["ledger"]
        for wire, per_hop in (("exact", 48), ("bf16", 24), ("int8", 12)):
            (rec,) = led[wire]["verbs"]
            assert rec["verb"] == "reshard" and rec["calls"] == 8
            assert rec["wire_dtype"] == {"exact": None, "bf16": "bfloat16",
                                         "int8": "int8"}[wire]
            assert rec["payload_bytes"] == 8 * per_hop
        (rec,) = led["rotate"]["verbs"]
        assert rec["verb"] == "rotate" and rec["payload_bytes"] == 96


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- one worker ---------------------------------------------------------------

def test_one_worker_rotate_is_a_copy():
    x = torch.arange(6, dtype=torch.float32)
    with telemetry.scope():
        y = C.rotate(x, 3)
        assert telemetry.ledger.volume() == 24
    assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_one_worker_rotate_quantized_still_rounds(jmesh1, wire):
    x = INPUTS["big"][:1]
    wd = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}[wire]
    got = C.rotate_quantized(torch.from_numpy(x[0].copy()),
                             wire_dtype=wd[0]).numpy()
    ref = _spmd(jmesh1, lambda v: JC.rotate_quantized(v, wire_dtype=wd[1]),
                x)[0]
    assert not np.array_equal(got, x[0])
    bound = _quantized_bound(x[0], wire)
    assert (np.abs(got - x[0]) <= bound).all()
    if wire == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:  # the two dequantize q · scale in their own way: 1 ulp apart
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("wire", ["exact", "bf16", "int8"])
def test_one_worker_pipeline_hop_moves_nothing(jmesh1, wire):
    """On one worker the reference's hop (a reshard to an equal layout) is
    the identity: no rounding on any wire, nothing on the ledger."""
    step = pipeline_step(jnp, "bf16")
    x = INPUTS["big"][:1, :, None] / 1e3
    ref_acc, ref_sl = _spmd(jmesh1, lambda s: JR.rotate_pipeline(
        step, jnp.float32(0.0), s, n_chunks=2, wire=wire), x)
    with telemetry.scope():
        acc, sl = R.rotate_pipeline(pipeline_step(torch, "bf16"),
                                    torch.zeros(()),
                                    torch.from_numpy(x[0].copy()),
                                    n_chunks=2, wire=wire)
        assert telemetry.ledger.volume() == 0
    np.testing.assert_allclose(sl.numpy(), ref_sl[0], rtol=1e-6)
    np.testing.assert_allclose(acc.numpy(), ref_acc[0], rtol=1e-6)


def test_pipeline_rejects_what_the_reference_rejects(monkeypatch):
    x = torch.zeros(8, 1)
    noop = lambda a, c, t: (a, c)  # noqa: E731
    with pytest.raises(ValueError, match="wire"):
        R.rotate_pipeline(noop, None, x, n_chunks=2, wire="f16")
    with pytest.raises(ValueError, match="split into 3"):
        R.rotate_pipeline(noop, None, x, n_chunks=3)
    with pytest.raises(ValueError, match="n_steps"):
        R.rotate_pipeline(noop, None, x, n_chunks=2, n_steps=2)
    with pytest.raises(ValueError, match="n_chunks"):
        R.rotate_pipeline(noop, None, x, n_chunks=0)
    monkeypatch.setattr(R, "num_workers", lambda: 4)
    for nc in (1, 2):
        with pytest.raises(ValueError, match="shares a factor"):
            R.rotate_pipeline(noop, None, x, n_chunks=nc, shift=2)
    with pytest.raises(ValueError, match="wire_dtype"):
        C.rotate_quantized(x, wire_dtype=torch.float16)


def test_pipeline_takes_trees_and_an_explicit_step_count():
    tree = {"a": torch.arange(8.0)[:, None], "b": torch.arange(8)[:, None]}
    seen = []

    def step(c, chunk, t):
        seen.append((t, float(chunk["a"].sum())))
        return c + 1, {"a": chunk["a"] + 1, "b": chunk["b"]}

    n, out = R.rotate_pipeline(step, 0, tree, n_chunks=4)
    assert n == 4 and [t for t, _ in seen] == [0, 1, 2, 3]
    torch.testing.assert_close(out["a"], tree["a"] + 1)
    assert torch.equal(out["b"], tree["b"])
    n, out = R.rotate_pipeline(step, 0, tree, n_steps=3)
    assert n == 3 and torch.equal(out["a"], tree["a"] + 3)
    assert R.ROTATE_WIRES == JR.ROTATE_WIRES
