"""The port's sequence-parallel attention (ring, a2a) and RoPE against
harp_tpu's, on one and on four workers.

The port runs one gloo world of 4 spawned processes, each on its sequence
shard; the reference runs the same whole arrays on a 4-device CPU mesh.
Tolerances: outputs rtol 2e-4 / atol 2e-5, the reference's own gate
between its schemes and the dense attention (f32, other summation orders);
gradients rtol 5e-3 / atol 5e-4 against the dense gradients, the
reference's own (``tests/test_attention.py``); RoPE rtol 2e-5 / atol
2e-6, the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import rope as JRO
from harp_tpu.ops.a2a_attention import make_a2a_attention_fn as j_make_a2a
from harp_tpu.ops.flash_attention import reference_attention as j_dense
from harp_tpu.ops.ring_attention import make_ring_attention_fn as j_make_ring
from harp_tpu.ops.ring_attention import ring_attention as j_ring
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.ops import rope as RO
from harp_tpu_torch.ops.a2a_attention import a2a_attention
from harp_tpu_torch.ops.ring_attention import ring_attention
from torch_world import (ATTN_CASES, GRAD_CASES, GRAD_SHAPE, WORLD,
                         attention_inputs, rope_input, run_attention_cases,
                         run_world)

OUT_TOL = {"rtol": 2e-4, "atol": 2e-5}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_attention_cases, tmp_path_factory.mktemp("attn"))


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh(jax.devices()[:WORLD])


def _joined(world, key):
    return np.concatenate([w[key] for w in world], axis=1)


def _reference(jm, scheme, kw, q, k, v):
    """The reference's scheme on the whole arrays, sharded over ``jm``."""
    if scheme == "ring-rope":
        spec = jm.spec(1, ndim=4)
        f = jax.jit(jm.shard_map(
            lambda q, k, v: j_ring(
                JRO.apply_rope(q), JRO.apply_rope(k), v, **kw),
            in_specs=(spec,) * 3, out_specs=spec))
        return np.asarray(f(q, k, v))
    make = j_make_ring if scheme == "ring" else j_make_a2a
    return np.asarray(make(jm, **kw)(q, k, v))


@pytest.mark.parametrize("cid,scheme,kw,shape,seed", ATTN_CASES,
                         ids=[c[0] for c in ATTN_CASES])
def test_scheme_matches_reference_on_four_workers(world, jmesh, cid, scheme,
                                                  kw, shape, seed):
    q, k, v = attention_inputs(shape, seed)
    got = _joined(world, cid)
    np.testing.assert_allclose(got, _reference(jmesh, scheme, kw, q, k, v),
                               **OUT_TOL)
    assert np.isfinite(got).all() and got.shape == q.shape


def _dense_grads(q, k, v, window):
    """The reference test's dense causal loss and its q/k/v gradients."""
    b, n, h, d = q.shape

    def dense_loss(q, k, v):
        qf, kf, vf = (a.transpose(0, 2, 1, 3).reshape(b * h, n, d)
                      for a in (q, k, v))
        o = j_dense(qf, kf, vf, causal=True, window=window)
        return (o ** 2).sum()

    return jax.grad(dense_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("scheme,window", GRAD_CASES)
def test_gradients_through_the_scheme_match_dense(world, scheme, window):
    q, k, v = attention_inputs(GRAD_SHAPE, 7)
    ref = _dense_grads(q, k, v, window)
    for i, r in enumerate(ref):
        got = np.concatenate([w[f"grad-{scheme}-{window}"][i] for w in world],
                             axis=1)
        np.testing.assert_allclose(got, np.asarray(r), rtol=5e-3, atol=5e-4)


def test_sharded_rope_matches_the_reference(world, jmesh):
    x = rope_input()
    ref = np.asarray(JRO.make_rope_fn(jmesh)(x))
    np.testing.assert_allclose(_joined(world, "rope"), ref, rtol=2e-5,
                               atol=2e-6)
    for w in world:
        np.testing.assert_allclose(w["host-rope"], ref, rtol=2e-5, atol=2e-6)


def test_host_view_functions_return_the_whole_output(world, jmesh):
    whole = attention_inputs((2, 64, 8, 8, 16), 2)
    ring = np.asarray(j_make_ring(jmesh, causal=True)(*whole))
    a2a = np.asarray(j_make_a2a(jmesh, causal=True, block_k=16)(*whole))
    for w in world:
        np.testing.assert_allclose(w["host-ring"], ring, **OUT_TOL)
        np.testing.assert_allclose(w["host-a2a"], a2a, **OUT_TOL)


@pytest.mark.parametrize("key,match", [
    ("reject-a2a-heads", "divisible by workers"),
    ("reject-ring-group", "multiple of KV heads"),
    ("reject-a2a-gqa", "KV heads"),
    ("reject-ring-window0", "window must be >= 1"),
    ("reject-a2a-window0", "window must be >= 1")])
def test_schemes_reject_what_the_reference_rejects(world, key, match):
    for w in world:
        assert match in w[key], w[key]


def test_ledger_counts_the_ring_hops_and_the_two_regroups(world):
    # q [1, 16, 8, 8] f32 a worker (4096 B), k and v [1, 16, 4, 8] (2048 B)
    for w in world:
        led = w["ledger"]
        ring = {r["verb"]: r for r in led["ring"]["verbs"]}
        assert ring["rotate"]["calls"] == 2 * WORLD  # k and v, 4 steps
        assert ring["rotate"]["payload_bytes"] == 2 * WORLD * 2048
        # window 12 over 16-position shards reaches one shard back: 2 steps
        win = {r["verb"]: r for r in led["ring-window"]["verbs"]}
        assert win["rotate"]["calls"] == 2 * 2
        a2a = {r["verb"]: r for r in led["a2a"]["verbs"]}
        assert a2a["regroup"]["calls"] == 2
        assert a2a["regroup"]["payload_bytes"] == (4096 + 2 * 2048) + 4096


# ---- one worker (this process) ------------------------------------------------

@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.mark.parametrize("cid,scheme,kw,shape,seed", ATTN_CASES,
                         ids=[c[0] for c in ATTN_CASES])
def test_scheme_matches_reference_on_one_worker(jmesh1, cid, scheme, kw,
                                                shape, seed):
    q, k, v = attention_inputs(shape, seed)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    if scheme == "ring-rope":
        got = ring_attention(RO.apply_rope(qt), RO.apply_rope(kt), vt, **kw)
    else:
        fn = ring_attention if scheme == "ring" else a2a_attention
        got = fn(qt, kt, vt, **kw)
    np.testing.assert_allclose(got.numpy(),
                               _reference(jmesh1, scheme, kw, q, k, v),
                               **OUT_TOL)


@pytest.mark.parametrize("scheme,window", GRAD_CASES)
def test_gradients_on_one_worker_match_dense(scheme, window):
    q, k, v = attention_inputs(GRAD_SHAPE, 7)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fn = ring_attention if scheme == "ring" else a2a_attention
    (fn(*ts, causal=True, window=window) ** 2).sum().backward()
    for t, r in zip(ts, _dense_grads(q, k, v, window)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-3,
                                   atol=5e-4)


def test_a2a_gradient_with_blocks_and_window_is_finite():
    """A query row masked whole in its first key block (window 10 over
    16-key blocks) keeps m = -inf there; its gradient stays finite (the
    NaN of exp(-inf - -inf) meets only masked scores) and equals the dense
    one."""
    q, k, v = attention_inputs(GRAD_SHAPE, 9)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (a2a_attention(*ts, causal=True, window=10, block_k=16) ** 2
     ).sum().backward()
    for t, r in zip(ts, _dense_grads(q, k, v, 10)):
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-3,
                                   atol=5e-4)


def test_rope_angles_match_and_reject_an_odd_head_dim():
    pos = np.arange(64)
    cos, sin = RO.rope_angles(torch.from_numpy(pos), 16)
    jcos, jsin = JRO.rope_angles(jnp.asarray(pos), 16)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=2e-5,
                               atol=2e-6)
    with pytest.raises(ValueError, match="even head_dim"):
        RO.rope_angles(torch.arange(4), 7)


def test_rope_preserves_norms_and_scores_depend_on_offsets_only():
    x = torch.from_numpy(rope_input())
    out = RO.apply_rope(x)
    np.testing.assert_allclose(out.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=2e-5)
    rng = np.random.default_rng(13)
    d = 16
    q, k = rng.normal(size=d), rng.normal(size=d)

    def rot(vec, p):
        cos, sin = RO.rope_angles(torch.tensor([p]), d)
        c, s = cos.double().numpy()[0], sin.double().numpy()[0]
        o = np.empty_like(vec)
        o[0::2] = vec[0::2] * c - vec[1::2] * s
        o[1::2] = vec[0::2] * s + vec[1::2] * c
        return o

    s1, s2 = rot(q, 9) @ rot(k, 4), rot(q, 104) @ rot(k, 99)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    assert abs(s1 - rot(q, 9) @ rot(k, 2)) > 1e-6


def test_nothing_in_the_world_imported_jax(world):
    assert not any(w["_jax_imported"] for w in world)
