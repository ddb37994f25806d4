"""K4's plain version (and the wrapper on the CPU) against harp_tpu's
``cgs_entry_update`` in interpret mode, K4's chunk rule and its Philox.

Both sides take the same tiles, totals, token ids and uniforms: the test
rebuilds the reference's interpret-mode uniforms from its seed exactly as
``harp_tpu/ops/lda_kernel.py`` draws them (``jax.random.uniform`` over
``wrap_key_data(seed2)``, [K, C], in [2⁻²⁵, 1)) and passes them transposed.
The reference works on topic-major tiles, the port on row-major ones.
Counts are integers and the uniforms are the same, so ``Db'``, ``Wb'``,
``z'`` and ``dnk`` must be bit-equal — except that ``torch.log`` and XLA's
``log`` round differently for ~14 % of the uniforms (by one ulp), which can
flip a token whose two best topics tie to an ulp.  The test counts such
flips (none occur at these seeds), allows at most one a case, and then
still requires the port's counts to reconcile exactly with its own ``z'``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.ops import lda_kernel as JK
from harp_tpu_torch.ops import lda_kernel as K

T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
KW = dict(alpha=0.1, beta=0.01, vbeta=0.64)


def _inputs(K_, DR, WR, C, dtype, hi, n_pad, seed):
    rng = np.random.default_rng(seed)
    Db = rng.integers(1, hi, (DR, K_)).astype(dtype)
    Wb = rng.integers(1, hi, (WR, K_)).astype(np.float32)
    nk = (Wb.sum(0) + 10 * hi).astype(np.float32)
    z = rng.integers(0, K_, C).astype(np.int32)
    cd = rng.integers(0, DR, C).astype(np.int32)
    cw = rng.integers(0, WR, C).astype(np.int32)
    if n_pad:
        cd[-n_pad:], cw[-n_pad:] = DR, WR
        z[-n_pad:] = 0
    return Db, Wb, nk, z, cd, cw


def _reference_uniforms(seed2, K_, C):
    key = jax.random.wrap_key_data(jnp.asarray(seed2).astype(jnp.uint32)[:2])
    u = jax.random.uniform(key, (K_, C), jnp.float32, minval=2.0 ** -25,
                           maxval=1.0)
    return np.ascontiguousarray(np.asarray(u).T)


def _reconciles(Db, Wb, cd, cw, z, z2, out, DR):
    """The port's tables moved by exactly its own topic changes."""
    Db2, Wb2, dnk = out[0].numpy(), out[1].numpy(), out[3].numpy()
    m = cd < DR
    dD = np.zeros(Db.shape, np.int64)
    dW = np.zeros(Wb.shape, np.int64)
    dk = np.zeros(Db.shape[1], np.int64)
    for a, r in ((dD, cd), (dW, cw)):
        np.add.at(a, (r[m], z2[m]), 1)
        np.add.at(a, (r[m], z[m]), -1)
    np.add.at(dk, z2[m], 1)
    np.add.at(dk, z[m], -1)
    np.testing.assert_array_equal(Db2.astype(np.int64) - Db, dD)
    np.testing.assert_array_equal(Wb2.astype(np.int64) - Wb, dW)
    np.testing.assert_array_equal(dnk, dk)
    np.testing.assert_array_equal(z2[~m], z[~m])


CASES = [
    # (id, K, d_tile, w_tile, C, ndk dtype, exact, count scale, pads)
    ("f32-exact", 8, 16, 16, 256, np.float32, True, 40, 30),
    ("int16-exact", 8, 16, 16, 256, np.int16, True, 40, 30),
    ("f32-approx-hot", 8, 16, 16, 256, np.float32, False, 2000, 0),
    ("int16-approx-hot", 8, 16, 16, 256, np.int16, False, 2000, 30),
    ("f32-exact-hot", 8, 16, 16, 256, np.float32, True, 2000, 0),
    ("several-chunks", 8, 16, 16, 1024, np.float32, True, 40, 200),
    ("k-not-multiple-of-4", 13, 8, 24, 512, np.int16, True, 300, 5),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_reference_kernel(case):
    _, K_, DR, WR, C, dt, exact, hi, n_pad = case
    Db, Wb, nk, z, cd, cw = _inputs(K_, DR, WR, C, dt, hi, n_pad, seed=C + K_)
    bounds = (int(Db.astype(np.int64).sum(1).max()), int(Wb.sum(1).max()))
    seed2 = np.array([7, 100 + K_], np.int32)
    ref = JK.cgs_entry_update(
        jnp.asarray(Db.T), jnp.asarray(Wb.T), jnp.asarray(nk), jnp.asarray(z),
        jnp.asarray(cd), jnp.asarray(cw), jnp.asarray(seed2), interpret=True,
        exact_gathers=exact, ndk_count_bound=bounds[0],
        nwk_count_bound=bounds[1], **KW)
    cc = K.chunk_width(K_, DR, WR, C, dt, exact, bounds)
    u = _reference_uniforms(seed2, K_, C)
    before = dict(K.LAUNCHES)
    out = K.cgs_entry_update(T(Db), T(Wb), T(nk), T(z), T(cd), T(cw), cc=cc,
                             exact_gathers=exact, u=T(u), **KW)
    assert K.LAUNCHES == before  # the CPU takes the plain version
    z2 = out[2].numpy()
    flips = int((z2 != np.asarray(ref[2])).sum())
    assert flips <= 1, f"{flips} tokens flipped"
    _reconciles(Db, Wb, cd, cw, z, z2, out, DR)
    if flips == 0:
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]).T)
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]).T)
        np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[0].dtype == torch.from_numpy(Db).dtype
    assert (z2 != z).any()  # it sampled
    if case[0] == "several-chunks":
        assert C // cc == 4


def _reference_chunk(K_, DR, WR, C, dt, exact, bounds):
    """The chunk width the reference picks: the grid of its pallas_call."""
    f = lambda *a: JK.cgs_entry_update(  # noqa: E731
        *a, interpret=True, exact_gathers=exact, ndk_count_bound=bounds[0],
        nwk_count_bound=bounds[1], **KW)
    jaxpr = jax.make_jaxpr(f)(
        jnp.zeros((K_, DR), dt), jnp.zeros((K_, WR)), jnp.zeros(K_),
        jnp.zeros(C, jnp.int32), jnp.zeros(C, jnp.int32),
        jnp.zeros(C, jnp.int32), jnp.zeros(2, jnp.int32))
    (eqn,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    return C // eqn.params["grid_mapping"].grid[0]


GRID = [(K_, DR, WR, C, dt, exact, bounds)
        for K_ in (8, 1000)
        for DR, WR in ((512, 512), (128, 512), (256, 128))
        for C, dt in ((768, np.float32), (2048, np.int16), (256, np.float32))
        for exact, bounds in ((True, (100, 258)), (True, (None, None)),
                              (False, (None, None)), (True, (300, 2 ** 17)))]


@pytest.mark.parametrize("shape", GRID[::3] + [GRID[-1]])
def test_chunk_width_is_the_reference_rule(shape):
    K_, DR, WR, C, dt, exact, bounds = shape
    try:
        want = _reference_chunk(*shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="VMEM"):
            K.chunk_width(*shape)
        assert "VMEM" in str(e)
        return
    assert K.chunk_width(*shape) == want


def test_chunk_width_at_the_benchmark_shape():
    """100k docs × 50k words × 1k topics, 100 tokens a doc: doc counts ≤
    100 (one plane), word counts up to 258 (two planes) → cc = 128."""
    assert K.chunk_width(1000, 512, 512, 768, "float32", True,
                         (100, 258)) == 128
    assert K.chunk_width(1000, 256, 256, 768, "float32", True,
                         (100, 256)) == 256
    with pytest.raises(ValueError, match="VMEM"):
        K.chunk_width(4096, 512, 512, 256, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        K.chunk_width(8, 16, 16, 300, torch.float32, chunk_c=256)
    assert [K.planes_for(b, False) for b in (256, 257, 2 ** 16)] == [1, 2, 3]
    assert K.planes_for(None, True) == 2 and K.planes_for(None, False) == 3


def test_kernel_draws_from_posterior():
    """The reference's frequency test on the port's own generator (the
    wrapper on the CPU: the plain version over torch Philox): one chunk a
    call, fresh seeds from the same counts, frequencies match p ∝
    (ndk+α)(nwk+β)/(nk+Vβ) with the current assignment removed."""
    K_, DR, WR, C = 8, 8, 8, 256
    av = np.array([1.0, 2, 3, 4, 1, 1, 1, 3]) * 10_000
    bv = np.array([4.0, 1, 2, 1, 1, 2, 1, 1]) * 10_000
    Db = torch.zeros((DR, K_))
    Wb = torch.zeros((WR, K_))
    Db[0], Wb[0] = torch.from_numpy(av).float(), torch.from_numpy(bv).float()
    nk = torch.full((K_,), 1e6)
    zeros = torch.zeros(C, dtype=torch.int32)
    a, b, c = av.copy(), bv.copy(), np.full(K_, 1e6)
    a[0] -= 1
    b[0] -= 1
    c[0] -= 1
    p = (a * b) / c
    p /= p.sum()
    reps = 24
    counts = np.zeros(K_)
    for r in range(reps):
        _, _, z_new, dnk = K.cgs_entry_update(
            Db, Wb, nk, zeros, zeros, zeros, alpha=0.0, beta=0.0, vbeta=0.0,
            cc=C, seed2=torch.tensor([3, 100 + r], dtype=torch.int32))
        zn = z_new.numpy()
        counts += np.bincount(zn, minlength=K_)
        np.testing.assert_allclose(
            dnk.numpy(), np.bincount(zn, minlength=K_)
            - np.array([C] + [0] * (K_ - 1)))
    freq = counts / (reps * C)
    se = np.sqrt(p * (1 - p) / (reps * C)).max()
    np.testing.assert_allclose(freq, p, atol=5 * se + 0.005)


def test_philox_words_and_uniforms():
    """The 16-bit-split multiply equals exact integer arithmetic, the
    uniforms lie in (0, 1] on the 2⁻²⁵ grid, and every
    (slot, topic) of an entry draws its own number."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    for m in (K._M0, K._M1):
        hi, lo = K._mulhilo(torch.from_numpy(a.astype(np.int64)), m)
        full = [int(x) * m for x in a]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]
    u = K.philox_uniforms(torch.tensor([5, -9], dtype=torch.int32), 512, 50,
                          128)
    assert u.shape == (512, 50) and u.dtype == torch.float32
    assert float(u.min()) > 0 and float(u.max()) <= 1
    assert abs(float(u.mean()) - 0.5) < 0.01
    grid = u.double() * 2 ** 25  # (2n + 1)·2⁻²⁵, rounded to f32 above 2⁻¹
    assert torch.equal(grid, grid.round())
    assert len(torch.unique(u)) > 0.99 * u.numel()
    v = K.philox_uniforms(torch.tensor([5, -8], dtype=torch.int32), 512, 50,
                          128)
    assert not torch.equal(u, v)


def test_step_walks_entries_in_order_against_running_totals():
    """cgs_step (the plain version on the CPU) equals the entries one by
    one through the single-entry wrapper, each against nk plus the deltas
    of the entries before it; trailing pad chunks and all-pad entries
    change nothing."""
    rng = np.random.default_rng(3)
    K_, DR, WR, C, NE = 8, 16, 16, 512, 5
    Ndk = torch.from_numpy(rng.integers(0, 30, (48, K_)).astype(np.int16))
    Nwk = torch.from_numpy(rng.integers(0, 30, (32, K_)).astype(np.float32))
    nk = Nwk.sum(0) + 50
    cd = torch.from_numpy(rng.integers(0, DR, (NE, C)).astype(np.int32))
    cw = torch.from_numpy(rng.integers(0, WR, (NE, C)).astype(np.int32))
    cd[1, 200:], cd[3] = DR, DR
    z = torch.from_numpy(rng.integers(0, K_, (NE, C)).astype(np.int32))
    od = torch.tensor([0, 16, 32, 16, 0], dtype=torch.int32)
    ow = torch.tensor([0, 16, 0, 16, 16], dtype=torch.int32)
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (NE, 2))
                             .astype(np.int32))
    kw = dict(KW, cc=128)
    Ndk1, Nwk1, z1 = Ndk.clone(), Nwk.clone(), z.clone()
    dNk = K.cgs_step(Ndk1, Nwk1, nk, z1, cd, cw, od, ow, d_tile=DR,
                     w_tile=WR, seeds=seeds, **kw)
    nk_run = nk.clone()
    for e in range(NE):
        o, q = int(od[e]), int(ow[e])
        Db, Wb, ze, dnk = K.cgs_entry_update(
            Ndk[o:o + DR], Nwk[q:q + WR], nk_run, z[e], cd[e], cw[e],
            seed2=seeds[e], **kw)
        Ndk[o:o + DR], Nwk[q:q + WR], z[e] = Db, Wb, ze
        nk_run += dnk
    assert torch.equal(Ndk1, Ndk) and torch.equal(Nwk1, Nwk)
    assert torch.equal(z1, z) and torch.equal(dNk, nk_run - nk)
    plan = K.EntryPlan.build(cd, cw, od, ow, DR, WR, 48, 32, 128)
    assert plan.n_chunks.tolist() == [4, 2, 4, 0, 4]
    assert plan.chunks == 14


@pytest.mark.parametrize("n_chunks", [[4, 2, 4, 0, 4], [0], [0, 0, 3],
                                      [16] * 7 + [0, 1]])
def test_chunk_offsets_are_the_prefix_sums_of_n_chunks(n_chunks):
    """The schedule the kernel walks on the card: entry e runs chunks
    offsets[e] to offsets[e + 1], one after another, every entry in
    order, and nothing else."""
    plan = K.EntryPlan(np.asarray(n_chunks, np.int32), 128, 64, 64)
    off = plan.chunk_offsets
    assert off.dtype == np.int32 and off.shape == (len(n_chunks) + 1,)
    assert off[0] == 0 and off[-1] == plan.chunks == sum(n_chunks)
    assert np.diff(off).tolist() == n_chunks
    walked = [(e, j) for e in range(len(n_chunks))
              for j in range(off[e + 1] - off[e])]
    assert walked == [(e, j) for e, n in enumerate(n_chunks)
                      for j in range(n)]
    dev = plan.offsets_on(torch.device("cpu"))
    assert dev.dtype == torch.int32 and dev.tolist() == off.tolist()
    assert plan.offsets_on(torch.device("cpu")) is dev  # copied once


def test_entry_plan_offsets_count_chunks_through_the_last_real_slot():
    """Built from entries: an entry's chunks end at its last real slot,
    whatever pads sit between real slots; the offsets follow."""
    C, cc, DR = 512, 128, 8
    cd = np.full((4, C), DR, np.int32)
    cd[0, 0] = 0                 # one chunk
    cd[1, 300] = 1               # pads before it: chunks 0-2
    cd[2, C - 1] = 2             # the last slot: all four
    zero = np.zeros(4, np.int32)
    plan = K.EntryPlan.build(cd, np.zeros_like(cd), zero, zero, DR, 8, DR,
                             8, cc)
    assert plan.n_chunks.tolist() == [1, 3, 4, 0]
    assert plan.chunk_offsets.tolist() == [0, 1, 4, 8, 8]
    assert plan.chunks == 8


def test_entry_plan_refuses_what_the_kernel_trusts():
    cd = np.zeros((1, 8), np.int32)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="out of their tiles"):
        K.EntryPlan.build(cd, cd + 8, z, z, 8, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="out of their tiles"):
        K.EntryPlan.build(cd - 1, cd, z, z, 8, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="outside Ndk"):
        K.EntryPlan.build(cd, cd, z + 4, z, 8, 8, 8, 8, 8)
    with pytest.raises(ValueError, match="multiple"):
        K.EntryPlan.build(cd, cd, z, z, 8, 8, 8, 8, 3)
    # an all-pad entry is never launched, so its offsets are not checked
    assert K.EntryPlan.build(cd + 8, cd, z + 99, z, 8, 8, 8, 8, 8
                             ).n_chunks.tolist() == [0]


def test_wrapper_checks_its_inputs():
    Db, Wb, nk = torch.zeros(8, 4), torch.zeros(8, 4), torch.zeros(4)
    z = torch.zeros(8, dtype=torch.int32)
    u = torch.full((8, 4), 0.5)
    kw = dict(KW, cc=8)
    with pytest.raises(ValueError, match="exactly one"):
        K.cgs_entry_update(Db, Wb, nk, z, z, z, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        K.cgs_entry_update(Db, Wb, nk, z, z, z, u=u,
                           seed2=torch.zeros(2, dtype=torch.int32), **kw)
    with pytest.raises(TypeError, match="Ndk"):
        K.cgs_entry_update(Db.double(), Wb, nk, z, z, z, u=u, **kw)
    with pytest.raises(TypeError, match="cd"):
        K.cgs_entry_update(Db, Wb, nk, z, z.long(), z, u=u, **kw)
    with pytest.raises(ValueError, match="u has shape"):
        K.cgs_entry_update(Db, Wb, nk, z, z, z, u=u[:4], **kw)
    m = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.cgs_entry_update(Db.to(m), Wb.to(m), nk.to(m), z.to(m), z.to(m),
                           z.to(m), u=u.to(m), **kw)
