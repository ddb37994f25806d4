"""K3's plain version (and the wrapper on the CPU) against harp_tpu's
``sgd_tile_update`` in interpret mode, and the level schedule.

Both sides take the same entries (from the reference's own
``partition_ratings_tiles``, or after its ``insert_coverage_entries``) and
the same W and H.  The reference works on transposed factors; the port on
row-major ones.  Tolerance, the reference's own for dense vs pallas: W and
H ``rtol 1e-4, atol 1e-5`` (the gradient sums are added in another f32
order), ``se`` ``rtol 1e-5``, ``cnt`` equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import mfsgd as JMF
from harp_tpu.ops import mfsgd_kernel as JK
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.ops import mfsgd_kernel as K

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _entries(tile, cap, nnz=600, nu=64, ni=48, seed=0, coverage=False,
             u_hi=None):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, u_hi or nu, nnz).astype(np.int32)
    i = rng.integers(0, ni, nnz).astype(np.int32)
    v = rng.normal(size=nnz).astype(np.float32)
    eu, ei, ev, ou, oi, _, _, ub, ib = JMF.partition_ratings_tiles(
        u, i, v, nu, ni, 1, tile, tile, cap, n_slices=1)
    ent = (eu, ei, ev, ou, oi)
    if coverage:
        ent = JK.insert_coverage_entries(*ent, ub, tile)
    return [a[0] for a in ent], ub, ib


def _check(rank, tile, dtype, cap=16, coverage=False, **kw):
    (eu, ei, ev, ou, oi), ub, ib = _entries(tile, cap, coverage=coverage,
                                            **kw)
    rng = np.random.default_rng(1)
    W = rng.uniform(0, 0.3, (ub, rank)).astype(np.float32)
    H = rng.uniform(0, 0.3, (ib, rank)).astype(np.float32)
    td, jd = DTYPES[dtype]
    hp = dict(lr=0.05, reg=0.02, u_tile=tile, i_tile=tile)
    Wt, Ht, se, cnt = JK.sgd_tile_update(
        jnp.asarray(W.T), jnp.asarray(H.T),
        *map(jnp.asarray, (eu, ei, ev, ou, oi)), compute_dtype=jd,
        interpret=True, **hp)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    before = dict(K.LAUNCHES)
    W2, H2, se2, cnt2 = K.sgd_tile_update(
        T(W), T(H), *map(T, (eu, ei, ev, ou, oi)), compute_dtype=td, **hp)
    assert K.LAUNCHES == before  # the CPU takes the plain version
    np.testing.assert_allclose(W2.numpy(), np.asarray(Wt).T, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(H2.numpy(), np.asarray(Ht).T, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(se2), float(se), rtol=1e-5)
    assert float(cnt2) == float(cnt) == float((eu < tile).sum())
    assert not np.allclose(W2.numpy(), W)  # it trained
    return eu


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("rank", [8, 64])
def test_plain_matches_reference_kernel(rank, tile, dtype):
    _check(rank, tile, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_entry_wider_than_512_slots(dtype):
    """All ratings in one tile: one entry of 600 ratings, which the
    reference pads to C = 1024 and runs as two 512-slot chunks that score
    against the same entry-start snapshot."""
    eu = _check(8, 8, dtype, cap=1024, coverage=True, nu=8, ni=8)
    assert eu.shape[-1] > 512


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_entries_after_insert_coverage_entries(dtype):
    """Coverage entries are all pads (no level), and their pad slots carry
    ei = 0 where partition_ratings_tiles' carry i_tile: neither is read."""
    eu = _check(8, 8, dtype, coverage=True, nu=64, u_hi=16)
    assert (~(eu < 8).any(-1)).any()  # there are all-pad entries


def test_masked_slot_never_reads_h():
    """A pad's ei may point one row past the tile (past H itself here):
    the slot is masked by eu alone and changes nothing."""
    W, H = torch.ones(8, 4), torch.ones(8, 4)
    eu = torch.tensor([[0, 8]], dtype=torch.int32)
    ei = torch.tensor([[0, 8]], dtype=torch.int32)
    ev = torch.tensor([[2.0, 99.0]])
    z = torch.zeros(1, dtype=torch.int32)
    W2, H2, se, cnt = K.sgd_tile_update(W, H, eu, ei, ev, z, z, lr=0.1,
                                        reg=0.0, u_tile=8, i_tile=8,
                                        compute_dtype=torch.float32)
    assert float(cnt) == 1 and float(se) == 4.0  # err = 2 - 4
    assert torch.equal(W2[1:], W[1:]) and torch.equal(H2[1:], H[1:])
    torch.testing.assert_close(W2[0], torch.full((4,), 1 - 0.2))


def test_level_schedule_at_reference_prep_shapes():
    """u-major entries of one block: same-ou entries run on successive
    levels, and entries without a rating get none."""
    (eu, ei, ev, ou, oi), ub, ib = _entries(8, 16, coverage=True, u_hi=16)
    s = K.LevelSchedule.build(eu, ei, ou, oi, 8, 8, ub, ib, "cpu")
    real = np.flatnonzero((eu < 8).any(-1))
    assert sorted(s.order.tolist()) == real.tolist()
    assert s.offsets[0] == 0 and s.offsets[-1] == len(real)
    assert s.n_levels >= 1 and s.max_width <= ub // 8


def test_level_schedule_refuses_tiles_outside_the_factors():
    eu = np.zeros((1, 4), np.int32)
    ou = np.array([8], np.int32)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="outside W"):
        K.LevelSchedule.build(eu, eu, ou, z, 8, 8, 8, 8, "cpu")
    with pytest.raises(ValueError, match="out of their tiles"):
        K.LevelSchedule.build(eu, eu + 9, z, z, 8, 8, 8, 16, "cpu")


def test_level_schedule_refuses_unaligned_tile_offsets():
    """Levels are keyed on the offsets: tiles at ou 0 and 4 (u_tile 8)
    overlap under different keys and could share a level."""
    eu = np.zeros((2, 4), np.int32)
    z = np.zeros(2, np.int32)
    for ou, oi in ((np.array([0, 4], np.int32), z),
                   (z, np.array([0, 3], np.int32))):
        with pytest.raises(ValueError, match="not multiples"):
            K.LevelSchedule.build(eu, eu, ou, oi, 8, 8, 16, 16, "cpu")


def test_accumulators_that_do_not_fit_are_refused():
    K.check_accumulator_fits(256, 256, 64, 232448)  # 128 KB: fits
    with pytest.raises(ValueError, match="232448"):
        K.check_accumulator_fits(512, 512, 64, 232448)
    # the kernel's static shared memory counts too
    K.check_accumulator_fits(256, 256, 64, 131072 + 128, static_bytes=128)
    with pytest.raises(ValueError, match="128 static"):
        K.check_accumulator_fits(256, 256, 64, 131072 + 100, static_bytes=128)


def test_wrapper_checks_its_inputs():
    W = torch.zeros(8, 4)
    e = torch.zeros(1, 4, dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int32)
    kw = dict(lr=0.1, reg=0.0, u_tile=8, i_tile=8)
    with pytest.raises(TypeError, match="ev"):
        K.sgd_tile_update(W, W, e, e, e, z, z, **kw)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.sgd_tile_update(W, W, e, e, e.float(), z, z,
                          compute_dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.sgd_tile_update(torch.zeros(4, 8).t(), W, e, e, e.float(), z, z,
                          **kw)
    m = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.sgd_tile_update(W.to(m), W.to(m), e.to(m), e.to(m),
                          e.float().to(m), z.to(m), z.to(m), **kw)


# hypothesis is optional in some images: without it only this property test
# skips, as in the reference's kernel tests
try:
    from hypothesis import given, settings, strategies as st  # noqa: E402
except ImportError:  # pragma: no cover
    given = None


def _property_case(fn):
    if given is None:  # pragma: no cover
        return pytest.mark.skip(reason="hypothesis not installed")(fn)
    return settings(max_examples=40, deadline=None)(given(
        nnz=st.integers(1, 300),
        n_users=st.sampled_from([16, 40, 64]),
        n_items=st.sampled_from([16, 48]),
        u_tile=st.sampled_from([8, 16]),
        entry_cap=st.sampled_from([8, 16, 64]),
        shuffle=st.booleans(),
        seed=st.integers(0, 2**31 - 1),
    )(fn))


@_property_case
def test_level_schedule_properties(nnz, n_users, n_items, u_tile, entry_cap,
                                   shuffle, seed):
    """For ANY rating set and any entry order: every entry with a rating is
    scheduled exactly once; entries on one level touch distinct ou and
    distinct oi; within one ou and within one oi the entry order is kept."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    v = rng.normal(size=nnz).astype(np.float32)
    eu, ei, ev, ou, oi, *_, ub, ib = MF.partition_ratings_tiles(
        u, i, v, n_users, n_items, 1, u_tile, u_tile, entry_cap, n_slices=1)
    eu, ei, ou, oi = eu[0], ei[0], ou[0], oi[0]
    if shuffle:  # the schedule must not lean on the u-major order
        p = rng.permutation(len(ou))
        eu, ei, ou, oi = eu[p], ei[p], ou[p], oi[p]
    s = K.LevelSchedule.build(eu, ei, ou, oi, u_tile, u_tile, ub, ib, "cpu")
    order = s.order.numpy()
    real = np.flatnonzero((eu < u_tile).any(-1))
    assert sorted(order.tolist()) == real.tolist()
    level = np.empty(len(ou), np.int64)
    for lv in range(s.n_levels):
        ents = order[s.offsets[lv]:s.offsets[lv + 1]]
        assert len(ents) > 0
        assert len(set(ou[ents].tolist())) == len(ents)
        assert len(set(oi[ents].tolist())) == len(ents)
        assert (np.diff(ents) > 0).all()  # entry order within a level
        level[ents] = lv
    for key in (ou, oi):
        for val in np.unique(key[real]):
            same = real[key[real] == val]  # in entry order
            assert (np.diff(level[same]) > 0).all()


def _random_topological_order(pred: np.ndarray, rng) -> list[int]:
    """A random order of the positions 0..n-1 in which every position
    comes after both of its predecessors (Kahn's algorithm, drawing the
    next position at random from those ready)."""
    n = len(pred)
    waiting = [int((p >= 0).sum()) for p in pred]
    succ: list[list[int]] = [[] for _ in range(n)]
    for p, qs in enumerate(pred):
        for q in qs:
            if q >= 0:
                succ[int(q)].append(p)
    ready = [p for p in range(n) if waiting[p] == 0]
    out = []
    while ready:
        p = ready.pop(int(rng.integers(len(ready))))
        out.append(p)
        for s in succ[p]:
            waiting[s] -= 1
            if waiting[s] == 0:
                ready.append(s)
    assert len(out) == n  # pred has no cycle
    return out


@_property_case
def test_pred_orders_the_entries_as_the_levels_do(nnz, n_users, n_items,
                                                  u_tile, entry_cap, shuffle,
                                                  seed):
    """``pred`` (the kernel's dataflow order): each position's two
    predecessors are the previous entries with its ou and with its oi, its
    level is ``1 + max(level of pred)``, and running the entries one at a
    time with the plain per-entry math in ANY random order that honours
    ``pred`` gives W, H, se and cnt bit-equal (f32, CPU) to the level
    order."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    v = rng.normal(size=nnz).astype(np.float32)
    eu, ei, ev, ou, oi, *_, ub, ib = MF.partition_ratings_tiles(
        u, i, v, n_users, n_items, 1, u_tile, u_tile, entry_cap, n_slices=1)
    eu, ei, ev, ou, oi = eu[0], ei[0], ev[0], ou[0], oi[0]
    if shuffle:
        p = rng.permutation(len(ou))
        eu, ei, ev, ou, oi = eu[p], ei[p], ev[p], ou[p], oi[p]
    s = K.LevelSchedule.build(eu, ei, ou, oi, u_tile, u_tile, ub, ib, "cpu")
    order, pred = s.order.numpy(), s.pred.numpy()
    assert pred.shape == (len(order), 2) and s.pred.dtype == torch.int32
    level = np.repeat(np.arange(s.n_levels), np.diff(s.offsets))
    for p, e in enumerate(order.tolist()):
        for q, key in zip(pred[p], (ou, oi)):
            earlier = [f for f in order.tolist()
                       if f < e and key[f] == key[e]]
            assert q == (order.tolist().index(max(earlier)) if earlier
                         else -1)
            assert q < p  # a topological order: predecessors come first
        assert level[p] == 1 + max(level[q] if q >= 0 else -1
                                   for q in pred[p])
    T = torch.from_numpy
    ent = [T(np.ascontiguousarray(a)) for a in (eu, ei, ev, ou, oi)]
    W0 = T(rng.uniform(0, 0.3, (ub, 8)).astype(np.float32))
    H0 = T(rng.uniform(0, 0.3, (ib, 8)).astype(np.float32))

    def run(positions):
        W, H = W0.clone(), H0.clone()
        se = torch.zeros(len(order))
        cnt = torch.zeros(len(order))
        for p in positions:
            err, cm = K.entries_update_plain(
                W, H, torch.tensor([int(order[p])]), *ent, lr=0.05, reg=0.02,
                u_tile=u_tile, i_tile=u_tile, compute_dtype=torch.float32)
            se[p], cnt[p] = (err * err).sum(), cm.sum()
        return W, H, se.sum(), cnt.sum()  # se summed in one fixed order

    in_levels = run(range(len(order)))
    shuffled = run(_random_topological_order(pred, rng))
    for a, b in zip(in_levels, shuffled):
        assert torch.equal(a, b)
    assert float(in_levels[3]) == float((eu < u_tile).sum())


@_property_case
def test_entry_sorts_order_each_entry_by_row(nnz, n_users, n_items, u_tile,
                                            entry_cap, shuffle, seed):
    """``LevelSchedule.sort`` (the kernel's split of an entry by row): for
    each scheduled entry, its real slots stably sorted by W row and by H
    row, each sorted position's run start, and each H-sorted slot's place
    in the W order; ``n_real`` counts the real slots."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    v = rng.normal(size=nnz).astype(np.float32)
    eu, ei, ev, ou, oi, *_, ub, ib = MF.partition_ratings_tiles(
        u, i, v, n_users, n_items, 1, u_tile, u_tile, entry_cap, n_slices=1)
    eu, ei, ou, oi = eu[0], ei[0], ou[0], oi[0]
    if shuffle:  # real slots need not come first
        eu, ei = eu[:, ::-1].copy(), ei[:, ::-1].copy()
    s = K.LevelSchedule.build(eu, ei, ou, oi, u_tile, u_tile, ub, ib, "cpu")
    sort, n_real = s.sort.numpy(), s.n_real.numpy()
    assert sort.shape == (len(s.order), 5, eu.shape[1])
    for p, e in enumerate(s.order.tolist()):
        real = np.flatnonzero(eu[e] < u_tile)
        n = int(n_real[p])
        assert n == len(real)
        for q, ids in ((0, eu[e]), (2, ei[e])):
            by = sort[p, q, :n]
            want = real[np.argsort(ids[real], kind="stable")]
            assert by.tolist() == want.tolist()
            keys = ids[by]
            for j in range(n):  # the start of j's run of one row
                st = sort[p, q + 1, j]
                assert keys[st] == keys[j] and (st == 0
                                                or keys[st - 1] != keys[j])
        w_order = sort[p, 0, :n].tolist()
        assert [w_order[k] for k in sort[p, 4, :n]] == sort[p, 2, :n].tolist()
