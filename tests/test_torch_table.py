"""The port's Table/KV layer (``harp_tpu_torch.table``) against
harp_tpu's, on one and four workers.

Four workers run as one spawned gloo world against a four-device mesh.
The sparse row verbs (raw and ``_dedup``) move the same values as the
reference, so rows, ``ok``, the new shard and the global drop count are
bit-equal, on a Zipf-skewed id stream at three capacities (one drops),
with out-of-range ids and padding; the pushes add each delta into the
table in slot order, as XLA's scatter does.  ``combine_by_key``
runs on small integers (exact); the KV union folds the same values in the
same order.  The host-side Table/KV classes are held to the reference's
results in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu import table as JT
from harp_tpu.parallel.collective import Combiner as JComb
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import table as T
from harp_tpu_torch.parallel import dispatch
from harp_tpu_torch.parallel.collective import Combiner
from torch_world import (KV_COMBINERS, TABLE_CAPS, TABLE_SHAPE, WORLD,
                         kv_tables, run_table_cases, run_world, table_inputs)

S = TABLE_SHAPE
INP = table_inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_table_cases, tmp_path_factory.mktemp("table"))


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


def _spmd(jm, fn, args, n_out):
    """``fn`` on every worker's slice of ``args`` (each [workers, ...];
    the table is sharded by rows): [workers, ...] per output."""
    def body(*a):
        out = fn(*(x if i == 0 else x[0] for i, x in enumerate(a)))
        return [o[None] if o.ndim else jnp.reshape(o, (1,)) for o in out]

    f = jax.jit(jm.shard_map(body, in_specs=tuple(jm.spec(0) for _ in args),
                             out_specs=[jm.spec(0)] * n_out))
    return [np.asarray(o) for o in f(*(jnp.asarray(a) for a in args))]


def _stack(world, key, i):
    return np.stack([np.asarray(w[key][i]) for w in world])


SPARSE = [(verb, cap, v) for verb in ("pull", "pull-dedup", "push",
                                      "push-dedup", "push-raw-int")
          for cap in TABLE_CAPS for v in ("all", "valid")]


def _ref_sparse(jm, verb, cap, v):
    valid = INP["valid"] if v == "valid" else None
    fns = {"pull": JT.pull_rows_sparse, "pull-dedup": JT.pull_rows_sparse_dedup,
           "push": JT.push_rows_sparse, "push-dedup": JT.push_rows_sparse_dedup,
           "push-raw-int": JT.push_rows_sparse}
    fn = fns[verb]
    deltas = INP["deltas"] if verb == "push" else INP["ideltas"]
    args = [INP["table"], INP["ids"]]
    if verb.startswith("push"):
        args.append(deltas)
    if valid is not None:
        args.append(valid)

    def call(t, i, *rest):
        kw = {"capacity": cap}
        if valid is not None:
            kw["valid"] = rest[-1]
            rest = rest[:-1]
        return fn(t, i, *rest, **kw)

    n_out = 3 if verb.startswith("pull") else 2
    return _spmd(jm, call, args, n_out)


@pytest.mark.parametrize("verb,cap,v", SPARSE,
                         ids=[f"{a}-{b}-{c}" for a, b, c in SPARSE])
def test_sparse_verbs_are_bit_equal_on_four_workers(world, jmesh4, verb, cap,
                                                    v):
    ref = _ref_sparse(jmesh4, verb, cap, v)
    key = f"{verb}-{cap}-{v}"
    for i, r in enumerate(ref):
        got = _stack(world, key, i).reshape(r.shape)
        np.testing.assert_array_equal(got, r, err_msg=f"{key} {i}")
    dropped = ref[-1].reshape(-1)
    assert (dropped == dropped[0]).all()  # the global count, everywhere
    if cap == TABLE_CAPS[0]:
        assert dropped[0] > 2 * WORLD  # capacity drops besides the bad ids
    if cap == TABLE_CAPS[-1] and not verb.endswith("dedup"):
        assert dropped[0] == 2 * WORLD  # only the two bad ids a worker


@pytest.mark.parametrize("v", ["all", "valid"])
def test_dedup_equals_raw_at_zero_drops(world, v):
    """The pulls are bit-equal; the deduped push adds a row's pre-summed
    deltas once where the raw push adds them one by one, so on this
    non-integer table they agree within rounding (on integer counts, as in
    LDA, both are exact)."""
    cap = TABLE_CAPS[-1]
    for w in world:
        raw, dd = w[f"pull-{cap}-{v}"], w[f"pull-dedup-{cap}-{v}"]
        np.testing.assert_array_equal(raw[0], dd[0])
        np.testing.assert_array_equal(raw[1], dd[1])
        np.testing.assert_allclose(w[f"push-raw-int-{cap}-{v}"][0],
                                   w[f"push-dedup-{cap}-{v}"][0], rtol=1e-6,
                                   atol=1e-6)
    counts = torch.from_numpy(np.round(INP["table"][:S["rows_local"]] * 10))
    ids = torch.from_numpy(INP["ids"][0] % S["rows_local"])
    d = torch.from_numpy(INP["ideltas"][0])
    valid = torch.from_numpy(INP["valid"][0]) if v == "valid" else None
    raw, _ = T.push_rows_sparse(counts, ids, d, capacity=cap, valid=valid)
    dd, _ = T.push_rows_sparse_dedup(counts, ids, d, capacity=cap,
                                     valid=valid)
    assert torch.equal(raw, dd)


def test_pulled_rows_are_the_table_rows(world):
    cap = TABLE_CAPS[-1]
    n_rows = WORLD * S["rows_local"]
    for r, w in enumerate(world):
        rows, ok, _ = w[f"pull-{cap}-valid"]
        ids, valid = INP["ids"][r], INP["valid"][r]
        want_ok = valid & (ids >= 0) & (ids < n_rows)
        np.testing.assert_array_equal(ok, want_ok)
        np.testing.assert_array_equal(rows[ok], INP["table"][ids[ok]])
        assert not rows[~ok].any()


@pytest.mark.parametrize("cap", [2, S["pairs"]])
def test_regroup_and_combine_by_key_are_bit_equal(world, jmesh4, cap):
    def fn(t, k, v):
        return JT.regroup_by_key(k, v, capacity=cap)

    ref = _spmd(jmesh4, fn, [INP["table"], INP["keys"], INP["values"]], 4)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(
            _stack(world, f"regroup-{cap}", i).reshape(r.shape), r)
    for r, w in enumerate(world):
        k_out, v_out = ref[0][r], ref[1][r]
        for op in KV_COMBINERS:
            want = np.asarray(JT.combine_by_key(
                jnp.asarray(k_out), jnp.asarray(v_out), S["keys"], op))
            np.testing.assert_array_equal(w[f"combine-{cap}"][op], want,
                                          err_msg=op)


def test_dense_pull_and_push_rows_are_bit_equal(world, jmesh4):
    def fn(t, i, d):
        return JT.pull_rows(t, i), JT.push_rows(t, i, d)

    pull, push = _spmd(jmesh4, fn, [INP["table"], INP["dense_ids"],
                                    INP["ideltas"][:, :12]], 2)
    np.testing.assert_array_equal(_stack(world, "pull_rows", slice(None)),
                                  pull)
    np.testing.assert_array_equal(
        np.concatenate([w["push_rows"] for w in world]),
        push.reshape(-1, S["k"]))


@pytest.mark.parametrize("op", KV_COMBINERS)
def test_kv_allreduce_unions_every_worker(world, op):
    tables = kv_tables(JT, WORLD, op)
    want = JT.kv_allreduce(tables[0], worker_tables=tables[1:])
    for w in world:
        name, keys, vals, counts = w[f"kv-{op}"]
        assert name == type(want).__name__ == "Int2FloatKVTable"
        for a, b in zip((keys, vals, counts), want.to_arrays()):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_capacity_sweep_drops_match_reference(world, jmesh4):
    from harp_tpu import benchmark as JB

    ref = [(r["dist"], r["capacity"], r["requests_per_worker"],
            r["drop_rate"])
           for r in JB.sweep_sparse_capacity(jmesh4, m=64, d=8, reps=1)]
    for w in world:
        got = [(d, c, n, rate) for d, c, n, _, rate in w["sweep"]]
        assert got == ref
    assert any(r[3] > 0 for r in ref) and ref[-1][3] == 0.0


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- one worker and the host-side tables ----------------------------------------

def test_one_worker_sparse_verbs_match_reference():
    jm = JaxMesh(jax.devices()[:1])
    inp = table_inputs(1)
    shard = torch.from_numpy(inp["table"])
    ids, valid = torch.from_numpy(inp["ids"][0]), torch.from_numpy(
        inp["valid"][0])
    for cap in TABLE_CAPS:
        ref = _spmd(jm, lambda t, i, v: JT.pull_rows_sparse_dedup(
            t, i, capacity=cap, valid=v), [inp["table"], inp["ids"],
                                           inp["valid"]], 3)
        got = T.pull_rows_sparse_dedup(shard, ids, capacity=cap, valid=valid)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g).reshape(r.shape), r)
        ref = _spmd(jm, lambda t, i, d: JT.push_rows_sparse(
            t, i, d, capacity=cap), [inp["table"], inp["ids"],
                                     inp["deltas"]], 2)
        got = T.push_rows_sparse(shard, ids, torch.from_numpy(
            inp["deltas"][0]), capacity=cap)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g).reshape(r.shape), r)


@pytest.mark.parametrize("ids_kind", ["padding", "in-range"])
def test_dedup_verbs_with_no_valid_id_change_nothing(ids_kind):
    """A call whose every slot is padding (a worker with whole chunks of
    padding in LDA push/pull) pulls zeros, pushes nothing and drops
    nothing, as the reference does."""
    jm = JaxMesh(jax.devices()[:1])
    inp = table_inputs(1)
    ids = inp["ids"] if ids_kind == "in-range" else np.full_like(
        inp["ids"], -1)
    valid = np.zeros_like(inp["valid"])
    shard = torch.from_numpy(inp["table"])
    t_ids, t_valid = torch.from_numpy(ids[0]), torch.from_numpy(valid[0])
    for cap in TABLE_CAPS:
        ref = _spmd(jm, lambda t, i, d, v: JT.push_rows_sparse_dedup(
            t, i, d, capacity=cap, valid=v),
            [inp["table"], ids, inp["deltas"], valid], 2)
        got = T.push_rows_sparse_dedup(shard, t_ids, torch.from_numpy(
            inp["deltas"][0]), capacity=cap, valid=t_valid)
        np.testing.assert_array_equal(got[0].numpy(), inp["table"])
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g).reshape(r.shape), r)
        ref = _spmd(jm, lambda t, i, v: JT.pull_rows_sparse_dedup(
            t, i, capacity=cap, valid=v), [inp["table"], ids, valid], 3)
        got = T.pull_rows_sparse_dedup(shard, t_ids, capacity=cap,
                                       valid=t_valid)
        assert not got[1].any() and not got[0].any() and int(got[2]) == 0
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g).reshape(r.shape), r)


def test_bucket_dispatch_skips_ids_that_name_no_destination():
    """An invalid item's destination may lie outside the buckets (a bad
    row id): it takes no slot and writes nothing, instead of failing the
    scatter."""
    dest = torch.tensor([0, 7, -3, 1, 1])
    valid = torch.tensor([True, False, False, True, True])
    (buf,), keep, slot, dropped = dispatch.bucket_by_destination(
        dest, (torch.arange(1, 6),), 1, 2, valid)
    assert keep.tolist() == [True, False, False, True, False]
    assert buf.tolist() == [[1], [4]] and int(dropped) == 1
    assert slot.tolist() == [0, 1, 1, 0, 1]


def test_table_and_kvtable_follow_reference():
    for op in ("add", "max", "min", "avg", "multiply"):
        a, b = T.Table(op), JT.Table(op)
        for pid, val in ((1, [1.0, 2.0]), (2, [3.0, 1.0]), (1, [5.0, -1.0]),
                         (1, [2.0, 2.0])):
            a.add_partition(pid, np.asarray(val))
            b.add_partition(pid, np.asarray(val))
        for x, y in zip(a.to_stacked(), b.to_stacked()):
            np.testing.assert_array_equal(x, y)
        back = T.Table.from_stacked(*a.to_stacked(), combiner=op)
        assert back.partition_ids() == [1, 2] and 1 in back
        assert [p.id for p in back] == [1, 2]
    assert T.modulo_partitioner(4)(10) == JT.modulo_partitioner(4)(10) == 2
    with pytest.raises(ValueError, match="no partitions"):
        T.Table().to_stacked()
    raw = [1, 2]
    t = T.Table()
    t.add_partition(0, raw)
    assert t.get_partition(0) is raw  # stored verbatim on first insert
    for cls in ("Int2IntKVTable", "Int2LongKVTable", "Int2FloatKVTable",
                "Int2DoubleKVTable", "Long2IntKVTable", "Long2DoubleKVTable"):
        for op in ("add", "avg", "max"):
            a, b = getattr(T, cls)(op, 3), getattr(JT, cls)(op, 3)
            for k, v in ((5, 1), (2, 4), (5, 7), (5, 2)):
                a.add(k, v)
                b.add(k, v)
            for x, y in zip(a.to_arrays(), b.to_arrays()):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
            assert a.partition(5) == b.partition(5) == 2 and len(a) == 2
            c = getattr(T, cls).from_arrays(*a.to_arrays()[:2], combiner=op,
                                            counts=a.to_arrays()[2])
            a2 = getattr(T, cls)(op, 3)
            a2.merge(c)
            a2.merge(a)
            d = getattr(JT, cls).from_arrays(*b.to_arrays()[:2], combiner=op,
                                             counts=b.to_arrays()[2])
            b2 = getattr(JT, cls)(op, 3)
            b2.merge(d)
            b2.merge(b)
            for x, y in zip(a2.to_arrays(), b2.to_arrays()):
                np.testing.assert_array_equal(x, y)
    e = T.KVTable(dtype=np.int16).to_arrays()
    assert e[1].shape == (0,) and e[1].dtype == np.int16
    t = T.kv_allreduce(T.Int2IntKVTable(), [T.Int2IntKVTable()])
    assert isinstance(t, T.Int2IntKVTable) and len(t) == 0


def test_combine_by_key_drops_padding_and_fills_identities():
    keys = torch.tensor([0, 2, 2, -1, 5, 9])
    vals = torch.tensor([[1.0], [2.0], [3.0], [100.0], [4.0], [7.0]])
    jk, jv = jnp.asarray(keys.numpy()), jnp.asarray(vals.numpy())
    for op in KV_COMBINERS:
        got = T.combine_by_key(keys, vals, 6, op).numpy()
        want = np.asarray(JT.combine_by_key(jk, jv, 6, op))
        np.testing.assert_array_equal(got, want, err_msg=op)
    ik = torch.tensor([1, 1, 3])
    iv = torch.tensor([4, 6, 5], dtype=torch.int32)
    for op in KV_COMBINERS:
        got = T.combine_by_key(ik, iv, 4, Combiner(op)).numpy()
        want = np.asarray(JT.combine_by_key(jnp.asarray(ik.numpy()),
                                            jnp.asarray(iv.numpy()), 4,
                                            JComb(op)))
        np.testing.assert_array_equal(got, want, err_msg=op)
        assert got.dtype == want.dtype, op


def test_table_shard_gives_this_workers_block():
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    t = T.Table()
    for pid in range(4):
        t.add_partition(pid, np.full(2, pid, np.float32))
    ids, stack = t.shard(WorkerMesh("cpu"))
    assert ids.tolist() == [0, 1, 2, 3] and stack.shape == (4, 2)
