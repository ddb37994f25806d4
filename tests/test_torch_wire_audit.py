"""The wire audit (``harp_tpu_torch/analysis/commgraph.py``) on a four-worker
gloo world, and the lint drivers (``analysis/drivers.py``) against
harp_tpu's programs.

- Every registered driver runs under the ``torch.distributed`` tap on four
  workers: no HL301 or HL302 anywhere, each protocol of the staging audit
  clean (the elastic one shrinks to three survivors), and every byte sheet
  passes ``scripts/check_jsonl.py``'s ``_check_lint_row``.
- The KMeans fit's sheet equals the hand computation: per Lloyd iteration
  one allreduce of the [k, d] sums, the [k] counts and the inertia, three
  leaves, f32.  The chunked reshard's sheet is one hop of half the block,
  amplified twice, as the reference's scan has it.
- The wire fixtures: a raw ``all_reduce`` fires HL301, a ledger that
  under-counts its wire HL302, a quantized record is exempt and an honest
  verb is clean.
- Each of the thirteen drivers this slice adds equals the reference's
  program on the same numpy inputs on one worker (tolerance per app).
"""

import importlib.util
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.analysis import allowlist as A
from harp_tpu_torch.analysis.drivers import DRIVERS, PROTOCOLS
from torch_lint_world import WORLD, run_wire_audit, run_world, time_limit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEW_DRIVERS = ("ring_attention", "rotate.pipeline_chunked",
               "ingest.accum_chunk", "ingest.finish_epoch",
               "kmeans.fit_hier", "collective.reshard",
               "collective.reshard_wire", "elastic.regather",
               "serve.mfsgd_topk", "serve.lda_infer", "serve.mlp_logits",
               "serve.rf_vote", "serve.svm_scores")


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(240):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_wire_audit, tmp_path_factory.mktemp("wire"),
                     timeout=200)


def test_every_driver_on_four_workers_has_no_hl301_or_hl302(world):
    assert set(NEW_DRIVERS) <= set(DRIVERS) and len(DRIVERS) == 24
    for w in world:
        assert w["violations"] == []
        assert set(w["sheets"]) == set(DRIVERS)
        assert not w["_jax_imported"]


def test_protocols_on_four_workers_are_clean(world):
    assert len(PROTOCOLS) == 4
    for w in world:
        assert w["protocol_violations"] == []


def test_sheets_pass_the_references_lint_row_check(world):
    spec = importlib.util.spec_from_file_location(
        "_check_jsonl", os.path.join(ROOT, "scripts", "check_jsonl.py"))
    cj = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cj)
    for w in world:
        row = {"kind": "lint", "backend": "cpu", "date": "2026-10-18",
               "commit": "x", "rules": [], "byte_sheets": w["sheets"]}
        assert cj._check_lint_row("row", 1, row) == []
    prims = {c["primitive"] for s in world[0]["sheets"].values()
             for c in s["collectives"]}
    assert prims == {"psum", "pmax", "all_gather", "all_to_all",
                     "ppermute"}


def test_kmeans_sheet_equals_the_hand_computation(world):
    k, d, iters = 8, 32, 2
    per_iter = k * d * 4 + k * 4 + 4        # sums, counts, inertia (f32)
    for w in world:
        (row,) = w["sheets"]["kmeans.fit"]["collectives"]
        assert (row["primitive"], row["verb"]) == ("psum", "allreduce")
        assert row["per_shard_bytes"] == iters * per_iter == 2120
        assert row["calls_per_trace"] == 3 * iters
        # the two-stage schedule moves the payload twice
        (hier,) = w["sheets"]["kmeans.fit_hier"]["collectives"]
        assert hier["verb"] == "allreduce_hier"
        assert hier["per_shard_bytes"] == 2 * 2120


def test_chunked_reshard_sheet_is_one_hop_amplified(world):
    rows = world[0]["sheets"]["collective.reshard_wire"]["collectives"]
    chunked = [r for r in rows if r["wire_dtype"] == "float32"
               and r["primitive"] == "ppermute"]
    (c,) = chunked
    assert (c["per_shard_bytes"], c["amplification"]) == (8 * 16 * 4 // 2,
                                                          2)
    # the accumulate is collective-free; the epoch tail is one allreduce
    assert world[0]["sheets"]["ingest.accum_chunk"]["collectives"] == []
    (fin,) = world[0]["sheets"]["ingest.finish_epoch"]["collectives"]
    assert fin["per_shard_bytes"] == 8 * 16 * 4 + 8 * 4 + 4


@pytest.mark.parametrize("name,rules", [("raw", ["HL301"]),
                                        ("lying", ["HL302"]),
                                        ("quantized", []), ("honest", [])])
def test_wire_fixtures(world, name, rules):
    for w in world:
        assert w["fixtures"][name]["rules"] == rules
    (row,) = world[0]["fixtures"][name]["sheet"]["collectives"]
    assert row["primitive"] == "psum" and row["per_shard_bytes"] == 32


def test_the_committed_allowlist_has_no_wire_entry():
    assert not [e for e in A.load() if e["rule"].startswith("HL30")]


# ---------------------------------------------------------------------------
# The new drivers against the reference's programs, one worker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


def _np(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _port(name):
    fn, args = DRIVERS[name]("cpu")
    return fn(*args), args


def test_ring_attention_driver(jmesh1):
    from harp_tpu.ops.ring_attention import make_ring_attention_fn

    got, (q, k, v) = _port("ring_attention")
    ref = make_ring_attention_fn(jmesh1, causal=True)(q, k, v)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_rotate_pipeline_chunked_driver(jmesh1):
    from harp_tpu.parallel.rotate import rotate_pipeline

    (acc, sl), (a0, s0) = _port("rotate.pipeline_chunked")

    def epoch(acc, sl):
        def step(c, chunk, t):
            return c + chunk.sum(), chunk * 1.01

        return rotate_pipeline(step, acc, sl, n_chunks=2)

    fn = jax.jit(jmesh1.shard_map(
        epoch, in_specs=(jmesh1.spec(0), jmesh1.spec(0)),
        out_specs=(jmesh1.spec(0), jmesh1.spec(0))))
    ra, rs = fn(a0, s0)
    np.testing.assert_allclose(_np(acc), np.asarray(ra), rtol=1e-5)
    np.testing.assert_allclose(_np(sl), np.asarray(rs), rtol=1e-6)


def test_ingest_drivers(jmesh1):
    from harp_tpu.models.kmeans_stream import (StreamConfig, _make_accum_fn,
                                               _make_finish_fn)

    (s, c, i), (pts, cents, sums, counts, inertia) = _port(
        "ingest.accum_chunk")
    ref = _make_accum_fn(jmesh1, StreamConfig(k=8))(
        pts, np.ones(pts.shape[0], np.float32), cents, sums[None],
        counts[None], np.asarray([inertia], np.float32))
    np.testing.assert_allclose(_np(s), np.asarray(ref[0])[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(_np(c), np.asarray(ref[1])[0])
    np.testing.assert_allclose(float(i), float(ref[2][0]), rtol=1e-5)
    (nc, ni), args = _port("ingest.finish_epoch")
    rc, ri = _make_finish_fn(jmesh1)(args[0][None], args[1][None],
                                     np.asarray([args[2]], np.float32),
                                     args[3])
    np.testing.assert_allclose(_np(nc), np.asarray(rc), rtol=1e-6)
    assert float(ni) == float(ri)


def test_kmeans_fit_hier_driver(jmesh1):
    from harp_tpu.models.kmeans import KMeansConfig, make_fit_fn

    (c, inertia), (pts,) = _port("kmeans.fit_hier")
    fn = make_fit_fn(jmesh1, KMeansConfig(k=8, iters=2,
                                          psum_schedule="hier"))
    rc, _ = fn(jnp.asarray(pts), jnp.asarray(pts[:8]))
    np.testing.assert_allclose(c, np.asarray(rc), rtol=1e-5, atol=1e-5)
    assert np.isfinite(inertia)


def _reshard_ref(jm, prog, x, out_specs):
    fn = jax.jit(jm.shard_map(prog, in_specs=(jm.spec(0, ndim=2),),
                              out_specs=out_specs))
    return fn(x)


def test_reshard_drivers(jmesh1):
    from harp_tpu.parallel.collective import ShardSpec, reshard
    from jax.sharding import PartitionSpec as P

    got, (x,) = _port("collective.reshard")

    def prog(x):
        rot = reshard(x, ShardSpec.blocked(0), ShardSpec.blocked(0, 1))
        swap = reshard(x, ShardSpec.blocked(0), ShardSpec.blocked(1))
        full = reshard(x, ShardSpec.blocked(0), ShardSpec.replicated())
        back = reshard(full, ShardSpec.replicated(), ShardSpec.blocked(0))
        return rot, swap, full.sum(), back

    ref = _reshard_ref(jmesh1, prog, x, (
        jmesh1.spec(0, ndim=2), jmesh1.spec(1, ndim=2), P(),
        jmesh1.spec(0, ndim=2)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-6)
    got, (x,) = _port("collective.reshard_wire")

    def prog_wire(x):
        chunked = reshard(x, ShardSpec.blocked(0), ShardSpec.blocked(0, 1),
                          n_chunks=2)
        narrow = reshard(x, ShardSpec.blocked(0), ShardSpec.blocked(0, 2),
                         wire="int8")
        return chunked, narrow

    ref = _reshard_ref(jmesh1, prog_wire, x, (jmesh1.spec(0, ndim=2),) * 2)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))
    # the int8 wire: one rounding of a step |max|/127 (bit-equal where
    # both packages round alike)
    np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]), rtol=0,
                               atol=np.abs(x).max() / 127 + 1e-6)


def test_elastic_regather_driver(jmesh1):
    from harp_tpu.elastic.move import make_regather_fn

    got, (x, rows) = _port("elastic.regather")
    ref = make_regather_fn(jmesh1, ndim=2)(x, rows.astype(np.int32))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


SERVE = {"serve.mfsgd_topk": ("mfsgd", {"n_users": 16, "n_items": 8,
                                        "rank": 8}, {"topk": 4}),
         "serve.lda_infer": ("lda", {"vocab_size": 64, "n_topics": 8},
                             {"em_iters": 4}),
         "serve.mlp_logits": ("mlp", {"sizes": (32, 16, 4)}, {}),
         "serve.rf_vote": ("rf", {"n_trees": 4, "max_depth": 3,
                                  "n_features": 8}, {}),
         "serve.svm_scores": ("svm", {"d": 32}, {})}


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_drivers(jmesh1, name):
    from harp_tpu.serve import engines as JE

    app, shape, opts = SERVE[name]
    got, args = _port(name)
    rng = np.random.default_rng(0)
    eng = JE.ENGINES[app](JE.ENGINES[app].synthetic_state(rng, **shape),
                          jmesh1, **opts)
    x = eng.make_input(eng.rows_from_request(eng.synthetic_request(rng, 8)),
                       8)
    np.testing.assert_array_equal(_np(args[-1]), x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(jax.jit(eng._step_fn())(*eng.state_args(),
                                                  jnp.asarray(x)))
    got = _np(got)
    if app == "mfsgd":
        np.testing.assert_array_equal(got[:, :4], ref[:, :4])
        np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=1e-5,
                                   atol=1e-6)
    elif app == "rf":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4 if app == "lda"
                                   else 1e-5, atol=1e-6)
