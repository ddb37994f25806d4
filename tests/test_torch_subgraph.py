"""The port's subgraph counting against harp_tpu's, on the same graphs and
colorings.

Every template up to u7, and two colorings with more colors than template
vertices, on a hub-heavy graph where ``max_degree=4`` puts most adjacency
on the overflow tail, through both overflow algos: three trials in chunks
of two (the last chunk padded), on one worker (in this process, against a
one-device mesh) and on four (a spawned gloo world, against a four-device
mesh; 50 vertices pad to 52).  The rooted counts are integers below 2^24,
so every f32 sum is exact and the per-trial estimates must be equal bit
for bit, as must the host partitioners' arrays.
"""

import itertools
import math

import jax
import numpy as np
import pytest
import torch

from harp_tpu.models import subgraph as JS
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch.models import subgraph as SG
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from torch_world import (SUBGRAPH_CASES, WORLD, run_subgraph_cases,
                         run_world, subgraph_config_kwargs, subgraph_graph)


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(run_subgraph_cases, tmp_path_factory.mktemp("subgraph"))


def _reference(jm, kw):
    edges, n = subgraph_graph()
    return JS.count_template(
        edges, n, JS.SubgraphConfig(**subgraph_config_kwargs(kw)), jm)


@pytest.mark.parametrize("cid,kw", SUBGRAPH_CASES,
                         ids=[c for c, _ in SUBGRAPH_CASES])
def test_one_worker_counts_equal_reference(jmesh1, cid, kw):
    edges, n = subgraph_graph()
    est, trials, ovf = SG.count_template(
        edges, n, SG.SubgraphConfig(**subgraph_config_kwargs(kw)),
        device="cpu")
    r_est, r_trials, r_ovf = _reference(jmesh1, kw)
    assert trials == r_trials and est == r_est and ovf == r_ovf > 0


@pytest.mark.parametrize("cid,kw", SUBGRAPH_CASES,
                         ids=[c for c, _ in SUBGRAPH_CASES])
def test_four_workers_counts_equal_reference(world, jmesh4, cid, kw):
    r_est, r_trials, r_ovf = _reference(jmesh4, kw)
    for w in world:
        assert w[cid]["trials"] == r_trials
        assert w[cid]["estimate"] == r_est and w[cid]["overflow"] == r_ovf


def test_four_workers_segment_equals_onehot(world):
    for w in world:
        for cid, _ in SUBGRAPH_CASES:
            if cid.endswith("segment"):
                other = cid.replace("segment", "onehot")
                assert w[cid]["trials"] == w[other]["trials"]


def test_four_worker_ledger_sheet(world):
    """Per chunk (two of them): one allgather of the child's compact table
    per combine, [chunk = 2, n_loc = 13, C(k, |child|)] f32, and one
    allreduce of the chunk's [2] rooted counts."""
    for cid, kw in SUBGRAPH_CASES:
        tpl = SG.TEMPLATES[kw["template"]]
        k = kw["n_colors"] or len(tpl)
        sizes = SG._subtree_sizes(tpl)
        gather = sum(2 * 13 * math.comb(k, sizes[c]) * 4
                     for c in range(1, len(tpl)))
        for w in world:
            led = w[cid]["ledger"]
            assert led["executions"] == 2
            recs = {r["verb"]: r for r in led["verbs"]}
            assert set(recs) == {"allgather", "allreduce"}
            assert recs["allgather"]["calls"] == 2 * (len(tpl) - 1)
            assert recs["allgather"]["payload_bytes"] == 2 * gather
            assert recs["allreduce"]["calls"] == 2
            assert recs["allreduce"]["payload_bytes"] == 2 * 2 * 4


def test_children_never_import_jax(world):
    assert not any(w["_jax_imported"] for w in world)


# ---- the host layout -----------------------------------------------------------

@pytest.mark.parametrize("nw", [1, 3, 4])
def test_partitioners_equal_reference(nw):
    edges, n = subgraph_graph()
    n_pad = -(-n // nw) * nw
    got = SG.pad_csr(edges, n, 4)
    want = JS.pad_csr(edges, n, 4)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    overflow = got[2]
    for g, r in zip(SG._partition_overflow(overflow, n_pad, nw),
                    JS._partition_overflow(overflow, n_pad, nw)):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    for rt, et in ((4, 8), (8, 16), (512, 2048)):
        for g, r in zip(SG._partition_overflow_tiles(overflow, n_pad, nw,
                                                     rt, et),
                        JS._partition_overflow_tiles(overflow, n_pad, nw,
                                                     rt, et)):
            np.testing.assert_array_equal(g, r)
            assert g.dtype == r.dtype
    # no overflow at all: one padding entry (segment) / one padding tile
    empty = np.zeros((0, 2), np.int64)
    for g, r in zip(SG._partition_overflow(empty, n_pad, nw),
                    JS._partition_overflow(empty, n_pad, nw)):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(SG._partition_overflow_tiles(empty, n_pad, nw, 8, 16),
                    JS._partition_overflow_tiles(empty, n_pad, nw, 8, 16)):
        np.testing.assert_array_equal(g, r)


def test_static_plan_equals_reference():
    for name, tpl in SG.TEMPLATES.items():
        assert SG.TEMPLATES[name] == JS.TEMPLATES[name]
        assert SG._count_automorphism_roots(tpl) == \
            JS._count_automorphism_roots(tpl)
        assert SG._subtree_sizes(tpl) == JS._subtree_sizes(tpl)
        assert SG._children(tpl) == JS._children(tpl)
    for k, (a, b) in itertools.product((3, 5), [(1, 1), (1, 2), (2, 1)]):
        assert SG._dp_subset_tables(None, k)(a, b) == \
            JS._dp_subset_tables(None, k)(a, b)
    assert SG._count_automorphism_roots(SG.TEMPLATES["u5-star"]) == 24


# ---- the DP alone (the reference's own tests) ----------------------------------

TINY_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2), (4, 0), (5, 1), (4, 5)]
TINY_N = 8


def _brute_force_rooted_colorful(edges, n, tpl, colors):
    adj = {(a, b) for a, b in edges} | {(b, a) for a, b in edges}
    s = len(tpl)
    return sum(
        1 for phi in itertools.product(range(n), repeat=s)
        if len({colors[v] for v in phi}) == s
        and all((phi[i], phi[tpl[i]]) in adj for i in range(1, s)))


def _run_dp(tpl, k, edges, n, colors, max_degree):
    nbr, msk, overflow = SG.pad_csr(edges, n, max_degree)
    ovf = SG._partition_overflow(overflow, n, 1)
    mesh = WorkerMesh("cpu")
    fn = SG.make_colorful_count_fn(tpl, k, mesh)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    out = fn(t(nbr).long(), t(msk), t(ovf[0]).long(), t(ovf[1]).long(),
             t(ovf[2]), t(colors[None, :]))
    return float(out[0])


@pytest.mark.parametrize("tname,k", [(t, 0) for t in (
    "u3-path", "u3-star", "u5-path", "u5-star", "u5-tree")]
    + [("u3-path", 5), ("u5-tree", 7)])
def test_dp_matches_brute_force_colorful(tname, k):
    tpl = SG.TEMPLATES[tname]
    k = k or len(tpl)
    colors = np.random.default_rng(2).integers(0, k, TINY_N).astype(np.int32)
    assert _run_dp(tpl, k, TINY_EDGES, TINY_N, colors, 8) == \
        _brute_force_rooted_colorful(TINY_EDGES, TINY_N, tpl, colors)


@pytest.mark.parametrize("tname", ["u10-tree", "u12-tree"])
def test_deep_templates_exact_on_complete_graph(tname):
    """On K_s with all-distinct colors every injective map respects edges,
    so the rooted colorful count is exactly s!."""
    tpl = SG.TEMPLATES[tname]
    s, n = len(tpl), 16
    edges = [(a, b) for a in range(s) for b in range(a + 1, s)]
    colors = np.zeros(n, np.int32)
    colors[:s] = np.arange(s)
    assert _run_dp(tpl, s, edges, n, colors, s) == math.factorial(s)


def test_estimator_unbiased_small():
    tpl = SG.TEMPLATES["u3-path"]
    adj = {(a, b) for a, b in TINY_EDGES} | {(b, a) for a, b in TINY_EDGES}
    maps = sum(1 for phi in itertools.permutations(range(TINY_N), 3)
               if all((phi[i], phi[tpl[i]]) in adj for i in range(1, 3)))
    exact = maps / SG._count_automorphism_roots(tpl)
    cfg = SG.SubgraphConfig(template="u3-path", n_trials=200, seed=1,
                            max_degree=8)
    est, _, _ = SG.count_template(TINY_EDGES, TINY_N, cfg, device="cpu")
    assert abs(est - exact) / exact < 0.2, (est, exact)


def test_low_degree_cap_counts_exactly_as_uncapped():
    rng = np.random.default_rng(7)
    n = 40
    edges = [(0, i) for i in range(1, n)] + [
        (int(a), int(b)) for a, b in zip(rng.integers(1, n, 60),
                                         rng.integers(1, n, 60))]
    out = {}
    for cap in (4, 128):
        cfg = SG.SubgraphConfig(template="u5-tree", n_trials=4, seed=5,
                                max_degree=cap)
        out[cap] = SG.count_template(edges, n, cfg, device="cpu")
    assert out[4][2] > 0 and out[128][2] == 0
    assert out[4][1] == out[128][1]


def test_benchmark_powerlaw_graph_and_cli(capsys):
    kw = dict(n_vertices=600, avg_degree=4, template="u3-path", max_degree=4,
              seed=7, device="cpu")
    with telemetry.scope():
        r1 = SG.benchmark(graph="powerlaw", **kw)
    r2 = SG.benchmark(graph="powerlaw", **kw)
    ref = JS.benchmark(600, 4, "u3-path", JaxMesh(jax.devices()[:1]), 7, 4,
                       "powerlaw")
    assert r1["dropped_edges"] == 0 and 0 < r1["overflow_share"] <= 1
    assert r1["overflow_edges"] == ref["overflow_edges"]
    assert r1["estimate"] == r2["estimate"] == ref["estimate"]
    assert r1["prep_sec"] > 0 and r1["dp_sec"] > 0
    ru = SG.benchmark(graph="uniform", **kw)
    assert ru["overflow_share"] < r1["overflow_share"]
    with pytest.raises(ValueError, match="graph must be"):
        SG.benchmark(n_vertices=100, graph="smallworld", device="cpu")
    SG.main(["--vertices", "300", "--avg-degree", "4", "--max-degree", "4",
             "--graph", "powerlaw", "--overflow-algo", "onehot",
             "--device", "cpu"])
    row = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"subgraph_cli"' in row and '"backend": "cpu"' in row


def test_validation():
    with pytest.raises(ValueError, match="overflow_algo"):
        SG.SubgraphConfig(overflow_algo="scatter")
    with pytest.raises(ValueError, match="n_colors"):
        SG.count_template(TINY_EDGES, TINY_N, SG.SubgraphConfig(
            template="u5-tree", n_colors=3), device="cpu")
