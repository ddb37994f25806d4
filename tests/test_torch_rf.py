"""The port's Random Forest against harp_tpu's, under the same draws.

Host prep (quantile edges, bins) is numpy on both sides: bit-equal.  One
level of growth (``_grow_level``) on the same bins, labels, weights, nodes
and feature masks gives the same splits and routes on all three arms.  The
whole forest: the test recomputes the reference's bootstrap weights and
feature masks from the keys its ``fit`` makes (``rf.py:345-348``, split
per tree as ``train_one_tree`` does) and hands them to the port's private
``_fit``; the forests must then be equal, on one worker (in this process)
and on four (one spawned gloo world against a four-device mesh).  Every
comparison is exact: the counts are integers and the Gini arithmetic is
the same f32 sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import rf as JRF
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import prng
from harp_tpu_torch import convert
from harp_tpu_torch.models import rf as RF
from harp_tpu_torch.ops import rf_kernel
from torch_world import (RF_ALGOS, RF_SHAPE, WORLD, rf_config_kwargs,
                         rf_data, run_rf_cases, run_world)

def reference_draws(nw: int, n: int, f: int, cfg: dict) -> list:
    """Per worker, (weights [tpw, n_loc], feat_mask [tpw, f]) as the
    reference's fit draws them."""
    tpw = cfg["n_trees"] // nw
    n_loc = n // nw
    keys = np.asarray(jax.random.split(
        jnp.asarray(prng.key_bits(cfg["seed"])), nw * tpw)).reshape(
        nw, tpw, 2)
    out = []
    for w in range(nw):
        ws, ms = [], []
        for j in range(tpw):
            k1, k2 = jax.random.split(jnp.asarray(keys[w, j]))
            ws.append(np.asarray(jax.random.poisson(k1, 1.0, (n_loc,))
                                 .astype(jnp.float32)))
            m = (jax.random.uniform(k2, (f,)) < cfg["feature_fraction"]
                 ).astype(jnp.float32)
            ms.append(np.asarray(jnp.where(m.sum() > 0, m, jnp.ones_like(m))))
        out.append((np.stack(ws), np.stack(ms)))
    return out


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x, _ = rf_data()
    draws = reference_draws(WORLD, x.shape[0], x.shape[1], RF_SHAPE)
    return run_world(run_rf_cases, tmp_path_factory.mktemp("rf"), draws)


def _reference_forest(jm, algo):
    x, y = rf_data()
    m = JRF.RandomForest(JRF.RFConfig(hist_algo=algo, **rf_config_kwargs()),
                         jm)
    m.fit(x, y)
    return m


def _equal_forests(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- host prep -----------------------------------------------------------------

def test_binning_is_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 7)).astype(np.float32)
    x[:50, 2] = 0.25  # ties on an edge
    e = RF.quantile_bins(x, 16)
    np.testing.assert_array_equal(e, JRF.quantile_bins(x, 16))
    b = RF.binize(x, e)
    np.testing.assert_array_equal(b, JRF.binize(x, e))
    np.testing.assert_array_equal(RF.binize_chunked(x, e, chunk_rows=97), b)
    np.testing.assert_array_equal(JRF.binize_chunked(x, e, chunk_rows=97), b)
    for a, r in zip(RF.synthetic_classification(300, 5, seed=2),
                    JRF.synthetic_classification(300, 5, seed=2)):
        np.testing.assert_array_equal(a, r)


# ---- one level ------------------------------------------------------------------

@pytest.mark.parametrize("algo", RF_ALGOS)
@pytest.mark.parametrize("level", [0, 2])
def test_grow_level_matches_reference(algo, level):
    """f·B = 128, so the reference's pallas arm runs its kernel."""
    rng = np.random.default_rng(level)
    T, n, f, B, C_ = 3, 500, 8, 16, 2
    bins = rng.integers(0, B, (n, f)).astype(np.int32)
    y = rng.integers(0, C_, n).astype(np.int32)
    weights = rng.poisson(1.0, (T, n)).astype(np.float32)
    node_id = rng.integers(0, 2 ** level, (T, n)).astype(np.int32)
    feat_mask = (rng.random((T, f)) < 0.7).astype(np.float32)
    feat_mask[:, 0] = 1.0
    jcfg = JRF.RFConfig(n_bins=B, n_classes=C_, hist_algo=algo)
    BO = JRF.bins_onehot(jnp.asarray(bins), B)
    ref = [JRF._grow_level(BO, jnp.asarray(bins), jnp.asarray(y),
                           jnp.asarray(weights[t]), jnp.asarray(node_id[t]),
                           level, jnp.asarray(feat_mask[t]), jcfg)
           for t in range(T)]
    cfg = RF.RFConfig(n_bins=B, n_classes=C_, hist_algo=algo)
    before = dict(rf_kernel.LAUNCHES)
    got = RF._grow_level(torch.from_numpy(bins).to(torch.uint8),
                         torch.from_numpy(y).long(),
                         torch.from_numpy(weights),
                         torch.from_numpy(node_id).long(), level,
                         torch.from_numpy(feat_mask), cfg)
    assert rf_kernel.LAUNCHES == before  # the CPU takes the plain version
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.stack([np.asarray(r[i]) for r in ref]))


def test_three_arms_give_the_same_histograms():
    rng = np.random.default_rng(9)
    T, n, f, B = 2, 300, 5, 7
    bins = torch.from_numpy(rng.integers(0, B, (n, f)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 3, n)).long()
    w = torch.from_numpy(rng.poisson(1.0, (T, n)).astype(np.int32))
    node = torch.from_numpy(rng.integers(0, 4, (T, n))).long()
    hists = [RF._histograms(bins, y, w, node, 4,
                            RF.RFConfig(n_bins=B, n_classes=3, hist_algo=a))
             for a in RF_ALGOS]
    for h in hists[1:]:
        assert torch.equal(h, hists[0])
    assert RF._exact_float(100_000) == torch.float32
    assert RF._exact_float(200_000) == torch.float64  # 127·n >= 2^24


# ---- the forest -------------------------------------------------------------------

@pytest.mark.parametrize("algo", RF_ALGOS)
def test_one_worker_forest_equals_reference(jmesh1, algo):
    x, y = rf_data()
    ref = _reference_forest(jmesh1, algo)
    draws = reference_draws(1, x.shape[0], x.shape[1], RF_SHAPE)
    m = RF.RandomForest(RF.RFConfig(hist_algo=algo, **rf_config_kwargs()),
                        device="cpu")
    m._fit(x, y, draws[0])
    _equal_forests(m.forest, ref.forest)
    np.testing.assert_array_equal(m.edges, ref.edges)
    np.testing.assert_array_equal(m.predict(x), ref.predict(x))


@pytest.mark.parametrize("algo", RF_ALGOS)
def test_four_worker_forest_equals_reference(world, jmesh4, algo):
    x, _ = rf_data()
    ref = _reference_forest(jmesh4, algo)
    for w in world:  # the allgather: every worker holds the whole forest
        _equal_forests(w[algo]["forest"], ref.forest)
        np.testing.assert_array_equal(w[algo]["edges"], ref.edges)
        np.testing.assert_array_equal(w[algo]["pred"], ref.predict(x[:100]))


def test_own_generator_forest_learns_the_task(world, jmesh4):
    """On the port's own draws the forest differs from the reference's but
    learns the XOR task no worse than the reference's own draws (less
    0.05), and every worker holds the same forest."""
    x, y = rf_data()
    ref_acc = _reference_forest(jmesh4, "pallas").accuracy(x, y)
    assert world[0]["own"]["acc"] >= max(ref_acc - 0.05, 0.75)
    for w in world:
        _equal_forests(w["own"]["forest"], world[0]["own"]["forest"])
    assert not any(w["_jax_imported"] for w in world)


def test_draws_are_seeded_per_tree():
    cfg = RF.RFConfig(n_trees=4, feature_fraction=0.5, seed=3)
    a = RF.tree_draws(cfg, 50, 6, range(4), "cpu")
    b = RF.tree_draws(cfg, 50, 6, range(2, 4), "cpu")
    assert torch.equal(a[0][2:], b[0]) and torch.equal(a[1][2:], b[1])
    assert not torch.equal(a[0][0], a[0][1])
    assert (a[1].sum(1) > 0).all() and float(a[0].mean()) > 0.5


def test_forest_from_the_reference_predicts_the_same(jmesh1):
    x, y = rf_data()
    ref = _reference_forest(jmesh1, "dense")
    feats, thresh, leaves = ref.forest
    state = convert.rf_forest_from_numpy(
        {"feats": feats, "thresh": thresh, "leaves": leaves,
         "edges": ref.edges}, "cpu")
    m = RF.RandomForest(RF.RFConfig(**rf_config_kwargs()), device="cpu",
                        state=state)
    np.testing.assert_array_equal(m.predict(x), ref.predict(x))
    assert m.accuracy(x, y) == ref.accuracy(x, y)
