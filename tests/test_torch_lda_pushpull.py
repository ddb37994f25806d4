"""The port's LDA-CGS push/pull algo against harp_tpu's, on one and four
workers.

Both packages start from the reference's pack; the port takes, through
``sample_epoch(noise=...)``, exactly the draws the reference makes from its
key chain (``prng.split_keys`` per worker, one key a chunk, the keys
advanced between sweeps).  Counts are integers, the pulled rows and the
pushed ±1 deltas are exact and the draws are the same, so after two sweeps
``Ndk``, the gathered ``Nwk``, ``Nk``, the topics, ``last_dropped`` and
every reader are bit-equal, with dedup on and off and at the default cap
and caps that drop.  ``log_likelihood`` is the reference's numpy formula
on equal tables.  The reference's push/pull contract tests
(``tests/test_lda.py``) run on the port's own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import lda as JL
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import prng
from harp_tpu_torch.models import lda as L
from harp_tpu_torch.utils import telemetry
from torch_world import (LDA_PP_CASES, LDA_SHAPE, WORLD, lda_corpus,
                         run_lda_pushpull_cases, run_world)

S = LDA_SHAPE
STATE = ("Ndk", "Nwk", "Nk", "z_grid")
SWEEPS = 2


def pushpull_noise(cfg: JL.LDAConfig, T_pad: int, keys) -> list:
    """The draws of one reference push/pull sweep, per worker: [T_pad, K]
    exponential or Gumbel draws, one key a chunk from the worker's key."""
    K, c = cfg.n_topics, min(cfg.chunk, T_pad)
    out = []
    for key in keys:
        draws = []
        for k in jax.random.split(jnp.asarray(key), T_pad // c):
            if cfg.rng_impl == "rbg":
                k = jax.random.wrap_key_data(jnp.concatenate([k, k]),
                                             impl="rbg")
            f = (jax.random.exponential if cfg.sampler == "exprace"
                 else jax.random.gumbel)
            draws.append(np.asarray(f(k, (c, K), jnp.float32)))
        out.append(np.concatenate(draws))
    return out


def sweep_noises(cfg, T_pad, n_workers, seed, sweeps=SWEEPS) -> list:
    """[sweep][worker] draws, the keys advanced between sweeps as the
    reference's ``LDA._advance_keys`` does."""
    keys = prng.split_keys(seed, n_workers)
    out = []
    for _ in range(sweeps):
        out.append(pushpull_noise(cfg, T_pad, keys))
        keys = prng.split_keys(int(keys[0][0]) ^ 0x9E37, n_workers)
    return out


def _reference(jm, kw, d, w, sweeps=SWEEPS):
    m = JL.LDA(S["n_docs"], S["vocab_size"],
               JL.LDAConfig(n_topics=S["n_topics"], **kw), jm, seed=S["seed"])
    pack = m.pack_tokens(d, w)
    m._install_pack(pack)
    dropped = []
    for _ in range(sweeps):
        m.sample_epoch()
        dropped.append(m.last_dropped)
    return m, pack, dropped


def _readers(m):
    return {"doc_topic": m.doc_topic_table(),
            "word_topic": m.word_topic_table(),
            "token_state": m.token_state(),
            "log_likelihood": m.log_likelihood()}


def _assert_equal(got: dict, want: dict):
    for k, v in want.items():
        if isinstance(v, tuple):
            for a, b in zip(got[k], v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.fixture(scope="module")
def jmesh1():
    return JaxMesh(jax.devices()[:1])


@pytest.fixture(scope="module")
def jmesh4():
    return JaxMesh(jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def corpus():
    return lda_corpus()


# ---- four workers -------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory, jmesh4, corpus):
    noises, refs = {}, {}
    for cid, kw in LDA_PP_CASES:
        d, w = lda_corpus(ragged=True) if "ragged" in cid else corpus
        ref, pack, dropped = _reference(jmesh4, kw, d, w)
        T_pad = pack["tokens"][0].shape[0] // WORLD
        noises[cid] = sweep_noises(ref.cfg, T_pad, WORLD, S["seed"])
        refs[cid] = ({k: np.asarray(getattr(ref, k)) for k in STATE},
                     _readers(ref), dropped, np.asarray(ref.last_work))
    res = run_world(run_lda_pushpull_cases, tmp_path_factory.mktemp("ldapp"),
                    noises, timeout=240.0)
    return res, refs


@pytest.mark.parametrize("cid", [c for c, _ in LDA_PP_CASES])
def test_four_workers_match_reference(world, cid):
    res, refs = world
    state, readers, dropped, work = refs[cid]
    got = [r[cid] for r in res]
    for k in ("Ndk", "Nwk", "z_grid"):  # worker shards, in rank order
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got]), state[k], err_msg=k)
    for g in got:
        np.testing.assert_array_equal(g["Nk"], state["Nk"])
        assert g["dropped"] == dropped
        assert g["work"] == work.tolist()
        _assert_equal({k: g[k] for k in readers}, readers)
        np.testing.assert_allclose(g["log_likelihood"],
                                   readers["log_likelihood"], rtol=1e-6)
    if "cap" in cid:
        assert all(x > 0 for x in dropped)
    else:
        assert dropped == [0] * SWEEPS


def test_four_worker_invariants_and_drops(world):
    res, _ = world
    for cid, _ in LDA_PP_CASES:
        Nwk = np.concatenate([r[cid]["Nwk"] for r in res])
        Ndk = np.concatenate([r[cid]["Ndk"] for r in res])
        n_tok = len(lda_corpus(ragged="ragged" in cid)[0])
        assert Ndk.sum() == Nwk.sum() == n_tok
        np.testing.assert_array_equal(Nwk.sum(0), res[0][cid]["Nk"])
    # the raw wire drops more than the deduped one at a tighter cap
    assert res[0]["raw-cap8"]["dropped"][0] > 0


def test_four_worker_ledger_per_sweep(world):
    """Per sweep and worker: the work allgather (4 B); per chunk the drop
    count allreduce (4 B), the Nk delta allreduce (K·4 B), two drop-count
    allreduces of the table verbs (4 B each), and the regroups: request ids
    (nw·cap·4 B), served rows and pushed (id, delta) slots."""
    res, _ = world
    K = S["n_topics"]
    for cid, kw in LDA_PP_CASES:
        for r in res:
            led = r[cid]["ledger"]
            got = {v["verb"]: (v["payload_bytes"], v["calls"])
                   for v in led["verbs"]}
            T_pad = r[cid]["z_grid"].shape[0]
            chunks = T_pad // kw["chunk"]
            cap = kw.get("pull_cap", kw["chunk"])
            slots = WORLD * cap
            assert got["allgather"] == (4, 1)
            assert got["allreduce"] == (chunks * (4 + K * 4 + 4 + 4),
                                        4 * chunks)
            assert got["regroup"] == (
                chunks * (slots * 4 + slots * K * 4 + slots * (4 + K * 4)),
                3 * chunks)
            assert led["executions"] == 1


def test_suggest_pull_cap_drops_nothing(world, corpus):
    res, _ = world
    d, w = corpus
    for dedup in (True, False):
        ref = JL.LDA(S["n_docs"], S["vocab_size"], JL.LDAConfig(
            n_topics=S["n_topics"], algo="pushpull", chunk=64,
            dedup_pulls=dedup), JaxMesh(jax.devices()[:WORLD]),
            seed=S["seed"])
        ref.set_tokens(d, w)
        want = ref.suggest_pull_cap()
        for r in res:
            cap, installed, dropped = r[f"suggest-{dedup}"]
            assert cap == installed == want and dropped == 0
    assert res[0]["suggest-True"][0] < res[0]["suggest-False"][0]


def test_children_never_import_jax(world):
    assert not any(r["_jax_imported"] for r in world[0])


# ---- one worker ----------------------------------------------------------------------

ONE = [("dedup", {"algo": "pushpull", "chunk": 64}),
       ("raw-int16", {"algo": "pushpull", "chunk": 64, "dedup_pulls": False,
                      "ndk_dtype": "int16"}),
       ("dedup-cap3-gumbel", {"algo": "pushpull", "chunk": 64, "pull_cap": 3,
                              "sampler": "gumbel"}),
       ("raw-cap16-chunk256", {"algo": "pushpull", "chunk": 256,
                               "dedup_pulls": False, "pull_cap": 16})]


@pytest.mark.parametrize("cid,kw", ONE, ids=[c for c, _ in ONE])
def test_one_worker_sweeps_match_reference(jmesh1, corpus, cid, kw):
    d, w = corpus
    ref, pack, dropped = _reference(jmesh1, kw, d, w)
    m = L.LDA(S["n_docs"], S["vocab_size"],
              L.LDAConfig(n_topics=S["n_topics"], **kw), device="cpu",
              seed=S["seed"])
    m._install_pack(pack)
    got = []
    for nz in sweep_noises(ref.cfg, pack["tokens"][0].shape[0], 1,
                           S["seed"]):
        m.sample_epoch(noise=lambda t, s, a=nz[0]: torch.from_numpy(a))
        got.append(m.last_dropped)
    assert got == dropped
    assert ("cap" in cid) == (sum(dropped) > 0)
    for k in STATE:
        np.testing.assert_array_equal(getattr(m, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    _assert_equal(_readers(m), _readers(ref))
    assert m.Ndk.dtype == getattr(torch, m.cfg.ndk_dtype)
    np.testing.assert_array_equal(m.last_work, np.asarray(ref.last_work))


@pytest.mark.parametrize("n", [1, 4])
def test_pack_and_host_helpers_are_bit_equal(corpus, n):
    d, w = corpus
    kw = {"n_topics": S["n_topics"], "algo": "pushpull", "chunk": 64}

    class Mesh(L.WorkerMesh):
        num_workers = property(lambda self: n)

    a = L.LDA(S["n_docs"], S["vocab_size"], L.LDAConfig(**kw), Mesh("cpu"),
              seed=2)
    b = JL.LDA(S["n_docs"], S["vocab_size"], JL.LDAConfig(**kw),
               JaxMesh(jax.devices()[:n]), seed=2)
    pa, pb = a.pack_tokens(d, w), b.pack_tokens(d, w)
    for k in ("z_grid", "Ndk", "Nwk", "Nk", "n_tokens"):
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    for x, y in zip(pa["tokens"], pb["tokens"]):
        np.testing.assert_array_equal(x, y)
    z0 = np.arange(len(d)) % S["n_topics"]
    for x, y in zip(L.partition_tokens_by_doc(d, w, z0, S["n_docs"], n, 64),
                    JL.partition_tokens_by_doc(d, w, z0, S["n_docs"], n, 64)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(0)
    wz = ((rng.zipf(1.1, size=len(d)) - 1) % 256).astype(np.int32)
    _, pw, _, pm, _ = JL.partition_tokens_by_doc(d, wz, z0, S["n_docs"], n,
                                                 64)
    for dedup in (True, False):
        for chunk in (16, 64):
            assert L.suggest_pull_cap(pw, pm, n, chunk, 256, dedup) == \
                JL.suggest_pull_cap(pw, pm, n, chunk, 256, dedup)
    assert (a.d_bound, a.w_bound, a.w_own) == (b.d_bound, b.w_bound, b.w_own)


# ---- the reference's push/pull contract tests, on the port's generator ----------------

def _model(n_docs, vocab, seed=1, **kw):
    return L.LDA(n_docs, vocab, L.LDAConfig(algo="pushpull", **kw),
                 device="cpu", seed=seed)


def _consistent(m):
    Ndk, Nwk = m.doc_topic_table(), m.word_topic_table()
    assert Ndk.sum() == Nwk.sum() == m.n_tokens
    np.testing.assert_array_equal(Nwk.sum(0), m.Nk.numpy())
    assert (Ndk >= 0).all() and (Nwk >= 0).all()
    d, _, z = m.token_state()
    rebuilt = np.zeros_like(Ndk, dtype=np.int64)
    np.add.at(rebuilt, (d, z), 1)
    np.testing.assert_array_equal(rebuilt, Ndk)


def test_pushpull_word_table_never_materialized_contract():
    d, w = L.synthetic_corpus(96, 64, 4, 50, seed=0)
    m = _model(96, 64, n_topics=8, chunk=64, alpha=0.5, beta=0.1)
    m.set_tokens(d, w)
    ll0 = m.log_likelihood()
    for _ in range(6):
        m.sample_epoch()
    _consistent(m)
    Nwk = m.word_topic_table()
    assert np.all(Nwk == np.round(Nwk))
    assert m.log_likelihood() > ll0 + 0.2


def test_pushpull_small_pull_cap_still_valid_chain():
    d, w = L.synthetic_corpus(64, 32, 2, 32, seed=1)
    m = _model(64, 32, n_topics=4, chunk=64, pull_cap=16)
    m.set_tokens(d, w)
    ll0 = m.log_likelihood()
    for _ in range(8):
        m.sample_epoch()
    _consistent(m)
    assert m.log_likelihood() > ll0 and m.last_dropped >= 0


def test_pushpull_drop_counter_surfaces_capacity_pressure():
    d = np.repeat(np.arange(16, dtype=np.int32), 8)
    w = np.zeros(16 * 8, np.int32)  # one hot word
    m = _model(16, 16, seed=0, n_topics=4, chunk=16, pull_cap=1,
               dedup_pulls=False)
    m.set_tokens(d, w)
    m.sample_epoch()
    assert m.last_dropped > 0
    _consistent(m)


def test_pushpull_dedup_serves_hot_word_in_one_slot():
    d = np.repeat(np.arange(16, dtype=np.int32), 8)
    w = np.zeros(16 * 8, np.int32)
    m = _model(16, 16, seed=0, n_topics=4, chunk=16, pull_cap=1)
    m.set_tokens(d, w)
    assert m.suggest_pull_cap() == 1
    m.sample_epoch()
    assert m.last_dropped == 0
    _consistent(m)


def test_pushpull_dedup_bit_identical_at_zero_drops():
    dw = L.synthetic_corpus(96, 64, 4, 50, seed=0)
    tables = []
    for dedup in (True, False):
        m = _model(96, 64, n_topics=8, chunk=64, dedup_pulls=dedup)
        m.set_tokens(*dw)
        for _ in range(3):
            m.sample_epoch()
        assert m.last_dropped == 0
        tables.append((m.doc_topic_table(), m.word_topic_table()))
    np.testing.assert_array_equal(tables[0][0], tables[1][0])
    np.testing.assert_array_equal(tables[0][1], tables[1][1])


def test_pushpull_zipf_corpus_dedup_vs_raw_drops():
    rng = np.random.default_rng(0)
    n_docs, vocab, tpd = 64, 256, 32
    d = np.repeat(np.arange(n_docs, dtype=np.int32), tpd)
    w = ((rng.zipf(1.1, size=n_docs * tpd) - 1) % vocab).astype(np.int32)
    drops = {}
    for dedup in (True, False):
        m = _model(n_docs, vocab, n_topics=4, chunk=64, pull_cap=8,
                   dedup_pulls=dedup)
        m.set_tokens(d, w)
        m.sample_epoch()
        drops[dedup] = m.last_dropped
        _consistent(m)
    assert drops[True] < drops[False]
    m = _model(n_docs, vocab, n_topics=4, chunk=64)
    m.set_tokens(d, w)
    cap = m.suggest_pull_cap(apply=True)
    assert m.cfg.pull_cap == cap < 64
    m.sample_epochs(2)
    assert m.last_dropped == 0


def test_suggest_pull_cap_exact_small_case():
    """Two workers of eight padded tokens, chunks of four, words 0-3 owned
    by worker 0 and 4-7 by worker 1 (the reference's hand-checked case)."""
    w = np.array([0, 0, 0, 1, 4, 4, 5, 6, 3, 3, 3, 3, 0, 1, 2, 3], np.int32)
    mask = np.ones(16, np.float32)
    assert L.suggest_pull_cap(w, mask, 2, 4, 8, dedup=False) == 4
    assert L.suggest_pull_cap(w, mask, 2, 4, 8, dedup=True) == 4
    mask[12:] = 0
    assert L.suggest_pull_cap(w, mask, 2, 4, 8, dedup=True) == 3
    assert L.suggest_pull_cap(w, mask, 2, 4, 8, dedup=False) == \
        JL.suggest_pull_cap(w, mask, 2, 4, 8, dedup=False)


def test_pushpull_rejects_dense_knobs_and_rotation():
    for make in (L, JL):
        with pytest.raises(ValueError, match="pull_cap only applies"):
            make.LDAConfig(algo="dense", pull_cap=8)
        with pytest.raises(ValueError, match="dense.pallas-only"):
            make._make_cfg(4, algo="pushpull", d_tile=8)
        with pytest.raises(ValueError, match="pushpull-only"):
            make._make_cfg(4, algo="scatter", chunk=16, pull_cap=8)
        with pytest.raises(ValueError, match="pull_cap must be >= 1"):
            make.LDAConfig(algo="pushpull", pull_cap=0)
        with pytest.raises(ValueError, match="never rotates"):
            make.LDAConfig(algo="pushpull", rotate_wire="int8")
    with pytest.raises(ValueError, match="pushpull"):
        _model_small = L.LDA(16, 8, L.LDAConfig(n_topics=2, algo="scatter"),
                             device="cpu")
        _model_small.suggest_pull_cap()
    m = _model(16, 8, n_topics=2)
    with pytest.raises(RuntimeError, match="set_tokens"):
        m.suggest_pull_cap()


def test_ledger_spans_and_benchmark_row():
    m = _model(96, 64, n_topics=8, chunk=64)
    m.set_tokens(*lda_corpus())
    with telemetry.scope():
        m.sample_epoch()
        m.sample_epochs(2)
        tag = telemetry.ledger.summary()["lda.epochs"]
        spans = [r["span"] for r in telemetry.tracer.records]
    assert tag["executions"] == 3 and spans == ["lda.epoch", "lda.epochs"]
    out = L.benchmark(n_docs=64, vocab_size=32, n_topics=8, tokens_per_doc=8,
                      epochs=1, algo="pushpull", device="cpu")
    assert out["dropped_tokens"] == 0 and np.isfinite(out["log_likelihood"])
    ref_keys = {"tokens_per_sec_per_chip", "sec_per_epoch", "n_tokens",
                "n_topics", "prep_sec", "num_workers", "log_likelihood",
                "dropped_tokens"}
    assert set(out) == ref_keys
    low = L.benchmark(n_docs=64, vocab_size=32, n_topics=8, tokens_per_doc=8,
                      epochs=1, algo="pushpull", pull_cap=1,
                      dedup_pulls=False, device="cpu")
    assert low["dropped_tokens"] > 0


def test_cli_pushpull_row():
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "lda", "--docs", "96",
         "--vocab", "64", "--topics", "8", "--algo", "pushpull",
         "--pull-cap", "4", "--no-dedup-pulls", "--epochs", "1",
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["config"] == "lda_cli" and row["backend"] == "cpu"
    assert row["dropped_tokens"] > 0 and row["n_tokens"] == 96 * 100
