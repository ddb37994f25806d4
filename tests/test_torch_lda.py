"""The port's LDA-CGS against harp_tpu's, from the same pack and draws.

Host prep: ``pack_tokens`` gives arrays bit-equal to the reference's.
Sampling: both packages start from the reference's pack (the port through
``convert.lda_state_from_numpy``) and run one ``sample_epoch``; the port
takes, through ``sample_epoch(noise=...)``, exactly the draws the reference
makes from its key chain (``prng.split_keys`` per worker, one split per
rotation step, one key per entry or chunk): the interpret-mode kernel's
uniforms for pallas, ``_cgs_resample``'s exponential or Gumbel draws for
dense and scatter.  Counts are integers and the draws are the same, so the
tables, the topics and every reader must be bit-equal.  One worker runs in
this process; four run as one spawned gloo world against a four-device
mesh.  On the port's own generator the chains are checked by their
invariants and by the log-likelihood within the reference's flip gate
(abs 0.05) of the reference's chain on the same corpus.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import lda as JL
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import prng
from harp_tpu_torch import convert
from harp_tpu_torch.models import lda as L
from harp_tpu_torch.ops import lda_kernel as K4
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from torch_world import (LDA_CASES, LDA_SHAPE, WORLD, lda_corpus,
                         run_lda_cases, run_world)

S = LDA_SHAPE
STATE = ("Ndk", "Nwk", "Nk", "z_grid")


def _kw(algo, **extra):
    base = {"n_topics": S["n_topics"], "algo": algo}
    if algo == "scatter":
        base["chunk"] = 64
    else:
        base.update(d_tile=16, w_tile=16, entry_cap=64)
    return {**base, **extra}


def reference_noise(cfg: JL.LDAConfig, tokens, n_workers, steps, seed):
    """The draws of one reference epoch: ``[worker][step]`` arrays, pallas
    ``[NE, C, K]`` uniforms, dense ``[NE, C, K]`` and scatter ``[B, K]``
    exponential or Gumbel draws."""
    K = cfg.n_topics
    keys = prng.split_keys(seed, n_workers)
    if cfg.algo == "scatter":
        B = tokens[0].shape[1]
        c = min(cfg.chunk, B)
        count, shape = B // c, (c, K)
    else:
        count, shape = tokens[0].shape[1], (tokens[0].shape[2], K)
    out = []
    for wk in range(n_workers):
        key, per_step = jnp.asarray(keys[wk]), []
        for _ in range(steps):
            key, sub = jax.random.split(key)
            draws = []
            for k in jax.random.split(sub, count):
                if cfg.algo == "pallas":
                    u = jax.random.uniform(jax.random.wrap_key_data(k),
                                           shape[::-1], jnp.float32,
                                           minval=2.0 ** -25, maxval=1.0)
                    draws.append(np.asarray(u).T)
                    continue
                if cfg.rng_impl == "rbg":
                    k = jax.random.wrap_key_data(jnp.concatenate([k, k]),
                                                 impl="rbg")
                f = (jax.random.exponential if cfg.sampler == "exprace"
                     else jax.random.gumbel)
                draws.append(np.asarray(f(k, shape, jnp.float32)))
            a = np.stack(draws)
            per_step.append(np.ascontiguousarray(
                a.reshape(-1, K) if cfg.algo == "scatter" else a))
        out.append(per_step)
    return out


def _steps(cfg, n):
    return (cfg.rotate_chunks or 2) * n


def _reference(jm, kw, d, w, epochs=1):
    m = JL.LDA(S["n_docs"], S["vocab_size"], JL.LDAConfig(**kw), jm,
               seed=S["seed"])
    pack = m.pack_tokens(d, w)
    m._install_pack(pack)
    for _ in range(epochs):
        m.sample_epoch()
    return m, pack


def _state(m):
    return {k: np.asarray(getattr(m, k)) for k in STATE}


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


class _Mesh(WorkerMesh):
    """Worker 0 of an ``n``-worker group, for host prep only."""

    def __init__(self, n):
        super().__init__("cpu")
        self._n = n

    num_workers = property(lambda self: self._n)


# ---- host prep --------------------------------------------------------------

@pytest.mark.parametrize("algo,n,extra", [
    ("pallas", 1, {}), ("pallas", 4, {"ndk_dtype": "int16"}),
    ("dense", 4, {"rotate_chunks": 3}), ("scatter", 1, {}),
    ("scatter", 4, {"rotate_chunks": 1})])
def test_pack_tokens_is_bit_equal(corpus, algo, n, extra):
    d, w = corpus
    kw = _kw(algo, **extra)
    a = L.LDA(S["n_docs"], S["vocab_size"], L.LDAConfig(**kw), _Mesh(n),
              seed=2)
    b = JL.LDA(S["n_docs"], S["vocab_size"], JL.LDAConfig(**kw),
               JaxMesh(jax.devices()[:n]), seed=2)
    pa, pb = a.pack_tokens(d, w), b.pack_tokens(d, w)
    for k in ("z_grid", "Ndk", "Nwk", "Nk", "n_tokens"):
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
        assert np.asarray(pa[k]).dtype == np.asarray(pb[k]).dtype
    for x, y in zip(pa["tokens"], pb["tokens"]):
        np.testing.assert_array_equal(x, y)
    z0 = np.arange(len(d)) % S["n_topics"]
    np.testing.assert_array_equal(a.pack_tokens(d, w, z0)["Ndk"],
                                  b.pack_tokens(d, w, z0)["Ndk"])


def test_corpora_match_reference():
    for x, y in zip(L.synthetic_corpus(20, 30, 3, 7, seed=4),
                    JL.synthetic_corpus(20, 30, 3, 7, seed=4)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(L.benchmark_corpus(50, 40, 9, 1),
                    JL.benchmark_corpus(50, 40, 9, 1)):
        np.testing.assert_array_equal(x, y)


# ---- one worker, injected draws ---------------------------------------------

ONE_WORKER = [
    ("pallas", _kw("pallas")),
    ("pallas-int16", _kw("pallas", ndk_dtype="int16")),
    ("pallas-approx", _kw("pallas", pallas_exact_gathers=False)),
    ("pallas-4chunks", _kw("pallas", d_tile=64, w_tile=64, entry_cap=1024)),
    ("pallas-nocarry", _kw("pallas", carry_db=False)),
    ("dense-exprace-rbg", _kw("dense", sampler="exprace", rng_impl="rbg")),
    ("dense-gumbel", _kw("dense", carry_db=True)),
    ("scatter-exprace", _kw("scatter", sampler="exprace")),
    ("scatter-gumbel-rbg", _kw("scatter", rng_impl="rbg")),
]


@pytest.mark.parametrize("cid,kw", ONE_WORKER, ids=[c for c, _ in ONE_WORKER])
def test_one_worker_epoch_matches_reference(jmesh1, corpus, cid, kw):
    d, w = corpus
    ref, pack = _reference(jmesh1, kw, d, w)
    cfg = L.LDAConfig(**kw)
    m = L.LDA(S["n_docs"], S["vocab_size"], cfg, device="cpu",
              seed=S["seed"])
    m._install_pack(pack)
    if cid == "pallas-4chunks":  # several chunks an entry
        assert m.cc * 4 <= pack["tokens"][0].shape[-1]
    nz = reference_noise(ref.cfg, pack["tokens"], 1, _steps(cfg, 1),
                         S["seed"])[0]
    K4.reset_launches()
    m.sample_epoch(noise=lambda t, s: torch.from_numpy(nz[t]))
    assert K4.LAUNCHES == {"cgs_entry_update": 0}  # the CPU runs the plain
    _assert_equal(_state(m), _state(ref))
    _assert_equal(_readers(m), _readers(ref))
    assert m.Ndk.dtype == getattr(torch, cfg.ndk_dtype)


def test_chunk_width_shrinks_with_hot_counts(jmesh1):
    """A 16-word vocabulary drives word-topic bounds past 256 (two gather
    planes), which halves the reference's chunk at 1k topics; the port
    picks the same width from the same pack."""
    d, w = JL.synthetic_corpus(64, 16, 4, 200, seed=5)
    kw = dict(n_topics=1000, algo="pallas", d_tile=512, w_tile=512,
              entry_cap=2048)
    m = L.LDA(64, 16, L.LDAConfig(**kw), device="cpu", seed=1)
    m.set_tokens(d, w)
    assert m._count_bounds[1] > 256 and m.cc == 128


# ---- four workers -----------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory, jmesh4, corpus):
    d, w = corpus
    noises, refs = {}, {}
    for cid, kw in LDA_CASES:
        kw = {"n_topics": S["n_topics"], **kw}
        ref, pack = _reference(jmesh4, kw, d, w)
        cfg = JL.LDAConfig(**kw)
        noises[cid] = reference_noise(cfg, pack["tokens"], WORLD,
                                      _steps(cfg, WORLD), S["seed"])
        refs[cid] = (ref, _state(ref), _readers(ref))
    res = run_world(run_lda_cases, tmp_path_factory.mktemp("lda"), noises,
                    timeout=240.0)
    return res, refs


@pytest.mark.parametrize("cid", [c for c, _ in LDA_CASES])
def test_four_workers_match_reference(world, cid):
    res, refs = world
    _, state, readers = refs[cid]
    got = [r[cid] for r in res]
    for k in ("Ndk", "Nwk", "z_grid"):  # worker shards, in rank order
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got]), state[k], err_msg=k)
    for g in got:
        np.testing.assert_array_equal(g["Nk"], state["Nk"])
        _assert_equal({k: g[k] for k in readers}, readers)


def test_four_worker_ledger_per_epoch(world):
    """Per epoch on four workers: the work allgather (4 B), one Nk
    allreduce (K·4 B) and one ring hop of one word chunk (w_rows·K·4 B)
    per rotation step."""
    res, _ = world
    for cid, kw in LDA_CASES:
        cfg = L.LDAConfig(n_topics=S["n_topics"], **kw)
        steps = _steps(cfg, WORLD)
        m = L.LDA(S["n_docs"], S["vocab_size"], cfg, _Mesh(WORLD))
        chunk_rows = m.w_bound // (cfg.rotate_chunks or 2)
        K = S["n_topics"]
        for r in res:
            led = r[cid]["ledger"]
            got = {v["verb"]: (v["payload_bytes"], v["calls"])
                   for v in led["verbs"]}
            assert got == {"allgather": (4, 1),
                           "allreduce": (steps * K * 4, steps),
                           "reshard": (steps * chunk_rows * K * 4, steps)}
            assert led["executions"] == 1


def test_children_never_import_jax(world):
    assert not any(r["_jax_imported"] for r in world[0])


# ---- the port's own generator -----------------------------------------------

def _invariants(m):
    Ndk, Nwk = m.doc_topic_table(), m.word_topic_table()
    Nk = m.Nk.numpy()
    assert Ndk.sum() == Nwk.sum() == m.n_tokens
    np.testing.assert_array_equal(Nwk.sum(0), Nk)
    np.testing.assert_array_equal(Nwk, np.round(Nwk))
    assert (Ndk >= 0).all() and (Nwk >= 0).all() and (Nk >= 0).all()
    d, w, z = m.token_state()  # the counts reconcile with the topics
    rebuilt = np.zeros_like(Ndk, dtype=np.int64)
    np.add.at(rebuilt, (d, z), 1)
    np.testing.assert_array_equal(rebuilt, Ndk)


@pytest.mark.parametrize("algo", ["pallas", "dense", "scatter"])
def test_native_chain_invariants_and_reference_likelihood(jmesh1, corpus,
                                                           algo):
    """Twelve sweeps from four seeds on each side: the invariants hold and
    the mean log-likelihood is within the flip gate (abs 0.05) of the
    reference's.  One chain's likelihood after twelve sweeps still moves by
    ~0.1 with its seed (it settles in one of several modes), so the gate
    is on the mean over the seeds."""
    d, w = corpus
    kw = (_kw(algo, chunk=256) if algo == "scatter" else
          _kw(algo, d_tile=32, w_tile=32, entry_cap=256))
    kw["sampler"] = "exprace"
    ll_ref, ll = [], []
    for seed in (3, 4, 5, 6):
        r = JL.LDA(S["n_docs"], S["vocab_size"], JL.LDAConfig(**kw), jmesh1,
                   seed=seed)
        r.set_tokens(d, w)
        r.sample_epochs(12)
        ll_ref.append(r.log_likelihood())
        m = L.LDA(S["n_docs"], S["vocab_size"], L.LDAConfig(**kw),
                  device="cpu", seed=seed)
        m.set_tokens(d, w)
        ll0 = m.log_likelihood()
        m.sample_epoch()
        m.sample_epochs(11)
        _invariants(m)
        ll.append(m.log_likelihood())
        assert ll[-1] > ll0
        assert m.last_work.tolist() == [m.n_tokens]
    assert abs(np.mean(ll) - np.mean(ll_ref)) < 0.05, (ll, ll_ref)


@pytest.mark.parametrize("algo", ["pallas", "dense"])
def test_int16_and_carry_give_the_same_chain(corpus, algo):
    d, w = corpus
    out = []
    for extra in ({}, {"ndk_dtype": "int16"}, {"carry_db": True},
                  {"carry_db": False}):
        m = L.LDA(S["n_docs"], S["vocab_size"],
                  L.LDAConfig(**_kw(algo, sampler="exprace", **extra)),
                  device="cpu", seed=5)
        m.set_tokens(d, w)
        m.sample_epochs(3)
        out.append((m.doc_topic_table().astype(np.float32),
                    m.word_topic_table(), m.z_grid.numpy()))
    for o in out[1:]:
        for a, b in zip(o, out[0]):
            np.testing.assert_array_equal(a, b)


# ---- API, config, entry points ----------------------------------------------

def _small(algo="pallas", **extra):
    m = L.LDA(S["n_docs"], S["vocab_size"], L.LDAConfig(**_kw(algo, **extra)),
              device="cpu", seed=1)
    m.set_tokens(*lda_corpus())
    return m


def test_ledger_per_epoch_on_one_worker_follows_the_reference(jmesh1,
                                                              corpus):
    """The reference's ledger records a site of its rotation scan once per
    trace; run time executes it once per rotation step.  So per epoch the
    port's bytes are the reference's site payloads with the step-body site
    (the Nk allreduce) times the steps: 4 + 2 · K · 4 on one worker (its
    ring hops move nothing)."""
    import harp_tpu.utils.telemetry as JT

    d, w = corpus
    kw = _kw("pallas")
    with JT.scope():
        _reference(jmesh1, kw, d, w, epochs=2)
        ref = JT.ledger.summary()["lda.epochs"]
    site = {s["verb"]: s["payload_bytes"] for s in ref["sites"]}
    m = _small()
    with telemetry.scope():
        m.sample_epoch()
        m.sample_epochs(2)
        tag = telemetry.ledger.summary()["lda.epochs"]
        spans = [r["span"] for r in telemetry.tracer.records]
    steps = _steps(m.cfg, 1)
    assert tag["executions"] == ref["executions"] + 1 == 3
    assert {v["verb"]: v["payload_bytes"] // 3 for v in tag["verbs"]} == {
        "allgather": site["allgather"],
        "allreduce": steps * site["allreduce"]}
    assert spans == ["lda.epoch", "lda.epochs"]


def test_config_validation_matches_reference():
    for kw, err in (({"algo": "nope"}, "algo"),
                    ({"ndk_dtype": "int8"}, "ndk_dtype"),
                    ({"algo": "pallas", "sampler": "gumbel"}, "exprace"),
                    ({"algo": "dense", "sampler": "x"}, "sampler"),
                    ({"algo": "dense", "rng_impl": "x"}, "rng_impl"),
                    ({"algo": "dense", "pull_cap": 4}, "pull_cap"),
                    ({"algo": "scatter", "carry_db": True}, "carry_db"),
                    ({"rotate_chunks": 0}, "rotate_chunks"),
                    ({"rotate_wire": "f16"}, "rotate_wire"),
                    ({"algo": "pushpull", "rotate_chunks": 2}, "rotate")):
        with pytest.raises(ValueError, match=err):
            L.LDAConfig(**kw)
        with pytest.raises(ValueError, match=err):
            JL.LDAConfig(**kw)
    for algo in ("pallas", "dense", "scatter"):
        for carry in (None, True, False):
            if carry and algo == "scatter":
                continue
            a = L.LDAConfig(algo=algo, carry_db=carry)
            b = JL.LDAConfig(algo=algo, carry_db=carry)
            assert L.carry_db_resolved(a) == JL.carry_db_resolved(b)
    assert dataclass_defaults(L.LDAConfig) == dataclass_defaults(JL.LDAConfig)
    with pytest.raises(ValueError, match="scatter-only|pushpull-only"):
        L._make_cfg(8, "dense", chunk=64)


def dataclass_defaults(cls):
    import dataclasses

    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("what", ["fit-ckpt", "fit-fault",
                                  "pack_cache", "--ckpt-dir", "--resume",
                                  "--input", "--elastic",
                                  "--max-worker-loss"])
def test_unported_options_raise_naming_the_roadmap(what, tmp_path):
    """pack_cache still raises naming its ROADMAP item; the checkpoint,
    input and elastic options are ported, and each case checks its ported
    behaviour instead."""
    if what == "fit-ckpt":
        a, b = _small(), _small()
        a.fit(2)
        b.fit(2, str(tmp_path / "c"))
        np.testing.assert_array_equal(a.z_grid.numpy(), b.z_grid.numpy())
        return
    if what == "fit-fault":
        with pytest.raises(ValueError, match="ckpt_dir"):
            _small().fit(1, fault=object())
        return
    if what in ("--ckpt-dir", "--resume", "--input"):
        want = {"--ckpt-dir": (RuntimeError, "device='cpu'"),
                "--resume": (SystemExit, "requires --ckpt-dir"),
                "--input": (SystemExit, "no input files")}[what]
        arg = {"--ckpt-dir": [str(tmp_path / "c")],
               "--input": [str(tmp_path / "none*.txt")]}.get(what, [])
        dev = [] if what == "--ckpt-dir" else ["--device", "cpu"]
        with pytest.raises(want[0], match=want[1]):
            L.main([what, *arg, *dev])
        return
    if what in ("--elastic", "--max-worker-loss"):
        # the elastic loop on a small synthetic corpus (one worker)
        arg = {"--max-worker-loss": ["1"]}.get(what, [])
        assert L.main([what, *arg, "--docs", "32", "--vocab", "24",
                       "--topics", "4", "--tokens-per-doc", "6",
                       "--epochs", "1", "--algo", "dense", "--d-tile", "8",
                       "--w-tile", "8", "--entry-cap", "16", "--device",
                       "cpu"]) == 0
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*item"):
        L.benchmark(n_docs=8, vocab_size=8, n_topics=2,
                    tokens_per_doc=2, pack_cache="x", device="cpu")


def test_state_checks_and_convert():
    m = L.LDA(S["n_docs"], S["vocab_size"], L.LDAConfig(**_kw("pallas")),
              device="cpu")
    with pytest.raises(RuntimeError, match="set_tokens"):
        m.sample_epoch()
    pack = m.pack_tokens(*lda_corpus())
    st = convert.lda_state_from_numpy(pack, "cpu")
    assert st["Ndk"].dtype == torch.float32 and len(st["tokens"]) == 4
    assert st["z_grid"].dtype == torch.int32
    with pytest.raises(ValueError, match="z_grid"):
        convert.lda_state_from_numpy({**pack, "z_grid": pack["z_grid"][:1]},
                                     "cpu")
    with pytest.raises(ValueError, match="Nk"):
        convert.lda_state_from_numpy({**pack, "Nk": pack["Nk"][:3]}, "cpu")
    with pytest.raises(ValueError, match="int16"):
        convert.lda_state_from_numpy(
            {**pack, "Ndk": pack["Ndk"].astype(np.int64)}, "cpu")
    i16 = L.LDA(S["n_docs"], S["vocab_size"],
                L.LDAConfig(**_kw("pallas", ndk_dtype="int16")), device="cpu")
    with pytest.raises(ValueError, match="config says int16"):
        i16._install_pack(pack)
    with pytest.raises(ValueError, match="int16"):
        i16.pack_tokens(np.zeros(40000, np.int32), np.zeros(40000, np.int32))


@pytest.mark.parametrize("algo", ["pallas", "dense", "scatter"])
def test_benchmark_reports_on_the_cpu(algo):
    kw = {} if algo == "scatter" else {"d_tile": 16, "w_tile": 16,
                                       "entry_cap": 64}
    out = L.benchmark(n_docs=64, vocab_size=32, n_topics=8, tokens_per_doc=8,
                      epochs=1, algo=algo, device="cpu", **kw)
    ref_keys = {"tokens_per_sec_per_chip", "sec_per_epoch", "n_tokens",
                "n_topics", "prep_sec", "num_workers", "log_likelihood"}
    assert set(out) == ref_keys and out["tokens_per_sec_per_chip"] > 0
    assert np.isfinite(out["log_likelihood"])


def test_cli_module_entry_row():
    out = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "lda", "--docs", "96",
         "--vocab", "64", "--topics", "8", "--d-tile", "16", "--w-tile",
         "16", "--entry-cap", "64", "--algo", "pallas", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["config"] == "lda_cli" and row["backend"] == "cpu"
    assert row["n_tokens"] == 96 * 100 and np.isfinite(row["log_likelihood"])
