"""The LDA cell's corpus and reference at a size a CPU test run holds: the
reference's Philox, layout and chunk rule against the program's, and its
chain (the first entries of each rotation step, and whole sweeps) against
the program's CPU path (K4's plain version)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import gen_corpus, harness
from portbench.reference import lda as ref
from portbench.tests.small import SMALL

ROOT = harness.ROOT
CELL = "lda.enwiki1m.zipf"
SEED = 2**31 + 6007


def _files(overrides=True):
    cfg = json.loads((ROOT / "portbench/configs/lda-enwiki1m-k1000.json")
                     .read_text())
    trf = json.loads((ROOT / "portbench/traffic/enwiki1m_zipf.json")
                     .read_text())
    if overrides:
        cfg.update(SMALL[CELL]["config"])
        trf.update(SMALL[CELL]["traffic"])
    return cfg, trf


@pytest.mark.parametrize("K,cc", [(4, 256), (10, 128), (1000, 128)])
def test_reference_philox_is_the_programs(K, cc):
    from harp_tpu_torch.ops import lda_kernel as K4

    C = 2 * cc
    for s in ([3, 100], [-2**31, 2**31 - 1], [-7, -123456789]):
        seed2 = torch.tensor(s, dtype=torch.int32)
        want = K4.philox_uniforms(seed2, C, K, cc)
        got = ref.uniforms(seed2, torch.arange(C), cc, K)
        assert torch.equal(got, want)
        odd = torch.arange(1, C, 3)
        assert torch.equal(ref.uniforms(seed2, odd, cc, K), want[odd])


@pytest.mark.parametrize("K,tile,C,int16,bounds", [
    (1000, 512, 2048, True, (8_000, 8_800_000)),
    (1000, 512, 768, False, (200, 200)),
    (1000, 512, 2048, True, (150, 250)),
    (8, 16, 256, True, (20, 900)),
    (100, 256, 1024, False, (5_000, 70_000))])
def test_chunk_rule_is_the_programs(K, tile, C, int16, bounds):
    from harp_tpu_torch.ops import lda_kernel as K4

    want = K4.chunk_width(K, tile, tile, C, "int16" if int16 else "float32",
                          True, bounds)
    assert ref.chunk_width(K, tile, tile, C, int16, *bounds) == want


def _corpus(cfg, trf, seed=SEED):
    return gen_corpus.corpus(cfg, trf, seed, "cpu")


def test_layout_is_the_programs_pack():
    from harp_tpu_torch.models import lda as L

    cfg, trf = _files()
    docs, words = _corpus(cfg, trf)
    lay = ref.Layout(docs, words, cfg)
    model = L.LDA(cfg["n_docs"], cfg["vocab_size"], L.LDAConfig(
        n_topics=cfg["n_topics"], d_tile=cfg["d_tile"], w_tile=cfg["w_tile"],
        entry_cap=cfg["entry_cap"], ndk_dtype=cfg["ndk_dtype"]), seed=5,
        device="cpu")
    z0 = ref.initial_topics(5, lay.n_tokens, cfg["n_topics"], "cpu")
    pack = model.pack_tokens(docs.int().numpy(), words.int().numpy(),
                             z0.numpy())
    ed, ew, od, ow = (torch.from_numpy(a) for a in pack["tokens"])
    assert tuple(ed.shape) == (2, lay.NE, lay.C)
    flat, ent = lay.flat(), lay.slice * lay.NE + lay.entry
    assert torch.equal(ed.reshape(-1)[flat].long(), lay.cd)
    assert torch.equal(ew.reshape(-1)[flat].long(), lay.cw)
    assert torch.equal(od.reshape(-1)[ent].long(), lay.od)
    assert torch.equal(ow.reshape(-1)[ent].long(), lay.ow)
    assert int((ed < cfg["d_tile"]).sum()) == lay.n_tokens
    z = torch.from_numpy(pack["z_grid"]).reshape(-1)[flat].long()
    assert torch.equal(z, z0[lay.order])
    model._install_pack(pack)
    assert model.cc == lay.cc and lay.C % lay.cc == 0 and lay.C > lay.cc
    d, w, zt = (torch.from_numpy(np.asarray(a)) for a in model.token_state())
    assert torch.equal(d, lay.doc) and torch.equal(w, lay.word)
    assert torch.equal(zt.long(), z)
    bad, _ = ref.recount(d, w, zt, cfg["n_docs"], cfg["vocab_size"],
                         cfg["n_topics"], cfg["alpha"], cfg["beta"],
                         tables=(model.doc_topic_table(),
                                 model.word_topic_table(), model.Nk))
    assert bad == 0


def _driver_run(sweeps):
    m = harness.load_manifest()
    cell, cfg, trf = harness.resolve(m, ROOT, CELL)
    cfg, trf = {**cfg, **SMALL[CELL]["config"]}, {**trf,
                                                  **SMALL[CELL]["traffic"]}
    ctx = harness.Context(cell, cfg, trf, SEED, torch.device("cpu"), 0.0)
    drv = harness.load_driver("lda")(ctx)
    drv.setup()
    prog = drv.steps(sweeps)
    drv.release()
    return drv, prog, cfg


def test_prefix_replay_is_the_programs_first_step_bit_for_bit():
    """The reference chain's replay of the first entries of both rotation
    steps of the first sweep agrees with the program's topics exactly."""
    drv, prog, cfg = _driver_run(1)
    out = drv.reference(1, "exact")
    lay = out["layout"]
    assert out["aligned"]
    first = drv._program_topics(prog[0]["z"])
    z0 = ref.initial_topics(drv.lda_seed, lay.n_tokens, cfg["n_topics"],
                            "cpu")[lay.order]
    for key, s in (("prefix", 0), ("rotate", 1)):
        lo, hi, z = out[key]
        assert bool((lay.slice[lo:hi] == s).all())
        assert hi - lo > 10_000
        assert torch.equal(first[lo:hi], z)
        assert int((z != z0[lo:hi]).sum()) > (hi - lo) // 2  # moved
    assert drv._numbers(prog, out)["rotate_mismatch"] == 0


def test_the_reference_chain_follows_whole_sweeps_bit_for_bit():
    """Over two whole sweeps, both slices, every token's topic from the
    reference's own chain is the program's; its likelihood after each
    sweep is the one ``ll_center`` is set from."""
    drv, prog, cfg = _driver_run(2)
    out = drv.reference(2, "exact")
    rows = drv.chain(2, out)
    assert [r["mismatch"] for r in rows] == [0, 0]
    lls = drv._numbers(prog, out)["ll_per_token"]
    assert [r["ll_per_token"] for r in rows] == pytest.approx(lls,
                                                              rel=1e-12)
    # the chain moved: its second sweep's likelihood is not its first's
    assert rows[1]["ll_per_token"] != rows[0]["ll_per_token"]


def test_a_program_that_packs_otherwise_fails_only_the_replays():
    """Tokens held in another order than the stated layout: the replays
    read inf, while the multiset of tokens and the recounts still hold."""
    drv, prog, _ = _driver_run(2)
    out = drv.reference(2, "exact")
    d, w, slot = drv.held
    perm = torch.arange(d.numel() - 1, -1, -1)
    drv.held = (d[perm], w[perm], slot[perm])
    out = drv.reference(2, "exact")
    got = drv._numbers(prog, out)
    assert not out["aligned"] and "rotate" not in out
    assert got["prefix_mismatch"] == got["rotate_mismatch"] == float("inf")
    assert got["count_gap"] == 0


def test_the_recount_finds_an_altered_count():
    cfg, trf = _files()
    docs, words = _corpus(cfg, trf)
    K, n_docs, V = cfg["n_topics"], cfg["n_docs"], cfg["vocab_size"]
    z = ref.initial_topics(3, docs.numel(), K, "cpu")
    tables = [torch.bincount(docs * K + z, minlength=n_docs * K)
              .reshape(-1, K).to(torch.int16),
              torch.bincount(words * K + z, minlength=V * K).reshape(-1, K)
              .float(), torch.bincount(z, minlength=K).float()]
    kw = dict(n_docs=n_docs, V=V, K=K, alpha=cfg["alpha"],
              beta=cfg["beta"])
    assert ref.recount(docs, words, z, tables=tables, **kw)[0] == 0
    tables[1][3, 1] += 1
    tables[0][0, 0] -= 1
    assert ref.recount(docs, words, z, tables=tables, **kw)[0] == 2
    # the order of the tokens does not matter, their topics do
    perm = torch.randperm(docs.numel())
    assert ref.recount(docs[perm], words[perm], z[perm], tables=tables,
                       **kw)[0] == 2
    tables[1][3, 1] -= 1
    tables[0][0, 0] += 1
    z[5] = (z[5] + 1) % K  # two cells of each table off by one
    assert ref.recount(docs, words, z, tables=tables, **kw)[0] == 6


def test_the_likelihood_is_the_collapsed_joint():
    """On a corpus small enough to sum by hand: one doc of words [0, 1,
    1], topics [0, 1, 1], K = 2, V = 2."""
    from math import lgamma

    z = torch.tensor([0, 1, 1])
    a, b = 0.1, 0.01
    want = (2 * lgamma(2 * b) - lgamma(1 + 2 * b) - lgamma(2 + 2 * b)
            + lgamma(1 + b) - lgamma(b) + lgamma(2 + b) - lgamma(b)
            + lgamma(2 * a) - lgamma(3 + 2 * a)
            + lgamma(1 + a) - lgamma(a) + lgamma(2 + a) - lgamma(a))
    _, ll = ref.recount(torch.tensor([0, 0, 0]), torch.tensor([0, 1, 1]), z,
                        1, 2, 2, a, b)
    assert ll == pytest.approx(want / 3, rel=1e-12)


def test_corpus_same_seed_same_tokens_other_seed_same_tiles():
    cfg, trf = _files()
    a, b, c = _corpus(cfg, trf), _corpus(cfg, trf), _corpus(cfg, trf, 11)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert int(a[0].max()) < cfg["n_docs"] and int(a[1].max()) < \
        cfg["vocab_size"]
    # sorted by document, then word
    key = a[0] * cfg["vocab_size"] + a[1]
    assert bool((key[1:] >= key[:-1]).all())

    def tiles(docs, words):
        w_own = -(-cfg["vocab_size"] // cfg["rotate_chunks"])
        t = (docs // cfg["d_tile"]) * 4096 + (words // w_own) * 1024 \
            + (words % w_own) // cfg["w_tile"]
        return torch.bincount(t)

    assert torch.equal(tiles(*a), tiles(*c))
    assert torch.equal(torch.bincount(a[0]).sort().values,
                       torch.bincount(c[0]).sort().values)


def test_corpus_lengths_and_zipf_mass():
    """At the configuration's vocabulary and tile width, 2,000 documents:
    the mean length, the cap, and word tile 0's Zipf share (H(512) /
    H(1,000,000) = 0.474)."""
    cfg, trf = _files(overrides=False)
    cfg["n_docs"] = 2000
    docs, words = _corpus(cfg, trf)
    n = torch.bincount(docs, minlength=cfg["n_docs"])
    assert int(n.min()) >= 1 and int(n.max()) <= trf["doc_len_cap"]
    assert float(n.double().mean()) == pytest.approx(293.44, rel=0.1)
    V = cfg["vocab_size"]
    h = np.cumsum(1.0 / np.arange(1, V + 1))
    share = float((words < 512).double().mean())
    assert share == pytest.approx(h[511] / h[-1], abs=0.01)
    lo, size = gen_corpus.bands(V, "cpu")
    assert int(lo[0]) == 0 and int(size.sum()) == V
    assert torch.equal(gen_corpus.band_of(lo), torch.arange(lo.numel()))


class _Slice:
    """A closed slice whose trace holds one K4 launch and a readback."""

    window_s = 1e-3

    def collect(self):
        def ev(cat, name, ts, dur, corr):
            return {"ph": "X", "cat": cat, "name": name, "ts": ts,
                    "dur": dur, "args": {"correlation": corr}}

        return [ev("cuda_runtime", "cudaLaunchCooperativeKernel", 0, 5, 1),
                ev("kernel", "void (anonymous namespace)::step_kernel<short,"
                   " true>(short*, float*)", 10, 500, 1),
                ev("cuda_runtime", "cudaMemcpyAsync", 520, 5, 2),
                ev("gpu_memcpy", "Memcpy DtoH", 530, 2, 2)]


def test_the_trace_check_counts_k4_launches():
    """A slice whose trace holds fewer K4 launches than the program's
    ``LAUNCHES`` counted is refused; a whole one gives the record."""
    from portbench import trace
    from portbench.drivers.lda import Driver

    cfg, trf = _files()
    drv = Driver(harness.Context({"name": CELL}, cfg, trf, SEED,
                                 torch.device("cpu"), 0.0))
    drv.n_tokens, drv.prep_s = 84_000, 1.5
    with pytest.raises(trace.TraceShort):
        drv._record(_Slice(), 2, 1, [0.3, 0.2, 0.3], 1)
    out = drv._record(_Slice(), 1, 1, [0.3, 0.2, 0.5], 1)
    rec = out["record"]
    assert trace.count_tag(rec["trace"], "K4") == 1
    assert rec["slice"] == {"sweeps": 1}
    assert rec["host"] == {"sweep_s": pytest.approx(0.4), "prep_s": 1.5}
    assert harness.load_reader(ROOT, "k4.roofline")(rec) == pytest.approx(
        100 * rec["work"]["sweep_bound_s"] / 500e-6)
