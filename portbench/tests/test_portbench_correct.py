"""``correct`` has to come out false for the control and for each fault a
cell can have, at a size a CPU test run holds.

- The control: the reference put in the program's place, in the nearest
  precision below the configuration's (int4 for int8, TF32 for f32 with
  TF32 off, float8 for bf16), against the reference at the stated one.
  The CPU has no TF32, so the f32 cell's control is read on the card only.
- The faults, planted in the program under a whole run (the harness's
  look for a card skipped): a step that returns its state unchanged, and
  half of the batch left out with the mean taken over the rest.  One
  worker has no exchange between chips, and training produces no token
  or answer, so those faults do not apply.
- LDA: the control is the program's own lower path, K4's count gathers
  rounded to bf16 (``pallas_exact_gathers=False``); its faults are a
  rotation step that leaves its state unchanged, a sweep that skips half
  the entries, and a token's topic altered where K4 writes it (LDA's
  answer is its topics).  One worker has no exchange between chips.
"""

from __future__ import annotations

import pytest
import torch

from portbench import compare, harness
from portbench.tests.small import SMALL

SEED = 2**31 + 4242
KMEANS = ["kmeans_stream.int8.n1e9", "kmeans_stream.f32.n1e8"]
MFSGD = ["mfsgd.ml20m.zipf", "mfsgd.ml20m.uniform"]
LDA = "lda.enwiki1m.zipf"
CONTROL = {"int8": "int4", "f32": "tf32", "bf16": "fp8"}


def _driver(cell):
    m = harness.load_manifest()
    c, config, traffic = harness.resolve(m, harness.ROOT, cell)
    config = {**config, **SMALL[cell]["config"]}
    traffic = {**traffic, **SMALL[cell]["traffic"]}
    ctx = harness.Context(c, config, traffic, SEED, torch.device("cpu"),
                          0.0)
    drv = harness.load_driver(config["driver"])(ctx)
    drv.setup()
    return drv, traffic


@pytest.mark.parametrize("cell", ["kmeans_stream.int8.n1e9"] + MFSGD)
def test_the_control_is_not_correct(cell):
    drv, traffic = _driver(cell)
    n = traffic["checked_steps"]
    ref = drv.reference(n, traffic["precision"])
    control = drv.reference(n, CONTROL[traffic["precision"]])
    values = compare.numbers(drv.initial(), control, ref)
    ok, _ = compare.judge(values, traffic["limits"])
    assert not ok, values


def _run(cell):
    return harness.run_cell(cell, SEED, 0.05, False, device="cpu",
                            overrides=SMALL[cell])


@pytest.mark.parametrize("cell", KMEANS)
def test_kmeans_faults_are_not_correct(cell, monkeypatch):
    from harp_tpu_torch.models import kmeans_stream as KS

    real = KS._synthetic_run
    assert _run(cell)["correct"] is True

    def unchanged(centroids, n_iters, gen, n_chunks, cfg, col_scale):
        _, inertia = real(centroids, n_iters, gen, n_chunks, cfg, col_scale)
        return centroids, inertia

    def half(centroids, n_iters, gen, n_chunks, cfg, col_scale):
        c, inertia = real(centroids, n_iters, gen, n_chunks // 2, cfg,
                          col_scale)
        return c, inertia * (n_chunks / (n_chunks // 2))

    for fault in (unchanged, half):
        monkeypatch.setattr(KS, "_synthetic_run", fault)
        r = _run(cell)
        assert r["correct"] is False, (fault.__name__, r["checks"])


@pytest.mark.parametrize("cell", MFSGD)
def test_mfsgd_faults_are_not_correct(cell, monkeypatch):
    from harp_tpu_torch.models import mfsgd as MF

    train, set_ratings = MF.MFSGD.train_epoch, MF.MFSGD.set_ratings
    assert _run(cell)["correct"] is True

    def unchanged(self):
        W, H = self.W, self.H
        rmse = train(self)
        self.W, self.H = W, H
        return rmse

    def half(self, users, items, vals):
        return set_ratings(self, users[::2], items[::2], vals[::2])

    for name, fault in (("train_epoch", unchanged), ("set_ratings", half)):
        with monkeypatch.context() as mp:
            mp.setattr(MF.MFSGD, name, fault)
            r = _run(cell)
        assert r["correct"] is False, (name, r["checks"])


def test_lda_control_is_not_correct():
    """The program with its bf16 count gathers switched on: the replayed
    prefix no longer agrees."""
    small = SMALL[LDA]
    r = harness.run_cell(LDA, SEED, 0.05, False, device="cpu", overrides={
        "config": {**small["config"], "pallas_exact_gathers": False},
        "traffic": small["traffic"]})
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["prefix_mismatch"]["value"] > 0


def test_lda_faults_are_not_correct(monkeypatch):
    from harp_tpu_torch.ops import lda_kernel as K4

    from portbench import calibrate

    real = K4.cgs_step
    assert _run(LDA)["correct"] is True

    def unchanged(Ndk, Nwk, nk, z, *args, **kw):
        saved = [t.clone() for t in (Ndk, Nwk, z)]
        real(Ndk, Nwk, nk, z, *args, **kw)
        for t, s in zip((Ndk, Nwk, z), saved):
            t.copy_(s)
        return torch.zeros_like(nk)

    def altered(Ndk, Nwk, nk, z, *args, **kw):
        dnk = real(Ndk, Nwk, nk, z, *args, **kw)
        z[0, 0] = (z[0, 0] + 1) % Ndk.shape[1]
        return dnk

    for name, fault in (("unchanged", unchanged), ("altered", altered)):
        with monkeypatch.context() as mp:
            mp.setattr(K4, "cgs_step", fault)
            r = _run(LDA)
        assert r["correct"] is False, (name, r["checks"])
    with calibrate._half_batch("lda")():
        r = _run(LDA)
    assert r["correct"] is False, ("half the entries", r["checks"])
    assert r["checks"]["prefix_mismatch"]["value"] > 0
    assert r["checks"]["ll_gap"]["value"] > r["checks"]["ll_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", KMEANS + MFSGD)
def test_the_control_is_not_correct_on_the_card(cell):
    """On the card, where TF32 exists, at a mid size: each cell's control
    (the f32 cell's is TF32) against its reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 and the kernels run there")
    mid = {"config": {"d": 300, "k": 1000, "chunk_points": 65536},
           "traffic": {"chunks": 8}} if cell in KMEANS else {
        "config": {"n_users": 20000, "n_items": 4000, "nnz": 1_000_000},
        "traffic": {}}
    m = harness.load_manifest()
    c, config, traffic = harness.resolve(m, harness.ROOT, cell)
    config = {**config, **mid["config"]}
    traffic = {**traffic, **mid["traffic"]}
    ctx = harness.Context(c, config, traffic, SEED, torch.device("cuda:0"),
                          0.0)
    drv = harness.load_driver(config["driver"])(ctx)
    drv.setup()
    n = traffic["checked_steps"]
    ref = drv.reference(n, traffic["precision"])
    control = drv.reference(n, CONTROL[traffic["precision"]])
    ok, _ = compare.judge(compare.numbers(drv.initial(), control, ref),
                          traffic["limits"])
    assert not ok
