"""Checkpoint, resume and fault recovery: the port's ``utils.checkpoint``
and ``utils.fault`` and every trainer's durable run, against harp_tpu's.

Every trainer (KMeans f32 and int8, MF-SGD, LDA, CCD++, the MLP's
``fit_ckpt`` and streaming KMeans f32 and int8) runs three times, on one
worker and in a spawned 4-worker gloo world: uninterrupted, with a worker
failure injected after its first checkpoint, and with one before it.

- The recovered runs are bit-equal to the port's uninterrupted run on
  the CPU (exact comparisons): a restore round-trips the state exactly,
  and a replayed iteration is the same computation on the same operands.
- The recovered run is within each app's parity tolerance of the
  reference's recovered run (the reference's recovery loop, the same
  failure): KMeans and streaming centroids rtol/atol 1e-5 (int8 on one
  worker bit-equal), inertia within 1e-5 of Σ|x|²; MF-SGD W and H rtol
  1e-4, atol 1e-5; CCD++ rtol 1e-4, atol 1e-6; MLP params rtol 1e-5,
  atol 1e-6.  LDA draws from the port's own generator (a different
  stream by design), so against the reference only its exact invariants
  are compared: each document's and each word's token count.
- Then the reference's ``tests/test_fault.py`` cases that need no flight
  recorder site, on the port's modules: the recovery loop, the
  injector's schedules on the ``ckpt_write`` site, crash-atomic saves, the
  fallback past damaged steps, ``resolve_resume``, and the CLIs'
  ``--resume`` contract.
"""

import json

import jax
import numpy as np
import pytest

from harp_tpu.models import ccd as JC
from harp_tpu.models import kmeans as JKM
from harp_tpu.models import kmeans_stream as JKS
from harp_tpu.models import lda as JL
from harp_tpu.models import mfsgd as JMF
from harp_tpu.models import mlp as JM
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu.utils import fault as JF
from harp_tpu_torch.models import ccd as CC
from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.models import kmeans_stream as KS
from harp_tpu_torch.models import lda as L
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.models import mlp as M
from harp_tpu_torch.utils import fault as F
from harp_tpu_torch.utils.checkpoint import CheckpointManager
from harp_tpu_torch.utils.fault import (FaultInjector, InjectedFault,
                                        PermanentWorkerLoss, WorkerFailure,
                                        resolve_resume, run_with_recovery)
from torch_world import (RECOVERY_FAILS, RECOVERY_TRAINERS, REC_MF, WORLD,
                         mfsgd_case_inputs, recovery_mlp_data,
                         recovery_points, recovery_run, run_fault_cases,
                         run_world)


def _starts(n_dev: int) -> dict:
    """The starting states both packages share: the reference's own
    initial factors and params (MF-SGD's from the shared test inputs)."""
    jm = JaxMesh(jax.devices()[:n_dev])
    cu, ci, cv = MF.synthetic_ratings(64, 48, 900, rank=3, seed=0)
    ccd = JC.CCD(64, 48, JC.CCDConfig(rank=4), jm, seed=0)
    tr = JM.MLPTrainer(JM.MLPConfig(sizes=(16, 32, 4), lr=0.05,
                                    optimizer="momentum"), jm, seed=0)
    return {"mfsgd": mfsgd_case_inputs(REC_MF, n_dev),
            "ccd": (cu, ci, cv, np.asarray(ccd.W), np.asarray(ccd.H)),
            "mlp": {"params": [{k: np.asarray(v) for k, v in p.items()}
                               for p in tr.params]}}


def _reference(name: str, n_dev: int, root, starts: dict) -> dict:
    """The reference's recovered run (failure after its first
    checkpoint)."""
    jm = JaxMesh(jax.devices()[:n_dev])
    kw = {"ckpt_dir": str(root / f"ref-{name}-{n_dev}"),
          "fault": JF.FaultInjector(fail_at=RECOVERY_FAILS["after"])}
    if name.startswith("kmeans"):
        q = "int8" if name.endswith("int8") else None
        c, inertia = JKM.fit(recovery_points(), k=4, iters=8, mesh=jm,
                             seed=0, quantize=q, ckpt_every=2, **kw)
        return {"c": c, "inertia": inertia}
    if name.startswith("stream"):
        q = "int8" if name.endswith("int8") else None
        c, _, hist = JKS.fit_streaming(
            recovery_points(), k=4, iters=5, chunk_points=96, mesh=jm,
            seed=0, quantize=q, return_history=True, ckpt_every=1, **kw)
        return {"c": c, "hist": hist}
    if name == "mfsgd":
        u, i, v, W0, H0 = starts["mfsgd"]
        m = JMF.MFSGD(96, 64, JMF.MFSGDConfig(rank=8, **REC_MF), mesh=jm)
        m.W, m.H = jm.shard_array(W0, 0), jm.shard_array(H0, 0)
        m.set_ratings(u, i, v)
        m.fit(5, ckpt_every=2, **kw)
        return {"W": np.asarray(m.W), "H": np.asarray(m.H)}
    if name == "lda":
        m = JL.LDA(32, 40, JL.LDAConfig(n_topics=4, algo="dense", d_tile=8,
                                       w_tile=8, entry_cap=32),
                   mesh=jm, seed=1)
        m.set_tokens(*JL.synthetic_corpus(32, 40, 2, tokens_per_doc=12,
                                          seed=1))
        m.fit(5, ckpt_every=2, **kw)
        return {"Ndk": np.asarray(m.doc_topic_table()),
                "Nwk": np.asarray(m.word_topic_table())}
    if name == "ccd":
        u, i, v, W0, H0 = starts["ccd"]
        m = JC.CCD(64, 48, JC.CCDConfig(rank=4), jm, seed=0)
        m.set_ratings(u, i, v)
        m.fit(5, ckpt_every=2, **kw)
        return {"W": np.asarray(m.W), "H": np.asarray(m.H)}
    if name == "mlp":
        x, y = recovery_mlp_data()
        tr = JM.MLPTrainer(JM.MLPConfig(sizes=(16, 32, 4), lr=0.05,
                                        optimizer="momentum"), jm, seed=0)
        hist = tr.fit_ckpt(x, y, 5, kw["ckpt_dir"], batch_size=64,
                           ckpt_every=2, fault=kw["fault"])
        out = {f"{i}{k}": np.asarray(p[k])
               for i, p in enumerate(tr.params) for k in p}
        out["hist"] = np.asarray(hist)
        return out
    raise ValueError(name)


def _hold_to_reference(name, got, want, rank=0, nw=1):
    """``got``: the port's recovered run on worker ``rank`` of ``nw``."""
    if name.startswith(("kmeans", "stream")):
        exact = name == "kmeans-int8" and nw == 1
        tol = {"rtol": 0, "atol": 0} if exact else {"rtol": 1e-5,
                                                    "atol": 1e-5}
        np.testing.assert_allclose(got["c"], want["c"], **tol)
        x2 = float((recovery_points().astype(np.float64) ** 2).sum())
        if name.startswith("kmeans"):
            assert abs(got["inertia"] - want["inertia"]) <= 1e-5 * x2
        else:
            np.testing.assert_allclose(got["hist"], want["hist"],
                                       atol=1e-5 * x2)
    elif name in ("mfsgd", "ccd"):
        tol = ({"rtol": 1e-4, "atol": 1e-5} if name == "mfsgd"
               else {"rtol": 1e-4, "atol": 1e-6})
        rows = want["W"].shape[0] // nw
        np.testing.assert_allclose(
            got["W"], want["W"][rank * rows:(rank + 1) * rows], **tol)
        h = want["H"]
        if name == "mfsgd":  # H is sharded: this worker's resident chunks
            rows = h.shape[0] // nw
            h = h[rank * rows:(rank + 1) * rows]
        np.testing.assert_allclose(got["H"], h, **tol)
    elif name == "lda":
        for k in ("Ndk", "Nwk"):
            np.testing.assert_array_equal(got[k].sum(1), want[k].sum(1))
    elif name == "mlp":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "hist" and "0w" in a:
            # the MLP's history lists the replayed epochs too (the
            # reference's contract): its last three are the clean run's
            np.testing.assert_array_equal(a[k][-3:], b[k][-3:])
            continue
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def starts1():
    return _starts(1)


@pytest.fixture(scope="module")
def starts4():
    return _starts(WORLD)


@pytest.fixture(scope="module")
def world(tmp_path_factory, starts4):
    root = tmp_path_factory.mktemp("fault")
    return run_world(run_fault_cases, root, str(root / "ck"), starts4,
                     timeout=240.0)


@pytest.mark.parametrize("name", RECOVERY_TRAINERS)
def test_one_worker_recovery_is_bit_equal_and_matches_reference(
        name, tmp_path, starts1):
    clean = recovery_run(name, None, None, starts1)
    got = {}
    for when, fail_at in RECOVERY_FAILS.items():
        got[when] = recovery_run(name, str(tmp_path / when), fail_at,
                                 starts1)
        _bit_equal(got[when], clean)
    _hold_to_reference(name, got["after"],
                       _reference(name, 1, tmp_path, starts1))


@pytest.mark.parametrize("name", RECOVERY_TRAINERS)
def test_four_worker_recovery_is_bit_equal_and_matches_reference(
        name, world, tmp_path, starts4):
    want = _reference(name, WORLD, tmp_path, starts4)
    for r, w in enumerate(world):
        for when in RECOVERY_FAILS:
            _bit_equal(w[name][when], w[name]["clean"])
        _hold_to_reference(name, w[name]["after"], want, r, WORLD)
        assert not w["_jax_imported"]


# ---- the reference's recovery-loop cases -------------------------------------

def _driver(tmp_path, fail_at=(), max_restarts=3, n_iters=20, ckpt_every=4):
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trace = []

    def step(i, state):
        trace.append(i)
        return {"acc": state["acc"] + np.float32(i)}

    state = run_with_recovery(
        lambda: {"acc": np.float32(0.0)}, step, n_iters, ckpt,
        ckpt_every=ckpt_every, max_restarts=max_restarts,
        fault=FaultInjector(fail_at))
    return state, trace


def test_recovery_clean_run(tmp_path):
    state, trace = _driver(tmp_path)
    assert trace == list(range(20))
    assert float(state["acc"]) == sum(range(20))


def test_recovery_resumes_from_checkpoint(tmp_path):
    state, trace = _driver(tmp_path, fail_at=(10,))
    # failed at 10 → restart from the checkpoint of step 7 (every 4: 3, 7)
    assert trace[:11] == list(range(10)) + [8]
    assert float(state["acc"]) == sum(range(20))


def test_recovery_restart_from_scratch_before_first_ckpt(tmp_path):
    state, trace = _driver(tmp_path, fail_at=(2,))
    assert trace[:3] == [0, 1, 0]
    assert float(state["acc"]) == sum(range(20))


def test_recovery_gives_up(tmp_path):
    with pytest.raises(WorkerFailure):
        _driver(tmp_path, fail_at=(5, 6, 7, 8), max_restarts=2)


def test_fault_injector_fires_once():
    fi = FaultInjector(fail_at=(3,))
    with pytest.raises(WorkerFailure):
        fi.check(3)
    fi.check(3)  # transient: a second pass over the iteration is clean
    assert fi.fired == [3]


def _drive_site(inj, n, site="ckpt_write"):
    fired = []
    for _ in range(n):
        try:
            inj.on_event(site)
        except InjectedFault as e:
            fired.append(e.ordinal)
    return fired


def test_injector_seeded_schedule_is_reproducible():
    a = _drive_site(FaultInjector(seed=11, fail={"ckpt_write": 0.3}), 50)
    b = _drive_site(FaultInjector(seed=11, fail={"ckpt_write": 0.3}), 50)
    c = _drive_site(FaultInjector(seed=12, fail={"ckpt_write": 0.3}), 50)
    assert a == b and 0 < len(a) < 50 and a != c


def test_injector_ordinal_schedule_counters_and_bounds():
    inj = FaultInjector(fail={"ckpt_write": (2, 4)})
    assert _drive_site(inj, 5) == [2, 4]
    assert inj.seen["ckpt_write"] == 5 and inj.injected["ckpt_write"] == 2
    assert inj.events == [("ckpt_write", 2), ("ckpt_write", 4)]
    assert inj.counters()["injected"]["dispatch"] == 0
    inj = FaultInjector(fail={"ckpt_write": 1.0}, max_faults=3)
    assert _drive_site(inj, 10) == [1, 2, 3]
    inj = FaultInjector(delay={"ckpt_write": (1,)}, delay_s=0.0)
    inj.on_event("ckpt_write")
    inj.on_event("ckpt_write")
    assert inj.delayed["ckpt_write"] == 1 and inj.injected["ckpt_write"] == 0


def test_injector_rejects_unknown_and_unported_sites():
    """An unknown site is refused; the flight-recorder sites, once
    unported, now arm an observer each (and only while armed)."""
    from harp_tpu_torch.utils import flightrec as FR

    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(fail={"dispacth": 0.1})
    regs = {"dispatch": FR._DISPATCH_OBSERVERS, "h2d": FR._H2D_OBSERVERS,
            "readback": FR._READBACK_OBSERVERS}
    for site, reg in regs.items():
        inj = FaultInjector(fail={site: (1,)})
        with inj.arm():
            assert len(reg) == 1
        assert reg == []


def test_injector_ckpt_write_site_leaves_only_a_tmp_dir(tmp_path):
    """A fault at the ckpt_write site lands after the bytes and before the
    rename: the earlier set stands, plus one ignored tmp.* directory."""
    root = tmp_path / "c"
    mgr = CheckpointManager(str(root))
    mgr.save(0, {"x": np.arange(3.0)})
    inj = FaultInjector(fail={"ckpt_write": (1,)})
    with inj.arm():
        with pytest.raises(InjectedFault, match="ckpt_write"):
            mgr.save(1, {"x": np.arange(3.0) + 1})
    assert sorted(p.name for p in root.iterdir()) == [
        "step_000000000000", "tmp.000000000001"]
    assert mgr.steps() == [0]
    step, state = mgr.restore_latest()
    assert step == 0
    np.testing.assert_array_equal(state["x"], np.arange(3.0))
    mgr.save(1, {"x": np.arange(3.0) + 1})  # the next save clears it
    assert sorted(p.name for p in root.iterdir()) == [
        "step_000000000000", "step_000000000001"]
    assert F._CKPT_WRITE_OBSERVERS == []  # disarmed on exit


def test_checkpoint_save_is_atomic_and_prunes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep=2)
    for s in (3, 4, 5):
        mgr.save(s, {"x": np.arange(4.0) + s, "n": s, "t": (None, "a")})
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "step_000000000004", "step_000000000005"]
    step, state = mgr.restore()
    assert step == 5 and state["n"] == 5 and state["t"] == (None, "a")
    np.testing.assert_array_equal(state["x"], np.arange(4.0) + 5)


def test_checkpoint_round_trips_tensors_exactly(tmp_path):
    import torch

    st = {"f": torch.randn(5, 3), "b": torch.randn(4).to(torch.bfloat16),
          "i": torch.arange(6, dtype=torch.int16), "l": [torch.ones(2)],
          "g": torch.Generator().manual_seed(3).get_state()}
    CheckpointManager(str(tmp_path)).save(0, st)
    _, got = CheckpointManager(str(tmp_path)).restore()
    np.testing.assert_array_equal(got["f"], st["f"].numpy())
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"],
                                                            st["b"])
    assert got["i"].dtype == np.int16
    np.testing.assert_array_equal(got["g"], st["g"].numpy())
    assert isinstance(got["l"], list)
    with open(tmp_path / "step_000000000000" / "rank_00000.json") as f:
        assert json.load(f)["world"] == 1


def test_checkpoint_truncated_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"x": np.arange(3.0)})
    mgr.save(2, {"x": np.arange(3.0) + 10})
    npz = tmp_path / "c" / "step_000000000002" / "rank_00000.npz"
    npz.write_bytes(npz.read_bytes()[:40])  # a torn copy
    with pytest.warns(RuntimeWarning, match="falling back"):
        step, state = mgr.restore_latest()
    assert step == 1
    np.testing.assert_array_equal(state["x"], np.arange(3.0))
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert mgr.restore(None)[0] == 1


def test_checkpoint_all_damaged_raises_filenotfound(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"x": np.arange(3.0)})
    for child in (tmp_path / "c" / "step_000000000001").iterdir():
        child.unlink()
    with pytest.warns(RuntimeWarning):
        with pytest.raises(FileNotFoundError, match="no restorable"):
            mgr.restore_latest()


def test_resolve_resume_contract(tmp_path):
    assert resolve_resume(None, False) is None
    assert resolve_resume(str(tmp_path / "x"), False) is None
    with pytest.raises(SystemExit, match="requires --ckpt-dir"):
        resolve_resume(None, True)
    with pytest.raises(SystemExit, match="no checkpoints"):
        resolve_resume(str(tmp_path / "empty"), True)
    CheckpointManager(str(tmp_path / "full")).save(4, {"x": np.arange(2.0)})
    assert resolve_resume(str(tmp_path / "full"), True) == 4


CLIS = {"kmeans": (KM.main, ["--n", "64", "--d", "4", "--k", "2",
                             "--iters", "2"]),
        "kmeans-stream": (KS.main, ["--k", "2", "--iters", "1"]),
        "mfsgd": (MF.main, ["--users", "16", "--items", "8", "--nnz", "64",
                            "--rank", "4", "--epochs", "1", "--algo",
                            "scatter"]),
        "lda": (L.main, ["--docs", "16", "--vocab", "8", "--topics", "4",
                         "--tokens-per-doc", "4", "--epochs", "1"])}


@pytest.mark.parametrize("app", sorted(CLIS))
def test_cli_resume_contract(app, tmp_path, capsys):
    """--resume without --ckpt-dir, and with an empty one, fails as the
    reference's does; a populated directory resumes and says so."""
    main, args = CLIS[app]
    with pytest.raises(SystemExit, match="requires --ckpt-dir"):
        main(args + ["--resume", "--device", "cpu"])
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="no checkpoints"):
        main(args + ["--resume", "--ckpt-dir", ck, "--device", "cpu"])
    if app == "kmeans-stream":
        np.save(tmp_path / "p.npy", recovery_points())
        args = args + ["--input", str(tmp_path / "p.npy")]
    main(args + ["--ckpt-dir", ck, "--device", "cpu"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(args + ["--ckpt-dir", ck, "--resume", "--device", "cpu"])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["resumed_from"] is None and again["resumed_from"] == 0
    assert again["ckpt_dir"] == ck


def test_kmeans_killed_then_resumed_is_bit_identical(tmp_path):
    """The reference's kill/resume pin: the process dies (max_restarts=0)
    after two checkpointed chunks; a fresh call resumes, and a call with
    nothing left still reports the checkpointed inertia."""
    pts = recovery_points()
    clean = KM.fit(pts, k=4, iters=6, seed=0, device="cpu")
    ck = str(tmp_path / "crash")
    with pytest.raises(WorkerFailure):
        KM.fit(pts, k=4, iters=6, seed=0, device="cpu", ckpt_dir=ck,
               ckpt_every=2, max_restarts=0,
               fault=FaultInjector(fail_at=(2,)))
    assert CheckpointManager(ck).latest_step() == 1
    for _ in range(2):
        c, inertia = KM.fit(pts, k=4, iters=6, seed=0, device="cpu",
                            ckpt_dir=ck, ckpt_every=2)
        np.testing.assert_array_equal(c, clean[0])
        assert inertia == clean[1]
    with pytest.raises(ValueError, match="ckpt_dir"):
        KM.fit(pts, k=4, iters=2, device="cpu",
               fault=FaultInjector(fail_at=(1,)))


def test_mfsgd_fit_resume_installs_and_refuses(tmp_path):
    u, i, v, W0, H0 = mfsgd_case_inputs(REC_MF, 1)
    from harp_tpu_torch import convert

    def make(rank=8):
        m = MF.MFSGD(96, 64, MF.MFSGDConfig(rank=rank, **REC_MF),
                     device="cpu", state=None if rank != 8 else
                     convert.mfsgd_state_from_numpy({"W": W0, "H": H0},
                                                    "cpu"))
        m.set_ratings(u, i, v)
        return m

    ck = str(tmp_path / "mf")
    a = make()
    assert len(a.fit(6, ck, ckpt_every=2,
                     fault=FaultInjector(fail_at=(3,)))) >= 6
    assert CheckpointManager(ck).latest_step() == 5
    b = make()
    assert b.fit(6, ck, ckpt_every=2) == []  # nothing left: installed
    np.testing.assert_array_equal(b.W.numpy(), a.W.numpy())
    with pytest.raises(ValueError, match="refusing to resume"):
        make(rank=4).fit(6, ck)


def test_mlp_and_ccd_resume_with_nothing_left(tmp_path):
    x, y = recovery_mlp_data()
    ck = str(tmp_path / "mlp")
    a = M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4), optimizer="adam"),
                     device="cpu", seed=0)
    hist = a.fit_ckpt(x, y, 4, ck, batch_size=16, ckpt_every=2,
                      fault=FaultInjector(fail_at=(3,)))
    assert len(hist) >= 4
    b = M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4), optimizer="adam"),
                     device="cpu", seed=1)
    assert b.fit_ckpt(x, y, 4, ck, batch_size=16) == []
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            np.testing.assert_array_equal(pa[k].numpy(), pb[k].numpy())
    assert int(b.opt_state["count"]) == int(a.opt_state["count"])
    with pytest.raises(ValueError, match="refusing to resume"):
        M.MLPTrainer(M.MLPConfig(sizes=(16, 32, 4), optimizer="sgd"),
                     device="cpu").fit_ckpt(x, y, 4, ck, batch_size=16)
    cu, ci, cv = MF.synthetic_ratings(64, 48, 900, rank=3, seed=0)
    m = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu", seed=0)
    m.set_ratings(cu, ci, cv)
    ck = str(tmp_path / "ccd")
    m.fit(3, ck)
    m2 = CC.CCD(64, 48, CC.CCDConfig(rank=4), device="cpu", seed=5)
    m2.set_ratings(cu, ci, cv)
    assert m2.fit(3, ck) == []
    np.testing.assert_array_equal(m2.H.numpy(), m.H.numpy())


def test_permanent_loss_fires_once_and_reproduces():
    def run():
        inj = FaultInjector(seed=3, permanent={"ckpt_write": (4,)},
                            lost_worker=2)
        fired = []
        for _ in range(8):
            try:
                inj.on_event("ckpt_write")
            except PermanentWorkerLoss as e:
                fired.append((e.site, e.ordinal, e.worker))
        return fired, inj

    fired, inj = run()
    assert fired == [("ckpt_write", 4, 2)]
    assert inj.permanent_fired and inj.injected["ckpt_write"] == 1
    assert run()[0] == fired
    with pytest.raises(ValueError, match="lost_worker"):
        FaultInjector(permanent={"ckpt_write": (1,)})
    e = PermanentWorkerLoss("ckpt_write", 2, 5)
    assert isinstance(e, WorkerFailure) and not isinstance(e, InjectedFault)


def test_run_with_recovery_and_permanent_losses(tmp_path):
    calls = []

    def dies(i, state):
        calls.append(i)
        raise PermanentWorkerLoss("ckpt_write", i + 1, 0)

    with pytest.raises(PermanentWorkerLoss):
        run_with_recovery(lambda: 0, dies, 3,
                          CheckpointManager(str(tmp_path / "a")),
                          max_restarts=3)
    assert calls == [0]  # no retry without a handler
    handled, armed = [], [True]

    def step(i, state):
        if i == 1 and armed[0]:
            armed[0] = False
            raise PermanentWorkerLoss("ckpt_write", 2, 4)
        return state + 1

    out = run_with_recovery(lambda: 0, step, 3,
                            CheckpointManager(str(tmp_path / "b")),
                            ckpt_every=1, max_restarts=0,
                            on_permanent=handled.append)
    assert out == 3 and [e.worker for e in handled] == [4]


def test_fit_epochs_contract(tmp_path):
    """Entry-state restart, an installed no-op resume, and fault without a
    directory refused."""
    box = {"x": np.zeros(2)}

    def train():
        box["x"] = box["x"] + 1

    def set_state(s):
        box["x"] = np.array(s["x"], copy=True)

    get = lambda: {"x": box["x"]}  # noqa: E731
    F.fit_epochs(train, get, set_state, 3, str(tmp_path / "e"),
                 ckpt_every=10, fault=FaultInjector(fail_at=(2,)))
    np.testing.assert_array_equal(box["x"], [3, 3])
    box["x"] = np.full(2, 99.0)
    F.fit_epochs(train, get, set_state, 3, str(tmp_path / "e"))
    np.testing.assert_array_equal(box["x"], [3, 3])
    with pytest.raises(ValueError, match="ckpt_dir"):
        F.fit_epochs(train, get, set_state, 1, fault=FaultInjector())
