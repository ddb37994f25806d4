"""``harp_tpu_torch.utils.threadguard``, the runtime twin of the threads lint
layer, against harp_tpu's.

The port of ``tests/test_threadguard.py``'s nine cases: a forbidden thread
is caught at a flight-recorder observer site and at an unlocked spine's
mutator; verified-locked spines are left as they are; disarmed, the guard
installs nothing and arming twice wraps once; the live thread names match
the patterns the static graph extracted (the scheduler workers' patterns
are those of their roots, device owners in the port, so not forbidden; the
watchdog timer's is forbidden); the TCP serve plane under injected
dispatch faults runs clean with the guard armed; and the MF-SGD flagship
budget holds unchanged with it armed.  Beside them: the int8 KMeans fit on
a four-worker gloo world is bit-equal armed and disarmed, with the same
kernel launches, dispatches and readbacks, and the guard's map equals the
one the reference's graph gives outside the schedule plane.
"""

import fnmatch
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from harp_tpu.analysis import threadgraph as JTG
from harp_tpu_torch.analysis import threadgraph
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.serve.engines import ENGINES
from harp_tpu_torch.serve.server import Server
from harp_tpu_torch.utils import flightrec, reqtrace, telemetry, threadguard
from harp_tpu_torch.utils.threadguard import ThreadOwnershipError
from torch_lint_world import (guarded_fit, run_guarded_fits, run_world,
                              time_limit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = WorkerMesh("cpu")


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


def _run_named(name, fn):
    """Run ``fn`` on a thread named ``name``; return what it raised."""
    box = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - returned to the caller
            box.append(e)

    t = threading.Thread(target=run, name=name, daemon=True)
    t.start()
    t.join(30)
    return box[0] if box else None


# ---------------------------------------------------------------------------
# The guard: observer sites and unlocked-spine mutators
# ---------------------------------------------------------------------------

def test_forbidden_thread_caught_at_observer_site():
    omap = {"forbidden_thread_patterns": ["evil-*"], "spines": {}}
    with threadguard.armed(omap) as g:
        flightrec.readback(torch.zeros(2))          # main: allowed
        before = g.checks
        err = _run_named("evil-1",
                         lambda: flightrec.readback(torch.zeros(2)))
        assert isinstance(err, ThreadOwnershipError)
        assert "evil-1" in str(err) and "evil-*" in str(err)
        assert g.checks >= before + 1 and g.violations
    assert threadguard.stats()["active"] is False


def test_forbidden_thread_caught_at_unlocked_spine_mutator():
    omap = {"forbidden_thread_patterns": ["evil-*"],
            "spines": {"comm_ledger": {
                "locked": False, "module": "harp_tpu_torch.utils.telemetry",
                "obj": "ledger", "mutators": ["record"]}}}
    with telemetry.scope(True):
        with threadguard.armed(omap):
            telemetry.ledger.record("allreduce", torch.zeros(4))
            before = str(telemetry.ledger._tags)
            err = _run_named("evil-2", lambda: telemetry.ledger.record(
                "allreduce", torch.zeros(4)))
            assert isinstance(err, ThreadOwnershipError)
            assert "comm_ledger.record" in str(err)
            assert str(telemetry.ledger._tags) == before  # write rejected
    assert telemetry.ledger.record.__name__ == "record"
    assert "record" not in vars(telemetry.ledger)


def test_verified_locked_spine_is_not_wrapped():
    omap = threadgraph.ownership_map(ROOT)
    assert omap["spines"]["reqtrace"]["locked"] is True
    orig_begin = reqtrace.tracer.begin
    orig_record = telemetry.ledger.record
    with threadguard.armed():
        assert reqtrace.tracer.begin == orig_begin       # untouched
        assert telemetry.ledger.record != orig_record    # wrapped
        for sp in omap["spines"].values():
            if sp["locked"]:
                continue
            mod = __import__(sp["module"], fromlist=["_"])
            target = getattr(mod, sp["obj"]) if sp["obj"] else mod
            for mut in sp["mutators"]:
                assert getattr(target, mut).__wrapped__ is not None
    assert telemetry.ledger.record == orig_record        # restored


def test_disarmed_installs_nothing():
    registries = (flightrec._READBACK_OBSERVERS,
                  flightrec._DISPATCH_OBSERVERS,
                  flightrec._H2D_OBSERVERS,
                  flightrec._CKPT_WRITE_OBSERVERS)
    before = [list(r) for r in registries]
    orig = (flightrec.record_h2d, flightrec.record_readback,
            flightrec.record_bucket)
    with threadguard.armed():
        assert all(len(r) == len(b) + 1
                   for r, b in zip(registries, before))
    assert [list(r) for r in registries] == before
    assert (flightrec.record_h2d, flightrec.record_readback,
            flightrec.record_bucket) == orig
    assert flightrec.record_h2d is orig[0]
    assert "record" not in vars(telemetry.ledger)
    assert threadguard.stats()["active"] is False
    assert threadguard.stats()["patterns"] == []


def test_arm_is_idempotent_and_disarm_total():
    with threadguard.armed() as g:
        threadguard.arm()                   # a second arm wraps nothing
        assert len(flightrec._READBACK_OBSERVERS) == 1
        flightrec.readback(torch.zeros(1))
        assert g.checks >= 1
    assert flightrec._READBACK_OBSERVERS == []


# ---------------------------------------------------------------------------
# Sync pins: the static map and the names real threads run under
# ---------------------------------------------------------------------------

def test_scheduler_worker_names_match_their_roots_and_are_owners():
    """The port's scheduler workers own the card (their tasks launch on
    streams of their own): their live names match the patterns the graph
    took from schedule.py, and the guard's map does not forbid them, as
    the reference's does."""
    from harp_tpu_torch.schedule import DynamicScheduler, StaticScheduler

    spec = next(p for p in threadgraph.PLANES if p.name == "schedule")
    root = threadgraph._plane_graph(ROOT, spec).roots["thread:worker"]
    assert "thread:worker" in spec.device_owners
    pats = threadgraph.ownership_map(ROOT)["forbidden_thread_patterns"]
    ref = JTG.ownership_map(ROOT)["forbidden_thread_patterns"]
    assert sorted(root.name_patterns) == sorted(
        p for p in ref if p.startswith("harp-sched-"))
    seen = []
    StaticScheduler(lambda x: seen.append(
        threading.current_thread().name), n_threads=2).schedule([1, 2])
    DynamicScheduler(lambda x: seen.append(
        threading.current_thread().name), n_threads=2).schedule([1, 2])
    assert len(seen) == 4
    for name in seen:
        assert any(fnmatch.fnmatch(name, p) for p in root.name_patterns)
        assert not any(fnmatch.fnmatch(name, p) for p in pats)
    with threadguard.armed() as g:
        StaticScheduler(lambda x: flightrec.readback(torch.ones(x)),
                        n_threads=2).schedule([1, 2])
    assert g.checks >= 2 and g.violations == []  # the two readbacks


def test_watchdog_timer_name_matches_the_static_pattern():
    from harp_tpu_torch.utils.timing import HangWatchdog

    pats = threadgraph.ownership_map(ROOT)["forbidden_thread_patterns"]
    fired = []
    wd = HangWatchdog(timeout_s=600, _exit=fired.append)
    wd.arm("sync-pin")
    try:
        assert wd._timer.name == "harp-watchdog" and wd._timer.daemon
        assert any(fnmatch.fnmatch(wd._timer.name, p) for p in pats)
    finally:
        wd.cancel()
    # a watchdog that fires: on_fire first, then the exit code
    seen = []
    wd = HangWatchdog(timeout_s=0.01, exit_code=5, on_fire=seen.append,
                      _exit=fired.append)
    wd.arm("phase-x")
    wd._timer.join(10)
    assert seen == ["phase-x"] and fired == [5]


# ---------------------------------------------------------------------------
# The chaos drill: a real socket, injected faults, the guard armed
# ---------------------------------------------------------------------------

def test_tcp_chaos_serve_runs_clean_with_guard_armed(tmp_path):
    from harp_tpu_torch.serve.transport import TCPFrontEnd
    from harp_tpu_torch.utils.fault import FaultInjector

    pats = threadgraph.ownership_map(ROOT)["forbidden_thread_patterns"]
    rng = np.random.default_rng(20)
    with telemetry.scope(True):
        state = ENGINES["kmeans"].synthetic_state(rng, k=8, d=16)
        srv = Server("kmeans", state=state, mesh=CPU, ladder=(1, 8),
                     cache_dir=str(tmp_path / "graphs"),
                     budget_action="warn")
        srv.startup()
        inj = FaultInjector(seed=0, fail={"dispatch": (2,)})
        with threadguard.armed() as g, inj.arm():
            fe = TCPFrontEnd(srv, port=0, max_retries=2).start_in_thread()
            try:
                live = {t.name for t in threading.enumerate()}
                assert {"harp-serve-tcp", "harp-serve-dispatch"} <= live
                assert any(fnmatch.fnmatch("harp-serve-tcp", p)
                           for p in pats)
                assert not any(fnmatch.fnmatch("harp-serve-dispatch", p)
                               for p in pats)
                s = socket.create_connection(("127.0.0.1", fe.port),
                                             timeout=60)
                f = s.makefile("rw")
                xs = [rng.normal(size=(1 + i % 3, 16)).astype(np.float32)
                      for i in range(12)]
                for i, x in enumerate(xs):
                    f.write(json.dumps({"id": i, "x": x.tolist()}) + "\n")
                f.flush()
                got = [json.loads(f.readline()) for _ in range(12)]
                s.close()
            finally:
                fe.shutdown()
                fe.join(60)
        assert inj.injected["dispatch"] == 1      # the chaos ran
        assert fe.runner.fault_retries >= 1
        cent = state["centroids"]
        for r, x in zip(sorted(got, key=lambda r: r["id"]), xs):
            ref = np.argmin(((x[:, None, :] - cent[None]) ** 2).sum(-1), 1)
            assert r["result"] == ref.tolist()
        assert g.checks > 0 and g.violations == []
        rs, tr = fe.runner, reqtrace.tracer
        assert tr.counts["served"] + rs.shed + rs.failed == 12
        assert tr.counts["served"] == 12 and tr.summary()["open"] == 0


# ---------------------------------------------------------------------------
# Flagship pins: the armed guard costs no flight traffic
# ---------------------------------------------------------------------------

def test_flagship_budget_pin_unchanged_with_guard_armed():
    """MF-SGD's flagship budget: ``train_epochs`` is one dispatch, one
    stacked readback, no compile and no H2D, with the guard armed too."""
    from harp_tpu_torch.models import mfsgd as MF

    cfg = MF.MFSGDConfig(rank=4, algo="dense", u_tile=8, i_tile=8,
                         entry_cap=32)
    with telemetry.scope():
        m = MF.MFSGD(64, 48, cfg, CPU, seed=3)
        u, i, v = MF.synthetic_ratings(64, 48, 600, rank=4, seed=3)
        m.set_ratings(u, i, v)
        m.train_epoch()
        m.train_epochs(3)
        with threadguard.armed() as g:
            with flightrec.budget(compiles=0, dispatches=1, readbacks=1,
                                  h2d_bytes=0,
                                  tag="mfsgd.train_epochs.guard") as b:
                m.train_epochs(3)
        assert b.spent()["dispatches"] == 1
        assert b.spent()["readbacks"] == 1
        assert g.checks > 0 and g.violations == []


def test_kmeans_fit_bit_equal_armed_and_disarmed_on_one_worker():
    pts = np.random.default_rng(1).normal(size=(256, 16)).astype(np.float32)
    off, on = (guarded_fit(CPU, pts, armed) for armed in (False, True))
    np.testing.assert_array_equal(off["c"], on["c"])
    assert off["inertia"] == on["inertia"]
    for k in ("launches", "dispatches", "readbacks"):
        assert off[k] == on[k], k
    assert on["checks"] > 0 and on["violations"] == []


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pts = np.random.default_rng(0).normal(size=(512, 16)).astype(np.float32)
    return run_world(run_guarded_fits, tmp_path_factory.mktemp("guard"),
                     pts, timeout=100)


def test_kmeans_fit_bit_equal_armed_and_disarmed_on_four_workers(world):
    for w in world:
        runs = [w["0-False"], w["1-True"], w["2-False"]]
        for r in runs[1:]:
            np.testing.assert_array_equal(r["c"], runs[0]["c"])
            assert r["inertia"] == runs[0]["inertia"]
            for k in ("launches", "dispatches", "readbacks"):
                assert r[k] == runs[0][k], k
        assert runs[1]["checks"] > 0 and runs[1]["violations"] == []
        assert not w["_jax_imported"]
    np.testing.assert_array_equal(world[0]["1-True"]["c"],
                                  world[3]["1-True"]["c"])
