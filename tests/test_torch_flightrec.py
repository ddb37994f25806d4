"""The port's flight recorder (``utils/flightrec.py``) and the fault
injector's flight-recorder sites against harp_tpu's.

- One event sequence through both recorders: the same counters, the same
  ``budget`` violations (raised messages, warn-mode health findings), the
  same ``SteadyState`` summaries, violations and ``verify_exact``
  verdicts.
- What feeds it: ``track`` (one dispatch a call, observers first),
  ``readback`` (one D2H copy), ``WorkerMesh.shard_array`` (H2D bytes),
  ``timing.device_sync`` (a readback), and CompileWatch's kernel builds
  and graph captures.  Zero cost while telemetry is off.
- The ``dispatch``, ``h2d`` and ``readback`` fault sites fire on their
  schedules through the flight recorder's observers, with the reference
  injector's counters on the same event sequence.
"""

import io
import json
import warnings

import numpy as np
import pytest
import torch

from harp_tpu import health as JH
from harp_tpu.utils import fault as JF
from harp_tpu.utils import flightrec as JFR
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch import health as PH
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import fault as PF
from harp_tpu_torch.utils import flightrec as PFR
from harp_tpu_torch.utils import telemetry as PT
from harp_tpu_torch.utils import timing
from torch_world import time_limit

PAIRS = [(JT, JFR, JH), (PT, PFR, PH)]


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


#: (op, argument) events of one run
EVENTS = [("h2d", 4096), ("dispatch", "a"), ("readback", 64), ("h2d", 10),
          ("dispatch", "b"), ("dispatch", "a"), ("readback", 8),
          ("bucket", 128), ("h2d", 1)]


def _play(fr, events):
    for op, arg in events:
        if op == "h2d":
            fr.record_h2d(arg, site="s")
        elif op == "readback":
            fr.record_readback(arg, site="s")
        elif op == "bucket":
            fr.record_bucket(arg, site="s")
        else:
            fr.transfers.record_dispatch(arg)


def _budget_run(tel, fr, **limits):
    with tel.scope(True):
        try:
            with fr.budget(**limits, tag="blk") as b:
                _play(fr, EVENTS)
                spent = b.spent()
            return spent, None
        except fr.BudgetExceeded as e:
            return None, str(e)


@pytest.mark.parametrize("limits", [
    {}, {"dispatches": 3, "readbacks": 2}, {"dispatches": 2},
    {"h2d_bytes": 4000, "readbacks": 1, "h2d_calls": 3},
    {"compiles": 0, "d2h_bytes": 71}])
def test_budget_matches_the_reference(limits):
    ref = _budget_run(JT, JFR, **limits)
    got = _budget_run(PT, PFR, **limits)
    assert got[1] == ref[1]
    if ref[0] is not None:
        assert got[0] == ref[0]


def test_counters_and_summary_match_the_reference():
    out = []
    for tel, fr, _ in PAIRS:
        with tel.scope(True):
            _play(fr, EVENTS)
            s = fr.transfers.summary()
            out.append((fr.snapshot(), s))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]


def test_warn_budget_lands_on_the_health_monitor_as_the_reference():
    rows = []
    for tel, fr, health in PAIRS:
        with tel.scope(True), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for _ in range(3):
                with fr.budget(dispatches=1, readbacks=0, action="warn",
                               tag="bench.x"):
                    _play(fr, EVENTS)
            rows.append(([str(x.message) for x in w],
                         [{k: v for k, v in r.items()} for r in
                          health.monitor.findings()]))
    assert rows[0] == rows[1]
    assert rows[1][1][0]["violations"] == 3


#: per-batch (dispatches, readbacks, h2d) of a steady-state run
BATCHES = [(1, 1, 1), (1, 1, 1), (2, 1, 1), (1, 0, 2), (0, 1, 0), (1, 1, 1)]


def _steady_run(tel, fr, action):
    with tel.scope(True), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        st = fr.SteadyState(compiles=0, dispatches=1, readbacks=1,
                            h2d_calls=1, action=action, tag="serve.t")
        errors = []
        for d, r, h in BATCHES:
            try:
                with st.batch():
                    for _ in range(d):
                        fr.transfers.record_dispatch("x")
                    for _ in range(r):
                        fr.record_readback(4, site="s")
                    for _ in range(h):
                        fr.record_h2d(8, site="s")
            except fr.BudgetExceeded as e:
                errors.append(str(e))
        try:
            exact = st.verify_exact(len(BATCHES))
        except fr.BudgetExceeded as e:
            exact = str(e)
        return (st.summary(), errors, exact, [str(x.message) for x in w])


@pytest.mark.parametrize("action", ["raise", "warn"])
def test_steady_state_matches_the_reference(action):
    ref = _steady_run(JT, JFR, action)
    got = _steady_run(PT, PFR, action)
    assert got == ref
    assert got[0]["violations"] >= 3


def test_steady_state_and_budget_are_free_while_off():
    st = PFR.SteadyState(dispatches=0)
    with PT.scope(False):
        with st.batch():
            PFR.transfers.record_dispatch("x")
        with PFR.budget(dispatches=0) as b:
            pass
        PFR.record_h2d(99)
        PFR.record_readback(9)
        PFR.on_capture("g", 1.0)
    assert b is None and st.batches == 0 and st.summary() == {
        "batches": 0, "violations": 0}
    assert PFR.transfers.h2d_bytes == 0 and PFR.compile_watch.count == 0


def test_track_counts_a_dispatch_after_its_observers():
    calls = []
    fn = PFR.track(lambda x: x + 1, "lbl")
    with PT.scope(True):
        assert fn(1) == 2
        with PFR.observe_dispatches(calls.append):
            fn(2)

            def boom(label):
                raise RuntimeError("no")

            with PFR.observe_dispatches(boom), pytest.raises(RuntimeError):
                fn(3)
        assert PFR.transfers.dispatches == 2  # the aborted one never ran
    assert calls == ["lbl", "lbl"]
    assert fn.__wrapped__(5) == 6


def test_readback_counts_one_copy_to_the_host():
    x = torch.arange(6, dtype=torch.float32)
    with PT.scope(True):
        out = PFR.readback(x)
        x += 1  # the host copy is the caller's
        assert out.tolist() == [0, 1, 2, 3, 4, 5]
        assert (PFR.transfers.readbacks, PFR.transfers.d2h_bytes) == (1, 24)
        timing.device_sync(x)
        assert PFR.transfers.readbacks == 2


def test_shard_array_counts_this_workers_h2d_bytes():
    m = WorkerMesh("cpu")
    with PT.scope(True):
        m.shard_array(np.zeros((8, 3), np.float32))
        assert (PFR.transfers.h2d_calls, PFR.transfers.h2d_bytes) == (1, 96)
        (site,) = PFR.transfers.summary()["sites"]
        assert site["site"].startswith("test_torch_flightrec.py:")


def test_compile_watch_counts_builds_and_captures_under_their_spans():
    with PT.scope(True):
        with PT.span("startup"):
            PFR.on_build("kmeans_partials", 12.5)
            PFR.on_capture("serve.kmeans.b8", 0.25)
        with pytest.raises(PFR.BudgetExceeded, match="compiles used 1"):
            with PFR.budget(compiles=0):
                PFR.on_capture("late", 0.1)
        s = PFR.compile_watch.summary()
        buf = io.StringIO()
        PFR.export_jsonl(buf)
    assert s["count"] == 3 and s["by_span"]["startup"]["count"] == 2
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [r["event"] for r in rows if r["kind"] == "compile"] == [
        "kernel_build", "graph_capture", "graph_capture"]
    assert rows[0]["backend"] in ("cpu", "cuda")


def test_telemetry_export_writes_every_plane(tmp_path):
    with PT.scope(True):
        with PT.span("s"):
            PFR.record_h2d(8, site="x")
        PT.export(str(tmp_path / "run.jsonl"))
    rows = PT.load_rows(str(tmp_path / "run.jsonl"))
    assert len(rows["span"]) == 1 and len(rows["transfer"]) == 1
    assert len(rows["memory"]) == 2  # the staged buffer + the summary


# ---------------------------------------------------------------------------
# the fault injector's flight-recorder sites
# ---------------------------------------------------------------------------

def _site_run(fault_mod, fr, site, sched, op):
    """Six events at ``site`` through the recorder, with ``sched``; the
    ordinals that raised, and the injector's counters."""
    inj = fault_mod.FaultInjector(seed=3, delay_s=0.0, lost_worker=0,
                                  **sched)
    raised = []
    with inj.arm():
        for i in range(1, 7):
            try:
                op(fr)
            except fault_mod.WorkerFailure:
                raised.append(i)
    return raised, inj.counters(), inj.events


def _ops(site):
    if site == "dispatch":
        return lambda fr: fr.track(lambda: None, "serve.b1")()
    if site == "h2d":
        return lambda fr: fr.record_h2d(64)
    return lambda fr: fr.readback(np.zeros(4, np.float32))


@pytest.mark.parametrize("site,sched", [
    ("dispatch", {"fail": {"dispatch": (2, 5)}}),
    ("h2d", {"fail": {"h2d": (1,)}, "delay": {"h2d": 0.5}}),
    ("readback", {"permanent": {"readback": (3,)}}),
    ("dispatch", {"fail": {"dispatch": 0.4}, "max_faults": 2})])
def test_flightrec_sites_fire_on_schedule_as_the_reference(site, sched):
    ref = _site_run(JF, JFR, site, sched, _ops(site))
    got = _site_run(PF, PFR, site, sched, _ops(site))
    assert got == ref
    assert got[0] and got[1]["seen"][site] == 6


def test_a_dispatch_fault_fires_before_the_dispatch_counts():
    inj = PF.FaultInjector(fail={"dispatch": (1,)})
    fn = PFR.track(lambda: 7, "x")
    with PT.scope(True), inj.arm():
        with pytest.raises(PF.InjectedFault) as e:
            fn()
        assert fn() == 7
        assert PFR.transfers.dispatches == 1
    assert (e.value.site, e.value.ordinal) == ("dispatch", 1)
    assert not PFR._DISPATCH_OBSERVERS  # disarmed on exit


def test_an_h2d_fault_aborts_a_placement_before_it_counts():
    m = WorkerMesh("cpu")
    inj = PF.FaultInjector(fail={"h2d": (2,)})
    with PT.scope(True), inj.arm():
        m.shard_array(np.ones(4, np.float32))
        with pytest.raises(PF.InjectedFault, match="h2d"):
            m.shard_array(np.ones(4, np.float32))
        assert PFR.transfers.h2d_calls == 1
    assert not PFR._H2D_OBSERVERS


def test_a_readback_fault_marks_the_request_timeline():
    from harp_tpu_torch.utils import reqtrace

    inj = PF.FaultInjector(fail={"readback": (1,)})
    with PT.scope(True), inj.arm():
        with pytest.raises(PF.InjectedFault):
            PFR.readback(torch.ones(2))
        (mark,) = reqtrace.tracer.marks
    assert (mark["source"], mark["name"], mark["site"]) == (
        "fault", "injected_fail", "readback")
    assert not PFR._READBACK_OBSERVERS
