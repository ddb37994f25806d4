"""Harp's L5 schedulers (``harp_tpu_torch/schedule.py``) and its L4 mapper
(``harp_tpu_torch/mapper.py``) against harp_tpu's.

- The static and dynamic schedulers give the reference's results in the
  reference's order (static: round-robin per task instance; dynamic: input
  order whatever the completion order), propagate a task's error, and
  keep the streaming lifecycle; a scheduler without a CUDA device touches
  no stream.
- ``apply_rebalance`` and ``rebalance_assignment`` replay a plan as the
  reference does and refuse what it refuses; ``device_map`` equals
  ``jax.vmap`` / ``lax.map`` of the same function.
- ``CollectiveApp`` on a spawned 4-worker gloo world: each process reads
  the files ``multi_file_splits`` deals it (the reference's split of the
  same files), ``map_collective`` runs once with the verbs, the metrics
  file, the master and the host skew stamp are there, and ``run_app``
  gives the same result.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harp_tpu.fileformat as JFF
from harp_tpu import schedule as JSCH
from harp_tpu_torch import schedule as SCH
from harp_tpu_torch.mapper import KeyValReader
from torch_plane_world import (WORLD, mapper_files, run_mapper_cases,
                               run_world, time_limit)


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return mapper_files(str(tmp_path_factory.mktemp("mapper-files")))


@pytest.fixture(scope="module")
def world(files, tmp_path_factory):
    root = tmp_path_factory.mktemp("mapper")
    return run_world(run_mapper_cases, root, str(root), files)


@pytest.mark.parametrize("mod", [SCH, JSCH], ids=["port", "reference"])
@pytest.mark.parametrize("n", [0, 1, 23])
def test_static_scheduler_order_and_coverage(mod, n):
    assert mod.StaticScheduler(lambda x: x * x, n_threads=4).schedule(
        list(range(n))) == [x * x for x in range(n)]


def _counting(mod):
    class Counting(mod.Task):
        def __init__(self):
            self.seen = []

        def run(self, item):
            self.seen.append(item)
            return item

    return Counting


def test_static_tasks_own_the_references_items():
    ours = [_counting(SCH)() for _ in range(3)]
    theirs = [_counting(JSCH)() for _ in range(3)]
    SCH.StaticScheduler(ours).schedule(list(range(9)))
    JSCH.StaticScheduler(theirs).schedule(list(range(9)))
    assert [t.seen for t in ours] == [t.seen for t in theirs] == [
        list(range(t, 9, 3)) for t in range(3)]


@pytest.mark.parametrize("cls", ["StaticScheduler", "DynamicScheduler"])
def test_a_tasks_error_propagates(cls):
    def boom(x):
        raise ValueError("task died")

    with pytest.raises(ValueError, match="task died"):
        getattr(SCH, cls)(boom, n_threads=2).schedule([1, 2, 3])
    with pytest.raises(ValueError, match="at least one task"):
        getattr(SCH, cls)([])


def test_dynamic_scheduler_keeps_input_order_whatever_completes_first():
    def slow_first(x):
        time.sleep(0.02 if x == 0 else 0.0)
        return x + 1

    got = SCH.DynamicScheduler(slow_first, n_threads=4).schedule(range(12))
    want = JSCH.DynamicScheduler(slow_first, n_threads=4).schedule(
        range(12))
    assert got == want == list(range(1, 13))


def test_dynamic_scheduler_streaming_lifecycle_and_threads():
    seen = set()

    def f(x):
        seen.add(threading.current_thread().name)
        time.sleep(0.005)
        return x * 2

    s = SCH.DynamicScheduler(f, n_threads=4)
    s.start()
    for x in range(8):
        s.submit(x)
    got = dict(s.wait_output() for _ in range(8))
    assert got == {x: 2 * x for x in range(8)}
    assert s.schedule([5, 6]) == [10, 12]  # on a started scheduler
    s.stop()
    assert len(seen) > 1 and all(n.startswith("harp-sched-dyn-")
                                 for n in seen)
    with pytest.raises(RuntimeError, match="already started"):
        s.start()
        s.start()
    s.stop()


def test_dynamic_scheduler_is_reusable_after_a_failure():
    def sometimes(x):
        if x == 3:
            raise ValueError("bad item")
        return x

    s = SCH.DynamicScheduler(sometimes, n_threads=2)
    with pytest.raises(ValueError):
        s.schedule(range(6))
    assert s.schedule([7, 8]) == [7, 8]


def test_a_scheduler_without_a_cuda_device_touches_no_stream():
    for dev in (None, "cpu", torch.device("cpu")):
        st = SCH._Streams(dev)
        assert st.device is None
        ready = st.mark()
        with st.context():
            st.take(ready, torch.ones(2))
        st.give(st.mark(), torch.ones(2))
        st.end()
        assert ready is None
    out = SCH.StaticScheduler(lambda x: torch.ones(2) * x, n_threads=2,
                              device="cpu").schedule([1, 2])
    assert [o.tolist() for o in out] == [[1.0, 1.0], [2.0, 2.0]]



class _StubCuda:
    """Stand-ins for the stream and event calls that ``schedule._Streams``
    makes, logging them in order: the caller's thread runs on stream
    "caller", each task thread on its own "task-<n>"."""

    def __init__(self):
        self.log: list[tuple] = []
        self.lock = threading.Lock()
        self.local = threading.local()
        self.n_streams = self.n_events = 0
        stub = self

        class Stream:
            def __init__(self, device=None):
                with stub.lock:
                    self.name = f"task-{stub.n_streams}"
                    stub.n_streams += 1

            def wait_event(self, ev):
                stub.add("wait", self.name, ev.name)

            def wait_stream(self, other):
                stub.add("wait_stream", self.name, other.name)

        class Event:
            def __init__(self):
                with stub.lock:
                    self.name = f"ev{stub.n_events}"
                    stub.n_events += 1

            def record(self, stream):
                stub.add("record", stream.name, self.name)

        caller = Stream.__new__(Stream)
        caller.name = "caller"
        self.Stream, self.Event, self.caller = Stream, Event, caller

    def add(self, *entry) -> None:
        with self.lock:
            self.log.append(entry)

    def current_stream(self, device=None):
        return getattr(self.local, "stream", self.caller)

    def stream(self, s):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.local.stream = s
            try:
                yield
            finally:
                del self.local.stream
        return ctx()


class _Item:
    """A stand-in CUDA tensor: logs ``record_stream``."""

    is_cuda = True

    def __init__(self, stub, name):
        self.stub, self.name = stub, name

    def record_stream(self, s):
        self.stub.add("record_stream", self.name, s.name)


@pytest.fixture
def stub_cuda(monkeypatch):
    stub = _StubCuda()
    for name in ("Stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, getattr(stub, name))
    monkeypatch.setattr(torch.cuda, "current_stream", stub.current_stream)
    monkeypatch.setattr(torch.cuda, "stream", stub.stream)
    return stub


def _item_order(stub, item: str, out: str) -> list[tuple]:
    """The log entries that order one item: its hand-in event, the task
    stream's wait on it, the item's record_stream, the task's event, the
    caller's wait on it and the result's record_stream."""
    log = stub.log
    task = next(e for e in log if e == ("task", item))
    t = log.index(task)
    rs_in = next(i for i, e in enumerate(log)
                 if e[:2] == ("record_stream", item))
    stream = log[rs_in][2]
    wait_in = max(i for i, e in enumerate(log[:rs_in])
                  if e[0] == "wait" and e[1] == stream)
    ready = log[wait_in][2]
    rec_in = next(i for i, e in enumerate(log)
                  if e == ("record", "caller", ready))
    done = next(i for i, e in enumerate(log)
                if i > t and e[0] == "record" and e[1] == stream)
    wait_out = next(i for i, e in enumerate(log)
                    if e == ("wait", "caller", log[done][2]))
    rs_out = next(i for i, e in enumerate(log)
                  if e == ("record_stream", out, "caller"))
    assert rec_in < wait_in < rs_in < t < done < wait_out < rs_out, log
    return [log[i] for i in (rec_in, wait_in, rs_in, done, wait_out,
                             rs_out)]


def test_dynamic_scheduler_orders_each_item_on_both_streams(stub_cuda):
    """Each submit records an event on the caller's stream that the task's
    stream waits on before the task; each result's task event is waited
    on by the caller's stream before wait_output or schedule hands it
    out; the tensors that cross are record_stream-ed both ways."""
    stub = stub_cuda

    def task(item):
        stub.add("task", item.name)
        return _Item(stub, "out-" + item.name)

    s = SCH.DynamicScheduler(task, n_threads=2, device="cuda")
    s.start()
    handed = []
    for k in range(4):
        s.submit(_Item(stub, f"a{k}"))
        idx, out = s.wait_output()  # one item at a time: submit after start
        stub.add("handed", out.name)
        handed.append(out.name)
    outs = s.schedule([_Item(stub, f"b{k}") for k in range(3)])
    s.stop()
    assert handed == [f"out-a{k}" for k in range(4)]
    assert [o.name for o in outs] == [f"out-b{k}" for k in range(3)]
    for k in range(4):
        _item_order(stub, f"a{k}", f"out-a{k}")
        rs_out = stub.log.index(("record_stream", f"out-a{k}", "caller"))
        assert rs_out < stub.log.index(("handed", f"out-a{k}"))
    ready = {_item_order(stub, f"a{k}", f"out-a{k}")[0][2]
             for k in range(4)}
    assert len(ready) == 4  # an event of its own for every submit
    for k in range(3):
        _item_order(stub, f"b{k}", f"out-b{k}")
    waits = [e for e in stub.log if e[0] == "wait_stream"]
    assert {e[2] for e in waits} == {"task-0", "task-1"}  # stop waits all


def test_static_scheduler_orders_each_item_on_both_streams(stub_cuda):
    stub = stub_cuda

    def task(item):
        stub.add("task", item.name)
        return _Item(stub, "out-" + item.name)

    outs = SCH.StaticScheduler(task, n_threads=3, device="cuda").schedule(
        [_Item(stub, f"s{k}") for k in range(7)])
    assert [o.name for o in outs] == [f"out-s{k}" for k in range(7)]
    ready = {_item_order(stub, f"s{k}", f"out-s{k}")[0][2] for k in range(7)}
    assert len(ready) == 1  # every item handed in at once
    assert len([e for e in stub.log if e[0] == "wait_stream"]) == 3

PLAN = {"moves": [{"id": "a", "from": 0, "to": 2, "work": 5.0},
                  {"id": "c", "from": 1, "to": 0, "work": 1.0}]}
SPLITS = [["a", "b"], ["c"], []]


def test_rebalance_replays_like_the_reference():
    assert SCH.apply_rebalance(SPLITS, PLAN) == \
        JSCH.apply_rebalance(SPLITS, PLAN) == [["b", "c"], [], ["a"]]
    assert SCH.rebalance_assignment(SPLITS, PLAN) == \
        JSCH.rebalance_assignment(SPLITS, PLAN)
    assert SPLITS == [["a", "b"], ["c"], []]  # the input is not mutated
    with pytest.raises(ValueError, match="fractional"):
        SCH.apply_rebalance(SPLITS, {"moves": [{"from": 0, "to": 1,
                                                "work": 1.0}]})
    with pytest.raises(ValueError, match="not found"):
        SCH.apply_rebalance(SPLITS, {"moves": [{"id": "z", "from": 0,
                                                "to": 1, "work": 1.0}]})


@pytest.mark.parametrize("batched", [True, False])
def test_device_map_equals_the_references(batched):
    x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)

    def fn(lib):
        return lambda t: {"s": (t * t).sum(), "m": t.max()}

    got = SCH.device_map(fn(torch), torch.from_numpy(x), batched=batched)
    want = JSCH.device_map(fn(jnp), jnp.asarray(x), batched=batched)
    for k in ("s", "m"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def test_key_val_reader_is_harps_reader(files):
    r = KeyValReader(files[:2], loader=lambda p: p.upper())
    with pytest.raises(RuntimeError, match="next_key_value"):
        r.current_key()
    seen = []
    while r.next_key_value():
        seen.append((r.current_key(), r.current_value()))
    assert seen == [(p, p.upper()) for p in files[:2]] == list(r)
    assert r.paths == files[:2]


def test_collective_app_on_four_workers(world, files):
    splits = JFF.multi_file_splits(files, WORLD)
    total = sum(float(np.loadtxt(p, delimiter=",").sum()) for p in files)
    for rank, r in enumerate(world):
        assert r["paths"] == splits[rank]
        assert r["total"] == pytest.approx(total, rel=1e-12)
        assert r["run_app"] == r["total"]
        assert r["master"] == (rank == 0)
        assert r["workers"] == (WORLD, rank)
        (m,) = r["metrics"]
        assert m["step"] == 0 and m["workers"] == WORLD
        host = r["skew"]["map_collective"]
        assert host["source"] == "host" and host["n_workers"] == WORLD
        assert [w > 0 for w in host["work"]] == [
            w == rank for w in range(WORLD)]


def test_collective_app_without_a_device_raises_without_cuda():
    from harp_tpu_torch.mapper import CollectiveApp
    from harp_tpu_torch.parallel import mesh as M

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with M.use_mesh(None), pytest.raises(RuntimeError, match="CUDA"):
        CollectiveApp().run()
