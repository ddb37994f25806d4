"""The program's spans and K3's work counter (``utils/telemetry.py``,
``ops/mfsgd_kernel.K3_WORK``).

- an off span (telemetry off, no profiler) is one shared null context and
  records nothing;
- ``collect_spans()`` records spans and leaves the comm ledger and the
  flight recorder at zero;
- under a CPU ``torch.profiler`` a span is a ``user_annotation`` that
  encloses the ``aten::`` ops run inside it, with telemetry off and on;
- the stage spans of ``MFSGD.set_ratings``, ``rotate_pipeline``, the
  epoch and the streaming Lloyd loop, each where its stage runs;
- ``K3_WORK`` after ``train_epoch`` on the CPU route: the schedules'
  entries and levels over the epoch's steps;
- one card-only case: a profiled ``train_epoch`` holds one ``mfsgd.k3``
  range around each ``sgd_step_kernel`` launch.

This file imports only torch and the port, so its card case also runs
with ``--noconftest`` on the card's machine.
"""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest
import torch

from harp_tpu_torch.models import kmeans_stream as KS
from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.ops import mfsgd_kernel as K3
from harp_tpu_torch.utils import flightrec, telemetry


def _profiled(fn, tmp_path, device="cpu"):
    """Run ``fn`` under a torch.profiler and return its trace events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _inside(e, outer) -> bool:
    return (float(outer["ts"]) <= float(e["ts"]) and float(e["ts"])
            + float(e.get("dur", 0)) <= float(outer["ts"])
            + float(outer["dur"]))


def _small_model(cfg=None):
    cfg = cfg or MF.MFSGDConfig(rank=4, algo="pallas", u_tile=8, i_tile=8,
                                entry_cap=16)
    m = MF.MFSGD(96, 64, cfg, device="cpu", seed=1)
    return m, MF.synthetic_ratings(96, 64, 2000, rank=4, noise=0.05, seed=1)


def test_an_off_span_is_the_shared_null_context_and_records_nothing():
    with telemetry.scope(False):
        a, b = telemetry.span("a"), telemetry.span("b", t=3)
        assert a is b is telemetry.tracer.span("c")
        with a as got:
            assert got is None
            assert telemetry.tracer.current_path() is None
        assert telemetry.tracer.records == []


def test_collect_spans_records_spans_and_leaves_the_ledgers_at_zero():
    m, rating = _small_model()
    with telemetry.scope(False), telemetry.collect_spans() as tr:
        m.set_ratings(*rating)
        m.train_epoch()
        names = collections.Counter(r["span"] for r in tr.records)
        assert telemetry.ledger.volume() == 0
        s = flightrec.transfers.summary()
        assert (s["h2d_calls"], s["readbacks"], s["dispatches"],
                s["sites"]) == (0, 0, 0, [])
    assert not telemetry.enabled()
    steps = MF.rotate_chunks_resolved(m.cfg)
    assert names == {"mfsgd.set_ratings": 1, "mfsgd.partition": 1,
                     "mfsgd.schedule": 1, "mfsgd.shard": 1,
                     "mfsgd.epoch": 1, "rotate.step": steps,
                     "rotate.hop": steps, "mfsgd.k3": steps,
                     "mfsgd.combine": 1, "mfsgd.readback": 1}
    # the block is over: spans are off again
    assert telemetry.span("x") is telemetry.span("y")


@pytest.mark.parametrize("collect", [False, True])
def test_under_a_profiler_a_span_is_an_annotation_around_its_ops(tmp_path,
                                                                 collect):
    a = torch.randn(64, 64)

    def run():
        with telemetry.span("stage"):
            torch.mm(a, a)
            torch.add(a, a)
        torch.sub(a, a)

    with telemetry.scope(False):
        if collect:
            with telemetry.collect_spans() as tr:
                events = _profiled(run, tmp_path)
            assert [r["span"] for r in tr.records] == ["stage"]
        else:
            events = _profiled(run, tmp_path)
            assert telemetry.tracer.records == []
    (stage,) = [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "stage"]
    ops = {e["name"]: e for e in events if e.get("cat") == "cpu_op"}
    assert _inside(ops["aten::mm"], stage)
    assert _inside(ops["aten::add"], stage)
    assert not _inside(ops["aten::sub"], stage)


def test_set_ratings_records_its_three_stages_under_its_span():
    m, rating = _small_model()
    with telemetry.collect_spans() as tr:
        m.set_ratings(*rating)
    recs = {r["span"]: r for r in tr.records}
    assert set(recs) == {"mfsgd.set_ratings", "mfsgd.partition",
                         "mfsgd.schedule", "mfsgd.shard"}
    parent = recs.pop("mfsgd.set_ratings")
    assert parent["depth"] == 0
    for name, r in recs.items():
        assert r["path"] == f"mfsgd.set_ratings/{name}" and r["depth"] == 1
    assert sum(r["dur"] for r in recs.values()) <= parent["dur"]
    summary = tr.summary()
    assert summary["mfsgd.schedule"]["n"] == 1
    assert summary["mfsgd.partition"]["total_s"] <= \
        summary["mfsgd.set_ratings"]["total_s"]


def test_scatter_set_ratings_has_no_schedule_span():
    cfg = MF.MFSGDConfig(rank=4, algo="scatter", chunk=64)
    m, rating = _small_model(cfg)
    with telemetry.collect_spans() as tr:
        m.set_ratings(*rating)
        m.train_epoch()
    names = {r["span"] for r in tr.records}
    assert {"mfsgd.partition", "mfsgd.shard", "rotate.step"} <= names
    assert not names & {"mfsgd.schedule", "mfsgd.k3"}


def test_rotate_steps_carry_their_index_and_hold_their_hop():
    m, rating = _small_model()
    m.set_ratings(*rating)
    with telemetry.collect_spans() as tr:
        m.train_epochs(2)
    steps = [r for r in tr.records if r["span"] == "rotate.step"]
    nc = MF.rotate_chunks_resolved(m.cfg)
    assert [r["t"] for r in steps] == list(range(nc)) * 2
    hops = [r for r in tr.records if r["span"] == "rotate.hop"]
    assert len(hops) == len(steps)
    assert {r["path"] for r in hops} == {
        "mfsgd.epochs/rotate.step/rotate.hop"}


@pytest.mark.parametrize("epochs", [1, 2])
def test_k3_work_counts_the_schedules_of_the_epochs_steps(epochs):
    m, rating = _small_model()
    m.set_ratings(*rating)
    K3.reset_launches()
    for _ in range(epochs):
        m.train_epoch()
    # one worker: each epoch's steps visit every block row once
    assert K3.K3_WORK == {
        "entries": epochs * sum(s.order.numel() for s in m._schedules),
        "levels": epochs * sum(s.n_levels for s in m._schedules)}
    assert K3.K3_WORK["levels"] > 0
    assert K3.LAUNCHES == {"sgd_tile_update": 0}  # the CPU launches nothing
    K3.reset_launches()
    assert K3.K3_WORK == {"entries": 0, "levels": 0}


def test_k3_work_counts_a_call_that_builds_its_own_schedule():
    rng = np.random.default_rng(0)
    ne, c, t = 6, 4, 8
    eu = torch.from_numpy(rng.integers(0, t, (ne, c)).astype(np.int32))
    ei = torch.from_numpy(rng.integers(0, t, (ne, c)).astype(np.int32))
    ev = torch.from_numpy(rng.normal(size=(ne, c)).astype(np.float32))
    ou = torch.tensor([0, 0, 8, 8, 0, 8], dtype=torch.int32)
    oi = torch.tensor([0, 8, 0, 8, 0, 8], dtype=torch.int32)
    W, H = torch.rand(16, 4), torch.rand(16, 4)
    sched = K3.LevelSchedule.build(eu, ei, ou, oi, t, t, 16, 16, "cpu")
    K3.reset_launches()
    K3.sgd_tile_update(W, H, eu, ei, ev, ou, oi, lr=0.01, reg=0.05,
                       u_tile=t, i_tile=t)
    assert K3.K3_WORK == {"entries": sched.order.numel(),
                          "levels": sched.n_levels}
    # entries sharing a W tile or an H tile chain: 4 levels for 6 entries
    assert sched.n_levels == 4


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_the_streaming_loop_names_its_stages(quantize):
    k, d, rows, n_chunks, epochs = 4, 8, 64, 3, 2
    g = torch.Generator().manual_seed(0)
    chunks = [torch.randn((rows, d), generator=g) for _ in range(n_chunks)]
    col_scale = torch.full((d,), 4.0 / 127) if quantize else None
    cfg = KS.StreamConfig(k=k, chunk_points=rows, quantize=quantize)
    with telemetry.collect_spans() as tr:
        KS._synthetic_run(chunks[0][:k].clone(), epochs,
                          lambda j: chunks[j].clone(), n_chunks, cfg,
                          col_scale)
    names = collections.Counter(r["span"] for r in tr.records)
    per_chunk = {"kmeans.partials": 1}
    if quantize:
        per_chunk.update({"kmeans_stream.quantize": 1, "kmeans.x2": 1})
    assert names == {"kmeans.operands": epochs, "kmeans.reduce": epochs,
                     **{n: c * epochs * n_chunks
                        for n, c in per_chunk.items()}}
    assert all(r["depth"] == 0 for r in tr.records)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_profiled_epoch_has_one_k3_range_around_each_launch(dev,
                                                              tmp_path):
    u, i, v = MF.synthetic_ratings(300, 200, 6000, seed=1)
    cfg = MF.MFSGDConfig(rank=16, algo="pallas", u_tile=16, i_tile=16,
                         entry_cap=64)
    m = MF.MFSGD(300, 200, cfg)
    m.set_ratings(u, i, v)
    m.train_epoch()  # builds K3
    K3.reset_launches()
    events = _profiled(m.train_epoch, tmp_path, device="cuda")
    launches = K3.LAUNCHES["sgd_tile_update"]
    assert launches == MF.rotate_chunks_resolved(cfg)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "mfsgd.k3"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "sgd_step_kernel" in e["name"]]
    corr = {e["args"]["correlation"] for e in kernels}
    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
             and e.get("args", {}).get("correlation") in corr]
    assert len(ranges) == len(kernels) == len(calls) == launches
    for call in calls:
        assert sum(_inside(call, r) for r in ranges) == 1
