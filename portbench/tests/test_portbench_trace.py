"""The trace reduction and the readers, on a hand-made Chrome trace."""

from __future__ import annotations

import pytest

from portbench import harness, trace

ROOT = harness.ROOT


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(drop=False):
    """Two chunks: the generator's kernel (launched inside portbench.gen),
    then K1's main and range kernels and an add, with a gap before each
    chunk's generator kernel."""
    ev = []
    t = 0.0
    for j in range(2):
        ev.append(_ev("user_annotation", "portbench.gen", t, 10))
        ev.append(_ev("cpu_op", "aten::randn", t + 1, 8))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 2, 1, 10 * j))
        ev.append(_ev("kernel", "randn_kernel", t + 20, 30, 10 * j))
        for i, name in enumerate(["void km::main_kernel<T>(km::MainArgs)",
                                  "void km::range_kernel<T>(km::RangeArgs)",
                                  "add_kernel"]):
            c = 10 * j + 1 + i
            ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 12 + i, 1,
                          c))
            if not (drop and j == 1 and i == 0):
                ev.append(_ev("kernel", name, t + 50 + 20 * i, 20, c))
        t += 200
    return ev


def test_reduce_splits_generator_from_program_and_counts_busy():
    red = trace.reduce(_events(), 400e-6, {"K1": trace_k1()})
    assert len(red["ops"]) == 8
    assert sum(o["gen"] for o in red["ops"]) == 2
    assert trace.count_tag(red, "K1", r"km::main_kernel") == 2
    assert trace.count_tag(red, "K1") == 4
    # each chunk: 30 us generator + 3 x 20 us program, back to back
    assert red["busy_s"] == pytest.approx(180e-6)
    # one gap between the chunks: 250 - 110 us, before the generator's
    # kernel, launched inside aten::randn
    assert len(red["gaps"]) == 1
    label, sec = red["gaps"][0]
    assert label == "aten::randn" and sec == pytest.approx(110e-6)
    b = trace.breakdown(red)
    assert b["device_ops"][0] == ["randn_kernel", pytest.approx(60e-6)]
    assert b["idle_gaps"] == [["aten::randn x1", pytest.approx(110e-6)]]


def trace_k1():
    from portbench.drivers.kmeans_stream import K1_NAMES

    return K1_NAMES


def test_a_trace_that_lost_a_kernel_is_refused():
    with pytest.raises(trace.TraceShort):
        trace.reduce(_events(drop=True), 400e-6, {"K1": trace_k1()})


def _rec(ops_scale=1.0):
    red = trace.reduce(_events(), 400e-6, {"K1": trace_k1(),
                                           "K3": r"sgd_step_kernel"})
    return {"trace": red, "slice": {"chunks": 2, "epochs": 2},
            "work": {"k1_chunk_bound_s": 10e-6 * ops_scale,
                     "epoch_bound_s": 1e-3},
            "host": {"epoch_s": 0.1, "prep_s": 3.5}}


@pytest.mark.parametrize("metric,want", [
    ("k1.roofline", 100 * 20e-6 / 80e-6),
    ("kmeans.program_ms_per_chunk", 60e-3),
    ("kmeans.step_mfu", 1.0),
    ("kmeans.device_idle", 100 * (1 - 180 / 400)),
    ("mfsgd.step_mfu", 1.0),
    ("mfsgd.device_idle", 100 * (1 - 180 / 400)),
    ("mfsgd.prep_s", 3.5),
    ("k3.roofline", None)])
def test_readers(metric, want):
    got = harness.load_reader(ROOT, metric)(_rec())
    assert got == (pytest.approx(want) if want is not None else None)


def test_readers_stay_silent_without_device_records():
    rec = _rec()
    rec["trace"] = trace.reduce([], 1.0)
    for m in ("k1.roofline", "k3.roofline", "kmeans.program_ms_per_chunk",
              "kmeans.step_mfu", "kmeans.device_idle", "mfsgd.step_mfu",
              "mfsgd.device_idle"):
        assert harness.load_reader(ROOT, m)(rec) is None
