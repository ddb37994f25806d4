"""The program's spans in a traced slice, and the readers of K3's work
counter, on hand-made traces and records."""

from __future__ import annotations

import importlib

import pytest

from portbench import harness, trace
from portbench.drivers.mfsgd import K3_NAMES

ROOT = harness.ROOT
K3_METRICS = ("mfsgd.k3_levels_per_epoch", "mfsgd.k3_entries_per_epoch")


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _epochs(spans: bool, n: int = 2):
    """``n`` MF-SGD epochs inside ``portbench.epoch``: a K3 launch from the
    wrapper's C call (no ATen op around it) after an ``aten::copy_``, then
    the readback's ``aten::sum``; with ``spans``, the program's stage
    annotations around them."""
    ev = []
    t = 0.0
    for j in range(n):
        c = 10 * j
        ev.append(_ev("user_annotation", "portbench.epoch", t, 190))
        if spans:
            ev.append(_ev("user_annotation", "rotate.step", t + 1, 60))
            ev.append(_ev("user_annotation", "mfsgd.k3", t + 2, 50))
            ev.append(_ev("user_annotation", "mfsgd.readback", t + 100, 80))
        ev.append(_ev("cpu_op", "aten::copy_", t + 3, 10))
        ev.append(_ev("cuda_runtime", "cudaMemcpyAsync", t + 5, 2, c))
        ev.append(_ev("gpu_memcpy", "Memcpy DtoD", t + 30, 5, c))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernelExC", t + 20, 3,
                      c + 1))
        ev.append(_ev("kernel", "sgd_step_kernel<true, float>", t + 40, 40,
                      c + 1))
        ev.append(_ev("cpu_op", "aten::sum", t + 110, 20))
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", t + 115, 2, c + 2))
        ev.append(_ev("kernel", "reduce_kernel", t + 150, 10, c + 2))
        t += 200
    return ev


def test_program_spans_change_only_the_gap_labels():
    plain = trace.reduce(_epochs(False), 400e-6, {"K3": K3_NAMES})
    spans = trace.reduce(_epochs(True), 400e-6, {"K3": K3_NAMES})
    keys = ("name", "ts", "dur", "gen", "tag", "launch_ts")
    assert [{k: o[k] for k in keys} for o in plain["ops"]] == \
        [{k: o[k] for k in keys} for o in spans["ops"]]
    assert plain["busy_s"] == spans["busy_s"] == pytest.approx(110e-6)
    assert [s for _, s in plain["gaps"]] == [s for _, s in spans["gaps"]]
    assert trace.count_tag(plain, "K3") == trace.count_tag(spans, "K3") == 2
    # the K3 launch, made from no ATen op, was put down to the benchmark's
    # epoch range; the program's span now names it
    assert [label for label, _ in plain["gaps"]] == [
        "portbench.epoch", "aten::sum", "aten::copy_", "portbench.epoch",
        "aten::sum"]
    assert [label for label, _ in spans["gaps"]] == [
        "mfsgd.k3", "aten::sum", "aten::copy_", "mfsgd.k3", "aten::sum"]


def _rec(k3_ops=4, epochs=2):
    ops = [{"name": "sgd_step_kernel", "ts": 10.0 * i, "dur": 5.0,
            "gen": False, "tag": "K3", "launch_ts": 10.0 * i - 1}
           for i in range(k3_ops)]
    ops.append({"name": "reduce_kernel", "ts": 100.0, "dur": 1.0,
                "gen": False, "tag": None, "launch_ts": 99.0})
    return {"trace": {"ops": ops, "busy_s": 1e-4, "window_s": 1e-3,
                      "gaps": []},
            "slice": {"epochs": epochs}}


@pytest.fixture
def k3(monkeypatch):
    from harp_tpu_torch.ops import mfsgd_kernel

    monkeypatch.setitem(mfsgd_kernel.LAUNCHES, "sgd_tile_update", 0)
    # raising=False: the same tests run against a program without it
    monkeypatch.setattr(mfsgd_kernel, "K3_WORK",
                        {"entries": 0, "levels": 0}, raising=False)
    return mfsgd_kernel


@pytest.mark.parametrize("metric,key", zip(K3_METRICS, ("levels",
                                                         "entries")))
def test_k3_readers_give_an_epochs_count(k3, metric, key):
    read = harness.load_reader(ROOT, metric)
    # 5 epochs of 2 launches: steps of 300 and 293 levels (1,180 and
    # 1,175 entries)
    k3.LAUNCHES["sgd_tile_update"] = 10
    k3.K3_WORK.update(levels=5 * (300 + 293), entries=5 * (1180 + 1175))
    want = {"levels": 593, "entries": 2355}[key]
    assert read(_rec(k3_ops=4, epochs=2)) == pytest.approx(want)


@pytest.mark.parametrize("metric", K3_METRICS)
def test_k3_readers_stay_silent_without_the_counter_or_a_launch(
        k3, monkeypatch, metric):
    read = harness.load_reader(ROOT, metric)
    k3.K3_WORK.update(levels=593, entries=2355)
    assert read(_rec()) is None  # the program counted no launch (the CPU)
    k3.LAUNCHES["sgd_tile_update"] = 2
    assert read(_rec(k3_ops=0)) is None  # the trace holds no K3 launch
    assert read(_rec(k3_ops=2, epochs=1)) == pytest.approx(
        k3.K3_WORK[metric.split("_")[1]] / 2 * 2)
    # a program without the counter (the tree before it)
    monkeypatch.delattr(k3, "K3_WORK")
    assert read(_rec()) is None


def test_the_k3_metrics_are_listed_for_the_mfsgd_cells_only():
    """Both MF-SGD cells, and no cell of another family (a driver's
    ``FAMILY``)."""
    m = harness.load_manifest(ROOT)
    for name in K3_METRICS:
        (x,) = [x for x in m["per_layer"] if x["name"] == name]
        assert x["source"] == "program_counter"
        assert x["moves"] == "mfsgd_updates_per_s"
        assert {"mfsgd.ml20m.uniform", "mfsgd.ml20m.zipf"} <= set(
            x["workloads"])
        for cell in x["workloads"]:
            _, config, _ = harness.resolve(m, ROOT, cell)
            driver = importlib.import_module(
                f"portbench.drivers.{config['driver']}")
            assert driver.FAMILY == "mfsgd", cell
