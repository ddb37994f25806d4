"""The process world of a cell of more than one card, on gloo workers: a
traced run, a rank that fails, and the one-card path that spawns
nothing."""

from __future__ import annotations

import multiprocessing
import time

import pytest
import torch.distributed as dist

from portbench import harness, world
from portbench.tests import added, small

SEED = 2**31 + 31


@pytest.fixture
def root(tmp_path):
    m = added.copy(tmp_path)
    added.write(tmp_path, added.add_world_cell(tmp_path, m, 4, 0.5))
    return tmp_path


def _run(root, trace=False, **config):
    ov = small.load(root)[added.WORLD_CELL]
    ov = {"config": {**ov["config"], **config}}
    return harness.run_cell(added.WORLD_CELL, SEED, 0.05, trace, root=root,
                            device="cpu", overrides=ov)


def test_a_traced_world_reads_rank_0_and_averages_the_slices(root):
    r = _run(root, trace=True)
    assert r["correct"] is True, r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "breakdown", "checks"]
    dev = r["device"]
    assert dev["count"] == 4 and dev["window_s"] > 0
    assert 0 <= dev["busy_s"] <= dev["window_s"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert multiprocessing.active_children() == []
    assert not dist.is_initialized()


@pytest.mark.parametrize("how,says", [
    ("raise", "RuntimeError: a fault planted on rank 2"),
    ("die", "rank 2 ended with exit code 7 before its report")])
def test_a_failing_rank_fails_the_run_in_time(root, capfd, how, says):
    t0 = time.monotonic()
    with pytest.raises(world.WorldError, match="rank 2 of 4 failed") as e:
        _run(root, fail_rank=2, fail_how=how)
    assert time.monotonic() - t0 < world.FAIL_S + 15  # set-up included
    assert says in str(e.value)
    assert says in capfd.readouterr().err
    assert multiprocessing.active_children() == []
    assert not dist.is_initialized()


def test_a_one_card_cell_starts_no_process_and_no_group(monkeypatch):
    def spawned(*args, **kw):
        raise AssertionError("a one-card cell went through the world")

    monkeypatch.setattr(world, "run", spawned)
    cell = "kmeans_stream.f32.n1e8"
    r = harness.run_cell(cell, SEED, 0.05, False, device="cpu",
                         overrides=small.SMALL[cell])
    assert r["correct"] is True and r["device"]["count"] == 1
    assert multiprocessing.active_children() == []
    assert not dist.is_initialized()
