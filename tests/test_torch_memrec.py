"""The port's memory ledger (``utils/memrec.py``) against harp_tpu's.

- One buffer-lifecycle event stream (staged, a dispatch that consumes
  its staged input, outputs, frees, a restore, executables) through both
  ledgers: the same rows, watermark and summary, given the same capacity.
- The watermark re-derives exactly from the exported events (the
  reference's ``summarize_rows`` replay), also for a real serving run and
  a checkpoint restore; a tampered export does not reconcile.
- The ``memory`` CLI's exit codes; pressure lands on the health monitor;
  the VMEM gate waits for ROADMAP.md Queue 1 item 9.
"""

import io
import json

import numpy as np
import pytest
import torch

from harp_tpu import health as JH
from harp_tpu.utils import flightrec as JFR
from harp_tpu.utils import memrec as JM
from harp_tpu.utils import telemetry as JT
from harp_tpu_torch import health as PH
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.serve.engines import SVMPredict
from harp_tpu_torch.serve.server import Server
from harp_tpu_torch.utils import flightrec as PFR
from harp_tpu_torch.utils import memrec as PM
from harp_tpu_torch.utils import telemetry as PT
from torch_world import time_limit

CAPACITY = 1 << 16


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


def _rows(mem):
    buf = io.StringIO()
    mem.export_jsonl(buf)
    return [{k: v for k, v in json.loads(ln).items()
             if k not in ("backend", "date", "commit")}
            for ln in buf.getvalue().splitlines()]


def _ledger_run(tel, fr, mem, health, arr):
    """The event stream: staging through the flight recorder, tracked
    dispatches that consume their staged argument, outputs, frees, a
    restore, two executables."""
    with tel.scope(True):
        mem.set_hbm_capacity(CAPACITY)
        step = fr.track(lambda state, x: arr(24), "serve.t.b8",
                        donate_argnums=(1,))
        for i in range(5):
            fr.record_h2d(64 + 8 * (i % 2), site="stage")
            step(arr(4), arr(64 + 8 * (i % 2)))
        mem.on_restored(4096, "ckpt:step_3")
        mem.note_freed(nbytes=96)
        mem.note_freed(nbytes=12345)          # no match: nothing freed
        fr.record_h2d(60000, site="big")      # past 90 % of the capacity
        mem.note_executable("serve.t.b8", {"argument_bytes": 100,
                                           "output_bytes": 96,
                                           "temp_bytes": 10,
                                           "generated_code_bytes": 0})
        mem.note_executable("nothing", None)
        snap = (mem.snapshot(), mem.delta_since(None), mem.live_summary(),
                mem.ledger.exec_total())
        rows = _rows(mem)
        findings = [{k: v for k, v in r.items() if k != "_seq"}
                    for r in health.monitor.findings()]
        return rows, snap, findings


def test_ledger_rows_match_the_reference():
    ref = _ledger_run(JT, JFR, JM, JH, lambda n: np.zeros(n // 4,
                                                          np.float32))
    got = _ledger_run(PT, PFR, PM, PH, lambda n: torch.zeros(n // 4))
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    assert got[2][0]["detector"] == "memory_pressure"
    s = PM.summarize_rows(got[0])
    assert s["errors"] == [] and s == JM.summarize_rows(ref[0])
    assert s["donated_bytes"] == 5 * 64 + 2 * 8


def test_a_tampered_export_does_not_reconcile():
    rows = _ledger_run(PT, PFR, PM, PH, lambda n: torch.zeros(n // 4))[0]
    bad = [dict(r) for r in rows]
    bad[3]["live_bytes"] += 1
    assert PM.summarize_rows(bad)["errors"]
    assert PM.summarize_rows(rows[:-1])["errors"] == [
        "no summary row — the export is unterminated"]


def test_a_serving_run_re_derives_its_watermark_exactly(tmp_path):
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    rng = np.random.default_rng(3)
    state = SVMPredict.synthetic_state(rng, d=16)
    CheckpointManager(str(tmp_path / "ck")).save(1, state)
    with PT.scope(True):
        srv = Server("svm", ckpt=str(tmp_path / "ck"),
                     mesh=WorkerMesh("cpu"), ladder=(1, 8))
        srv.startup()
        srv.process([srv.engine.synthetic_request(rng, n)
                     for n in (1, 5, 12)])
        rows = _rows(PM)
    s = PM.summarize_rows(rows)
    assert s["errors"] == [] and s["dispatches"] == 3
    events = [r["event"] for r in rows if r["ev"] == "buffer"]
    assert events[0] == "restored" and events.count("staged") == 3
    assert events.count("donated") == 3 and events.count("output") == 3
    assert s["hbm_bytes"] == 0  # no card: no capacity, no pressure


def test_the_memory_cli(tmp_path, capsys):
    with PT.scope(True):
        PFR.record_h2d(100, site="x")
        PT.export(str(tmp_path / "ok.jsonl"))
    assert PM.main([str(tmp_path / "ok.jsonl"), "--json"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["staged_bytes"] == 100 and row["errors"] == []
    lines = (tmp_path / "ok.jsonl").read_text().splitlines()
    tampered = [json.loads(ln) for ln in lines]
    for r in tampered:
        if r.get("ev") == "summary":
            r["peak_hbm_bytes"] += 1
    (tmp_path / "bad.jsonl").write_text(
        "\n".join(json.dumps(r) for r in tampered) + "\n")
    assert PM.main([str(tmp_path / "bad.jsonl")]) == 1
    (tmp_path / "empty.jsonl").write_text("")
    assert PM.main([str(tmp_path / "empty.jsonl")]) == 1
    assert PM.main([str(tmp_path / "missing.jsonl")]) == 2


def test_the_ledger_is_empty_while_off():
    with PT.scope(True):
        pass  # a fresh ledger
    with PT.scope(False, reset=False):
        PFR.record_h2d(64)
        PM.on_restored(8)
        PM.note_executable("x", {"argument_bytes": 1})
    assert PM.live_summary() is None


def test_the_vmem_gate_waits_for_item_9():
    with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
        PM.require_vmem_fit("k", 1, budget=2)
