"""The port's memory ledger (``utils/memrec.py``) against harp_tpu's.

- One buffer-lifecycle event stream (staged, a dispatch that consumes
  its staged input, outputs, frees, a restore, executables) through both
  ledgers: the same rows, watermark and summary, given the same capacity.
- The watermark re-derives exactly from the exported events (the
  reference's ``summarize_rows`` replay), also for a real serving run and
  a checkpoint restore; a tampered export does not reconcile.
- The ``memory`` CLI's exit codes; pressure lands on the health monitor.
- The fit gates (``require_smem_fit``, ``require_hbm_fit``) against the
  reference's VMEM gate on the same (bytes, budget) pairs: the same
  refusal (``MemoryError``, whatever the telemetry state, its message
  ending "refused before dispatch"), the same ``vmem_check`` rows and
  counters plus the memory they held (``space``), and the replay's
  reconciliation; the budgets default to the card's limits.
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


#: (predicted bytes, budget) pairs through both gates
GATE_CASES = [(1, 2), (2, 2), (3, 2), (232_448, 232_448),
              (232_449, 232_448), (10 << 20, 16 << 20), (17 << 20, 16 << 20)]


def test_the_vmem_gate_waits_for_item_9():
    """Item 9 landed: the reference's VMEM gate is two gates at the card's
    limits.  Each refuses as the reference's does, off and on."""
    for gate in (PM.require_smem_fit, PM.require_hbm_fit):
        with PT.scope(False):
            with pytest.raises(MemoryError, match="refused before dispatch"):
                gate("k", 3, budget=2)
            gate("k", 2, budget=2)
    assert not hasattr(PM, "require_vmem_fit")


@pytest.mark.parametrize("gate,space", [("require_smem_fit", "smem"),
                                        ("require_hbm_fit", "hbm")])
def test_fit_gates_match_the_reference_gate(gate, space):
    rows = {}
    for name, tel, mem, fn in (
            ("port", PT, PM, getattr(PM, gate)),
            ("ref", JT, JM, JM.require_vmem_fit)):
        with tel.scope(True):
            refused = []
            for pred, budget in GATE_CASES:
                try:
                    fn("kernel.x", pred, budget=budget)
                    refused.append(False)
                except MemoryError as e:
                    refused.append(True)
                    assert str(pred) in str(e) and "refused before " \
                        "dispatch" in str(e)
            snap = mem.live_summary()
            rows[name] = (refused, _rows(mem), snap["vmem_checks"],
                          snap["vmem_refusals"])
    port, ref = rows["port"], rows["ref"]
    assert port[0] == ref[0] == [p > b for p, b in GATE_CASES]
    assert port[2:] == ref[2:] == (len(GATE_CASES), sum(ref[0]))
    checks = [r for r in port[1] if r["ev"] == "vmem_check"]
    assert all(r.pop("space") == space for r in checks)
    assert checks == [r for r in ref[1] if r["ev"] == "vmem_check"]
    assert PM.summarize_rows(port[1])["vmem_refusals"] == sum(ref[0])


def test_fit_gate_budgets_default_to_the_card_s_limits():
    from harp_tpu_torch.ops.kernel_registry import H100_SMEM_OPTIN

    assert PM.smem_optin() == H100_SMEM_OPTIN == 232_448
    PM.require_smem_fit("k", H100_SMEM_OPTIN)
    with pytest.raises(MemoryError, match="shared memory"):
        PM.require_smem_fit("k", H100_SMEM_OPTIN + 1)
    with PT.scope(True):
        PM.set_hbm_capacity(CAPACITY)
        assert PM.hbm_free("cpu") == PM.hbm_free() == CAPACITY
        PM.require_hbm_fit("k", CAPACITY, device="cpu")
        with pytest.raises(MemoryError, match="device memory"):
            PM.require_hbm_fit("k", CAPACITY + 1, device="cpu")
        (a, b) = [r for r in _rows(PM) if r["ev"] == "vmem_check"]
        assert (a["budget_bytes"], a["fits"], b["refused"]) == (
            CAPACITY, True, True)
