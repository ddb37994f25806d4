"""The port's ``bench`` app (``harp_tpu_torch.benchmark``) on the CPU.

The rows' times are CPU times here and say nothing of a card; what is held
is that every verb of ``VERBS`` (the reference's, with its wire factors)
and both sparse verbs print a row naming its device, that one worker's
rows say they time the local path only, and that the capacity sweep drops
exactly the requests the reference's sweep drops on the same ids.
"""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from harp_tpu import benchmark as JB
from harp_tpu.parallel.mesh import WorkerMesh as JaxMesh
from harp_tpu_torch import benchmark as B
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry

CPU = WorkerMesh("cpu")


def test_verbs_and_wire_factors_are_the_reference_ones():
    assert set(B.VERBS) == set(JB.VERBS)
    assert B.SPARSE_VERBS == JB.SPARSE_VERBS
    for name, (_, kw, wire) in B.VERBS.items():
        ref_fn, ref_kw, _, ref_wire = JB.VERBS[name]
        assert B.VERBS[name][0].__name__ == ref_fn.__name__
        assert set(kw) == set(ref_kw)
        for nw in (1, 4, 8):
            assert wire(nw) == ref_wire(nw), name


def test_every_row_prints_on_the_cpu(capsys):
    assert B.main(["--device", "cpu", "--min-kb", "16", "--max-mb", "1",
                   "--reps", "2"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    sizes = B.sizes(16, 1)
    assert sizes == [16 << 10, 64 << 10, 256 << 10, 1 << 20]
    assert {r["verb"] for r in rows} == set(B.VERBS) | set(B.SPARSE_VERBS)
    assert len(rows) == len(sizes) * (len(B.VERBS) + len(B.SPARSE_VERBS))
    for r in rows:
        assert r["device"] == "cpu" and r["num_workers"] == 1
        assert "local path" in r["note"]
        assert r["sec"] > 0 and r["gb_per_sec"] > 0
    dense = [r for r in rows if r["verb"] in B.VERBS]
    assert sorted({r["bytes"] for r in dense}) == sizes


def test_bench_verb_and_sparse_account_as_the_reference():
    """Payload bytes and GB/s follow the reference's conventions: the
    global [rows, 128] f32 payload times the wire factor; the sparse verbs
    a global requested-row payload with a table 4x past it."""
    r = B.bench_verb("allreduce_int8", CPU, 1 << 16, reps=1, label="cpu")
    assert r["bytes"] == 1 << 16
    assert np.isclose(r["gb_per_sec"], r["bytes"] * 0.5 / r["sec"] / 1e9)
    s = B.bench_sparse("push_sparse", CPU, 1 << 16, reps=1, label="cpu")
    m = (1 << 16) // (4 * 128)
    assert s["requested_rows_per_worker"] == m and s["bytes"] == m * 512
    assert s["table_rows"] == 4 * m
    with telemetry.scope():
        B.bench_verb("rotate", CPU, 1 << 14, reps=3, label="cpu")
        led = telemetry.ledger.summary()["bench.rotate"]
    assert led["executions"] == 4 and led["verbs"][0]["calls"] == 4


def test_capacity_sweep_drops_match_reference_on_one_worker():
    ref = list(JB.sweep_sparse_capacity(JaxMesh(jax.devices()[:1]), m=256,
                                        d=8, reps=1))
    got = list(B.sweep_sparse_capacity(CPU, m=256, d=8, reps=1, label="cpu"))
    assert len(got) == len(ref) == 15
    for g, r in zip(got, ref):
        for k in ("dist", "capacity", "cap_frac", "requests_per_worker",
                  "drop_rate", "wire_mb", "num_workers", "zipf_a"):
            assert g[k] == r[k], k
    zipf = {g["capacity"]: g["drop_rate"] for g in got if g["dist"] == "zipf"}
    dedup = {g["capacity"]: g["drop_rate"] for g in got
             if g["dist"] == "zipf_dedup"}
    assert all(dedup[c] <= zipf[c] for c in zipf)


def test_host_op_runs_a_verb_on_this_workers_block():
    op = C.host_op(CPU, C.allreduce_hier, group_size=1)
    out = op(np.arange(6, dtype=np.int32))
    assert isinstance(out, torch.Tensor) and out.tolist() == list(range(6))
    tree = C.host_op(CPU, C.push_quantized, wire_dtype=torch.int8)(
        {"a": np.ones(4, np.float32), "b": np.ones(2, np.int32)})
    assert torch.equal(tree["b"], torch.ones(2, dtype=torch.int32))
    assert torch.allclose(tree["a"], torch.ones(4))


def test_device_label_names_the_cpu_and_rejects_unknown_verbs():
    assert B.device_label(torch.device("cpu")) == "cpu"
    with pytest.raises(SystemExit):
        B.main(["--device", "cpu", "--verbs", "nope"])


def test_cli_module_entry_prints_sweep_rows():
    out = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "bench", "--device", "cpu",
         "--sparse-capacity-sweep", "--reps", "1"], capture_output=True,
        text=True, timeout=300, check=True)
    rows = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert len(rows) == 15 and {r["dist"] for r in rows} == {
        "even", "zipf", "zipf_dedup"}
    assert all(r["device"] == "cpu" for r in rows)
