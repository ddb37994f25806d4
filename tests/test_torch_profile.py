"""``harp_tpu_torch.utils.profiling`` and ``harp_tpu_torch.profile``
against harp_tpu's.

- ``op_breakdown`` on the reference's forged traces (nested device spans;
  two devices beside a host track), rewritten into torch.profiler's
  Chrome-trace layout, gives the reference's totals; a real CPU capture of
  a ``torch.mm`` loop lists ``aten::mm``; only the newest capture of a
  logdir is read; a missing logdir raises ``FileNotFoundError``.
- ``classify`` maps a table of real CUDA and ATen names, each K1-K8
  symbol among them, to its mechanism; ``attribute`` on forged breakdowns
  is the reference's where the two classify alike.
- A CPU ``capture`` of every app is reconciled and its terms sum to its
  wall; a trace short of a kernel's launches is not reconciled and says
  why; the CLI prints one row per app (``--all --json``, also with
  ``capture`` stubbed, the reference's pattern) and raises without a card
  unless ``--device`` is given.
"""

import gzip
import json

import pytest
import torch

from harp_tpu.profile import attribution as JA
from harp_tpu.utils import profiling as JP
from harp_tpu_torch import __main__ as cli
from harp_tpu_torch.profile import attribution as A
from harp_tpu_torch.profile import cli as PCLI
from harp_tpu_torch.utils import profiling as P
from harp_tpu_torch.utils import telemetry
from torch_world import time_limit


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(120):
        yield


def _write_reference(d, events, meta):
    d.mkdir(parents=True)
    with gzip.open(d / "x.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + events}, f)


def _write_port(d, events, name="capture-00000000000000000001"):
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.pt.trace.json").write_text(json.dumps(
        {"traceEvents": events}))


#            0         10        20        30        40
# jit_run    [----------------------------------------]   40 us
#   while.1      [------------------]                      20 us
#     fusion.1     [------]  [------]                      8+8 us
#   fusion.2                              [------]         8 us
NESTED = [("jit_run", 0, 40), ("while.1", 4, 20), ("fusion.1", 5, 8),
          ("fusion.1", 14, 8), ("fusion.2", 30, 8)]


@pytest.mark.parametrize("self_time", [True, False])
def test_nested_device_spans_give_the_references_totals(tmp_path, self_time):
    meta = [{"ph": "M", "name": "process_name", "pid": 7,
             "args": {"name": "/device:TPU:0"}}]
    ref = [{"ph": "X", "pid": 7, "tid": 1, "name": n, "ts": t, "dur": u}
           for n, t, u in NESTED]
    ref.append({"ph": "X", "pid": 1, "tid": 1, "name": "host_thing",
                "ts": 0, "dur": 999})
    _write_reference(tmp_path / "ref", ref, meta)
    ours = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n,
             "ts": t, "dur": u, "args": {"device": 0, "stream": 7}}
            for n, t, u in NESTED]
    ours.append({"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1,
                 "name": "host_thing", "ts": 0, "dur": 999})
    _write_port(tmp_path / "port", ours)
    got = dict(P.op_breakdown(str(tmp_path / "port"), self_time=self_time))
    want = dict(JP.op_breakdown(str(tmp_path / "ref"), self_time=self_time))
    assert got.keys() == want.keys() and "host_thing" not in got
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    if self_time:
        assert sum(got.values()) == pytest.approx(40e-6, abs=1e-12)
        assert got["jit_run"] == pytest.approx(12e-6, abs=1e-12)
    else:
        assert got["jit_run"] == pytest.approx(40e-6, abs=1e-12)


def test_two_devices_split_like_the_references(tmp_path):
    spans = [(0, "fusion.1", 0, 100), (1, "fusion.1", 0, 300),
             (1, "copy.2", 400, 50)]
    meta = [{"ph": "M", "name": "process_name", "pid": p + 1,
             "args": {"name": f"/device:TPU:{p} (chip {p})"}}
            for p in (0, 1)]
    ref = [{"ph": "X", "pid": d + 1, "tid": 0, "ts": t, "dur": u, "name": n}
           for d, n, t, u in spans]
    ref.append({"ph": "X", "pid": 7, "tid": 0, "ts": 0, "dur": 999,
                "name": "host_thing"})
    _write_reference(tmp_path / "ref" / "plugins" / "profile" / "0001", ref,
                     meta)
    ours = [{"ph": "X", "cat": "kernel", "pid": d, "tid": 7, "ts": t,
             "dur": u, "name": n, "args": {"device": d}}
            for d, n, t, u in spans]
    ours.append({"ph": "X", "cat": "cpu_op", "pid": 9, "tid": 0, "ts": 0,
                 "dur": 999, "name": "host_thing"})
    _write_port(tmp_path / "port", ours)
    assert dict(P.op_breakdown(str(tmp_path / "port"))) == pytest.approx(
        dict(JP.op_breakdown(str(tmp_path / "ref"))))
    assert sorted(P.op_breakdown(str(tmp_path / "port"), per_device=True)
                  ) == pytest.approx(sorted(JP.op_breakdown(
                      str(tmp_path / "ref"), per_device=True)))
    # memcpy and memset tracks are device time too; host_events keeps all
    _write_port(tmp_path / "port", ours + [
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 9, "ts": 500,
         "dur": 20, "name": "Memcpy DtoH (Device -> Pinned)",
         "args": {"device": 0}}], name="capture-00000000000000000002")
    got = dict(P.op_breakdown(str(tmp_path / "port")))
    assert got["Memcpy DtoH (Device -> Pinned)"] == pytest.approx(20e-6)
    assert "host_thing" in dict(P.op_breakdown(str(tmp_path / "port"),
                                               host_events=True))


def test_a_real_cpu_capture_lists_aten_mm_and_reads_the_newest(tmp_path):
    a = torch.randn(128, 128)
    with P.trace(str(tmp_path / "tr")) as d:
        with telemetry.span("loop"):
            for _ in range(4):
                torch.mm(a, a)
    first = dict(P.op_breakdown(d))
    assert "aten::mm" in first and first["aten::mm"] > 0
    # the span is the capture's named region (telemetry off)
    assert "loop" in dict(P.op_breakdown(d, host_events=True))
    with P.trace(d):
        torch.mm(a, a)
    second = dict(P.op_breakdown(d))
    # the newest capture alone: its one mm, not the sum of both captures
    assert second == dict(P.op_breakdown(P.newest_capture(d)))
    assert second["aten::mm"] < first["aten::mm"]
    with pytest.raises(FileNotFoundError, match="trace"):
        P.op_breakdown(str(tmp_path / "nope"))


#: the host's calls of a card's capture: three kernel launches (runtime
#: and driver API), a copy and a sync, beside the host spans
_API = [{"ph": "X", "cat": c, "pid": 1, "tid": 1, "ts": 0, "dur": 1,
         "name": n} for c, n in (("cuda_runtime", "cudaLaunchKernel"),
                                 ("cuda_runtime", "cudaLaunchKernelExC"),
                                 ("cuda_driver", "cuLaunchKernel"),
                                 ("cuda_runtime", "cudaMemcpyAsync"),
                                 ("cuda_runtime", "cudaDeviceSynchronize"))]
_HOST = [{"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 0,
          "dur": 50, "name": "aten::mm"}]


def _kernels(n):
    return [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 10 * i,
             "dur": 5, "name": f"k{i}", "args": {"device": 0}}
            for i in range(n)]


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_a_card_capture_without_device_records_never_reads_the_host(
        tmp_path, device):
    """A card's capture whose device records were all dropped gives an
    empty table, never the host's cpu_op spans; told the capture was a
    CPU's, the same file reads its cpu_op spans."""
    _write_port(tmp_path, _HOST + _API)
    assert P.is_card_capture(P.load_events(str(tmp_path)))
    assert P.op_breakdown(str(tmp_path), device=device) == []
    assert dict(P.op_breakdown(str(tmp_path), device="cpu")) == {
        "aten::mm": pytest.approx(50e-6)}
    # with no record of the card at all, the trace reads as a CPU's
    _write_port(tmp_path, _HOST, name="capture-00000000000000000002")
    assert not P.is_card_capture(P.load_events(str(tmp_path)))
    assert dict(P.op_breakdown(str(tmp_path))) == {
        "aten::mm": pytest.approx(50e-6)}


@pytest.mark.parametrize("traced,short", [(3, False), (4, False),
                                          (2, True), (0, True)])
def test_a_card_capture_short_of_its_launches_says_so(traced, short):
    """Whatever kernels ran, a card's capture holds a kernel record for
    every launch the host's runtime recorded, or names the drop."""
    events = _HOST + _API + _kernels(traced)
    assert P.launch_records(events) == 3
    why = A.device_records_short(events)
    assert bool(why) == short
    if short:
        assert why == [f"the trace holds {traced} kernel records of 3 "
                       "launches: torch.profiler dropped device records"]
    assert A.device_records_short(_HOST) == [
        "the trace holds no device record of a cuda capture: "
        "torch.profiler dropped device records"]


#: real trace names → bucket; every K1-K8 symbol is here
NAMES = {
    "void km::main_kernel<km::Int8Traits, false>(km::MainArgs)": "mxu",
    "void km::main_kernel<km::Bf16Traits<float>, true>(km::MainArgs)": "mxu",
    "void km::range_kernel<km::Int8Traits>(km::RangeArgs)": "scatter",
    "void km::range_kernel<km::Bf16Traits<__nv_bfloat16> >(km::RangeArgs)":
        "scatter",
    "(anonymous namespace)::pack_kernel(signed char const*, float const*, "
    "float const*, int, int, int, int, unsigned char*, float*, float*)":
        "elementwise",
    "(anonymous namespace)::reduce_kernel(float const*, int, long, float*)":
        "elementwise",
    "void (anonymous namespace)::sgd_step_kernel<true>(float*, float*)":
        "gather_dus",
    "void (anonymous namespace)::step_kernel<short>(short*, float*)":
        "scatter",
    "void (anonymous namespace)::rows_kernel<false, 4, 1>(void const*)":
        "elementwise",
    "void (anonymous namespace)::tile_kernel<true>(void const*)":
        "elementwise",
    "void (anonymous namespace)::bx_kernel<3, false, true>(void const*)":
        "elementwise",
    "void (anonymous namespace)::hist_kernel<unsigned char, true, true>("
    "unsigned char const*)": "scatter",
    "void (anonymous namespace)::simt_kernel<float, 8, 2, 128>(float const*)":
        "mxu",
    "void (anonymous namespace)::wgmma_kernel<128>(CUtensorMap)": "mxu",
    "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_warpgroupsize"
    "1x1x1_execute_segment_k_off_kernel__5x_cublas": "mxu",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_tn_align1>("
    "cutlass_80_simt_sgemm_128x32_8x5_tn_align1::Params)": "mxu",
    "nvjet_tst_128x64_64x8_2x1_v_bz_NNT": "mxu",
    "aten::mm": "mxu", "aten::addmm": "mxu", "aten::bmm": "mxu",
    "void at::native::(anonymous namespace)::indexFuncLargeIndex<float, "
    "long, unsigned int, 2, 2, -2, true>(...)": "scatter",
    "aten::index_add_": "scatter", "aten::scatter_add_": "scatter",
    "aten::bincount": "scatter",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
    "long, unsigned int, 2, 2, -2, true>(...)": "gather_dus",
    "aten::index_select": "gather_dus", "aten::gather": "gather_dus",
    "aten::index": "gather_dus",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
    "<4096ul>)": "wire",
    "c10d::allreduce_": "wire", "gloo:all_reduce": "wire",
    "Memcpy HtoD (Pageable -> Device)": "overhead",
    "Memset (Device)": "overhead", "cudaLaunchKernel": "overhead",
    "cudaStreamSynchronize": "overhead", "cuLaunchKernel": "overhead",
    "aten::empty": "overhead", "aten::view": "overhead",
    "aten::_local_scalar_dense": "overhead",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, at::detail::Array<char*, 1> >(int, ...)":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor>>>(...)":
        "elementwise",
    "aten::add": "elementwise", "aten::tanh": "elementwise",
    "aten::copy_": "elementwise", "aten::broadcast_tensors": "elementwise",
}


@pytest.mark.parametrize("name", list(NAMES))
def test_classify_reads_cuda_and_aten_names(name):
    assert A.classify(name) == NAMES[name]


#: names the two classifiers bucket alike
ALIKE = {"fusion.3": "elementwise", "gather.2": "gather_dus",
         "dynamic-slice.4": "gather_dus", "scatter-add.1": "scatter",
         "matmul.7": "mxu", "all-gather.1": "wire",
         "collective-permute.2": "wire"}


def test_frozen_vocabulary_is_the_references():
    assert A.BUCKETS == JA.BUCKETS
    assert A.SUM_REL_TOL == JA.SUM_REL_TOL
    assert A.PROFILE_APPS == JA.PROFILE_APPS
    for name, bucket in ALIKE.items():
        assert A.classify(name) == JA.classify(name) == bucket


@pytest.mark.parametrize("wall,n_devices", [(1e-3, 1), (1e-3, 2),
                                            (2e-4, 1), (0.0, 1)])
def test_attribute_is_the_references(wall, n_devices):
    breakdown = [("fusion.3", 0, 2e-4), ("matmul.7", 0, 1e-4),
                 ("gather.2", 1, 5e-5), ("scatter-add.1", 1, 3e-5),
                 ("all-gather.1", 0, 1e-5), ("dynamic-slice.4", None, 4e-5)]
    assert A.attribute(breakdown, wall, n_devices) == JA.attribute(
        breakdown, wall, n_devices)


def test_kernel_records_reconcile_with_the_launch_counts():
    k1 = ("harp_tpu_torch.ops.kmeans_kernel", "kmeans_partials_int8")
    k4 = ("harp_tpu_torch.ops.lda_kernel", "cgs_entry_update")
    ev = [{"ph": "X", "cat": "kernel", "name":
           "void km::main_kernel<km::Int8Traits, false>(km::MainArgs)"}] * 3
    ev += [{"ph": "X", "cat": "kernel",
            "name": "void (anonymous namespace)::sgd_step_kernel<true>()"}]
    seen, short = A.kernel_records(ev, {k1: 3, k4: 0})
    assert seen == {"kmeans_partials_int8": {"launches": 3, "traced": 3}}
    assert short == []
    seen, short = A.kernel_records(ev[1:], {k1: 3})
    assert seen["kmeans_partials_int8"]["traced"] == 2
    assert short and "dropped device records" in short[0]


@pytest.fixture(scope="module")
def cpu_rows():
    with time_limit(120):
        return [A.capture(app, reps=2, device="cpu")
                for app in A.PROFILE_APPS]


@pytest.mark.parametrize("app", list(JA.PROFILE_APPS))
def test_a_cpu_capture_is_reconciled_and_sums_to_its_wall(cpu_rows, app):
    row = next(r for r in cpu_rows if r["app"] == app)
    assert row["reconciled"] and row["why"] == []
    assert row["program"] == JA.PROFILE_APPS[app]
    assert set(row["terms"]) == {f"{b}_s" for b in A.BUCKETS}
    assert sum(row["terms"].values()) == pytest.approx(row["wall_s"],
                                                       abs=1e-5)
    assert row["dispatches"] == row["reps"] * row["dispatches_per_rep"]
    assert row["compiles_in_window"] == 0 and row["kernels"] == {}
    assert row["backend"] == "cpu" and row["device"] == "cpu"
    assert row["wire_unmatched"] == 0


def test_the_kmeans_capture_moves_the_fits_allreduce_bytes(cpu_rows):
    row = next(r for r in cpu_rows if r["app"] == "kmeans")
    # one fit a rep: 2 iterations of the [8, 32] sums, [8] counts and the
    # inertia as one f32 allreduce bundle, reps = 2
    assert row["wire_bytes"] > 0 and row["wire_sites"] >= 1
    assert row["wire_bytes"] % row["reps"] == 0


def test_the_cli_prints_one_reconciled_row_per_app(capsys):
    assert cli.main(["profile", "--all", "--json", "--device", "cpu",
                     "--reps", "1"]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["app"] for r in rows] == list(A.PROFILE_APPS)
    assert len(rows) == 11 and all(r["reconciled"] for r in rows)


def test_the_cli_with_capture_stubbed(monkeypatch, capsys):
    """The reference's CLI pattern: every app once, an unreconciled row
    turns exit 0 into 1, an unknown app or none is 2."""
    template = {"kind": "profile", "app": "?", "program": "?",
                "wall_s": 1.0, "reps": 4, "n_devices": 1,
                "terms": {f"{b}_s": 1.0 / 6 for b in A.BUCKETS},
                "bound": "mxu", "sum_rel_err": 0.0, "wire_bytes": 0,
                "wire_sites": 0, "wire_unmatched": 0, "dispatches": 4,
                "dispatches_per_rep": 1, "dispatch_reconciled": True,
                "compiles_in_window": 0, "kernels": {}, "reconciled": True,
                "why": []}
    calls = []

    def fake_capture(app, reps=4, device=None):
        calls.append((app, device))
        return dict(template, app=app)

    monkeypatch.setattr(A, "capture", fake_capture)
    assert PCLI.main(["--all", "--json", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [c[0] for c in calls] == list(A.PROFILE_APPS)
    assert len(lines) == len(A.PROFILE_APPS)
    monkeypatch.setattr(A, "capture", lambda app, reps=4, device=None: dict(
        template, app=app, reconciled=False,
        why=["the trace holds 7 of the 10 kmeans_partials_int8 launches"]))
    assert PCLI.main(["kmeans", "--device", "cpu"]) == 1
    assert "FAILED: the trace holds 7" in capsys.readouterr().out
    assert PCLI.main(["nope", "--device", "cpu"]) == 2
    assert PCLI.main([]) == 2


def test_without_a_card_and_a_device_the_cli_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        PCLI.main(["--all"])
