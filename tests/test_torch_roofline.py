"""``harp_tpu_torch.utils.roofline`` and ``harp_tpu_torch.ops.
kernel_registry`` against harp_tpu's, and the bounds of ``PERF.md`` §6.

- Every work model of ``WORK_MODELS`` gives the reference's bytes and
  metric on the same row, and its operations where the route does the
  reference's work; a KMeans row that runs K1 or K2 counts those kernels'
  operations (the registry's ``k12_ops``), not the one-hot sums matmul.
  ``annotate`` under the reference's peaks is the reference's
  ``annotate`` where the two hold a row to the same peak key (int8, K2's
  bf16, bf16 MLPs), its operation fields scaled by the route's work; by
  default the peaks are the H100's, and the peak follows the route the
  row ran.
- The rows of ``PERF.md`` §5 (KMeans int8 and f32 + use_pallas at k = 100
  and 1000, the f32 default path, streaming int8 ex-generation, MF-SGD,
  LDA, the MLP's f32 wire) read under 100 % of every peak.
- The registry holds K1-K8 under the reference's eight names, each with
  positive work that fits the card's shared memory, and each build function's
  call on the CPU is its plain version's.
- The pure-shape bounds equal ``PERF.md`` §6's printed values.
"""

import functools
import math

import pytest
import torch

from harp_tpu.ops import kernel_registry as JKR
from harp_tpu.utils import roofline as JR
from harp_tpu_torch.ops import kernel_registry as KR
from harp_tpu_torch.utils import roofline as R
from torch_world import time_limit


@pytest.fixture(autouse=True)
def _limit():
    with time_limit(60):
        yield


KM = {"n": 1_000_000, "d": 300, "k": 100, "num_workers": 1}
#: one row per route the work models read, as the benchmarks write them
ROWS = {
    "kmeans_int8": dict(KM, quantize="int8", use_pallas=True,
                        dtype="float32", iters_per_sec=1140.88),
    "kmeans_f32_pallas": dict(KM, quantize=None, use_pallas=True,
                              dtype="float32", iters_per_sec=1014.97),
    "kmeans_f32": dict(KM, quantize=None, use_pallas=False, dtype="float32",
                       iters_per_sec=119.51),
    "kmeans_bf16": dict(KM, dtype="bfloat16", iters_per_sec=300.0),
    "kmeans_4w": dict(KM, num_workers=4, quantize="int8",
                      iters_per_sec=400.0),
    "kmeans_stream": dict(KM, n=1_000_000_000, k=1000, quantize="int8",
                          iters_per_sec=0.103729, iters_per_sec_ex_gen=0.14),
    "kmeans_stream_no_ex_gen": dict(KM, iters_per_sec=2.0,
                                    iters_per_sec_ex_gen=None),
    "mfsgd": {"rank": 64, "algo": "pallas",
              "updates_per_sec_per_chip": 1.149298e9},
    "lda": {"n_topics": 1000, "tokens_per_sec_per_chip": 2.698343e7},
    "mlp": {"batch": 8192, "num_workers": 1, "half_precision": False,
            "samples_per_sec": 5.103149e6},
    "mlp_bf16": {"batch": 8192, "num_workers": 2, "half_precision": True,
                 "samples_per_sec": 5e6},
}
FAMILY = {"kmeans": "kmeans", "mfsgd": "mfsgd", "lda": "lda", "mlp": "mlp"}


def _rows_for(config):
    fam = config.split("_")[0]
    return {k: v for k, v in ROWS.items() if k.split("_")[0] == fam}


def _runs_k12(row) -> bool:
    """The row's sums are K1's or K2's (or the int8 path's index adds),
    not a one-hot matmul."""
    return row.get("quantize") == "int8" or bool(row.get("use_pallas"))


def test_the_work_model_map_is_the_references():
    assert list(R.WORK_MODELS) == list(JR.WORK_MODELS)


@pytest.mark.parametrize("config", list(JR.WORK_MODELS))
def test_every_work_model_gives_the_references_work(config):
    for what, row in _rows_for(config).items():
        ours, theirs = R.WORK_MODELS[config](row), JR.WORK_MODELS[config](row)
        for key in ("bytes", "per"):
            assert ours[key] == theirs[key], (what, key)
        if _runs_k12(row):
            n, d, k = row["n"], row["d"], row["k"]
            assert ours["flops"] == KR.k12_ops(n, d, k) == 2 * n * k * d \
                + n * d, what
            assert theirs["flops"] == 4.0 * n * d * k
        else:
            assert ours["flops"] == theirs["flops"], what


@pytest.mark.parametrize("what", ["kmeans_int8", "kmeans_f32_pallas",
                                  "kmeans_4w", "kmeans_stream"])
def test_kernel_routes_count_the_registrys_work(what):
    """A KMeans row that runs K1 or K2 is held to the operations the
    registry counts for those kernels: the work model and the registered
    entry's flops are one count."""
    row = ROWS[what]
    assert R.WORK_MODELS["kmeans"](row)["flops"] == KR.k12_ops(
        row["n"], row["d"], row["k"])
    for name in ("kmeans.partials", "kmeans.partials_int8"):
        assert KR.KERNEL_WORK[name]["flops"] == KR.k12_ops(
            KR._KM_N, KR._KM_D, KR._KM_K)


#: rows the two packages hold to the same peak key
SAME_ROUTE = ["kmeans_int8", "kmeans_f32_pallas", "kmeans_bf16",
              "kmeans_4w", "kmeans_stream", "mlp_bf16"]


@pytest.mark.parametrize("what", SAME_ROUTE)
def test_annotate_under_the_references_peaks_is_the_references(what):
    """Equal field for field where the route does the reference's work;
    on K1's and K2's routes the bytes fields are equal and the operation
    fields the reference's scaled by k12_ops / 4ndk."""
    config = "mlp" if what.startswith("mlp") else "kmeans"
    row = ROWS[what]
    ours = R.annotate(config, row, peaks=dict(JR.V5E_PEAKS))
    theirs = JR.annotate(config, row)
    if config == "mlp" or not _runs_k12(row):
        assert ours == theirs
        return
    ratio = KR.k12_ops(row["n"], row["d"], row["k"]) / (
        4.0 * row["n"] * row["d"] * row["k"])
    for key in ("achieved_gbs", "pct_peak_bw", "roofline_peak"):
        assert ours[key] == theirs[key], key
    assert ours["achieved_tflops"] == pytest.approx(
        theirs["achieved_tflops"] * ratio, abs=1e-3)
    assert ours["pct_peak_flops"] == pytest.approx(
        theirs["pct_peak_flops"] * ratio, abs=0.01)


@pytest.mark.parametrize("what", ["kmeans_f32", "mfsgd", "lda", "mlp"])
def test_other_routes_differ_from_the_reference_only_in_their_peak(what):
    config = what.split("_")[0]
    row = ROWS[what]
    ours = R.annotate(config, row, peaks=dict(JR.V5E_PEAKS))
    theirs = JR.annotate(config, row)
    assert ours["roofline_peak"] == "f32_flops"
    assert theirs["roofline_peak"] == "bf16_flops"
    for key in ("achieved_tflops", "achieved_gbs", "pct_peak_bw"):
        assert ours[key] == theirs[key]
    assert ours["pct_peak_flops"] == pytest.approx(
        theirs["pct_peak_flops"] * 197e12 / 49.25e12, rel=1e-3, abs=0.03)


def test_the_default_peaks_are_the_h100s():
    assert R.H100_PEAKS == {"bf16_flops": 989e12, "int8_ops": 1979e12,
                            "f32_flops": 67e12, "hbm_gbs": 3.35e12}
    assert set(R.H100_PEAKS) == set(JR.V5E_PEAKS)
    assert R.HBM_BYTES_S == 3.35e12
    assert R.PEAK_OPS == {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
    row = ROWS["kmeans_int8"]
    assert R.annotate("kmeans", row) == R.annotate("kmeans", row,
                                                   peaks=R.H100_PEAKS)
    # unknown configs and rows without their fields pass through
    assert R.annotate("svm", {"x": 1}) == {"x": 1}
    assert R.annotate("kmeans", {"iters_per_sec": 1.0}) == {
        "iters_per_sec": 1.0}
    assert R.annotate("kmeans", dict(KM)) == dict(KM)


@pytest.mark.parametrize("what,peak", [
    ("kmeans_int8", "int8_ops"), ("kmeans_f32_pallas", "bf16_flops"),
    ("kmeans_f32", "f32_flops"), ("kmeans_bf16", "bf16_flops"),
    ("mfsgd", "f32_flops"), ("lda", "f32_flops"), ("mlp", "f32_flops"),
    ("mlp_bf16", "bf16_flops")])
def test_the_peak_is_the_routes(what, peak):
    assert R.route_peak(ROWS[what]) == peak


def test_a_wrong_peak_shows_at_once():
    """KMeans f32 + use_pallas at 1,014.97 iter/s: K2's 2ndk + nd
    operations are 6.12e13 op/s, 6.19 % of its bf16 peak but 91.3 % of the
    f32 peak; counted as the reference counts (4ndk, 1.22e14 flop/s) on
    the f32 peak that the row would be held to if its route were ignored,
    182 %."""
    row = ROWS["kmeans_f32_pallas"]
    ann = R.annotate("kmeans", row)
    assert ann["roofline_peak"] == "bf16_flops"
    assert ann["pct_peak_flops"] == pytest.approx(6.19, abs=0.01)
    f32_peak = dict(R.H100_PEAKS, bf16_flops=R.H100_PEAKS["f32_flops"])
    assert R.annotate("kmeans", row, peaks=f32_peak)[
        "pct_peak_flops"] == pytest.approx(91.3, abs=0.1)
    wrong = R.annotate("kmeans", dict(row, use_pallas=False))
    assert wrong["pct_peak_flops"] == pytest.approx(181.8, abs=0.1)


#: PERF.md §5's rows (NVIDIA H100 80GB HBM3, 700 W): config, row
PERF_ROWS = {
    "kmeans int8 k=100": ("kmeans", ROWS["kmeans_int8"]),
    "kmeans int8 k=1000": ("kmeans", dict(ROWS["kmeans_int8"], k=1000,
                                          iters_per_sec=438.89)),
    "kmeans f32 pallas k=100": ("kmeans", ROWS["kmeans_f32_pallas"]),
    "kmeans f32 pallas k=1000": ("kmeans", dict(ROWS["kmeans_f32_pallas"],
                                                k=1000, iters_per_sec=206.36)),
    "kmeans f32 default": ("kmeans", ROWS["kmeans_f32"]),
    "streaming int8 ex-gen": ("kmeans_stream_int8",
                              dict(ROWS["kmeans_stream"],
                                   iters_per_sec_ex_gen=0.103729 * 9.6405
                                   / (9.6405 - 7.6))),
    "mfsgd": ("mfsgd_pallas", ROWS["mfsgd"]),
    "lda": ("lda_pallas", ROWS["lda"]),
    "mlp f32": ("mlp", ROWS["mlp"]),
}


@pytest.mark.parametrize("what", sorted(PERF_ROWS))
def test_perf_rows_read_under_every_peak(what):
    config, row = PERF_ROWS[what]
    ann = R.annotate(config, row)
    assert 0 < ann["pct_peak_flops"] < 100
    assert 0 < ann["pct_peak_bw"] < 100


# ---- the registry ---------------------------------------------------------

def test_the_registry_holds_the_references_eight_names():
    assert list(KR.KERNELS) == list(JKR.KERNELS)
    assert sorted(KR.KERNEL_INFO[n]["kernel"] for n in KR.KERNELS) == [
        f"K{i}" for i in range(1, 9)]
    assert {KR.KERNEL_INFO[n]["replaces"].split(":")[0]
            for n in KR.KERNELS} <= {
        "harp_tpu/ops/kmeans_kernel.py", "harp_tpu/ops/lda_kernel.py",
        "harp_tpu/ops/mfsgd_kernel.py", "harp_tpu/ops/flash_attention.py",
        "harp_tpu/ops/svm_kernel.py", "harp_tpu/ops/wdamds_kernel.py",
        "harp_tpu/ops/rf_kernel.py"}


@pytest.mark.parametrize("name", list(JKR.KERNELS))
def test_each_entry_states_positive_work_that_fits_the_card(name):
    work = KR.KERNEL_WORK[name]
    assert set(work) == {"flops", "min_hbm_bytes", "smem_bytes"}
    assert all(type(v) is int and v > 0 for v in work.values())
    assert work["smem_bytes"] <= 232_448
    info = KR.KERNEL_INFO[name]
    mod = KR.wrapper_module(name)
    assert info["counter"] in mod.LAUNCHES and info["launches"] == 1
    fn, args = KR.KERNELS[name](torch.device("cpu"))
    assert isinstance(fn, functools.partial)
    got = KR.run_on_copies(fn, args)
    want = KR.run_on_copies(KR.plain_of(name, fn), args)
    ok, err = KR.agree(name, got, want)
    assert ok and err == 0.0
    before = mod.LAUNCHES[info["counter"]]
    fn(*[a.clone() if isinstance(a, torch.Tensor) else a for a in args])
    assert mod.LAUNCHES[info["counter"]] == before  # the CPU never counts


def test_registration_refuses_work_that_is_not_stated():
    for bad in (0, -1, 1.5, True, None):
        with pytest.raises(ValueError, match="positive int"):
            KR.register_kernel("x", flops=bad, min_hbm_bytes=1, smem_bytes=1,
                               kernel="K0", module="m", counter="c",
                               plain="p", tol=(0, 0), source="s",
                               replaces="r")
    with pytest.raises(ValueError, match="shared memory"):
        KR.register_kernel("x", flops=1, min_hbm_bytes=1,
                           smem_bytes=232_449, kernel="K0", module="m",
                           counter="c", plain="p", tol=(0, 0), source="s",
                           replaces="r")
    assert "x" not in KR.KERNELS


def test_agree_holds_each_entry_to_its_class():
    a = (torch.tensor([1.0, 2.0]),)
    assert KR.agree("rf.hist_bins", a, a) == (True, 0.0)
    assert not KR.agree("rf.hist_bins", (a[0] + 1e-6,), a)[0]
    ok, err = KR.agree("wdamds.smacof_dist", (a[0] * (1 + 5e-5),), a)
    assert ok and err == pytest.approx(1e-4, rel=1e-2)


def test_the_kmeans_entries_state_the_cards_fused_plans():
    """K1's and K2's registered shared memory is the main block of the
    fused plan the card makes at (d=256, k=8) (phase 44 reads it from the
    card's plan): the int8 tiles' block is the smaller, and both fit."""
    k1 = KR.KERNEL_WORK["kmeans.partials_int8"]["smem_bytes"]
    k2 = KR.KERNEL_WORK["kmeans.partials"]["smem_bytes"]
    assert (k1, k2) == (83_424, 218_528)
    assert k1 < k2 <= KR.H100_SMEM_OPTIN


#: PERF.md §6's pure-shape bounds (ms, by), as chip_smoke.py printed them
BOUNDS = {
    "K1 k=100": (lambda: KR.k12_bound_ms(1_000_000, 300, 100, True),
                 0.0896, "bytes"),
    "K1 k=1000": (lambda: KR.k12_bound_ms(1_000_000, 300, 1000, True),
                  0.3032, "operations"),
    "K2 k=100": (lambda: KR.k12_bound_ms(1_000_000, 300, 100, False),
                 0.3583, "bytes"),
    "K2 k=1000": (lambda: KR.k12_bound_ms(1_000_000, 300, 1000, False),
                  0.6067, "operations"),
    "K1 chunk": (lambda: KR.k12_bound_ms(262_144, 300, 1000, True),
                 0.0795, "operations"),
    "K2 chunk": (lambda: KR.k12_bound_ms(262_144, 300, 1000, False),
                 0.1590, "operations"),
    "K5 f32": (lambda: KR.k5_bound_ms(500_256, 128, 4), 0.0777, "bytes"),
    "K5 bf16": (lambda: KR.k5_bound_ms(500_256, 128, 2), 0.0394, "bytes"),
    "K6 f32": (lambda: KR.k6_bound_ms(4096, 4096, 3, 4), 0.0201, "bytes"),
    "K6 bf16": (lambda: KR.k6_bound_ms(4096, 4096, 3, 2), 0.0101, "bytes"),
    "K8 f32 causal w4096": (lambda: KR.k8_bound_ms(32, 8192, 128, False,
                                                   True, 4096),
                            6.1545, "operations"),
    "K8 f32 causal": (lambda: KR.k8_bound_ms(32, 8192, 128, False, True,
                                             None), 8.2063, "operations"),
    "K8 bf16 causal": (lambda: KR.k8_bound_ms(32, 8192, 128, True, True,
                                              None), 0.5559, "operations"),
    "K8 bf16 causal w4096": (lambda: KR.k8_bound_ms(32, 8192, 128, True,
                                                    True, 4096),
                             0.4169, "operations"),
    "K8 f32 w512 N2048": (lambda: KR.k8_bound_ms(32, 2048, 128, False, False,
                                                 512), 0.4484, "operations"),
    "K8 bf16 D64": (lambda: KR.k8_bound_ms(64, 4096, 64, True, True, None),
                    0.1390, "operations"),
}


@pytest.mark.parametrize("what", sorted(BOUNDS))
def test_pure_shape_bounds_are_perf_md_s(what):
    fn, ms, by = BOUNDS[what]
    got_ms, got_by = fn()
    assert f"{got_ms:.4f}" == f"{ms:.4f}" and got_by == by


def test_data_bounds_count_what_the_data_asks():
    import numpy as np

    eu = np.array([[0, 1, 1, 4], [2, 2, 4, 4]], np.int32)  # tile 4: 4 = pad
    ei = np.array([[3, 3, 0, 9], [0, 1, 9, 9]], np.int32)
    w = KR.k3_work(eu, ei, 4, 4)
    assert w == {"entries": 2, "slots": 8, "ratings": 5, "rows": 2 + 1 + 2 + 2}
    ms, by = KR.k3_bound_ms(w, 8, 8, 64)
    nbytes = 4 * 8 + 8 * 5 + 8 * 2 + 2 * 4 * 16 * 64
    assert ms == pytest.approx(max(nbytes / 3.35e12,
                                   (10 * 5 * 64 + 2 * 7 * 64) / 67e12) * 1e3)
    assert KR.k4_work(np.array([[0, 5, 1]]), 4) == {
        "entries": 1, "slots": 3, "tokens": 2}
    assert KR.k7_bound_ms(10, 2, 1, 2, 4, 10)[1] == "bytes"
    assert KR.k8_pairs(4, True, None) == 10 and KR.k8_pairs(4, False, 2) == 10
    assert math.isclose(KR.bound_ms(3.35e9, 0, "f32")[0], 1.0)
