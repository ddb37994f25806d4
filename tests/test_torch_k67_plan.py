"""The arithmetic around K6 and K7 that runs on the host: the bounds that
``chip_smoke.py`` prints beside the kernels' times, and K7's launch plan
(``rf_kernel.plan``), held to hand-computed cases.

Shapes are the main paths' (``chip_smoke.py``): K6 at n_loc = N = 4096,
dim 3; K7 at 200,000 samples x 64 features x 32 bins, 32 trees, 2 classes
(R = 2, 4, ..., 64 over levels 0-5), with the 4,046,723 nonzero (tree,
sample) weights of the benchmark's fit.  The card's figures are an H100's:
232,448 bytes of opt-in shared memory a block, 132 SMs.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as CS
from harp_tpu_torch.ops import rf_kernel as K7

OPTIN, SMS = 232_448, 132
N, F, TREES, B = 200_000, 64, 32, 32
NNZ = 4_046_723


# ---- bounds -----------------------------------------------------------------

@pytest.mark.parametrize("dsize,want", [(4, 0.0201), (2, 0.0101)])
def test_k6_bound_at_the_main_path(dsize, want):
    """δ once (4096² elements), X, Xl twice over (in, out) and the row mask:
    (4096² · dsize + 4 · (3·4096 + 2·3·4096 + 4096)) / 3.35e12 s."""
    ms, by = CS.k6_bound_ms(4096, 4096, 3, dsize)
    nbytes = 4096 * 4096 * dsize + 4 * (4 * 4096 + 6 * 4096)
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert round(ms, 4) == want and by == "bytes"


def test_k6_bound_turns_to_operations_when_delta_is_small():
    """At N = 1 there is hardly a byte to read; the SFU's sqrt and division
    a pair (2 results a pair at 16 a clock on 132 SMs at 1.98 GHz) and the
    ~20 f32 operations a pair are tiny too, but the bytes of X and Xl still
    set it: bytes, and the formula above."""
    ms, by = CS.k6_bound_ms(1_000_000, 1, 8, 4)
    nbytes = 1_000_000 * 4 + 4 * (8 + 2 * 8_000_000 + 1_000_000)
    t_ops = max(20 * 1e6 / 67e12, 2 * 1e6 / (16 * 132 * 1.98e9))
    assert ms == pytest.approx(max(nbytes / 3.35e12, t_ops) * 1e3)


@pytest.mark.parametrize("level", range(6))
def test_k7_bound_a_level_of_the_main_path(level):
    """2.59e8 weighted increments (4,046,723 nonzero weights x 64 features)
    at one 4-byte shared-memory update per bank and clock (32 x 132 x 1.98
    GHz = 8.364e12/s): 0.0310 ms at every level; the bytes (bins 12.8 MB,
    row codes and weights 51.2 MB, the histogram 0.5-16.8 MB) take less."""
    R = 2 * 2 ** level
    ms, by = CS.k7_bound_ms(N, F, TREES, R, B, NNZ)
    assert ms == pytest.approx(NNZ * F / (32 * 132 * 1.98e9) * 1e3)
    assert round(ms, 4) == 0.0310 and by == "operations"
    nbytes = N * F + 8 * TREES * N + 4 * TREES * R * F * B
    assert nbytes / 3.35e12 * 1e3 < ms


def test_k7_bound_a_fit_is_six_levels():
    total = sum(CS.k7_bound_ms(N, F, TREES, 2 * 2 ** lv, B, NNZ)[0]
                for lv in range(6))
    assert round(total, 4) == 0.1858


@pytest.mark.parametrize("bin_bytes", [1, 4])
def test_k7_bound_is_bytes_when_few_weights_are_nonzero(bin_bytes):
    ms, by = CS.k7_bound_ms(N, F, TREES, 64, B, 1000, bin_bytes)
    nbytes = N * F * bin_bytes + 8 * TREES * N + 4 * TREES * 64 * F * B
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


# ---- K7's launch plan ---------------------------------------------------------

def test_shared_memory_of_a_plan_by_hand():
    """Level 5's plan: one tree's [64, 32, 16] int32 histograms (131,072
    bytes), two counters (16), a queue of 1 x 32 x 30 items of 8 bytes
    (7,680), and four ring slots of 960 samples x 16 bin ids plus 960 row
    codes and weights (4 x 23,040)."""
    assert K7.smem_bytes(16, 1, 16, 30, 64, 32, 1) == (
        131_072 + 16 + 7_680 + 4 * (960 * 16 + 2 * 960 * 4))
    # int32 bins: 4 bytes an id; fs = 24 rounds up to 32 columns (w = 32)
    assert K7.smem_bytes(24, 2, 32, 4, 8, 32, 4) == (
        2 * 8 * 32 * 32 * 4 + 16 + 2 * 128 * 8 + 4 * (128 * 24 * 4
                                                    + 2 * 2 * 128 * 4))


def test_layout_of_level_5_by_hand():
    """The regions of the level-5 plan in order, each on 16 bytes: the
    histograms [1, 64, 32, 16] int32, the counters, the 960-item queue,
    then four slots of 960 x 16 bin ids and, at 15,360 bytes into a slot,
    960 row codes and 960 weights."""
    assert K7.layout(16, 1, 16, 30, 64, 32, 1) == {
        "fsp": 16, "counts_at": 131_072, "queue_at": 131_088,
        "ring_at": 131_088 + 7_680, "slot": 15_360 + 7_680,
        "rcw_at": 15_360, "smem": 138_768 + 4 * 23_040}


def test_layout_pads_and_rounds_to_16_bytes():
    """fs = 3 at w = 4 pads to 4 columns; the regions of odd sizes (a
    [1, 3, 5, 4] histogram of 240 bytes, 32 x 3 bin ids of 96 bytes) keep
    their successors on 16-byte boundaries, as does a [1, 1, 3, 1]
    histogram of 12 bytes."""
    lay = K7.layout(3, 1, 4, 1, 3, 5, 1)
    assert lay["fsp"] == 4 and lay["counts_at"] == 240
    assert lay["rcw_at"] == 96 and lay["slot"] == 96 + 2 * 32 * 4
    assert all(v % 16 == 0 for k, v in lay.items() if k != "fsp")
    assert K7.layout(1, 1, 1, 1, 1, 3, 1)["counts_at"] == 16  # 12 → 16


@pytest.mark.parametrize("T,n,f,B,R,itemsize", [(32, N, F, B, 64, 1),
                                                (7, 9001, 13, 32, 8, 4),
                                                (3, 500, 5, 7, 2, 1)])
def test_a_plan_carries_its_layout(T, n, f, B, R, itemsize):
    """The kernel takes the regions as the plan gives them; they must be
    what :func:`rf_kernel.layout` makes for the plan's own choices."""
    p = K7.plan(T, n, f, B, R, itemsize, OPTIN, SMS)
    lay = K7.layout(p.fs, p.tg, p.w, p.ns, R, B, itemsize)
    assert {k: getattr(p, k) for k in lay} == lay


# level: (fs, tg, w, ns, chunk, nchunks) of the main path's plans, uint8
MAIN = {0: (64, 8, 32, 5, 6080, 33), 1: (64, 4, 32, 7, 12544, 16),
        2: (64, 2, 32, 9, 25056, 8), 3: (64, 1, 32, 10, 50240, 4),
        4: (32, 1, 32, 18, 100224, 2), 5: (16, 1, 16, 30, 200640, 1)}


@pytest.mark.parametrize("level", range(6))
def test_main_path_plans(level):
    """The widest slice whose histograms fit (64 features until one tree's
    [R, 32, 64] int32 histogram, 8·R KB, fills the block at R = 32), the
    tree count whose busiest block reads the fewest (tree, sample) pairs
    (8 trees in 4 groups x 33 chunks at level 0: 8 x 6,061; then 4, 2,
    1), chunks to about one block an SM, and the ring in the rest of
    shared memory."""
    R = 2 * 2 ** level
    p = K7.plan(TREES, N, F, B, R, 1, OPTIN, SMS)
    assert (p.fs, p.tg, p.w, p.ns, p.chunk, p.nchunks) == MAIN[level]
    assert p.smem == K7.smem_bytes(p.fs, p.tg, p.w, p.ns, R, B, 1) <= OPTIN
    # one more sub-tile a slot would not fit (the ring takes the rest)
    assert p.ns == 64 or K7.smem_bytes(p.fs, p.tg, p.w, p.ns + 1, R, B,
                                       1) > OPTIN
    groups = math.ceil(TREES / p.tg) * math.ceil(F / p.fs)
    assert groups * p.nchunks <= SMS


def test_level_0_prefers_eight_trees_to_nine():
    """Nine trees fit at level 0 too, but make four groups of 9, 9, 9 and 5
    trees: the busiest block reads 9 x 6,061 pairs, against 8 x 6,061."""
    nine = K7.plan(TREES, N, F, B, 2, 1, OPTIN, SMS, tg=9)
    eight = K7.plan(TREES, N, F, B, 2, 1, OPTIN, SMS)
    assert nine is not None and eight.tg == 8
    assert 9 * math.ceil(N / nine.nchunks) > 8 * math.ceil(N / eight.nchunks)


def test_int32_bins_leave_less_room_for_trees():
    """An int32 bin id takes 4 bytes of a ring slot: at level 0 four trees
    and the minimum ring of 4 sub-tiles fit, not eight (pinned, eight trees
    get a ring of fewer sub-tiles)."""
    p = K7.plan(TREES, N, F, B, 2, 4, OPTIN, SMS)
    assert (p.fs, p.tg, p.ns) == (64, 4, 4)
    assert K7.smem_bytes(64, 8, 32, 4, 2, B, 4) > OPTIN
    pinned = K7.plan(TREES, N, F, B, 2, 4, OPTIN, SMS, fs=64, tg=8)
    assert pinned.ns < K7.MIN_SUB_TILES


def test_a_histogram_past_shared_memory_has_no_plan():
    assert K7.plan(1, 100, 2, 32, 2 ** 16, 1, OPTIN, SMS) is None
    # the largest R with a plan: one feature, one tree, one sub-tile
    R = (OPTIN - 16 - 256 - 4 * (32 + 256)) // (32 * 4)
    assert K7.plan(1, 100, 1, 32, R, 1, OPTIN, SMS) is not None
    assert K7.plan(1, 100, 1, 32, R + 1, 1, OPTIN, SMS) is None


@pytest.mark.parametrize("fs,tg,ns,nchunks", [(64, 2, 2, 5), (24, 2, 4, 2),
                                              (1, 3, 4, 4), (4, 1, 64, 1)])
def test_pinned_plans_keep_their_pins(fs, tg, ns, nchunks):
    p = K7.plan(7, 9001, 64, 32, 8, 1, OPTIN, SMS, fs=fs, tg=tg, ns=ns,
                nchunks=nchunks)
    assert (p.fs, p.tg, p.ns, p.nchunks) == (fs, tg, ns, nchunks)
    assert p.w == min(32, 1 << (fs - 1).bit_length()) and fs <= 2 * p.w


SHAPES = [(1, 1, 1, 1, 1), (3, 500, 5, 7, 2), (5, 7001, 9, 32, 96),
          (7, 9001, 64, 32, 8), (32, 20_000, 64, 32, 64), (40, 12_345, 130,
                                                            16, 6),
          (2, 1_000_000, 8, 255, 4), (64, 3001, 13, 32, 128)]


@pytest.mark.parametrize("T,n,f,B,R", SHAPES)
@pytest.mark.parametrize("itemsize", [1, 4])
def test_every_plan_is_one_the_kernel_takes(T, n, f, B, R, itemsize):
    """What ``rf_hist_bins`` checks before it launches: a slice of at most
    2·w features, w a power of two up to 32, 1-64 sub-tiles, chunks that
    are whole super-tiles and cover n with no empty chunk, tg·R below
    2^20, and the shared memory within the card's."""
    p = K7.plan(T, n, f, B, R, itemsize, OPTIN, SMS)
    assert p is not None
    assert 1 <= p.fs <= min(f, 64) and p.fs <= 2 * p.w
    assert p.w in (1, 2, 4, 8, 16, 32) and 1 <= p.ns <= 64
    assert 1 <= p.tg <= min(T, 32) and p.tg * R <= 1 << 20
    assert p.chunk % (32 * p.ns) == 0
    assert p.chunk * p.nchunks >= n > (p.nchunks - 1) * p.chunk
    assert p.smem <= OPTIN
    groups = math.ceil(T / p.tg) * math.ceil(f / p.fs)
    assert groups * p.nchunks <= max(SMS, groups)


def test_the_cpu_path_plans_and_builds_nothing():
    rng = np.random.default_rng(0)
    bins = torch.from_numpy(rng.integers(0, 8, (50, 3)).astype(np.uint8))
    rc = torch.from_numpy(rng.integers(0, 4, (2, 50)).astype(np.int32))
    before = (dict(K7.LAUNCHES), dict(K7._PLANS), dict(K7._CARDS))
    K7.hist_bins(bins, rc, rc, 4, 8)
    assert (K7.LAUNCHES, K7._PLANS, K7._CARDS) == before
    assert not K7._BOUND
