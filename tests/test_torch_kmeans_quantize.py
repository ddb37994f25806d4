"""The streamed int8 chunk's fused pass (``kmeans_kernel.quantize_rows_int8``,
``csrc/kmeans_quantize_int8.cu``): an f32 chunk to its int8 chunk and its
sum of |x|^2 in one launch.

On the CPU the wrapper runs its plain version, which must equal the two
expressions the streaming loop ran before the fusion (the in-place
divide, round, clamp and cast, then ``models.kmeans._hoisted_x2``), and
the loop's routing is checked there.  The ``cuda`` cases hold the kernel
to the plain version on the card: the int8 chunk bit for bit, the sum of
|x|^2 within 1e-6 relative (and to the exact sum, which the kernel rounds
about once).  This file imports only torch and the port, so on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kmeans_quantize.py -q
"""

from __future__ import annotations

import pytest
import torch

from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.models import kmeans_stream as KS
from harp_tpu_torch.ops import kmeans_kernel as KK


def _chunk(n, d, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g) * 1.5
    scale = (x.abs().amax(0) if n else torch.ones(d)).clamp_min(1e-3) / 127
    return x.to(device), (scale * 0.8).to(device)  # some values saturate


def _before(x, col_scale):
    """The loop's two passes before the fusion, as it ran them."""
    q = x.clone().div_(col_scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, KM._hoisted_x2((q, col_scale))


# (n, d): ragged row counts at the chunk's width and at a width whose rows
# are not whole 16-byte groups, and an empty chunk
SHAPES = [(1001, 300), (4099, 300), (1001, 7), (33, 7), (0, 300), (0, 7)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_equals_the_loops_passes_before_the_fusion(n, d):
    x, scale = _chunk(n, d)
    keep = x.clone()
    q, x2 = KK.quantize_rows_int8_plain(x, scale)
    q0, x20 = _before(x, scale)
    assert q.dtype == torch.int8 and q.shape == (n, d)
    assert torch.equal(q, q0) and torch.equal(x2, x20)
    assert torch.equal(x, keep)  # the chunk is read, not overwritten


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    x, scale = _chunk(257, 300, seed=1)
    before = dict(KK.LAUNCHES)
    q, x2 = KK.quantize_rows_int8(x, scale)
    q0, x20 = KK.quantize_rows_int8_plain(x, scale)
    assert torch.equal(q, q0) and torch.equal(x2, x20)
    assert KK.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    x, scale = _chunk(64, 12)
    if bad == "dtype":
        args, err = (x.to(torch.bfloat16), scale), TypeError
    elif bad == "shape":
        args, err = (x, scale[:-1]), ValueError
    elif bad == "contiguity":
        args, err = (x.t().contiguous().t(), scale), ValueError
    else:
        args, err = (x, scale.to("meta")), ValueError
    with pytest.raises(err):
        KK.quantize_rows_int8(*args)


def test_synthetic_run_equals_the_loop_before_the_fusion():
    """``_synthetic_run``'s int8 epochs through the fused pass end on the
    centroids and inertia of the quantize-then-``chunk_partials(x2=None)``
    loop it replaced, bit for bit on the CPU."""
    k, d, rows, n_chunks, epochs = 5, 7, 96, 3, 2
    g = torch.Generator().manual_seed(3)
    chunks = [torch.randn((rows, d), generator=g) for _ in range(n_chunks)]
    col = torch.full((d,), 4.0 / 127)
    cfg = KS.StreamConfig(k=k, chunk_points=rows, quantize="int8")
    c0 = chunks[0][:k].clone()
    c1, i1 = KS._synthetic_run(c0, epochs, lambda j: chunks[j].clone(),
                               n_chunks, cfg, col)
    c = c0
    for _ in range(epochs):
        ops = KM.epoch_operands(c, "int8", col)
        sums, counts = torch.zeros((k, d)), torch.zeros((k,))
        inertia = torch.zeros(())
        for j in range(n_chunks):
            q, _ = _before(chunks[j], col)
            s, n_, i = KM.chunk_partials(q, ops, "int8")
            sums, counts, inertia = sums + s, counts + n_, inertia + i
        c = KM._normalize_centroids(sums, counts, c)
    assert torch.equal(c1, c) and torch.equal(i1, inertia)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused pass has no CPU mode)")
    return torch.device("cuda")


def _exact_x2(q, scale) -> float:
    """The chunk's sum of |x|^2 from exact integer sums of q^2, in f64."""
    qq = (q.to(torch.int64) ** 2).sum(0).to(torch.float64)
    return float((scale.to(torch.float64) ** 2 * qq).sum())


def _check(x, scale):
    """One kernel call against the plain version: q bit for bit, x2 within
    1e-6 of the plain f32 sum and rounded from the exact sum; one launch."""
    before = KK.LAUNCHES["kmeans_quantize_int8"]
    q, x2 = KK.quantize_rows_int8(x, scale)
    torch.cuda.synchronize()
    assert KK.LAUNCHES["kmeans_quantize_int8"] == before + 1
    q0, x20 = KK.quantize_rows_int8_plain(x, scale)
    assert q.dtype == torch.int8 and torch.equal(q, q0)
    want = float(x20)
    assert abs(float(x2) - want) <= 1e-6 * abs(want)
    exact = _exact_x2(q0, scale)
    assert abs(float(x2) - exact) <= 2 ** -23 * exact
    return q, x2


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1001, 300), (262_144, 300), (4099, 7),
                                 (33, 7), (5, 1), (77, 2), (1000, 1040),
                                 (300, 1025)])
def test_kernel_matches_plain_on_random_chunks(dev, n, d):
    x, scale = _chunk(n, d, seed=n + d, device=dev)
    q, x2 = _check(x, scale)
    q2, x22 = KK.quantize_rows_int8(x, scale)  # reruns are bit-equal
    assert torch.equal(q, q2) and torch.equal(x2, x22)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 7])
def test_kernel_is_bit_equal_on_crafted_values(dev, d):
    """Exact .5 ties of x / s (both parities, both signs), values at and
    beyond ±127·s, ±0, infinities and large magnitudes.  Every other
    column's scale is a power of two, so that x / s lands exactly on the
    tie; the others land next to it."""
    n = 611
    scale = torch.linspace(0.01, 3.0, d, device=dev)
    steps = torch.arange(len(scale[::2]), device=dev, dtype=torch.float32)
    scale[::2] = 2.0 ** (steps % 12 - 6)
    k = torch.arange(-130, 131, device=dev, dtype=torch.float32)
    ties = torch.cat([k + 0.5, k - 0.5, k, torch.tensor(
        [127.0, -127.0, 127.5, -127.5, 128.0, -128.0, 126.5, -126.5],
        device=dev)])
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), 1e30,
                            -1e30, 3.4e38, -3.4e38, 1e-30, -1e-30],
                           device=dev)
    g = torch.Generator(device=dev).manual_seed(d)
    pick = torch.randint(0, ties.numel(), (n, d), generator=g, device=dev)
    x = ties[pick] * scale[None, :]  # x / s lands on or next to a tie
    x[::7] = special[torch.randint(0, special.numel(), (d,), generator=g,
                                   device=dev)]
    q, x2 = KK.quantize_rows_int8(x, scale)
    q0, x20 = KK.quantize_rows_int8_plain(x, scale)
    torch.cuda.synchronize()
    assert torch.equal(q, q0)
    assert abs(float(x2) - float(x20)) <= 1e-6 * abs(float(x20))


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_chunk(dev):
    """A view one float past a 16-byte boundary takes element loads of the
    same groups."""
    x, scale = _chunk(2049 * 300 + 1, 1, seed=9, device=dev)
    view = x.view(-1)[1:].view(2049, 300)
    _check(view, scale.expand(300).contiguous())


@pytest.mark.cuda
def test_kernel_keeps_a_blocks_int32_sums_exact(dev):
    """Every q at ±127 over more rows than one block may sum (the plan
    grows the grid): x2 is n · 127² · s² rounded once."""
    n = 150_000_000
    x = torch.full((n, 1), 1e3, device=dev)
    x[1::2] = -1e3
    scale = torch.full((1,), 0.5, device=dev)
    q, x2 = KK.quantize_rows_int8(x, scale)
    torch.cuda.synchronize()
    assert int(q.to(torch.int32).abs().min()) == 127
    assert float(x2) == float(torch.tensor(n * 127 ** 2 * 0.25,
                                           dtype=torch.float64).float())


@pytest.mark.cuda
def test_empty_chunk_launches_nothing(dev):
    x = torch.empty((0, 300), device=dev)
    before = KK.LAUNCHES["kmeans_quantize_int8"]
    q, x2 = KK.quantize_rows_int8(x, torch.ones(300, device=dev))
    assert q.shape == (0, 300) and float(x2) == 0.0
    assert KK.LAUNCHES["kmeans_quantize_int8"] == before


@pytest.mark.cuda
def test_synthetic_run_launches_the_fused_pass_once_a_chunk(dev):
    rows, d, k, n_chunks = 4096, 300, 16, 5
    gen = KS._make_chunk_gen(7, 0, rows, d, torch.float32, dev)
    col = torch.full((d,), 5.0 / 127, device=dev)
    cfg = KS.StreamConfig(k=k, chunk_points=rows, quantize="int8")
    c0 = torch.randn((k, d), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    KK.reset_launches()
    KS._synthetic_run(c0, 2, gen, n_chunks, cfg, col)
    torch.cuda.synchronize()
    assert KK.LAUNCHES == {"kmeans_partials_int8": 2 * n_chunks,
                           "kmeans_partials": 0,
                           "kmeans_quantize_int8": 2 * n_chunks}
