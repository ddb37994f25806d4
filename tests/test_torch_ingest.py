"""The port's ingest pipeline (harp_tpu_torch.ingest) against the contract
of harp_tpu.ingest, and RF's chunked binning through it.

Every depth of the pipeline is bit-exact: the stages are deterministic per
chunk and consumption is in order, so only the overlap changes.  The
staging ring's guard (a pinned buffer is rewritten only after its last
copy has completed) is checked with a deliberately slow, asynchronous copy
standing in for the card's H2D copy: without the guard the prep stage
would overwrite a buffer that copy is still reading.  All comparisons here
are exact (integer chunk ids, row patterns, bin ids).
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from harp_tpu import ingest as JI
from harp_tpu.models import rf as JRF
from harp_tpu_torch import ingest
from harp_tpu_torch.models import rf as RF

# (depth, read_threads, prep_threads)
SHAPES = [(1, 1, 1), (2, 1, 1), (4, 2, 2), (2, 3, 1), (4, 1, 4)]


@pytest.mark.parametrize("depth,rt,pt", SHAPES)
def test_pipeline_preserves_order_and_values(depth, rt, pt):
    def prep(r):
        time.sleep(0.001 * ((7 * r) % 3))  # out-of-order finishing
        return r * 10

    with ingest.IngestPipeline(lambda j: j, prep, lambda r: r + 1,
                               depth=depth, read_threads=rt,
                               prep_threads=pt) as pipe:
        assert list(pipe.stream(13)) == [j * 10 + 1 for j in range(13)]
        assert pipe.stats.chunks == 13 and pipe.stats.depth == depth
        # the same pipeline again (epoch reuse), and an empty stream
        assert list(pipe.stream(3)) == [1, 11, 21]
        assert list(pipe.stream(0)) == []


@pytest.mark.parametrize("depth,rt,pt", SHAPES)
def test_pipeline_matches_reference(depth, rt, pt):
    """The port and harp_tpu's pipeline yield the same chunks for the same
    stages (here numpy row blocks, cast and offset)."""
    x = np.random.default_rng(depth).normal(size=(50, 3)).astype(np.float32)
    stages = (lambda j: x[5 * j:5 * j + 5],
              lambda b: b.astype(np.float16), lambda b: b * 2)
    with ingest.IngestPipeline(*stages, depth=depth, read_threads=rt,
                               prep_threads=pt) as a, \
            JI.IngestPipeline(*stages, depth=depth, read_threads=rt,
                              prep_threads=pt) as b:
        for got, want in zip(a.stream(10), b.stream(10), strict=True):
            np.testing.assert_array_equal(got, want)


def test_pipeline_single_reader_runs_in_order():
    """Stateful sequential sources depend on read(j) running in
    submission order on one thread."""
    seen = []

    def read(j):
        seen.append(j)
        time.sleep(0.001 * (3 - j % 3))  # per-call jitter
        return j

    with ingest.IngestPipeline(read, depth=4) as pipe:
        assert list(pipe.stream(9)) == list(range(9))
    assert seen == list(range(9))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("stage", ["read", "prep", "ship"])
def test_pipeline_propagates_stage_errors(depth, stage):
    def fail_at_3(j):
        if j == 3:
            raise RuntimeError(f"{stage} on fire")
        return j

    stages = {"read": lambda j: j, "prep": lambda r: r, "ship": lambda r: r}
    stages[stage] = fail_at_3
    got = []
    with ingest.IngestPipeline(stages["read"], stages["prep"],
                               stages["ship"], depth=depth) as pipe:
        with pytest.raises(RuntimeError, match=f"{stage} on fire"):
            for c in pipe.stream(8):
                got.append(c)
    # in order up to the failure (shipping ahead may surface it earlier)
    assert got == [0, 1, 2][:len(got)]


def test_pipeline_rejects_bad_knobs():
    with pytest.raises(ValueError, match="depth"):
        ingest.IngestPipeline(lambda j: j, depth=0)
    with pytest.raises(ValueError, match="threads"):
        ingest.IngestPipeline(lambda j: j, read_threads=0)
    with pytest.raises(ValueError, match="threads"):
        ingest.IngestPipeline(lambda j: j, prep_threads=0)


def test_stall_detector_fires_on_sabotaged_overlap():
    """A dead pipeline: each read is gated on the previous chunk's
    consumption, so depth 2 cannot work ahead and the detector says so."""
    sem = threading.Semaphore(1)

    def read(j):
        sem.acquire()  # can never run ahead of consumption
        time.sleep(0.02)
        return j

    pipe = ingest.IngestPipeline(read, depth=2, tag="unit.sabotage",
                                 stall_warn=0.5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in pipe.stream(8):
            time.sleep(0.01)  # the compute the reads should hide under
            sem.release()
    pipe.close()
    assert pipe.stats.overlap_efficiency < 0.5, pipe.stats
    assert pipe.stats.stalls == 1
    assert any("stalled" in str(x.message) for x in w)


def test_no_stall_warning_when_overlap_works():
    def read(j):
        time.sleep(0.01)
        return j

    pipe = ingest.IngestPipeline(read, depth=2, tag="unit.healthy",
                                 stall_warn=0.5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in pipe.stream(8):
            time.sleep(0.01)
    pipe.close()
    assert not any("stalled" in str(x.message) for x in w)
    assert pipe.stats.overlap_efficiency >= 0.5, pipe.stats


def test_serial_and_idle_runs_score_vacuously_efficient():
    for depth in (1, 2):
        with ingest.IngestPipeline(lambda j: j, depth=depth) as pipe:
            list(pipe.stream(5))
            assert pipe.stats.overlap_efficiency == 1.0
            assert pipe.stats.as_dict()["chunks"] == 5


# ---- the staging ring ------------------------------------------------------

class _SlowCopy:
    """An asynchronous copy that reads its source a row at a time, slowly:
    the CPU's stand-in for an H2D copy in flight."""

    def __init__(self, dst, src):
        self._done = threading.Event()
        self._t = threading.Thread(target=self._run, args=(dst, src),
                                   daemon=True)
        self._t.start()

    def _run(self, dst, src):
        for r in range(src.shape[0]):
            time.sleep(0.0005)
            dst[r].copy_(src[r])
        self._done.set()

    def query(self):
        return self._done.is_set()

    def synchronize(self):
        assert self._done.wait(30), "slow copy never finished"


def _ring_stream(depth, n_chunks, rows=24, slow=True):
    """Chunk j's rows hold the pattern j * 1000 + row; returns what the
    consumer saw and the ring."""
    ring = ingest.StagingRing(rows, (4,), torch.float32,
                              torch.device("cpu"), slots=depth + 1)
    if slow:
        ring._copy = lambda dst, src: _SlowCopy(dst, src)

    def prep(j):
        n = rows - j % 3  # ragged chunks too
        ring.host(j, n).copy_(
            (j * 1000 + torch.arange(n, dtype=torch.float32))[:, None]
            .expand(n, 4))
        return j, n

    # the consumer reads chunk j only once chunk j+1 has arrived, as the
    # card's compute runs behind the host: the copy of chunk j may still
    # be in flight while the pipeline preps ahead
    seen, held = [], None
    with ingest.IngestPipeline(lambda j: j, prep, lambda t: ring.ship(*t),
                               depth=depth) as pipe:
        for shipped in pipe.stream(n_chunks):
            if held is not None:
                seen.append(held.get().clone())
            held = shipped
    seen.append(held.get().clone())
    return seen, ring


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_staging_ring_waits_for_in_flight_copies(depth):
    seen, ring = _ring_stream(depth, 12)
    for j, x in enumerate(seen):
        n = 24 - j % 3
        want = (j * 1000 + torch.arange(n, dtype=torch.float32))[:, None]
        assert torch.equal(x, want.expand(n, 4)), f"chunk {j} corrupted"
    # with a thread ahead of the consumer the prep stage found copies in
    # flight and waited for them: the guard was exercised, not idle
    # (serially, chunk j+2's prep follows the consumer's read of chunk j)
    assert ring.waits > 0 if depth > 1 else ring.waits == 0


def test_staging_ring_synchronous_copies_never_wait():
    seen, ring = _ring_stream(2, 6, slow=False)
    assert [int(x[0, 0]) for x in seen] == [j * 1000 for j in range(6)]
    assert ring.waits == 0 and ring.slots == 3


def test_shipped_get_waits_for_its_copy_on_the_host():
    src = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    dst = torch.zeros_like(src)
    got = ingest.Shipped(dst, _SlowCopy(dst, src)).get()
    assert got is dst and torch.equal(got, src)
    assert ingest.Shipped(src).get() is src


# ---- RF's binning through the pipeline ---------------------------------------

@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("chunk_rows", [1024, 977, 5000])
def test_rf_binize_chunked_bit_equal(prefetch, chunk_rows):
    """Bit-equal to binize and to the reference's binize_chunked."""
    rng = np.random.default_rng(chunk_rows)
    x = rng.normal(size=(5000, 9)).astype(np.float32)
    edges = RF.quantile_bins(x, 8)
    np.testing.assert_array_equal(edges, JRF.quantile_bins(x, 8))
    ref = RF.binize(x, edges)
    np.testing.assert_array_equal(
        RF.binize_chunked(x, edges, chunk_rows=chunk_rows,
                          prefetch=prefetch), ref)
    np.testing.assert_array_equal(
        JRF.binize_chunked(x, edges, chunk_rows=chunk_rows,
                           prefetch=prefetch), ref)


def test_rf_binize_chunked_empty_input():
    edges = np.zeros((3, 7), np.float32)
    out = RF.binize_chunked(np.zeros((0, 3), np.float32), edges)
    assert out.shape == (0, 3) and out.dtype == np.int32
