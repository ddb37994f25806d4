"""The port's native loader and streaming sources
(harp_tpu_torch.native, harp_tpu_torch.fileformat) against numpy and
against harp_tpu.native on the same files.

The C++ parser's floats are compared with np.loadtxt within rtol 2e-6 (it
rounds each decimal string to float32 by its own scanner, at most about an
ulp from numpy's f64 parse cast to f32); against the reference's loader,
built from the same scanner, they are equal.  File placement
(multi_file_splits) is compared exactly.
"""

import ctypes
import pathlib

import numpy as np
import pytest

from harp_tpu import fileformat as JFF
from harp_tpu.native import datasource as JDS
from harp_tpu_torch import fileformat as FF
from harp_tpu_torch.native import build as B
from harp_tpu_torch.native import datasource as DS

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native_lib():
    lib = B.load_native()
    if lib is None:
        pytest.skip("no g++: the numpy parse is tested below")
    return lib


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(B, "_LIB", None)
    monkeypatch.setattr(B, "_TRIED", True)  # the numpy fallback


def _write_csv(path, pts, blanks=False, sep=","):
    with open(path, "w") as f:
        f.write("# header comment\n")
        for i, row in enumerate(pts):
            f.write(sep.join(f"{v:.7e}" for v in row) + "\n")
            if blanks and i % 97 == 0:
                f.write("\n")


def test_the_loaded_library_is_the_ports_own(native_lib):
    so = pathlib.Path(native_lib._name).resolve()
    assert so.parent == (REPO / "harp_tpu_torch" / "_build").resolve()
    assert so == B.so_path().resolve() and so.exists()
    assert "harp_tpu/native" not in str(so)
    assert (REPO / "harp_tpu_torch" / "native" / "loader.cpp").exists()


@pytest.mark.parametrize("sep", [",", " ", "\t"])
@pytest.mark.parametrize("threads", [0, 1, 3])
def test_load_csv_matches_loadtxt(native_lib, tmp_path, sep, threads):
    pts = np.random.default_rng(threads).normal(size=(1537, 7)).astype(
        np.float32)
    p = str(tmp_path / "a.csv")
    _write_csv(p, pts, blanks=True, sep=sep)
    got = DS.load_csv(p, n_threads=threads)
    ref = np.loadtxt(p, delimiter=None if sep != "," else ",",
                     dtype=np.float64, ndmin=2).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (1537, 7)
    np.testing.assert_allclose(got, ref, rtol=2e-6)
    np.testing.assert_array_equal(got, JDS.load_csv(p, n_threads=threads))


def test_load_csv_fallback_matches_native(native_lib, tmp_path, monkeypatch):
    pts = np.random.default_rng(9).normal(size=(300, 4)).astype(np.float32)
    p = str(tmp_path / "f.csv")
    _write_csv(p, pts, blanks=True, sep=" ")
    nat = DS.load_csv(p)
    monkeypatch.setattr(B, "_LIB", None)
    monkeypatch.setattr(B, "_TRIED", True)
    np.testing.assert_allclose(DS.load_csv(p), nat, rtol=2e-6)


def test_missing_file_raises(native_lib):
    with pytest.raises(OSError):
        DS.load_csv("/nonexistent/nope.csv")


@pytest.mark.parametrize("chunk", [1, 2, 7, 450])
def test_csv_stream_blocks_concatenate_to_full_matrix(native_lib, tmp_path,
                                                      chunk):
    pts = np.random.default_rng(chunk).normal(size=(901, 5)).astype(
        np.float32)
    p = str(tmp_path / "s.csv")
    _write_csv(p, pts, blanks=True)
    with DS.CSVStream(p, chunk_rows=chunk) as st:
        assert st.cols == 5
        blocks = list(st)
    with JDS.CSVStream(p, chunk_rows=chunk) as st:
        ref = np.concatenate(list(st), 0)
    assert all(b.shape[0] <= chunk for b in blocks)
    got = np.concatenate(blocks, 0)
    np.testing.assert_allclose(got, pts, rtol=2e-6)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("chunk", [1, 123])
def test_csv_stream_fallback_equivalent(tmp_path, no_native, chunk):
    pts = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    p = str(tmp_path / "f.csv")
    _write_csv(p, pts)
    with DS.CSVStream(p, chunk_rows=chunk) as st:
        assert st.cols == 4
        got = np.concatenate(list(st), 0)
    np.testing.assert_allclose(got, pts, rtol=2e-6)


@pytest.mark.parametrize("native", [True, False])
def test_csv_stream_pads_ragged_rows(native_lib, tmp_path, monkeypatch,
                                     native):
    """Short rows zero-pad and extra columns are dropped, on both paths."""
    p = str(tmp_path / "r.csv")
    with open(p, "w") as f:
        f.write("1,2,3\n4,5\n6,7,8,9\n")
    if not native:
        monkeypatch.setattr(B, "_LIB", None)
        monkeypatch.setattr(B, "_TRIED", True)
    with DS.CSVStream(p, chunk_rows=10) as st:
        got = np.concatenate(list(st), 0)
    np.testing.assert_array_equal(
        got, np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.float32))


@pytest.mark.parametrize("native", [True, False])
def test_csv_points_sequential_contract(native_lib, tmp_path, monkeypatch,
                                        native):
    if not native:
        monkeypatch.setattr(B, "_LIB", None)
        monkeypatch.setattr(B, "_TRIED", True)
    pts = np.random.default_rng(2).normal(size=(1200, 3)).astype(np.float32)
    p = str(tmp_path / "p.csv")
    _write_csv(p, pts, blanks=True)
    with DS.CSVPoints(p, chunk_rows=256) as cp:
        assert cp.shape == (1200, 3) and len(cp) == 1200
        np.testing.assert_allclose(cp[0:300], pts[:300], rtol=2e-6)
        np.testing.assert_allclose(cp[300:900], pts[300:900], rtol=2e-6)
        np.testing.assert_allclose(cp[0:50], pts[:50], rtol=2e-6)  # restart
        with pytest.raises(ValueError, match="sequential"):
            cp[500:600]
        idx = np.arange(0, 1200, 37)
        np.testing.assert_allclose(cp[idx], pts[idx], rtol=2e-6)
        with pytest.raises(IndexError):
            cp[np.array([5, 1200])]
        with pytest.raises(IndexError, match="negative"):
            cp[-5:]


def test_csv_count_stream_matches_dense_count(native_lib, tmp_path):
    pts = np.random.default_rng(5).normal(size=(777, 4)).astype(np.float32)
    p = str(tmp_path / "cnt.csv")
    _write_csv(p, pts, blanks=True)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    assert native_lib.harp_csv_count_stream(
        p.encode(), ctypes.byref(rows), ctypes.byref(cols)) == 0
    assert (rows.value, cols.value) == (777, 4)
    assert native_lib.harp_count_rows(p.encode(), 2, ctypes.byref(rows),
                                      ctypes.byref(cols)) == 0
    assert (rows.value, cols.value) == (777, 4)


def test_gzip_text_parses_like_plain(native_lib, tmp_path):
    import gzip

    pts = np.random.default_rng(6).normal(size=(50, 3)).astype(np.float32)
    p = str(tmp_path / "g.csv")
    _write_csv(p, pts)
    with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
        g.write(f.read())
    np.testing.assert_allclose(DS.load_csv(p + ".gz"), DS.load_csv(p),
                               rtol=2e-6)
    with DS.CSVPoints(p + ".gz", chunk_rows=16) as cp:
        np.testing.assert_allclose(cp[0:50], pts, rtol=2e-6)


def test_parquet_is_not_ported_yet(tmp_path):
    p = str(tmp_path / "x.parquet")
    pathlib.Path(p).write_bytes(b"")
    for call in (lambda: DS.load_csv(p), lambda: DS.CSVPoints(p),
                 lambda: DS.FileSplits([p], 1, [0])):
        with pytest.raises(NotImplementedError, match="item 5"):
            call()


# ---- file placement and file splits ------------------------------------------

def _write_splits(tmp_path, pts, n_files, fmt="csv"):
    paths = []
    bounds = np.linspace(0, len(pts), n_files + 1).astype(int)
    for i in range(n_files):
        blk = pts[bounds[i]:bounds[i + 1]]
        p = tmp_path / f"split_{i}.{fmt}"
        if fmt == "npy":
            np.save(p, blk)
        else:
            np.savetxt(p, blk, fmt="%.6f", delimiter=",")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("workers", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("by_size", [True, False])
def test_multi_file_splits_match_reference(tmp_path, workers, by_size):
    pts = np.arange(200, dtype=np.float32).reshape(100, 2)
    paths = _write_splits(tmp_path, pts, 6)
    got = FF.multi_file_splits(paths, workers, by_size=by_size)
    assert got == JFF.multi_file_splits(paths, workers, by_size=by_size)
    assert sorted(p for s in got for p in s) == sorted(paths)


def test_list_files_and_single_file_splits(tmp_path):
    paths = _write_splits(tmp_path, np.ones((9, 2), np.float32), 3, "npy")
    assert FF.list_files(str(tmp_path)) == sorted(paths)
    assert FF.list_files(str(tmp_path / "*.npy")) == \
        JFF.list_files(str(tmp_path / "*.npy"))
    assert FF.single_file_splits(paths, 3) == [[p] for p in paths]
    with pytest.raises(ValueError, match="one file per worker"):
        FF.single_file_splits(paths, 2)
    with pytest.raises(ValueError, match="positive"):
        FF.multi_file_splits(paths, 0)


@pytest.mark.parametrize("fmt", ["csv", "npy"])
def test_filesplits_blocks_cover_every_row_once(tmp_path, fmt):
    pts = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    paths = _write_splits(tmp_path, pts, 4, fmt)
    fs = DS.FileSplits(paths, n_workers=3, local_workers=range(3),
                       chunk_rows=8)
    ref = JDS.FileSplits(paths, n_workers=3, local_workers=range(3),
                         chunk_rows=8)
    assert fs.cols == 3 and sum(fs.rows(w) for w in range(3)) == 23
    assert [fs.rows(w) for w in range(3)] == [ref.rows(w) for w in range(3)]
    seen = []
    for w in range(3):
        while True:
            blk = fs.next_block(w, 5)
            np.testing.assert_array_equal(blk, ref.next_block(w, 5))
            if blk.shape[0] == 0:
                break
            seen.append(blk)
    got = np.concatenate(seen, 0)
    np.testing.assert_array_equal(got[np.argsort(got[:, 0])], pts)
    fs.reset()
    assert fs.next_block(0, 2).shape[0] == min(2, fs.rows(0))
    np.testing.assert_array_equal(fs.amax(), np.abs(pts).max(0))
    s = fs.sample(6, rng=0)
    assert s.shape == (6, 3) and set(s[:, 0]) <= set(pts[:, 0])
    assert fs.dtype == np.float32
    fs.close()
    ref.close()


def test_filesplits_rejects_ragged_columns(tmp_path):
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    np.save(a, np.ones((4, 3), np.float32))
    np.save(b, np.ones((4, 2), np.float32))
    with pytest.raises(ValueError, match="column count"):
        DS.FileSplits([str(a), str(b)], 1, [0])
    with pytest.raises(ValueError, match="at least one"):
        DS.FileSplits([], 1, [0])
