"""The port's real-data readers against harp_tpu.native.datasource on the
same files: libsvm (0- and 1-based, gzip), rating triples (with and
without ratings), CSV and triple globs, ``csr_to_ell`` and Parquet.

Both of the port's paths (the native C++ parser and the Python parse) give
arrays ``np.array_equal`` to the reference's: every reader here is exact.
The error cases are the reference's.  One spawned 4-worker gloo world
streams a mixed split directory (CSV, Parquet, npy), each worker its own
files, and its blocks equal the reference's ``FileSplits`` for the same
worker.
"""

import gzip

import numpy as np
import pytest

from harp_tpu.native import datasource as JDS
from harp_tpu_torch.native import build as B
from harp_tpu_torch.native import datasource as DS
from torch_world import WORLD, run_datasource_cases, run_world



def _arrow():
    """(pyarrow, pyarrow.parquet), or skip: only the Parquet cases need
    them."""
    return (pytest.importorskip("pyarrow"),
            pytest.importorskip("pyarrow.parquet"))


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    """Each test runs on the native parser and on the Python parse."""
    if request.param == "native":
        if B.load_native() is None:
            pytest.skip("no g++ here")
    else:
        monkeypatch.setattr(DS, "load_native", lambda: None)
    return request.param


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def _libsvm_text(seed=0, n=60, d=30, zero_based=False):
    rng = np.random.default_rng(seed)
    lines = ["# a header comment"]
    for r in range(n):
        cols = np.sort(rng.choice(d, size=rng.integers(0, 6), replace=False))
        off = 0 if zero_based else 1
        pairs = " ".join(f"{c + off}:{rng.normal():.6g}" for c in cols)
        lab = int(rng.choice([-1, 1]))
        lines.append(f"{lab} {pairs}".rstrip() + (" # tail" if r % 7 == 0
                                                  else ""))
        if r % 11 == 0:
            lines.append("")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("zero_based", [False, True])
def test_libsvm_matches_reference(tmp_path, path_kind, zero_based):
    p = tmp_path / "d.svm"
    p.write_text(_libsvm_text(zero_based=zero_based))
    want = JDS.load_libsvm(str(p), zero_based=zero_based)
    for threads in (1, 3):
        _equal(DS.load_libsvm(str(p), n_threads=threads,
                              zero_based=zero_based), want)


def test_libsvm_gzip_and_malformed_lines(tmp_path, path_kind):
    text = ("1 3:\n5 1:2.0\nheader junk:line\n-1 abc:1 2:7.0\n"
            "3:1.5\n1 foo#bar 2:9.0\n1x 2:4.0\n" + _libsvm_text(1))
    p = tmp_path / "m.svm"
    p.write_text(text)
    with gzip.open(str(p) + ".gz", "wt") as g:
        g.write(text)
    want = JDS.load_libsvm(str(p))
    _equal(DS.load_libsvm(str(p)), want)
    _equal(DS.load_libsvm(str(p) + ".gz"), want)


def test_libsvm_zero_based_file_without_the_flag_raises(tmp_path, path_kind):
    p = tmp_path / "z.svm"
    p.write_text("1 0:2.0 3:4.0\n")
    with pytest.raises(ValueError, match="zero_based"):
        DS.load_libsvm(str(p))
    _equal(DS.load_libsvm(str(p), zero_based=True),
           JDS.load_libsvm(str(p), zero_based=True))


@pytest.mark.parametrize("ratings", [True, False])
def test_triples_match_reference(tmp_path, path_kind, ratings):
    rng = np.random.default_rng(2)
    u, i = rng.integers(0, 50, 200), rng.integers(0, 40, 200)
    v = rng.normal(size=200)
    p = tmp_path / "t.txt"
    with open(p, "w") as f:
        f.write("# user item rating\n")
        for a, b, c in zip(u, i, v):
            f.write(f"{a} {b} {c:.5f}\n" if ratings else f"{a},{b}\n")
    _equal(DS.load_triples(str(p)), JDS.load_triples(str(p)))
    with open(p, "rb") as src, gzip.open(str(p) + ".gz", "wb") as g:
        g.write(src.read())
    _equal(DS.load_triples(str(p) + ".gz"), JDS.load_triples(str(p)))
    got = DS.load_triples_glob(str(tmp_path / "t.txt"))
    _equal(got, JDS.load_triples_glob(str(tmp_path / "t.txt")))
    assert got[3] is ratings


def test_globs_match_reference_and_raise_as_it_does(tmp_path, path_kind):
    rng = np.random.default_rng(3)
    parts = [rng.normal(size=(n, 4)).astype(np.float32) for n in (7, 0, 5)]
    for j, a in enumerate(parts):  # an empty shard is skipped
        np.savetxt(tmp_path / f"x{j}.csv", a, delimiter=",", fmt="%.7e")
    pat = str(tmp_path / "x*.csv")
    _equal([DS.load_csv_glob(pat)], [JDS.load_csv_glob(pat)])
    _equal([DS.load_csv_glob(str(tmp_path))], [JDS.load_csv_glob(pat)])
    for fn in (DS.load_csv_glob, DS.load_triples_glob):
        with pytest.raises(ValueError, match="no input files"):
            fn(str(tmp_path / "none*"))
    (tmp_path / "e").mkdir()
    (tmp_path / "e" / "a.csv").write_text("# nothing\n")
    with pytest.raises(ValueError, match="contain no rows"):
        DS.load_csv_glob(str(tmp_path / "e"))
    (tmp_path / "r").mkdir()
    (tmp_path / "r" / "a.txt").write_text("1 2 3.0\n4 5\n")
    with pytest.raises(ValueError, match="column count"):
        DS.load_triples_glob(str(tmp_path / "r"))
    with pytest.raises(ValueError, match="column count"):
        JDS.load_triples_glob(str(tmp_path / "r"))


@pytest.mark.parametrize("width", [None, 2, 9])
def test_csr_to_ell_matches_reference(tmp_path, width):
    labels, indptr, indices, values, _ = JDS.load_libsvm(
        _write(tmp_path / "c.svm", _libsvm_text(4)))
    _equal(DS.csr_to_ell(indptr, indices, values, width),
           JDS.csr_to_ell(indptr, indices, values, width))


def _write(path, text):
    path.write_text(text)
    return str(path)


def _parquet(path, arr, names=None):
    pa, pq = _arrow()
    names = names or [f"c{j}" for j in range(arr.shape[1])]
    pq.write_table(pa.table({n: arr[:, j] for j, n in enumerate(names)}),
                   str(path), row_group_size=100)
    return str(path)


def test_parquet_points_chunks_match_reference(tmp_path):
    pts = np.random.default_rng(5).normal(size=(700, 3)).astype(np.float32)
    p = _parquet(tmp_path / "p.parquet", pts)
    with DS.ParquetPoints(p, chunk_rows=128) as a, \
            JDS.ParquetPoints(p, chunk_rows=128) as b:
        assert a.shape == b.shape == (700, 3)
        for lo, hi in ((0, 300), (300, 650), (650, 700), (0, 10)):
            np.testing.assert_array_equal(a[lo:hi], b[lo:hi])
        idx = np.arange(0, 700, 37)
        np.testing.assert_array_equal(a[idx], b[idx])
        with pytest.raises(ValueError, match="sequential"):
            a[500:600]
    pa, pq = _arrow()
    bad = str(tmp_path / "bad.parquet")
    pq.write_table(pa.table({"x": [1.0, 2.0], "name": ["a", "b"]}), bad)
    with pytest.raises(ValueError, match="non-numeric"):
        DS.ParquetPoints(bad)


def test_parquet_triples_and_dense(tmp_path):
    rng = np.random.default_rng(6)
    t3 = np.stack([rng.integers(0, 9, 50), rng.integers(0, 7, 50),
                   rng.normal(size=50)], 1)
    p3 = _parquet(tmp_path / "t3.parquet", t3)
    p2 = _parquet(tmp_path / "t2.parquet", t3[:, :2].astype(np.int64))
    for p in (p3, p2):
        _equal(DS.load_triples(p), JDS.load_triples(p))
        _equal(DS.load_csv(p)[None], JDS.load_csv(p)[None])
    _equal(DS.load_triples_glob(p3), JDS.load_triples_glob(p3))
    p4 = _parquet(tmp_path / "t4.parquet", np.ones((3, 4)))
    with pytest.raises(ValueError, match="2 or 3 columns"):
        DS.load_triples(p4)


def test_missing_pyarrow_names_it(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name.startswith("pyarrow"):
            raise ImportError("no pyarrow here")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    for call in (lambda: DS.ParquetPoints("x.parquet"),
                 lambda: DS.load_csv("x.parquet"),
                 lambda: DS.load_triples("x.pq")):
        with pytest.raises(ImportError, match="pyarrow"):
            call()


def test_stream_cli_reads_parquet_as_the_npy(tmp_path, capsys):
    """kmeans-stream --input takes .parquet; the same rows as .npy give
    the same inertia."""
    import json

    from harp_tpu_torch.models import kmeans_stream as KS

    pts = np.random.default_rng(7).normal(size=(600, 5)).astype(np.float32)
    p = _parquet(tmp_path / "s.parquet", pts)
    np.save(tmp_path / "s.npy", pts)
    rows = []
    for src in (p, str(tmp_path / "s.npy")):
        KS.main(["--input", src, "--k", "4", "--iters", "2", "--chunk",
                 "256", "--device", "cpu"])
        rows.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert rows[0]["inertia"] == rows[1]["inertia"]
    assert rows[0]["n"] == 600 and rows[0]["d"] == 5


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("splits")
    rng = np.random.default_rng(8)
    paths = []
    for j, n in enumerate((130, 90, 170, 60, 110)):
        a = rng.normal(size=(n, 4)).astype(np.float32)
        if j % 3 == 0:
            paths.append(_parquet(d / f"s{j}.parquet", a))
        elif j % 3 == 1:
            np.save(d / f"s{j}.npy", a)
            paths.append(str(d / f"s{j}.npy"))
        else:
            np.savetxt(d / f"s{j}.csv", a, delimiter=",", fmt="%.9e")
            paths.append(str(d / f"s{j}.csv"))
    return sorted(paths)


def test_four_workers_stream_their_own_splits(tmp_path, split_dir):
    got = run_world(run_datasource_cases, tmp_path, split_dir)
    total = 0
    for r, w in enumerate(got):
        with JDS.FileSplits(split_dir, WORLD, [r], chunk_rows=64) as fs:
            want = fs.next_block(r, 10_000)
            assert w["rows"] == fs.rows(r)
            np.testing.assert_array_equal(w["amax"], fs.amax())
        np.testing.assert_array_equal(w["block"], want)
        total += w["rows"]
        assert not w["_jax_imported"]
    assert total == 560
