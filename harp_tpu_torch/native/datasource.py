"""Data sources for the streaming apps: the port of the parts of
``harp_tpu.native.datasource`` that streaming KMeans reads.

``load_csv`` parses with the port's multi-threaded C++ loader
(:mod:`harp_tpu_torch.native.build`) where ``g++`` exists, else with numpy
(host parsing, the same semantics either way).  :class:`CSVStream`,
:class:`FileSplits`, :class:`SequentialPoints` and :class:`CSVPoints` are
the beyond-RAM sources of ``models.kmeans_stream``.

Not ported yet (ROADMAP.md, Queue 1, item 5): ``load_libsvm``,
``load_triples*``, ``csr_to_ell`` and the Parquet sources; a ``.parquet``
input raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from harp_tpu_torch.native.build import load_native


def _is_gz(path: str) -> bool:
    return path.endswith(".gz")


def _open_text(path: str):
    """Text handle for plain or gzip-compressed files — HDFS-style text
    splits are routinely .gz; the native C++ parser reads plain bytes
    only, so gz inputs take the Python parse path (same semantics)."""
    if _is_gz(path):
        import gzip

        return gzip.open(path, "rt")
    return open(path)


def _reject_parquet(path: str) -> None:
    if path.endswith((".parquet", ".pq")):
        raise NotImplementedError(
            f"{path}: Parquet sources are not ported yet (ROADMAP.md, "
            "Queue 1, item 5)")


def _loadtxt_any_sep(path: str) -> np.ndarray:
    """numpy fallback accepting comma OR whitespace separators, matching the
    native parser's behavior so results don't depend on g++ availability."""
    with _open_text(path) as f:
        text = f.read().replace(",", " ")
    import io
    import warnings

    with warnings.catch_warnings():
        # empty shards are legitimate input (skipped by the glob loaders)
        warnings.filterwarnings("ignore", message=".*input contained no data.*")
        return np.loadtxt(io.StringIO(text), dtype=np.float64, ndmin=2)


def load_csv(path: str, n_threads: int = 0) -> np.ndarray:
    """Dense CSV/whitespace numeric file → float32 [rows, cols]."""
    _reject_parquet(path)
    n_threads = n_threads or (os.cpu_count() or 1)
    lib = None if _is_gz(path) else load_native()
    if lib is None:
        return _loadtxt_any_sep(path).astype(np.float32)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.harp_count_rows(path.encode(), n_threads,
                             ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"native loader failed to read {path!r} (rc={rc})")
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.harp_load_csv_f32(
        path.encode(), n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, cols.value)
    if rc != 0:
        raise OSError(f"native loader failed to parse {path!r} (rc={rc})")
    return out



# ---------------------------------------------------------------------------
# Streaming CSV — beyond-RAM text corpora for the blocked-epoch apps.
# ---------------------------------------------------------------------------


class CSVStream:
    """Iterate [≤chunk_rows, cols] float32 blocks of a CSV/whitespace file.

    Native path: the C++ reader parses the NEXT chunk on a background
    thread while the caller consumes the current one (double-buffered —
    disk+parse overlaps device compute); memory is bounded by two parsed
    slots regardless of file size.  Python fallback parses line blocks
    with the same separator/comment semantics.  Use as an iterator or a
    context manager; ``cols`` blocks until the first block is parsed.
    """

    def __init__(self, path: str, chunk_rows: int = 65_536):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.path, self.chunk_rows = path, chunk_rows
        # .gz takes the Python parse path: the native reader consumes
        # plain bytes (see _open_text)
        self._lib = None if _is_gz(path) else load_native()
        self._h = None
        self._f = None
        if self._lib is not None:
            h = self._lib.harp_csv_stream_open(path.encode(), chunk_rows)
            if not h:
                raise OSError(f"native stream failed to open {path!r}")
            self._h = h
            self._cols = int(self._lib.harp_csv_stream_cols(h))
            if self._cols < 0:
                raise OSError(f"native stream failed to read {path!r}")
        else:
            self._f = _open_text(path)
            self._cols = None  # discovered on first block
            self._py_buf: list = []

    @property
    def cols(self) -> int:
        # loop: the first chunk_rows lines can be all comments/blanks —
        # matching the native reader, which scans until a data line or EOF
        while self._cols is None:
            if not self._py_fill():
                return 0
        return self._cols

    def _py_fill(self):
        """Fallback: read chunk_rows raw lines, parse non-blank ones.

        Matches the NATIVE parser's semantics, not np.loadtxt's: comments
        stripped at '#', cols fixed by the first data line, short rows
        zero-padded, extra trailing columns ignored, unparseable tokens
        read as 0.0 — so behavior never depends on g++ availability.
        """
        lines = []
        for line in self._f:
            lines.append(line)
            if len(lines) >= self.chunk_rows:
                break
        rows = []
        for line in lines:
            body = line.split("#", 1)[0].replace(",", " ").split()
            if not body:
                continue
            if self._cols is None:
                self._cols = len(body)
            vals = []
            for tok in body[: self._cols]:
                try:
                    vals.append(float(tok))
                except ValueError:
                    vals.append(0.0)
            vals += [0.0] * (self._cols - len(vals))
            rows.append(vals)
        arr = (np.asarray(rows, np.float32) if rows
               else np.zeros((0, self._cols or 0), np.float32))
        self._py_buf = [arr] if arr.size else []
        return bool(lines)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is not None:
            buf = np.empty((self.chunk_rows, self._cols), np.float32)
            rows = int(self._lib.harp_csv_stream_next(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.chunk_rows))
            if rows < 0:
                raise OSError(f"native stream error reading {self.path!r}")
            if rows == 0:
                raise StopIteration
            return buf[:rows]
        while True:
            if self._py_buf:
                return self._py_buf.pop()
            if not self._py_fill():
                raise StopIteration
            if not self._py_buf:   # block of blanks/comments: keep reading
                continue

    def close(self):
        if self._h is not None:
            self._lib.harp_csv_stream_close(self._h)
            self._h = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # belt-and-braces; close() is the real API
        try:
            self.close()
        except Exception:
            pass


class FileSplits:
    """Size-balanced file→worker assignment with per-worker sequential
    block reads — Harp's input shape (SURVEY.md §3.1 L4 input formats /
    §4.2 "load points shard"): the dataset is a DIRECTORY of splits and
    each worker streams only its own files, never the whole set.

    ``paths`` (already-resolved list; sort for a deterministic
    assignment) are dealt to workers by
    :func:`harp_tpu_torch.fileformat.multi_file_splits` — greedy size-balanced
    by default (``by_size``), Harp's ``MultiFileInputFormat`` rule — and
    only ``local_workers`` — the workers this process serves — are
    opened, so a multi-host job touches each file exactly once across
    the fleet.  ``.npy`` files open as memmaps; anything else
    through :class:`CSVPoints` (native streaming parser, bounded memory;
    a ``.parquet``/``.pq`` file raises, not ported yet).  All files must agree on the column count.

    Per worker: ``rows(w)`` (total), ``next_block(w, count)`` (the next
    ≤count rows, crossing file boundaries), and :meth:`reset` rewinds
    every stream for the next epoch.  ``head(count)`` serves seeding
    (rows from this process's files in worker order) and resets after.
    """

    def __init__(self, paths, n_workers: int, local_workers,
                 chunk_rows: int = 65_536, by_size: bool = True):
        from harp_tpu_torch.fileformat import multi_file_splits

        if not paths:
            raise ValueError("FileSplits needs at least one input file")
        self.paths = list(paths)
        self.n_workers = n_workers
        self.local_workers = list(local_workers)
        self._chunk_rows = chunk_rows
        assign = multi_file_splits(self.paths, n_workers, by_size=by_size)
        self._srcs: dict[int, list] = {}
        cols = {}
        for w in self.local_workers:
            srcs = []
            for p in assign[w]:
                if p.endswith(".npy"):
                    s = np.load(p, mmap_mode="r")
                else:
                    s = CSVPoints(p, chunk_rows)
                if len(s.shape) != 2:
                    raise ValueError(f"{p}: expected 2-D rows, got shape "
                                     f"{s.shape}")
                srcs.append(s)
                cols[int(s.shape[1])] = p
            self._srcs[w] = srcs
        if len(cols) > 1:
            raise ValueError(
                f"input files disagree on column count {sorted(cols)} "
                f"(e.g. {list(cols.values())[:2]}) — a ragged mix would "
                "silently misalign features")
        self.cols = next(iter(cols)) if cols else 0
        self._pos = {w: [0, 0] for w in self.local_workers}  # [src, row]

    @property
    def dtype(self):
        """Common source dtype of this process's files, or None when they
        mix (or it owns none) — feeds the streaming wire-dtype choice
        (kmeans_stream._resolve_wire_dtype): a uniform f16 file set may
        ship f16 over H2D; a mixed set must not.  CSV sources parse to
        float32 and count as such."""
        names = {np.dtype(getattr(s, "dtype", np.float32)).name
                 for srcs in self._srcs.values() for s in srcs}
        return np.dtype(next(iter(names))) if len(names) == 1 else None

    def rows(self, w: int) -> int:
        return int(sum(s.shape[0] for s in self._srcs[w]))

    def reset(self) -> None:
        self._pos = {w: [0, 0] for w in self.local_workers}

    def next_block(self, w: int, count: int) -> np.ndarray:
        out = []
        si, off = self._pos[w]
        srcs = self._srcs[w]
        need = count
        while need > 0 and si < len(srcs):
            s = srcs[si]
            take = min(need, int(s.shape[0]) - off)
            if take > 0:
                out.append(np.asarray(s[off:off + take], np.float32))
                off += take
                need -= take
            if off >= s.shape[0]:
                si += 1
                off = 0
        self._pos[w] = [si, off]
        return (np.concatenate(out, 0) if out
                else np.zeros((0, self.cols), np.float32))

    def head(self, count: int) -> np.ndarray:
        """First ``count`` rows across this process's workers (worker
        order) — for shape probing; rewinds all streams afterwards."""
        self.reset()
        out = []
        need = count
        for w in self.local_workers:
            if need <= 0:
                break
            blk = self.next_block(w, need)
            out.append(blk)
            need -= blk.shape[0]
        self.reset()
        return (np.concatenate(out, 0) if out
                else np.zeros((0, self.cols), np.float32))

    def sample(self, count: int, rng=0) -> np.ndarray:
        """Up to ``count`` rows drawn RANDOMLY (without replacement per
        file) across this process's files — centroid seeding that does
        not collapse on sorted/cluster-grouped inputs the way a
        first-rows head() would.  The draw spreads an even quota over
        files (capped by file size; approximately, not exactly,
        row-uniform), via sorted index gathers (memmap fancy-index; text
        sources run one dedicated streaming pass).  Stream cursors are
        untouched.  ``rng``: seed or ``np.random.Generator``."""
        rng = (rng if isinstance(rng, np.random.Generator)
               else np.random.default_rng(rng))
        flat = [(w, i, int(s.shape[0]))
                for w in self.local_workers
                for i, s in enumerate(self._srcs[w])]
        total = sum(z for _, _, z in flat)
        remaining = min(count, total)
        out = []
        for j, (w, i, z) in enumerate(flat):
            if remaining <= 0:
                break
            quota = min(z, -(-remaining // (len(flat) - j)))
            idx = np.sort(rng.choice(z, size=quota, replace=False))
            out.append(np.asarray(self._srcs[w][i][idx], np.float32))
            remaining -= quota
        return (np.concatenate(out, 0) if out
                else np.zeros((0, self.cols), np.float32))

    def amax(self) -> np.ndarray:
        """Per-feature |max| over ALL of this process's files (one
        streaming pass in ``chunk_rows`` blocks; rewinds afterwards) —
        the local half of the int8 scale reduction."""
        out = np.zeros(self.cols, np.float32)
        self.reset()
        for w in self.local_workers:
            while True:
                blk = self.next_block(w, self._chunk_rows)
                if blk.shape[0] == 0:
                    break
                np.maximum(out, np.abs(blk).max(0), out=out)
        self.reset()
        return out

    def close(self) -> None:
        for srcs in self._srcs.values():
            for s in srcs:
                if hasattr(s, "close"):
                    s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SequentialPoints:
    """Shared engine of the ``points`` source contract of
    :func:`harp_tpu_torch.models.kmeans_stream.fit_streaming` — a file viewed
    as a 2-D array that only supports the access pattern the streaming
    apps use:

    ``points[lo:hi]`` with ascending, contiguous ``lo`` that restarts at
    0 each epoch (each restart reopens the underlying stream), plus
    ``points[sorted_index_array]`` row gathers (one dedicated streaming
    pass — used by centroid init).  Anything else raises, loudly.

    Subclasses set ``self.shape`` in ``__init__`` and implement
    ``_open_stream() -> iterator of [n, cols] float32 blocks`` (with an
    optional ``close()``); everything else — position bookkeeping,
    skip-forward, the gather pass — lives here once
    (:class:`CSVPoints`).
    """

    shape: tuple
    chunk_rows: int

    def _open_stream(self):
        raise NotImplementedError

    def _init_cursor(self):
        self._stream = None
        self._pos = 0
        self._pending: np.ndarray | None = None  # rows read but not consumed

    def __len__(self):
        return self.shape[0]

    def _restart(self):
        if self._stream is not None and hasattr(self._stream, "close"):
            self._stream.close()
        self._stream = self._open_stream()
        self._pos = 0
        self._pending = None

    def _read(self, count: int, keep: bool = True) -> np.ndarray:
        """Consume ``count`` rows; ``keep=False`` drains them in O(chunk)
        memory (the skip-forward path must not materialize the prefix)."""
        parts: list = []
        need = count
        while need > 0:
            if self._pending is not None and len(self._pending):
                take = self._pending[:need]
                self._pending = self._pending[need:]
                if keep:
                    parts.append(take)
                need -= len(take)
                continue
            try:
                self._pending = next(self._stream)
            except StopIteration:
                break
        self._pos += count - need
        return np.concatenate(parts, 0) if parts else \
            np.zeros((0, self.shape[1]), np.float32)

    def __getitem__(self, key):
        name = type(self).__name__
        if isinstance(key, slice):
            lo = key.start or 0
            hi = self.shape[0] if key.stop is None else key.stop
            if key.step not in (None, 1):
                raise ValueError(f"{name} slices must be contiguous")
            if lo < 0 or hi < 0:
                raise IndexError(
                    f"{name} does not support negative slice bounds "
                    f"(got {lo}:{hi})")
            hi = min(hi, self.shape[0])
            if lo == 0 or self._stream is None:
                self._restart()
                if lo:
                    self._read(lo, keep=False)  # skip forward (init paths)
            elif lo != self._pos:
                raise ValueError(
                    f"{name} is sequential: asked for rows {lo}:{hi} at "
                    f"position {self._pos} (slices must ascend contiguously "
                    "and restart at 0)")
            return self._read(hi - lo)
        idx = np.asarray(key)
        if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
            raise TypeError(f"{name} supports slices or 1-D integer "
                            "index arrays")
        if len(idx) and (np.diff(idx) < 0).any():
            raise ValueError(f"{name} index arrays must be sorted")
        if len(idx) and int(idx[0]) < 0:
            raise IndexError(f"{name} does not support negative indices "
                             f"(got {int(idx[0])})")
        out = np.empty((len(idx), self.shape[1]), np.float32)
        st = self._open_stream()
        try:
            base, j = 0, 0
            for blk in st:
                hi = base + blk.shape[0]
                while j < len(idx) and idx[j] < hi:
                    out[j] = blk[idx[j] - base]
                    j += 1
                base = hi
                if j >= len(idx):
                    break
        finally:
            if hasattr(st, "close"):
                st.close()
        if j < len(idx):
            raise IndexError(f"index {int(idx[j])} out of range "
                             f"({self.shape[0]} rows)")
        return out

    def close(self):
        if self._stream is not None:
            if hasattr(self._stream, "close"):
                self._stream.close()
            self._stream = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CSVPoints(SequentialPoints):
    """:class:`SequentialPoints` over a CSV/whitespace text file — text
    corpora too large for RAM stream through the native parser
    (:class:`CSVStream`); ``shape`` comes from the native bounded-memory
    row-count pass."""

    def __init__(self, path: str, chunk_rows: int = 65_536):
        _reject_parquet(path)
        self.path, self.chunk_rows = path, chunk_rows
        lib = None if _is_gz(path) else load_native()
        if lib is not None:
            # streaming count (bounded memory) — harp_count_rows reads the
            # whole file into RAM, which this class exists to avoid
            rows = ctypes.c_int64()
            cols = ctypes.c_int64()
            rc = lib.harp_csv_count_stream(path.encode(),
                                           ctypes.byref(rows),
                                           ctypes.byref(cols))
            if rc != 0:
                raise OSError(f"native loader failed to read {path!r}")
            self.shape = (int(rows.value), int(cols.value))
        else:
            n, c = 0, 0
            with CSVStream(path, chunk_rows) as st:
                for blk in st:
                    n += blk.shape[0]
                    c = blk.shape[1]
            self.shape = (n, c)
        self._init_cursor()

    def _open_stream(self):
        return CSVStream(self.path, self.chunk_rows)


