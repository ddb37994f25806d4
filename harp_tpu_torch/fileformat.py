"""Input formats — Harp L4 (``edu.iu.fileformat``), the port of
``harp_tpu.fileformat``.

Harp jobs use ``MultiFileInputFormat`` (each split is a list of whole
files, so every long-running worker gets its file list up front) and
``SingleFileInputFormat`` (each split exactly one whole file).  Workers
then read their own files; the input format only decides placement.  Here
placement stays on the host: whole files are dealt to workers, balanced by
byte size, and each worker reads only its own
(:class:`harp_tpu_torch.native.datasource.FileSplits`).

:func:`load_sharded_csv` and :func:`load_sharded_triples` read a
multi-file dataset into equal per-worker row shards (padded, with each
worker's real row count), the layout ``WorkerMesh.shard_array`` takes.

With telemetry on, the splitters and readers record per-worker bytes,
rows or nonzeros and the padding fraction on the skew ledger
(``skew.record_partition``); ``multi_file_splits`` records its files as
movable units, so a skew plan can move whole files
(``schedule.apply_rebalance``).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Sequence

import numpy as np


def _record_skew(phase: str, work, *, unit: str,
                 padded_total: int | None = None, units=None) -> None:
    """Ingest-side skew record: host arithmetic over what the splitter
    already built, a no-op while telemetry is off."""
    from harp_tpu_torch.utils import skew, telemetry

    if telemetry.enabled():
        skew.record_partition(phase, work, unit=unit,
                              padded_total=padded_total, units=units)


def list_files(pattern_or_dir: str) -> list[str]:
    """Expand a glob pattern or directory into a sorted file list."""
    if os.path.isdir(pattern_or_dir):
        names = [os.path.join(pattern_or_dir, n)
                 for n in sorted(os.listdir(pattern_or_dir))]
        return [p for p in names if os.path.isfile(p)]
    return sorted(_glob.glob(pattern_or_dir))


def multi_file_splits(paths: Sequence[str], num_workers: int,
                      by_size: bool = True) -> list[list[str]]:
    """Assign whole files to workers — ``MultiFileInputFormat`` splits.

    Greedy longest-processing-time balancing on file size (``by_size``),
    else round-robin by position.  Every worker appears in the result
    (possibly with an empty list, as in Harp when files < workers)."""
    if num_workers <= 0:
        raise ValueError("num_workers must be positive")
    splits: list[list[str]] = [[] for _ in range(num_workers)]
    if by_size:
        loads = [0] * num_workers
        sized = sorted(paths, key=lambda p: -os.path.getsize(p))
        for p in sized:
            w = loads.index(min(loads))
            splits[w].append(p)
            loads[w] += os.path.getsize(p)
        for s in splits:
            s.sort()  # deterministic per-worker order
    else:
        for i, p in enumerate(paths):
            splits[i % num_workers].append(p)
    from harp_tpu_torch.utils import telemetry

    if telemetry.enabled():
        # movable units = whole files, for a whole-file rebalance plan
        units = [[(p, os.path.getsize(p)) for p in s] for s in splits]
        _record_skew("fileformat.multi_file_splits",
                     [sum(sz for _, sz in u) for u in units],
                     unit="bytes", units=units)
    return splits


def single_file_splits(paths: Sequence[str],
                       num_workers: int) -> list[list[str]]:
    """One whole file per split — ``SingleFileInputFormat``.

    Requires ``len(paths) == num_workers`` (Harp launches one mapper per
    file; here the worker count is fixed by the group, so they must
    agree)."""
    if len(paths) != num_workers:
        raise ValueError(
            f"SingleFileInputFormat needs exactly one file per worker: "
            f"{len(paths)} files vs {num_workers} workers")
    return [[p] for p in paths]


def _pad_rows(a: np.ndarray, n_rows: int) -> np.ndarray:
    if a.shape[0] == n_rows:
        return a
    pad = np.zeros((n_rows - a.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad], axis=0)


def _paths(pattern_or_paths) -> list[str]:
    paths = (list_files(pattern_or_paths) if isinstance(pattern_or_paths, str)
             else list(pattern_or_paths))
    if not paths:
        raise FileNotFoundError(f"no input files match {pattern_or_paths!r}")
    return paths


def load_sharded_csv(pattern_or_paths, num_workers: int,
                     loader: Callable[[str], np.ndarray] | None = None,
                     pad_value: float = 0.0):
    """Read a multi-file dense dataset into equal per-worker row shards.

    Returns ``(stacked, row_counts)``: ``stacked`` is ``[num_workers *
    rows_pad, cols]``, ready for ``WorkerMesh.shard_array``, and
    ``row_counts[w]`` the number of real rows in worker *w*'s shard (the
    rest is ``pad_value``).  ``loader`` reads one file (default: the native
    CSV reader, :func:`harp_tpu_torch.native.datasource.load_csv`); the
    files are read through the ingest pipeline, two at a time, in
    submission order, so the result is the serial loop's."""
    from harp_tpu_torch.ingest import IngestPipeline
    from harp_tpu_torch.utils import flightrec

    if loader is None:
        from harp_tpu_torch.native.datasource import load_csv as loader
    splits = multi_file_splits(_paths(pattern_or_paths), num_workers)
    flat = [(w, p) for w, files in enumerate(splits) for p in files]
    loaded: list = [None] * len(flat)
    if flat:
        # reading builds nothing on the card
        with IngestPipeline(lambda j: loader(flat[j][1]), depth=4,
                            read_threads=2,
                            tag="fileformat.load_sharded_csv") as pipe, \
                flightrec.budget(compiles=0, action="warn",
                                 tag="fileformat.load_sharded_csv"):
            for j, arr in enumerate(pipe.stream(len(flat))):
                loaded[j] = arr
    shards: list = []
    cols = None
    for w in range(len(splits)):
        parts = [loaded[j] for j, (fw, _) in enumerate(flat) if fw == w]
        if parts:
            shard = np.concatenate(parts, axis=0)
            cols = shard.shape[1] if cols is None else cols
        else:
            shard = None
        shards.append(shard)
    if cols is None:
        raise ValueError("all splits empty")
    shards = [s if s is not None else np.zeros((0, cols), np.float32)
              for s in shards]
    counts = np.asarray([s.shape[0] for s in shards], np.int64)
    rows_pad = int(counts.max())
    _record_skew("fileformat.load_sharded_csv", counts, unit="rows",
                 padded_total=num_workers * rows_pad)
    stacked = np.concatenate([_pad_rows(s, rows_pad) for s in shards], axis=0)
    if pad_value != 0.0:
        for w, c in enumerate(counts):
            stacked[w * rows_pad + c: (w + 1) * rows_pad] = pad_value
    return stacked, counts


def load_sharded_triples(pattern_or_paths, num_workers: int):
    """Read multi-file ``u i v`` triple data into equal per-worker shards.

    Returns ``((u, i, v), counts)``, each array ``[num_workers *
    nnz_pad]``; a padding entry has ``u = i = -1`` and ``v = 0``, so the
    rating and token partitioners can mask it."""
    from harp_tpu_torch.native.datasource import load_triples

    splits = multi_file_splits(_paths(pattern_or_paths), num_workers)
    per_worker: list = []
    for files in splits:
        if files:
            loaded = [load_triples(p) for p in files]
            u = np.concatenate([t[0] for t in loaded])
            i = np.concatenate([t[1] for t in loaded])
            v = np.concatenate([t[2] for t in loaded])
        else:
            u = np.zeros(0, np.int32)
            i = np.zeros(0, np.int32)
            v = np.zeros(0, np.float32)
        per_worker.append((u, i, v))
    counts = np.asarray([len(t[0]) for t in per_worker], np.int64)
    nnz_pad = int(counts.max())
    if nnz_pad == 0:
        raise ValueError("all splits empty")
    _record_skew("fileformat.load_sharded_triples", counts,
                 unit="nonzeros", padded_total=num_workers * nnz_pad)

    def pad1(a, fill):
        out = np.full(nnz_pad, fill, a.dtype)
        out[: len(a)] = a
        return out

    u = np.concatenate([pad1(t[0], -1) for t in per_worker])
    i = np.concatenate([pad1(t[1], -1) for t in per_worker])
    v = np.concatenate([pad1(t[2], 0) for t in per_worker])
    return (u, i, v), counts
