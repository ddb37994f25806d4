"""Input formats — Harp L4 (``edu.iu.fileformat``): the part of
``harp_tpu.fileformat`` that streaming KMeans reads.

Harp jobs use ``MultiFileInputFormat`` (each split is a list of whole
files, so every long-running worker gets its file list up front) and
``SingleFileInputFormat`` (each split exactly one whole file).  Workers
then read their own files; the input format only decides placement.  Here
placement stays on the host: whole files are dealt to workers, balanced by
byte size, and each worker reads only its own
(:class:`harp_tpu_torch.native.datasource.FileSplits`).

Not ported yet: ``load_sharded_csv``/``load_sharded_triples`` (ROADMAP.md,
Queue 1, item 5) and the ingest skew record of ``multi_file_splits``
(item 8).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Sequence


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
