"""Runnable beyond-HBM KMeans app — the port of the reference's
``examples/streaming_kmeans_app.py``: the 1B-point pattern, end to end.

Shows the streaming stack on a dataset the card never holds: a CSV
written to disk (the reference's text, byte for byte: a ``#`` header line,
then each value as ``f"{v:.9e}"``, at which f32 round-trips), streamed
through the native reader (:class:`harp_tpu_torch.native.datasource.
CSVPoints`), clustered by the blocked-epoch Lloyd (:func:`harp_tpu_torch.
models.kmeans_stream.fit_streaming`) with checkpoints every two epochs,
and checked against the resident :func:`harp_tpu_torch.models.kmeans.fit`
on the same points and seed: relative inertia difference below 1e-3.  The
north star swaps the toy shapes for ``--n 1000000000 --d 300 --k 1000``
and a real corpus.

The CSV and the checkpoints go to ``--workdir``, a directory every worker
sees; by default worker 0 makes a temporary one, hands its path to the
others over the verbs, and removes it at the end.

Run:  python -m harp_tpu_torch.examples.streaming_kmeans_app
          [--device cpu] [--n 20000] [--d 16] [--k 8] [--iters 6]
          [--chunk 4096] [--workdir DIR]

Without ``--device cpu`` it runs on this worker's card and raises where
there is none.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from harp_tpu_torch import WorkerMesh
from harp_tpu_torch.models import kmeans, kmeans_stream
from harp_tpu_torch.native.datasource import CSVPoints
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import is_master

#: bytes of a directory path handed from worker 0 to the others
_PATH_BYTES = 4096


def write_csv(path: str, pts: np.ndarray) -> None:
    """The reference app's dataset file: a ``#`` header line, then one row
    of comma-separated ``f"{v:.9e}"`` values a point."""
    with open(path, "w") as f:
        f.write("# synthetic blobs\n")
        for row in pts:
            f.write(",".join(f"{v:.9e}" for v in row) + "\n")


def blobs(n: int, d: int, k: int) -> np.ndarray:
    """The reference app's points: unit normals around k blob offsets."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, d))
            + rng.integers(0, k, size=(n, 1)) * 6).astype(np.float32)


def _shared_dir(mesh: WorkerMesh) -> str:
    """A temporary directory made by worker 0, its path on every worker."""
    path = tempfile.mkdtemp(prefix="harp_stream_app_") \
        if mesh.rank == 0 else ""
    if mesh.num_workers == 1:
        return path
    raw = np.zeros(_PATH_BYTES, np.uint8)
    enc = np.frombuffer(path.encode(), np.uint8)
    raw[:len(enc)] = enc
    raw = C.broadcast(torch.from_numpy(raw).to(mesh.device)).cpu().numpy()
    return raw.tobytes().rstrip(b"\0").decode()


def run(n: int = 20_000, d: int = 16, k: int = 8, iters: int = 6,
        chunk: int = 4096, *, mesh: WorkerMesh | None = None,
        workdir: str | None = None) -> dict:
    """Stream, fit, compare; returns the streamed history and both
    inertias.  Raises AssertionError where they part by 1e-3 or more."""
    mesh = mesh or WorkerMesh()
    if is_master():
        print(f"mesh: {mesh}")
    pts = blobs(n, d, k)
    own = workdir is None
    tmp = _shared_dir(mesh) if own else workdir
    try:
        # the "HDFS split" stand-in: the dataset lives on disk as text
        csv = os.path.join(tmp, "points.csv")
        if mesh.rank == 0:
            os.makedirs(tmp, exist_ok=True)
            write_csv(csv, pts)
        C.barrier()
        src = CSVPoints(csv, chunk_rows=chunk)
        if is_master():
            print(f"source: {src.shape[0]} rows x {src.shape[1]} cols "
                  f"(streamed, chunk={chunk})")
        c_stream, inertia, hist = kmeans_stream.fit_streaming(
            src, k=k, iters=iters, chunk_points=chunk, mesh=mesh, seed=1,
            return_history=True, ckpt_dir=os.path.join(tmp, "ckpt"),
            ckpt_every=2)
        src.close()
        hist = [float(h) for h in hist]
        if is_master():
            print("streamed inertia per epoch:",
                  [round(h, 1) for h in hist])
        # ground truth: the resident fit on the same data and init
        c_res, inertia_res = kmeans.fit(pts, k=k, iters=iters, mesh=mesh,
                                        seed=1)
        C.barrier()
    finally:
        if own and mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    rel = abs(inertia - inertia_res) / max(abs(inertia_res), 1e-9)
    if is_master():
        print(f"resident inertia {inertia_res:.1f} vs streamed "
              f"{inertia:.1f}  (rel diff {rel:.2e})")
    assert rel < 1e-3, "streamed != resident Lloyd"
    if is_master():
        print("OK: beyond-HBM streaming == device-resident KMeans")
    return {"workers": mesh.num_workers, "rows": n, "cols": d,
            "history": hist, "inertia_streamed": float(inertia),
            "inertia_resident": float(inertia_res), "rel_diff": rel,
            "centroids_streamed": c_stream, "centroids_resident": c_res}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--workdir", default=None,
                   help="a directory every worker sees, for the CSV and "
                        "the checkpoints (default: a temporary one)")
    args = p.parse_args(argv)
    out = run(args.n, args.d, args.k, args.iters, args.chunk,
              mesh=WorkerMesh(args.device), workdir=args.workdir)
    return {key: out[key] for key in ("workers", "rows", "cols", "history",
                                      "inertia_streamed",
                                      "inertia_resident", "rel_diff")}


if __name__ == "__main__":
    main()
