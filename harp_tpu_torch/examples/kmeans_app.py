"""Runnable Harp-style KMeans app — the port of the reference's
``examples/kmeans_app.py`` (the ``MIGRATING.md`` side-by-side, complete).

Shows the ``CollectiveApp`` / ``mapCollective`` programming model (Harp
L4) on synthetic data, with the reference's own step: squared distances,
a one-hot argmin (the lowest index on ties), ``one_hot.T @ points``, one
``allreduce`` of the sums and counts, and the new centroids.  It runs no
kernel of the port's: the production path, with K1/K2, is
:mod:`harp_tpu_torch.models.kmeans`.  Each worker (process) holds its
block of the points; with no process group it is one worker holding all
of them.

Run:  python -m harp_tpu_torch.examples.kmeans_app [--device cpu]
          [--n 4096] [--d 16] [--k 8] [--iters 10]

Without ``--device cpu`` it runs on this worker's card and raises where
there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from harp_tpu_torch import CollectiveApp, Combiner, WorkerMesh, run_app
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import is_master

#: elements of the [rows, k, d] difference tensor a block of rows may take
#: (256 MiB of f32): at wider shapes the distances go in row blocks
BLOCK_ELEMENTS = 1 << 26


def assign(pts: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid (the lowest index on ties), from the
    reference's ``((pts[:, None] - cents[None]) ** 2).sum(-1)``, taken in
    blocks of rows so that ``[rows, k, d]`` fits; a row's distances do not
    depend on the block."""
    k, d = cents.shape
    rows = max(1, BLOCK_ELEMENTS // max(k * d, 1))
    return torch.cat([((x[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
                      for x in pts.split(rows)])


def step(pts: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration of the reference's app on this worker's
    points: the new centroids, the same on every worker."""
    one_hot = torch.nn.functional.one_hot(
        assign(pts, cents), cents.shape[0]).to(pts.dtype)
    sums = one_hot.T @ pts
    counts = one_hot.sum(0)
    sums, counts = C.allreduce((sums, counts), Combiner.ADD)
    return sums / counts[:, None].clamp_min(1.0)


class KMeansApp(CollectiveApp):
    """``config``: a dict with ``n``, ``d``, ``k`` and ``iters``."""

    def load_shard(self):
        c = self.config
        rng = np.random.default_rng(0)
        n = c["n"] // self.num_workers * self.num_workers
        pts = rng.normal(size=(n, c["d"])).astype(np.float32)
        return self.mesh.shard_array(pts, 0), pts

    def map_collective(self) -> np.ndarray:
        pts, pts_host = self.load_shard()
        cents = self.mesh.replicated(pts_host[:self.config["k"]])
        for i in range(self.config["iters"]):
            cents = step(pts, cents)
            self.metrics.log(step=i)
        return cents.cpu().numpy()


def run(n: int = 4096, d: int = 16, k: int = 8, iters: int = 10, *,
        mesh: WorkerMesh | None = None) -> np.ndarray:
    """The app's centroids [k, d] after ``iters`` iterations."""
    return run_app(KMeansApp, config={"n": n, "d": d, "k": k,
                                      "iters": iters},
                   mesh=mesh or WorkerMesh())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    cents = run(args.n, args.d, args.k, args.iters,
                mesh=WorkerMesh(args.device))
    out = {"k": args.k, "iters": args.iters,
           "centroid_norm": float(np.linalg.norm(cents))}
    if is_master():
        print(out)
    return out


if __name__ == "__main__":
    main()
