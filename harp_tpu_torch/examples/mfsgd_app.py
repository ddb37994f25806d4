"""Runnable Harp-style MF-SGD app — the port of the reference's
``examples/mfsgd_app.py``: the model-rotation pattern, complete.

Shows the signature Harp pattern (``edu.iu.sgd``): item factors travel
the worker ring while each worker trains on its resident slice.  The
production implementation (K3, checkpoint/resume, elastic training) is
:mod:`harp_tpu_torch.models.mfsgd`; this app drives it through the
``CollectiveApp`` lifecycle the way a Harp ``mapCollective`` program
would, with the reference's ``algo="dense"``, 64 × 64 tiles and 256
ratings an entry.

Run:  python -m harp_tpu_torch.examples.mfsgd_app [--device cpu]
          [--users 600] [--items 400] [--nnz 20000] [--rank 16]
          [--epochs 10]

Without ``--device cpu`` it runs on this worker's card and raises where
there is none.
"""

from __future__ import annotations

import argparse

from harp_tpu_torch import CollectiveApp, WorkerMesh, run_app
from harp_tpu_torch.models.mfsgd import MFSGD, MFSGDConfig, synthetic_ratings
from harp_tpu_torch.parallel.mesh import is_master


class MFSGDApp(CollectiveApp):
    """``config``: a dict with ``users``, ``items``, ``nnz``, ``rank`` and
    ``epochs``.  ``state``: the initial global W and H
    (:func:`harp_tpu_torch.convert.mfsgd_state_from_numpy`) in place of
    the seeded ones."""

    def __init__(self, config, state: dict | None = None, **kw):
        super().__init__(config, **kw)
        self.state = state

    def map_collective(self) -> dict:
        c = self.config
        # this job's ratings (a real app would read file splits through
        # self.reader; see `python -m harp_tpu_torch mfsgd --input`)
        u, i, v = synthetic_ratings(c["users"], c["items"], c["nnz"],
                                    rank=4, noise=0.05, seed=0)
        cfg = MFSGDConfig(rank=c["rank"], lr=0.05, algo="dense",
                          u_tile=64, i_tile=64, entry_cap=256)
        model = MFSGD(c["users"], c["items"], cfg, self.mesh, seed=0,
                      state=self.state)
        model.set_ratings(u, i, v)
        # every epoch is a full ring rotation of the item factors, all of
        # them one call with one readback
        rmses = model.train_epochs(c["epochs"])
        for e, r in enumerate(rmses):
            self.metrics.log(epoch=e, rmse=round(r, 4))
        return {"rmse_first": round(rmses[0], 4),
                "rmse_final": round(rmses[-1], 4),
                "workers": self.num_workers}


def run(users: int = 600, items: int = 400, nnz: int = 20_000,
        rank: int = 16, epochs: int = 10, *, mesh: WorkerMesh | None = None,
        state: dict | None = None) -> dict:
    """The app's result: the first and last epochs' RMSE (rounded to 4
    places, as the reference prints them) and the worker count."""
    return run_app(MFSGDApp, config={"users": users, "items": items,
                                     "nnz": nnz, "rank": rank,
                                     "epochs": epochs},
                   state=state, mesh=mesh or WorkerMesh())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--users", type=int, default=600)
    p.add_argument("--items", type=int, default=400)
    p.add_argument("--nnz", type=int, default=20_000)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    args = p.parse_args(argv)
    if args.epochs < 1:
        p.error("--epochs must be >= 1")
    out = run(args.users, args.items, args.nnz, args.rank, args.epochs,
              mesh=WorkerMesh(args.device))
    if is_master():
        print(out)
    return out


if __name__ == "__main__":
    main()
