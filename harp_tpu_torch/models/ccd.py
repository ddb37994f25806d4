"""CCD++ matrix factorization — coordinate descent with a column allreduce;
the port of ``harp_tpu.models.ccd``.

Harp's ``edu.iu.ccd`` implements CCD++ (Yu et al.): each rank coordinate
gets a closed-form update ``w_uf ← Σ_i R̂_ui h_if / (λ + Σ_i h_if²)`` (and
symmetrically for H), cycling through the coordinates.

Users and their ratings are range-partitioned, so each worker holds all
ratings of its users; the item factors H are replicated.  A coordinate
update is then exact: the W column from per-user sums over the local
ratings (no communication), the H column from per-item partial (num, den)
sums over the global item ids combined by one ``C.allreduce`` of two
[n_items] vectors.  The per-user and per-item sums are ``index_add_``
(the reference's ``segment_sum``), and the predictions are kept up to date
across coordinate updates, so an epoch costs O(nnz · rank).  An epoch is a
Python loop over ``rank × sweeps`` coordinates that never waits for the
device; the reference runs it as one program, so ``compile_epochs`` has
nothing to compile here and only validates.

``fit(epochs, ckpt_dir)`` checkpoints W and H through
:func:`harp_tpu_torch.utils.fault.fit_epochs`; a checkpoint of another
rank or shape refuses to restore.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.utils import telemetry

@dataclasses.dataclass
class CCDConfig:
    rank: int = 32
    reg: float = 0.1
    sweeps: int = 1  # coordinate cycles per epoch


def _segment_sum(values, ids, n):
    return torch.zeros((n,), dtype=values.dtype,
                       device=values.device).index_add_(0, ids, values)


def _epoch(W, H, bu, bi, bv, bm, cfg: CCDConfig):
    """One epoch on this worker: W [u_bound, r] its users' rows (updated in
    place), H [n_items, r] replicated (in place); ``bu`` local user ids,
    ``bi`` global item ids, ``bv`` ratings, ``bm`` the 0/1 mask.  Returns
    (se, cnt), summed over the workers."""
    u_size, n_items = W.shape[0], H.shape[0]
    pred = (W[bu] * H[bi]).sum(-1)
    for f in list(range(cfg.rank)) * cfg.sweeps:
        wf = W[:, f][bu]
        hf = H[:, f][bi]
        rhat = bm * (bv - pred + wf * hf)

        # the W column: all of each user's ratings are local
        num_u = _segment_sum(rhat * hf, bu, u_size)
        den_u = _segment_sum(bm * hf * hf, bu, u_size)
        w_new_col = torch.where(den_u > 0, num_u / (cfg.reg + den_u), W[:, f])
        W[:, f] = w_new_col
        wf_new = w_new_col[bu]
        pred = pred + bm * (wf_new - wf) * hf

        # the H column: per-item partials, one allreduce (exact)
        rhat = bm * (bv - pred + wf_new * hf)
        num_i = _segment_sum(rhat * wf_new, bi, n_items)
        den_i = _segment_sum(bm * wf_new * wf_new, bi, n_items)
        num_i, den_i = C.allreduce((num_i, den_i))
        h_new_col = torch.where(den_i > 0, num_i / (cfg.reg + den_i), H[:, f])
        H[:, f] = h_new_col
        hf_new = h_new_col[bi]
        pred = pred + bm * wf_new * (hf_new - hf)

    err = bm * (bv - pred)
    return C.allreduce(((err * err).sum(), bm.sum()))


def _rmse(se: float, cnt: float) -> float:
    return float(np.sqrt(max(se, 0.0) / max(cnt, 1.0)))


class CCD:
    """The host side (the mapCollective residue for edu.iu.ccd).  Runs on this
    worker's card unless ``device`` (or ``mesh``) says otherwise.  The
    initial factors come from a ``torch.Generator`` seeded with ``seed``,
    or from ``state`` (``convert.ccd_state_from_numpy``: the global ``W``
    [u_bound · n, rank] and ``H`` [n_items, rank])."""

    def __init__(self, n_users, n_items, cfg: CCDConfig | None = None,
                 mesh: WorkerMesh | None = None, seed=0, device=None,
                 state: dict | None = None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or CCDConfig()
        self.n_users, self.n_items = n_users, n_items
        n, r = self.mesh.num_workers, self.cfg.rank
        self.u_bound = -(-n_users // n)
        if state is None:
            gen = torch.Generator().manual_seed(seed)
            s = 1.0 / math.sqrt(r)
            W = torch.rand((self.u_bound * n, r), generator=gen) * s
            H = torch.rand((n_items, r), generator=gen) * s
        else:
            W, H = state["W"], state["H"]
            want = ((self.u_bound * n, r), (n_items, r))
            if (tuple(W.shape), tuple(H.shape)) != want:
                raise ValueError(f"W {tuple(W.shape)} and H {tuple(H.shape)}"
                                 f" must be {want[0]} and {want[1]}")
        # copies: the epochs update W and H in place
        self.W = self.mesh.shard_array(W.to(torch.float32), 0).clone()
        self.H = self.mesh.replicated(H.to(torch.float32)).clone()
        self._blocks = None

    def set_ratings(self, users, items, vals):
        """Partition by user range; items stay global (H is replicated)."""
        n = self.mesh.num_workers
        users = np.asarray(users)
        items = np.asarray(items)
        vals = np.asarray(vals, np.float32)
        wid = users // self.u_bound
        order = np.argsort(wid, kind="stable")
        su, si, sv, sw = users[order], items[order], vals[order], wid[order]
        counts = np.bincount(sw, minlength=n)
        B = int(counts.max())
        bu = np.zeros((n, B), np.int64)
        bi = np.zeros((n, B), np.int64)
        bv = np.zeros((n, B), np.float32)
        bm = np.zeros((n, B), np.float32)
        starts = np.zeros(n, np.int64)
        starts[1:] = counts.cumsum()[:-1]
        for w in range(n):
            c = counts[w]
            sl = slice(starts[w], starts[w] + c)
            bu[w, :c] = su[sl] - w * self.u_bound
            bi[w, :c] = si[sl]
            bv[w, :c] = sv[sl]
            bm[w, :c] = 1.0
        self._blocks = tuple(self.mesh.shard_array(a.reshape(n * B), 0)
                             for a in (bu, bi, bv, bm))

    def _check(self, what: str) -> None:
        if self._blocks is None:
            raise RuntimeError(f"call set_ratings() before {what}()")

    def _run(self, epochs: int) -> list:
        stats = []
        with telemetry.ledger.run("ccd.epochs", steps=epochs):
            for _ in range(epochs):
                stats.append(torch.stack(_epoch(self.W, self.H,
                                                *self._blocks, self.cfg)))
        stats = torch.stack(stats).cpu().numpy()  # one readback
        return [_rmse(float(se), float(cnt)) for se, cnt in stats]

    def train_epoch(self) -> float:
        self._check("train_epoch")
        return self._run(1)[0]

    def compile_epochs(self, epochs: int):
        """Validates and trains nothing: the epochs are a Python loop here,
        so there is no program to build ahead (the reference's contract:
        a benchmark's warm-up must not run extra epochs)."""
        self._check("compile_epochs")
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        return self

    def train_epochs(self, epochs: int) -> list:
        """Run ``epochs`` epochs; their RMSEs, read back once."""
        self.compile_epochs(epochs)
        return self._run(epochs)

    def fit(self, epochs: int, ckpt_dir: str | None = None, *,
            ckpt_every: int = 5, max_restarts: int = 3, fault=None):
        """Train ``epochs`` epochs with optional checkpoint/resume (the
        contract of MF-SGD's and LDA's ``fit``); returns the RMSEs of the
        epochs this call ran."""
        from harp_tpu_torch.utils.fault import (factor_state_io, fit_epochs,
                                                to_device)

        self._check("fit")
        rmses: list[float] = []
        dev = self.mesh.device
        get_state, set_state = factor_state_io(self, {
            "W": lambda a: to_device(a, dev), "H": lambda a: to_device(a, dev)})
        fit_epochs(lambda: rmses.append(self.train_epoch()), get_state,
                   set_state, epochs, ckpt_dir, ckpt_every=ckpt_every,
                   max_restarts=max_restarts, fault=fault, phase="ccd.epochs")
        return rmses


def benchmark(n_users=50_000, n_items=20_000, nnz=2_000_000, rank=32,
              epochs=2, mesh=None, seed=0, device=None):
    """Coordinate updates per second over ``epochs`` timed epochs, after an
    untimed one (the reference's windows)."""
    from harp_tpu_torch.models.mfsgd import synthetic_ratings

    mesh = resolve_mesh(mesh, device)
    model = CCD(n_users, n_items, CCDConfig(rank=rank), mesh, seed)
    u, i, v = synthetic_ratings(n_users, n_items, nnz, seed=seed)
    model.set_ratings(u, i, v)
    r0 = model.train_epoch()      # warm-up
    model.compile_epochs(epochs)  # trains nothing
    t0 = time.perf_counter()
    r = model.train_epochs(epochs)[-1]
    dt = time.perf_counter() - t0
    return {"coord_updates_per_sec": nnz * rank * epochs / dt,
            "sec_per_epoch": dt / epochs, "rmse_first": r0, "rmse_final": r,
            "rank": rank, "nnz": nnz, "num_workers": mesh.num_workers}


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu CCD++ on PyTorch (edu.iu.ccd parity)")
    p.add_argument("--nnz", type=int, default=2_000_000)
    p.add_argument("--rank", type=int, default=32)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    mesh = WorkerMesh(args.device)
    print(benchmark_json("ccd_cli", benchmark(
        nnz=args.nnz, rank=args.rank, epochs=args.epochs, mesh=mesh),
        mesh.device))
    return 0


if __name__ == "__main__":
    main()
