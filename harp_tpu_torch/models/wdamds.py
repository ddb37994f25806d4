"""WDA-MDS: multidimensional scaling by SMACOF — the port of
``harp_tpu.models.wdamds`` (its unweighted path).

Harp's ``edu.iu.wdamds``: embed N points in ``dim`` dimensions from a
dissimilarity matrix Δ by the SMACOF majorization ``X ← B(X) X / N``, with
the rows of Δ split over the workers.  Each iteration a worker updates its
block of coordinate rows and the blocks are exchanged (``reshard``
blocked(0) → replicated, on ``coord_wire``); after the last iteration the
upper-triangle stress Σ_{i<j} (δ − d)² is summed with an allreduce.

Two Guttman steps (``MDSConfig.algo``): ``"xla"``, K6's plain version
(:func:`harp_tpu_torch.ops.wdamds_kernel.smacof_bx_plain`, the reference's
XLA body: the distance and ratio blocks are materialised), and
``"pallas"``, kernel K6 (:func:`harp_tpu_torch.ops.wdamds_kernel.
smacof_bx`), which keeps them in registers.  The port takes any N on
either: the reference's fallback to its XLA body when N is not a multiple
of 128 is a Mosaic rule.

The weighted path (``mds(weights=...)``, the "W" of WDA-MDS:
:func:`wsmacof`) solves ``V X = B(X) X`` by ``MDSConfig.cg_iters`` steps of
conjugate gradients a SMACOF iteration, V the weight Laplacian applied
row-sharded (one allgather a CG step).  A weight of 0 drops a
dissimilarity from the objective (missing or unreliable entries).  Its
Guttman step is plain torch on either algo: K6 computes the unweighted
ratio only, as the reference's kernel does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.ops import wdamds_kernel
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.utils import telemetry


@dataclasses.dataclass
class MDSConfig:
    dim: int = 2
    iters: int = 50
    eps: float = 1e-9
    # the coordinate exchange's wire: "bf16"/"int8" narrow the [N, dim]
    # payload with one rounding per iteration
    coord_wire: str = "exact"
    # the dtype Δ is staged in; arithmetic promotes it back to f32
    delta_dtype: str = "f32"
    # Guttman step: "xla" (plain torch) or "pallas" (kernel K6)
    algo: str = "xla"
    # CG steps a SMACOF iteration on the weighted path
    cg_iters: int = 10

    def __post_init__(self):
        if self.coord_wire not in ("exact", "bf16", "int8"):
            raise ValueError(f"coord_wire must be exact|bf16|int8, got "
                             f"{self.coord_wire!r}")
        if self.delta_dtype not in ("f32", "bf16"):
            raise ValueError(f"delta_dtype must be f32|bf16, got "
                             f"{self.delta_dtype!r}")
        if self.algo not in ("xla", "pallas"):
            raise ValueError(f"algo must be xla|pallas, got {self.algo!r}")


def _dist_block(Xl, X):
    """Distances of this worker's rows to every point: [n_loc, N] (the
    final stress's)."""
    x2 = (Xl ** 2).sum(-1)[:, None]
    y2 = (X ** 2).sum(-1)[None, :]
    return torch.sqrt(torch.clamp_min(x2 - 2.0 * (Xl @ X.T) + y2, 0.0))


def _live(row_mask, n_pad: int, n_real: float):
    cols = torch.arange(n_pad, device=row_mask.device) < n_real
    return row_mask[:, None] * cols.to(torch.float32)[None, :]


def smacof(delta_rows, row_mask, X0, n_real: float, cfg: MDSConfig, me0: int):
    """This worker's SMACOF run → (X [N, dim] on every worker, stress).

    ``delta_rows`` [n_loc, N] are this worker's rows of Δ, which start at
    global row ``me0``; ``X0`` [N, dim] the replicated start."""
    n_loc, n_pad = delta_rows.shape
    X = X0
    for _ in range(cfg.iters):
        Xl = X[me0:me0 + n_loc]
        step = (wdamds_kernel.smacof_bx if cfg.algo == "pallas"
                else wdamds_kernel.smacof_bx_plain)
        Xl_new = step(delta_rows, row_mask, Xl.contiguous(), X, n_real,
                      eps=cfg.eps)
        X = C.reshard(Xl_new, C.ShardSpec.blocked(0),
                      C.ShardSpec.replicated(), wire=cfg.coord_wire)
    # final stress: Σ_{i<j} (δ − d)², each pair once through the upper mask
    D = _dist_block(X[me0:me0 + n_loc], X)
    rows = me0 + torch.arange(n_loc, device=X.device)
    upper = torch.arange(n_pad, device=X.device)[None, :] > rows[:, None]
    se = ((delta_rows - D) ** 2 * _live(row_mask, n_pad, n_real)
          * upper).sum()
    return X, C.allreduce(se)


def _center(X, n_pad: int, n_real: float):
    """X centered over the live rows (V's translation null space)."""
    m = (torch.arange(n_pad, device=X.device) < n_real).to(X.dtype)[:, None]
    return (X - (X * m).sum(0) / max(n_real, 1.0)) * m


def wsmacof(delta_rows, w_rows, row_mask, X0, n_real: float,
            cfg: MDSConfig, me0: int):
    """This worker's weighted SMACOF run → (X [N, dim] on every worker,
    the weighted stress Σ_{i<j} w (δ − d)²).

    Each iteration solves ``V X = B(X) X`` by ``cfg.cg_iters`` CG steps on
    the replicated [N, dim] system, the only distributed operation being
    ``V``'s row block and an allgather a step.  Three guards freeze the
    solve once it has converged (zero weights can make V singular beyond
    translations, or disconnect the weight graph, and past convergence CG
    would divide f32 noise by f32 noise): the residual relative to the
    first, an absolute floor against |rhs|², and a curvature gate that
    takes no step (and restarts p from r) along a direction with ~0 or
    negative p·Vp."""
    n_loc, n_pad = delta_rows.shape
    dev = delta_rows.device
    delta_rows = delta_rows.to(torch.float32)
    w_live = w_rows * _live(row_mask, n_pad, n_real)
    vdiag = w_live.sum(1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def v_apply(Y):
        # (V Y) rows = vdiag ⊙ Y_local − W_block @ Y, assembled on all
        rows = vdiag[:, None] * Y[me0:me0 + n_loc] - w_live @ Y
        return C.allgather(rows)

    X = X0
    for _ in range(cfg.iters):
        Xl = X[me0:me0 + n_loc]
        D = _dist_block(Xl, X)
        ratio = torch.where(
            D > cfg.eps, w_live * delta_rows / torch.clamp_min(D, cfg.eps),
            zero)
        bz_rows = ratio.sum(1)[:, None] * Xl - ratio @ X
        rhs = _center(C.allgather(bz_rows), n_pad, n_real)
        x = _center(X, n_pad, n_real)
        r = rhs - v_apply(x)
        p = r
        rs = (r * r).sum()
        rs0 = rs
        rhs_sq = (rhs * rhs).sum()
        for _ in range(cfg.cg_iters):
            vp = v_apply(p)
            pvp = (p * vp).sum()
            step_ok = ((rs > 1e-12 * rs0 + 1e-30)
                       & (rs > 1e-10 * rhs_sq + 1e-30)
                       & (pvp > 1e-12 * (p * p).sum()))
            alpha = torch.where(step_ok, rs / torch.clamp_min(pvp, 1e-30),
                                zero)
            x = x + alpha * p
            r = r - alpha * vp
            rs_new = (r * r).sum()
            beta = torch.where(step_ok, rs_new / torch.clamp_min(rs, 1e-30),
                               zero)
            p = r + beta * p
            rs = rs_new
        X = _center(x, n_pad, n_real)
    D = _dist_block(X[me0:me0 + n_loc], X)
    rows = me0 + torch.arange(n_loc, device=dev)
    upper = torch.arange(n_pad, device=dev)[None, :] > rows[:, None]
    se = ((delta_rows - D) ** 2 * w_live * upper).sum()
    return X, C.allreduce(se)


def mds(delta, cfg: MDSConfig | None = None, mesh: WorkerMesh | None = None,
        seed=0, weights=None, device=None, X0=None):
    """Embed points from the dissimilarity matrix ``delta`` [n, n] →
    (X [n, dim] numpy, stress).

    The start is ``np.random.default_rng(seed).normal(size=(n_pad, dim))``,
    the reference's, so both packages start from the same coordinates;
    ``X0`` [n, dim] (e.g. from ``convert.mds_state_from_numpy``) replaces
    it.  Runs on this worker's card unless ``device`` (or ``mesh``) says
    otherwise.

    ``weights`` (optional [n, n], nonnegative): per-pair importance; 0
    removes a dissimilarity from the objective (:func:`wsmacof`).  The
    diagonal is zeroed (self-pairs never count).  None runs the unweighted
    closed form."""
    mesh = resolve_mesh(mesh, device)
    cfg = cfg or MDSConfig()
    _exact_f32(mesh.device)
    delta = np.asarray(delta, np.float32)
    n = delta.shape[0]
    nw = mesh.num_workers
    n_pad = -(-n // nw) * nw
    rows = torch.zeros((n_pad, n_pad), dtype=torch.float32)
    rows[:n, :n] = torch.from_numpy(delta)
    if cfg.delta_dtype == "bf16":
        rows = rows.to(torch.bfloat16)  # before sharding: half the bytes
    mask = torch.zeros(n_pad, dtype=torch.float32)
    mask[:n] = 1.0
    start = np.random.default_rng(seed).normal(
        size=(n_pad, cfg.dim)).astype(np.float32)
    if X0 is not None:
        start[:n] = torch.as_tensor(X0).detach().cpu().numpy()
    n_loc = n_pad // nw
    w_rows = None
    if weights is not None:
        w = np.asarray(weights, np.float32)
        if w.shape != delta.shape:
            raise ValueError(f"weights shape {w.shape} != delta shape "
                             f"{delta.shape}")
        if (w < 0).any():
            raise ValueError("weights must be nonnegative")
        w_rows = torch.zeros((n_pad, n_pad), dtype=torch.float32)
        w_rows[:n, :n] = torch.from_numpy(w)
        w_rows.fill_diagonal_(0.0)  # self-pairs never contribute
    with telemetry.span("wdamds.mds", iters=cfg.iters), \
            telemetry.ledger.run("wdamds.mds", steps=cfg.iters):
        args = (mesh.shard_array(mask, 0), mesh.replicated(start), float(n),
                cfg, mesh.rank * n_loc)
        if w_rows is None:
            X, stress = smacof(mesh.shard_array(rows, 0), *args)
        else:
            X, stress = wsmacof(mesh.shard_array(rows, 0),
                                mesh.shard_array(w_rows, 0), *args)
        X, stress = X.cpu().numpy(), float(stress)
    return X[:n], stress


def benchmark_delta(n: int, seed: int = 0) -> np.ndarray:
    """The reference benchmark's Δ: distances of 4-D normal points, to be
    embedded in 3-D (lossy, so the stress stays away from 0)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 4)).astype(np.float32)
    return np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))


def benchmark(n=4096, mesh=None, seed=0, coord_wire="exact",
              delta_dtype="f32", algo="xla", device=None):
    """Iterations per second of one timed ``mds`` (30 iterations, dim 3)
    after an untimed one, with the final stress."""
    mesh = resolve_mesh(mesh, device)
    delta = benchmark_delta(n, seed)
    cfg = MDSConfig(dim=3, iters=30, coord_wire=coord_wire,
                    delta_dtype=delta_dtype, algo=algo)
    mds(delta, cfg, mesh, seed)  # warmup: builds the kernel
    t0 = time.perf_counter()
    _, stress = mds(delta, cfg, mesh, seed)
    dt = time.perf_counter() - t0
    return {"sec_total": dt, "iters_per_sec": cfg.iters / dt,
            "final_stress": stress, "n": n, "coord_wire": coord_wire,
            "delta_dtype": delta_dtype, "algo": algo,
            "num_workers": mesh.num_workers}


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu WDA-MDS on PyTorch (edu.iu.wdamds parity)")
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--algo", choices=("xla", "pallas"), default="xla",
                   help="Guttman step (pallas = kernel K6)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    mesh = WorkerMesh(args.device)
    print(benchmark_json("wdamds_cli", benchmark(args.n, mesh=mesh,
                                                 algo=args.algo),
                         mesh.device))
    return 0


if __name__ == "__main__":
    main()
