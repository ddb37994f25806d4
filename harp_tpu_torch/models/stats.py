"""The classic analytics suite — Harp-DAAL's map + reduce apps; the port of
``harp_tpu.models.stats``.

Harp's ``ml/daal`` apps (``daal_mom``, ``daal_cov``, ``daal_pca``,
``daal_naive``, ``daal_linreg``, ``daal_ridgereg``, ``daal_qr``,
``daal_svd``, ``daal_als``): each worker computes a partial result on its
rows, the partials are combined with ``allreduce``/``allgather``, and a
small closed-form step finishes.

Every app here is "local sufficient statistics → ``allreduce`` → finish":
Gram matrices and moment sums on this worker's rows (:func:`_shard_rows`),
combined by the port's verbs.  QR and SVD are TSQR (local QR, allgather
of the small R factors, QR again).  ALS keeps the reference's padded
per-user lists ([users, max ratings]); its H step accumulates the [nnz, r,
r] outer products per item with ``index_add_`` (the reference's
``segment_sum``), and both solves are batched ``torch.linalg.solve``.

f32 products on the card run in full f32 (TF32 off, as KMeans sets it):
normal equations and Grams in TF32 would lose about three digits.  The
signs of QR and eigen factors come from the card's or the host's LAPACK
and may differ from the reference's; they are not normalised here, as
they are not there.

Every entry point takes numpy arrays or tensors (a tensor on the card
stays there) and runs on this worker's card unless ``device`` (or
``mesh``) says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard_rows(mesh: WorkerMesh, *arrays):
    """Pad row-aligned arrays to a worker multiple and shard them.

    Returns ``(*this_workers_blocks, weights)``, the weights 1 for real rows
    and 0 for padding.  Floating arrays become float32, except bfloat16,
    which keeps its type (the reference's test is numpy's ``kind == 'f'``,
    which its bfloat16 does not pass); other types are kept.  A tensor
    already on the worker's device is sharded there."""
    arrays = [_as_tensor(a) for a in arrays]
    nw = mesh.num_workers
    n = arrays[0].shape[0]
    n_pad = -(-n // nw) * nw
    out = []
    for a in arrays:
        if a.is_floating_point() and a.dtype != torch.bfloat16:
            a = a.to(torch.float32)
        if n_pad > n:
            a = torch.cat([a, a.new_zeros((n_pad - n, *a.shape[1:]))])
        out.append(mesh.shard_array(a, 0))
    w = torch.zeros(n_pad, dtype=torch.float32)
    w[:n] = 1.0
    out.append(mesh.shard_array(w, 0))
    return tuple(out)


def _mesh(mesh, device) -> WorkerMesh:
    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    return mesh


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Moments and covariance (daal_mom, daal_cov)
# ---------------------------------------------------------------------------

def moments(x, mesh: WorkerMesh | None = None, device=None):
    """Low-order moments per feature: n, sum, min, max, mean, the centered
    sum of squares, variance and std (numpy)."""
    mesh = _mesh(mesh, device)
    x, w = _shard_rows(mesh, x)
    big = torch.tensor(3.4e38, device=x.device)
    live = w[:, None] > 0
    stats = {
        "n": C.allreduce(w.sum()),
        "sum": C.allreduce((x * w[:, None]).sum(0)),
        "min": C.allreduce(torch.where(live, x, big).amin(0), C.Combiner.MIN),
        "max": C.allreduce(torch.where(live, x, -big).amax(0),
                           C.Combiner.MAX),
    }
    mean = stats["sum"] / stats["n"]
    # a centered second pass: E[x²] − mean² cancels in f32 when |mean| ≫
    # std; one more allreduce buys exactness
    cx = (x - mean[None, :]) * w[:, None]
    stats["centered_sum2"] = C.allreduce((cx * cx).sum(0))
    stats["mean"] = mean
    stats["variance"] = torch.clamp_min(stats["centered_sum2"] / stats["n"],
                                        0.0)
    stats["std"] = torch.sqrt(stats["variance"])
    return {k: _np(v) for k, v in stats.items()}


def covariance(x, mesh: WorkerMesh | None = None, device=None):
    """(mean [d], covariance [d, d]) from one allreduce of (n, Σx) and one
    of the centered Gram."""
    mesh = _mesh(mesh, device)
    x, w = _shard_rows(mesh, x)
    n, s = C.allreduce((w.sum(), (x * w[:, None]).sum(0)))
    mean = s / n
    # the centered Gram (a second pass): no f32 cancellation at large means
    xc = x - mean[None, :]
    g = C.allreduce((xc * w[:, None]).T @ xc)
    return _np(mean), _np(g / n)


# ---------------------------------------------------------------------------
# PCA (daal_pca: the correlation method)
# ---------------------------------------------------------------------------

def pca(x, n_components=None, mesh: WorkerMesh | None = None, device=None):
    """PCA by the covariance method → (components [k, d], explained
    variance [k]), descending.  The O(n) part stays on the workers; the
    d × d eigendecomposition runs on the host (``np.linalg.eigh``)."""
    _, cov = covariance(x, mesh, device)
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1]
    k = n_components or cov.shape[0]
    return evecs[:, order[:k]].T, evals[order[:k]]


# ---------------------------------------------------------------------------
# Naive Bayes (daal_naive: multinomial)
# ---------------------------------------------------------------------------

def naive_bayes_fit(x, y, n_classes, alpha=1.0,
                    mesh: WorkerMesh | None = None, device=None):
    """Multinomial naive Bayes: per-class feature sums → allreduce → log
    probabilities (numpy)."""
    mesh = _mesh(mesh, device)
    x, y, w = _shard_rows(mesh, x, _as_tensor(y).to(torch.int32))
    oh = F.one_hot(y.long(), n_classes).to(torch.float32) * w[:, None]
    feat, cls = C.allreduce((oh.T @ x, oh.sum(0)))
    feat, cls = _np(feat), _np(cls)
    log_prior = np.log((cls + alpha) / (cls.sum() + alpha * n_classes))
    log_lik = np.log((feat + alpha)
                     / (feat.sum(1, keepdims=True) + alpha * feat.shape[1]))
    return {"log_prior": log_prior, "log_likelihood": log_lik}


def naive_bayes_predict(model, x):
    scores = np.asarray(x) @ model["log_likelihood"].T + model["log_prior"]
    return scores.argmax(1).astype(np.int32)


# ---------------------------------------------------------------------------
# Linear and ridge regression (daal_linreg, daal_ridgereg)
# ---------------------------------------------------------------------------

def linear_regression(x, y, l2=0.0, fit_intercept=True,
                      mesh: WorkerMesh | None = None, device=None):
    """Normal equations: allreduce (XᵀX, Xᵀy), solve on the device →
    (coefficients, intercept or None), numpy.

    ``y`` may be [n] or [n, t] (several dependent variables).  The
    intercept is never regularized."""
    mesh = _mesh(mesh, device)
    x = _as_tensor(x).to(torch.float32)
    y = _as_tensor(y).to(torch.float32)
    vec = y.ndim == 1
    y2 = y[:, None] if vec else y
    if fit_intercept:
        x = torch.cat([x, x.new_ones((x.shape[0], 1))], 1)
    xd, w = _shard_rows(mesh, x)
    yd, _ = _shard_rows(mesh, y2.to(x.device))
    d = x.shape[1]
    reg = torch.full((d,), float(l2), dtype=torch.float32)
    if fit_intercept:
        reg[-1] = 0.0
    xw = xd * w[:, None]
    xtx, xty = C.allreduce((xw.T @ xd, xw.T @ yd))
    beta = _np(torch.linalg.solve(
        xtx + torch.diag(reg).to(xtx.device), xty))
    if fit_intercept:
        coef, icpt = beta[:-1], beta[-1]
        return (coef.squeeze(-1), icpt.squeeze(-1)) if vec else (coef, icpt)
    return (beta.squeeze(-1) if vec else beta), None


def ridge_regression(x, y, l2=1.0, fit_intercept=True, mesh=None,
                     device=None):
    return linear_regression(x, y, l2=l2, fit_intercept=fit_intercept,
                             mesh=mesh, device=device)


# ---------------------------------------------------------------------------
# QR and SVD (daal_qr, daal_svd): TSQR
# ---------------------------------------------------------------------------

def tsqr(x, mesh: WorkerMesh | None = None, device=None):
    """Tall-skinny QR: local QR → allgather the R factors → QR of the
    stack → lift the local Q.  Returns (Q [n, d], R [d, d]), numpy, on
    every worker.  Raises when a worker's block is not tall."""
    mesh = _mesh(mesh, device)
    x = _as_tensor(x).to(torch.float32)
    n, d = x.shape
    nw = mesh.num_workers
    n_pad = -(-n // nw) * nw
    if n_pad // nw < d:
        raise ValueError(
            f"tsqr needs a tall-skinny local block: {n} rows / {nw} workers "
            f"= {n_pad // nw} per worker < {d} columns")
    if n_pad > n:
        # zero rows factor exactly: [X; 0] = [Q; 0] R
        x = torch.cat([x, x.new_zeros((n_pad - n, d))])
    xl = mesh.shard_array(x, 0)
    q1, r1 = torch.linalg.qr(xl)                 # [n_loc, d], [d, d]
    q2, r = torch.linalg.qr(C.allgather(r1))     # the [nw*d, d] stack
    me = mesh.rank
    q = C.allgather(q1 @ q2[me * d:(me + 1) * d])
    return _np(q)[:n], _np(r)


def svd(x, mesh: WorkerMesh | None = None, device=None):
    """Tall-skinny SVD by TSQR: X = QR, R = UΣVᵀ → X = (QU)ΣVᵀ."""
    q, r = tsqr(x, mesh, device)
    u_r, s, vt = np.linalg.svd(r)
    return q @ u_r, s, vt


# ---------------------------------------------------------------------------
# ALS (daal_als): alternating least squares on ratings
# ---------------------------------------------------------------------------

def als_user_lists(users, items, vals, n_users, n_workers):
    """The reference's per-user padded lists (host prep): item ids,
    ratings and a mask, each [ceil(n_users / n_workers) * n_workers, m]
    with m the largest per-user count."""
    users = np.asarray(users)
    items = np.asarray(items)
    vals = np.asarray(vals, np.float32)
    u_bound = -(-n_users // n_workers)
    order = np.argsort(users, kind="stable")
    su, si, sv = users[order], items[order], vals[order]
    starts = np.searchsorted(su, np.arange(n_users))
    counts = np.diff(np.append(starts, len(su)))
    m = max(int(counts.max()), 1)
    rows = u_bound * n_workers
    ui = np.zeros((rows, m), np.int32)
    uv = np.zeros((rows, m), np.float32)
    um = np.zeros((rows, m), np.float32)
    pos = np.arange(len(su)) - np.repeat(starts, counts)
    ui[su, pos] = si
    uv[su, pos] = sv
    um[su, pos] = 1.0
    return ui, uv, um


def als(users, items, vals, n_users, n_items, rank=16, reg=0.1, iters=10,
        mesh: WorkerMesh | None = None, seed=0, device=None):
    """Explicit-feedback ALS with the users sharded and the item factors
    replicated → (W [n_users, rank], H [n_items, rank], rmse_history).

    The W step solves each user's normal equations over its padded item
    list (one batched solve); the H step sums per-item Grams over the
    worker's ratings (``index_add_``), combines them with one allreduce
    (the DAAL partial-result exchange) and solves per item.  H starts at
    ``np.random.default_rng(seed).normal(size=(n_items, rank)) /
    sqrt(rank)``, the reference's start."""
    mesh = _mesh(mesh, device)
    dev = mesh.device
    ui, uv, um = (mesh.shard_array(a, 0) for a in als_user_lists(
        users, items, vals, n_users, mesh.num_workers))
    ui = ui.long()
    rng = np.random.default_rng(seed)
    H = mesh.replicated((rng.normal(size=(n_items, rank)).astype(np.float32)
                         / np.sqrt(rank)).astype(np.float32))
    eye = reg * torch.eye(rank, dtype=torch.float32, device=dev)
    flat_i, flat_v, flat_m = ui.reshape(-1), uv.reshape(-1), um.reshape(-1)
    hist = []
    for _ in range(iters):
        # W step: per-user normal equations
        h = H[ui] * um[:, :, None]                           # [u, m, r]
        A = h.transpose(1, 2) @ h + eye
        b = (h * (uv * um)[:, :, None]).sum(1)
        W = torch.linalg.solve(A, b)                         # [u, r]
        # H step: per-item Grams over this worker's ratings
        w_rep = W.repeat_interleave(ui.shape[1], 0) * flat_m[:, None]
        A = torch.zeros((n_items, rank, rank), device=dev).index_add_(
            0, flat_i, w_rep[:, :, None] * w_rep[:, None, :])
        b = torch.zeros((n_items, rank), device=dev).index_add_(
            0, flat_i, w_rep * flat_v[:, None])
        A, b = C.allreduce((A, b))
        H = torch.linalg.solve(A + eye, b)
        pred = (W[:, None, :] * H[ui]).sum(-1)
        se, cnt = C.allreduce(((((pred - uv) * um) ** 2).sum(), um.sum()))
        hist.append(torch.sqrt(se / torch.clamp_min(cnt, 1.0)))
    hist = [float(h) for h in torch.stack(hist).cpu()] if hist else []
    W_all = _np(C.allgather(W)) if iters else np.zeros((0, rank), np.float32)
    return W_all[:n_users], _np(H), hist


def main(argv=None):
    """``python -m harp_tpu_torch stats <algo>``: the ``daal_*`` launchers
    in one."""
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu classic analytics on PyTorch (edu.iu.daal_* "
                    "parity)")
    p.add_argument("algo", choices=["pca", "cov", "moments", "naive",
                                    "linreg", "ridge", "qr", "svd", "als"])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input", default=None, metavar="FILE_OR_GLOB",
                   help="CSV shards instead of synthetic data; for "
                        "naive/linreg/ridge the LAST column is the "
                        "label/target, for als rows are 'user item rating' "
                        "triples")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    mesh = WorkerMesh(args.device)

    rng = np.random.default_rng(args.seed)
    y_file = None
    if args.input and args.algo == "als":
        from harp_tpu_torch.native.datasource import load_triples_glob

        try:
            u_in, i_in, v_in, has_vals = load_triples_glob(args.input)
        except ValueError as e:
            raise SystemExit(str(e))
        if not has_vals:
            raise SystemExit(f"{args.input}: als needs 'user item rating' rows")
        if int(u_in.min()) < 0 or int(i_in.min()) < 0:
            raise SystemExit(
                f"{args.input}: negative user/item ids (ids index factor "
                "rows)")
        x = None
    elif args.input:
        from harp_tpu_torch.native.datasource import load_csv_glob

        try:
            x = load_csv_glob(args.input)
        except ValueError as e:
            raise SystemExit(str(e))
        if x.ndim != 2 or x.shape[1] < 1:
            raise SystemExit(f"{args.input}: need a 2-D CSV matrix")
        if args.algo in ("naive", "linreg", "ridge"):
            if x.shape[1] < 2:
                raise SystemExit(
                    f"{args.input}: {args.algo} needs >= 2 columns "
                    "(features..., label)")
            y_file, x = x[:, -1], x[:, :-1].copy()
    else:
        x = rng.normal(size=(args.n, args.d)).astype(np.float32)

    def emit(result):
        print(benchmark_json("stats_cli", result, mesh.device))

    if args.algo == "pca":
        _, evals = pca(x, mesh=mesh)
        emit({"algo": "pca", "top5_evals": np.asarray(evals)[:5].tolist()})
    elif args.algo == "cov":
        _, c = covariance(x, mesh)
        emit({"algo": "cov", "trace": float(np.trace(c))})
    elif args.algo == "moments":
        m = moments(x, mesh)
        emit({"algo": "moments",
              "mean_norm": float(np.linalg.norm(m["mean"])),
              "var_mean": float(np.mean(m["variance"]))})
    elif args.algo == "naive":
        if y_file is not None:
            if not np.all(y_file == np.round(y_file)):
                raise SystemExit(
                    "naive: labels (last column) must be integers — "
                    "fractional values would silently truncate to wrong "
                    "classes")
            y = y_file.astype(np.int64)
            if y.min() < 0:
                raise SystemExit("naive: labels (last column) must be >= 0")
            n_classes = int(y.max()) + 1
            if n_classes > 10_000:
                raise SystemExit(
                    f"naive: {n_classes} classes from the label column — "
                    "is this a regression target? (refusing to allocate "
                    "count tables that size)")
        else:
            # class-dependent feature patterns (multinomial NB is blind to
            # uniform shifts): each class boosts its own d/4 feature slice
            y, n_classes = rng.integers(0, 4, args.n), 4
            x = x + 3.0 * (np.arange(x.shape[1])[None, :] % 4
                           == y[:, None])
        model = naive_bayes_fit(np.abs(x), y, n_classes=n_classes, mesh=mesh)
        acc = float((naive_bayes_predict(model, np.abs(x)) == y).mean())
        emit({"algo": "naive_bayes", "train_acc": acc})
    elif args.algo in ("linreg", "ridge"):
        if y_file is not None:
            y = y_file
        else:
            w_true = rng.normal(size=x.shape[1]).astype(np.float32)
            y = x @ w_true + 0.01 * rng.normal(size=len(x)).astype(
                np.float32)
        fit = linear_regression if args.algo == "linreg" else ridge_regression
        coef, intercept = fit(x, y, mesh=mesh)
        pred = x @ np.asarray(coef) + float(np.asarray(intercept))
        rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
        emit({"algo": args.algo, "fit_rmse": rmse})
    elif args.algo == "qr":
        q, r = tsqr(x, mesh)
        resid = float(np.linalg.norm(q @ r - x) / np.linalg.norm(x))
        emit({"algo": "tsqr", "rel_resid": resid})
    elif args.algo == "svd":
        _, s, _ = svd(x, mesh)
        emit({"algo": "svd", "top5_sv": np.asarray(s)[:5].tolist()})
    elif args.algo == "als":
        if args.input:
            users, items, vals = u_in, i_in, v_in
            nu, ni = int(users.max()) + 1, int(items.max()) + 1
        else:
            nnz = min(args.n, 200_000)
            users = rng.integers(0, 1000, nnz).astype(np.int32)
            items = rng.integers(0, 500, nnz).astype(np.int32)
            vals = rng.normal(size=nnz).astype(np.float32)
            nu, ni = 1000, 500
        _, _, hist = als(users, items, vals, nu, ni, rank=8, iters=3,
                         mesh=mesh)
        emit({"algo": "als", "rmse_history": [round(h, 4) for h in hist]})
    return 0


if __name__ == "__main__":
    main()
