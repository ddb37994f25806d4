"""Random Forest: data-parallel ensemble, allgather — the port of
``harp_tpu.models.rf``.

Harp's ``edu.iu.rf``: every worker grows trees on bootstrap samples of its
shard and the trees are gathered so every worker holds the forest;
prediction is a majority vote.  As in the reference, a tree grows level by
level on quantile-binned features: per (tree, node, feature, bin, class)
label histograms, Gini impurity from their cumulative sums, the best
(feature, bin) of each node by the lowest-index argmin, and every sample
routed to its child.  All trees of a worker grow together, the tree axis a
dimension of every tensor.

Three histogram arms (``RFConfig.hist_algo``), with bit-identical int32
counts and so the same forest: ``"dense"``, the one-hot product in plain
torch (float products with TF32 off, exact while counts stay below 2^24,
f64 beyond); ``"scatter"``, an int32 ``index_put_`` scatter add (K7's plain
version, :func:`harp_tpu_torch.ops.rf_kernel.hist_bins_plain`); and
``"pallas"``, kernel K7 (:func:`harp_tpu_torch.ops.rf_kernel.hist_bins`),
one launch per level for the whole forest.  The port takes any f·n_bins
(the reference's fallback to dense when f·B is not a multiple of 128 is a
Mosaic rule).

Bootstrap Poisson(1) weights and feature masks come from a
``torch.Generator`` seeded from ``cfg.seed`` and the tree's global index:
another stream than the reference's threefry, with the same distributions.
``RandomForest._fit(x, y, draws)`` takes the draws instead (the tests hand
in the reference's).

Not ported yet: ``binize_chunked``'s ingest threads (ROADMAP.md, Queue 1,
item 3).  Until they come it is a serial chunk loop with ``binize``'s
output, kept as the place they go in; and the telemetry,
skew and flight-recorder hooks of ``fit``/``predict`` (item 10).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.ops import rf_kernel
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.utils import telemetry


@dataclasses.dataclass
class RFConfig:
    n_trees: int = 32          # total across workers
    max_depth: int = 6
    n_bins: int = 32
    n_classes: int = 2
    feature_fraction: float = 1.0  # per-tree feature subsampling
    # "dense" (one-hot product), "scatter" (scatter add) or "pallas" (K7)
    hist_algo: str = "dense"
    seed: int = 0

    def __post_init__(self):
        if self.hist_algo not in ("dense", "scatter", "pallas"):
            raise ValueError(
                f"hist_algo must be 'dense', 'scatter' or 'pallas', got "
                f"{self.hist_algo!r}")


def quantile_bins(x, n_bins):
    """Per-feature quantile bin edges [f, n_bins-1] from a sample."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(np.asarray(x), qs, axis=0).T.astype(np.float32)


def binize(x, edges):
    """x [n, f] → bin ids [n, f] int32 via the precomputed edges (one
    searchsorted per feature keeps the transient at [n])."""
    x = np.asarray(x)
    out = np.empty(x.shape, np.int32)
    for j in range(x.shape[1]):
        out[:, j] = np.searchsorted(edges[j], x[:, j], side="left")
    return out


def binize_chunked(x, edges, chunk_rows=65_536):
    """:func:`binize` a chunk of rows at a time, with the same output (a
    row's bins depend on that row alone)."""
    x = np.asarray(x)
    out = np.empty(x.shape, np.int32)
    for lo in range(0, x.shape[0], chunk_rows):
        out[lo:lo + chunk_rows] = binize(x[lo:lo + chunk_rows], edges)
    return out


def bins_onehot(bins, n_bins, dtype=torch.float32):
    """The flattened bin one-hots BO [n, f·B] of the dense arm, built once
    a fit (bins never change during one)."""
    n, f = bins.shape
    return torch.nn.functional.one_hot(bins.to(torch.int64), n_bins).reshape(
        n, f * n_bins).to(dtype)


def _exact_float(n: int) -> torch.dtype:
    """The float type in which the dense arm's counts are exact integers:
    f32 while a cell's sum of [0, 127] weights stays below 2^24."""
    return torch.float32 if 127 * n < (1 << 24) else torch.float64


def _histograms(bins, y, w_i32, node_id, n_nodes, cfg, BO=None):
    """[T, n_nodes·C, f·B] int32 label histograms of one level."""
    T, n = node_id.shape
    B, C_ = cfg.n_bins, cfg.n_classes
    R = n_nodes * C_
    rows = node_id * C_ + y[None, :]                       # [T, n]
    if cfg.hist_algo == "pallas":
        return rf_kernel.hist_bins(bins, rows.to(torch.int32), w_i32, R, B)
    if cfg.hist_algo == "scatter":  # K7's plain version, on any device
        return rf_kernel.hist_bins_plain(bins, rows, w_i32, R, B)
    if BO is None:
        BO = bins_onehot(bins, B, _exact_float(n))
    out = []
    for t in range(T):
        nc = torch.nn.functional.one_hot(rows[t].long(), R).to(BO.dtype)
        nc = nc * w_i32[t].to(BO.dtype)[:, None]
        out.append((nc.T @ BO).round().to(torch.int32))
    return torch.stack(out)


def _grow_level(bins, y, weights, node_id, level, feat_mask, cfg, BO=None):
    """Grow one level of every tree: returns (split_feat [T, 2^level],
    split_bin [T, 2^level], new_node_id [T, n]).

    ``bins`` [n, f] bin ids (uint8 or int32), ``y`` [n] labels, ``weights``
    [T, n] bootstrap weights (small non-negative integers, f32), ``node_id``
    [T, n] each sample's node within this level, ``feat_mask`` [T, f] 0/1;
    ``BO``: the dense arm's one-hots, when the caller built them."""
    T, n = node_id.shape
    C_, B = cfg.n_classes, cfg.n_bins
    f = bins.shape[1]
    n_nodes = 2 ** level
    w_i32 = weights.clamp(0, 127).to(torch.int32)
    hist = _histograms(bins, y, w_i32, node_id, n_nodes, cfg, BO)
    hist = hist.reshape(T, n_nodes, C_, f, B).permute(0, 1, 3, 4, 2)
    hist = hist.to(torch.float32)                      # [T, node, f, B, C]

    # left counts for the threshold "<= bin b": bins <= b go left
    left = torch.cumsum(hist, dim=3)
    right = left[:, :, :, -1:, :] - left

    def gini_side(cnt):  # [.., C] -> impurity * size
        sz = cnt.sum(-1)
        p = cnt / torch.clamp_min(sz[..., None], 1e-9)
        return sz * (1.0 - (p * p).sum(-1))

    score = gini_side(left) + gini_side(right)         # [T, node, f, B]
    # forbid the last bin (empty right side) and masked-out features
    score[..., -1] = float("inf")
    score = torch.where(feat_mask[:, None, :, None] > 0, score,
                        torch.full_like(score, float("inf")))
    best = torch.argmin(score.reshape(T, n_nodes, f * B), dim=2)
    split_feat = (best // B).to(torch.int64)
    split_bin = (best % B).to(torch.int64)

    # route: go right if the sample's bin exceeds its node's split bin
    sf = split_feat.gather(1, node_id)                  # [T, n]
    sb = split_bin.gather(1, node_id)
    sample_bin = bins.to(torch.int64).T.gather(0, sf)   # bins[i, sf[t, i]]
    new_node_id = node_id * 2 + (sample_bin > sb).to(torch.int64)
    return split_feat, split_bin, new_node_id


def _leaf_stats(y, weights, node_id, n_leaves, n_classes):
    """Each leaf's majority class (weighted; ties to the lower class)."""
    T = node_id.shape[0]
    hist = torch.zeros((T, n_leaves, n_classes), dtype=torch.float32,
                       device=y.device)
    t_idx = torch.arange(T, device=y.device)[:, None].expand_as(node_id)
    hist.index_put_((t_idx, node_id, y[None, :].expand_as(node_id)),
                    weights, accumulate=True)
    return torch.argmax(hist, dim=2)


def _train_trees(bins, y, weights, feat_mask, cfg):
    """This worker's trees → (feats, thresh [T, 2^depth − 1], leaves
    [T, 2^depth]) int32, the nodes in heap order (level l at offset
    2^l − 1)."""
    T, n = weights.shape
    BO = (bins_onehot(bins, cfg.n_bins, _exact_float(n))
          if cfg.hist_algo == "dense" else None)
    node_id = torch.zeros((T, n), dtype=torch.int64, device=bins.device)
    feats, thresh = [], []
    for level in range(cfg.max_depth):
        sf, sb, node_id = _grow_level(bins, y, weights, node_id, level,
                                      feat_mask, cfg, BO)
        feats.append(sf)
        thresh.append(sb)
    leaves = _leaf_stats(y, weights, node_id, 2 ** cfg.max_depth,
                         cfg.n_classes)
    return tuple(a.to(torch.int32) for a in
                 (torch.cat(feats, 1), torch.cat(thresh, 1), leaves))


def tree_draws(cfg: RFConfig, n: int, n_features: int, tree_ids,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """Bootstrap weights [T, n] (Poisson(1), f32) and feature masks
    [T, f] (never all zero) of the trees ``tree_ids``, each from its own
    generator seeded from ``cfg.seed`` and the tree's global index."""
    ws, ms = [], []
    for g in tree_ids:
        gen = torch.Generator(device=device)
        gen.manual_seed((cfg.seed * 1_000_003 + int(g)) % (1 << 63))
        ws.append(torch.poisson(torch.ones(n, device=device), generator=gen))
        m = (torch.rand(n_features, generator=gen, device=device)
             < cfg.feature_fraction).to(torch.float32)
        ms.append(torch.where(m.sum() > 0, m, torch.ones_like(m)))
    return torch.stack(ws), torch.stack(ms)


def predict_forest(forest, bins, max_depth, n_classes):
    """Majority vote over all trees (ties to the lower class).  ``forest``
    (feats, thresh, leaves) tensors, ``bins`` [n, f] on their device."""
    feats, thresh, leaves = (a.to(torch.int64) for a in forest)
    T, n = feats.shape[0], bins.shape[0]
    binsT = bins.to(torch.int64).T
    node = torch.zeros((T, n), dtype=torch.int64, device=bins.device)
    offset = 0
    for level in range(max_depth):
        heap = offset + node
        sf, sb = feats.gather(1, heap), thresh.gather(1, heap)
        node = node * 2 + (binsT.gather(0, sf) > sb).to(torch.int64)
        offset += 2 ** level
    votes = leaves.gather(1, node)                     # [T, n]
    counts = torch.nn.functional.one_hot(votes, n_classes).sum(0)
    return torch.argmax(counts, dim=-1)


class RandomForest:
    """Host driver (the mapCollective residue for edu.iu.rf).  Runs on this
    worker's card unless ``device`` (or ``mesh``) says otherwise; ``state``
    (from ``convert.rf_forest_from_numpy``) sets a trained forest."""

    def __init__(self, cfg: RFConfig | None = None,
                 mesh: WorkerMesh | None = None, device=None,
                 state: dict | None = None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or RFConfig()
        nw = self.mesh.num_workers
        if self.cfg.n_trees % nw:
            raise ValueError(
                f"n_trees={self.cfg.n_trees} must be divisible by {nw} "
                "workers")
        self.trees_per_worker = self.cfg.n_trees // nw
        self.forest = None
        self.edges = None
        if state is not None:
            self.forest = tuple(state[k].detach().cpu().numpy()
                                for k in ("feats", "thresh", "leaves"))
            self.edges = state["edges"].detach().cpu().numpy()

    def fit(self, x, y):
        n, f = np.shape(x)
        first = self.mesh.rank * self.trees_per_worker
        draws = tree_draws(self.cfg, n // self.mesh.num_workers, f,
                           range(first, first + self.trees_per_worker),
                           self.mesh.device)
        return self._fit(x, y, draws)

    def _fit(self, x, y, draws):
        """:meth:`fit` with this worker's draws given: ``(weights [tpw,
        n_loc] f32, feat_mask [tpw, f] f32)``."""
        cfg = self.cfg
        nw, dev = self.mesh.num_workers, self.mesh.device
        x, y = np.asarray(x, np.float32), np.asarray(y, np.int32)
        if y.max() >= cfg.n_classes or y.min() < 0:
            raise ValueError(
                f"labels must be in [0, {cfg.n_classes}); got range "
                f"[{y.min()}, {y.max()}] — set RFConfig(n_classes=...)")
        n = (x.shape[0] // nw) * nw
        x, y = x[:n], y[:n]
        _exact_f32(dev)
        self.edges = quantile_bins(x, cfg.n_bins)
        bins = binize_chunked(x, self.edges)
        # bins < n_bins <= 256 ride as bytes (a quarter of K7's reads)
        bins = bins.astype(np.uint8) if cfg.n_bins <= 256 else bins
        weights, feat_mask = (torch.as_tensor(a).to(dev, torch.float32)
                              for a in draws)
        with telemetry.span("rf.fit", trees=cfg.n_trees), \
                telemetry.ledger.run("rf.fit"):
            trees = _train_trees(self.mesh.shard_array(bins, 0),
                                 self.mesh.shard_array(y.astype(np.int64), 0),
                                 weights, feat_mask, cfg)
            # Harp step: allgather the local trees -> the forest everywhere
            self.forest = tuple(a.cpu().numpy() for a in C.allgather(trees))
        return self

    def predict(self, x):
        if self.forest is None:
            raise RuntimeError("call fit() before predict()")
        dev = self.mesh.device
        bins = torch.from_numpy(binize(np.asarray(x, np.float32),
                                       self.edges)).to(dev)
        forest = tuple(torch.from_numpy(a).to(dev) for a in self.forest)
        return predict_forest(forest, bins, self.cfg.max_depth,
                              self.cfg.n_classes).cpu().numpy()

    def accuracy(self, x, y):
        return float((self.predict(x) == np.asarray(y)).mean())


def synthetic_classification(n=100_000, f=64, classes=2, seed=0):
    """Axis-aligned-structure task a depth-6 forest can learn."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    # XOR of two axis-aligned thresholds: exactly representable at depth 2,
    # invisible to any single split (so it actually tests tree growth)
    y = ((x[:, 0] > 0).astype(int) ^ (x[:, 1] > 0.5).astype(int)) % classes
    return x, y.astype(np.int32)


def benchmark(n=200_000, f=64, n_trees=32, max_depth=6, mesh=None, seed=0,
              hist_algo="dense", device=None):
    """Trees per second of one timed ``fit`` after an untimed one, the
    prediction time of 20,000 rows and their accuracy."""
    mesh = resolve_mesh(mesh, device)
    cfg = RFConfig(n_trees=n_trees, max_depth=max_depth, seed=seed,
                   hist_algo=hist_algo)
    x, y = synthetic_classification(n, f, seed=seed)
    model = RandomForest(cfg, mesh)
    model.fit(x, y)  # warmup: builds the kernel
    t0 = time.perf_counter()
    model.fit(x, y)
    fit_dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = model.accuracy(x[:20_000], y[:20_000])
    pred_dt = time.perf_counter() - t0
    return {
        "trees_per_sec": n_trees / fit_dt,
        "fit_sec": fit_dt,
        "predict_sec_20k": pred_dt,
        "train_acc": acc,
        "n": n, "features": f, "n_trees": n_trees, "depth": max_depth,
        "num_workers": mesh.num_workers, "hist_algo": hist_algo,
    }


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu random forest on PyTorch (edu.iu.rf parity)")
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--trees", type=int, default=32)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--hist-algo", choices=("dense", "scatter", "pallas"),
                   default="dense",
                   help="histogram arm (pallas = kernel K7); the same "
                        "counts on every arm")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    mesh = WorkerMesh(args.device)
    print(benchmark_json("rf_cli", benchmark(
        args.n, args.features, args.trees, args.depth, mesh=mesh,
        hist_algo=args.hist_algo), mesh.device))
    return 0


if __name__ == "__main__":
    main()
