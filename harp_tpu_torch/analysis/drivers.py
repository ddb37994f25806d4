"""Registered driver programs: the port of the part of
``harp_tpu.analysis.drivers`` that ``profile`` captures.

Each build function takes a ``device`` and returns ``(fn, args)``: one call of
``fn(*args)`` runs the app's program once at the reference's registered
shape and algo, on a one-worker group on ``device``
(``WorkerMesh(device)``), and ends in the readback the app's own loop
ends in.  The ``_pallas`` arms launch the port's kernels on the card (K7
for ``rf.grow_pallas``, K5 for ``svm.train_pallas``, K6 for
``wdamds.smacof_pallas``); the others take the paths the reference's
drivers take (the dense or XLA arm: plain torch on the card).

The eleven programs are those of ``profile``'s ``PROFILE_APPS``:
``kmeans.fit``, ``mfsgd.epoch``, ``lda.epoch``, ``rf.grow``,
``rf.grow_pallas``, ``svm.train``, ``svm.train_pallas``,
``wdamds.smacof``, ``wdamds.smacof_pallas``, ``subgraph.count`` and
``serve.kmeans_assign``.  The reference's other drivers and its
``PROTOCOLS`` feed its lint layers (the jaxpr checks, the CommGraph byte
sheets, the donation audit), which have no counterpart here yet:
``ring_attention``, ``serve.mfsgd_topk``, ``serve.lda_infer``,
``serve.mlp_predict``, ``serve.rf_predict``, ``serve.svm_predict``,
``rotate.pipeline_chunked``, ``ingest.accum_chunk``,
``ingest.finish_epoch``, ``elastic.regather``, ``kmeans.fit_hier`` and
the serve ``ContinuousRunner`` protocols wait for that slice.

Build functions import lazily and build on call: importing this module does
nothing.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

DRIVERS: dict[str, Callable[[Any], tuple[Callable, tuple[Any, ...]]]] = {}


def register_driver(name: str):
    def deco(build):
        DRIVERS[name] = build
        return build
    return deco


def _mesh(device):
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    return WorkerMesh(device)


@register_driver("kmeans.fit")
def _kmeans_fit(device):
    """The whole T-iteration Lloyd fit (k = 8, 2 iterations) on 16 points
    a worker of 32 features, f32 (the dense matmul path)."""
    from harp_tpu_torch.models import kmeans as KM

    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(16 * mesh.num_workers, 32)).astype(np.float32)

    def fit(points):
        return KM.fit(points, k=8, iters=2, mesh=mesh, seed=None)

    return fit, (pts,)


@register_driver("mfsgd.epoch")
def _mfsgd_epoch(device):
    """One rotation epoch of the dense MF-SGD (rank 4) on 8 × 16 users and
    items a worker, 64 ratings a worker."""
    from harp_tpu_torch.models.mfsgd import (MFSGD, MFSGDConfig,
                                             synthetic_ratings)

    mesh = _mesh(device)
    nw = mesh.num_workers
    users, items, vals = synthetic_ratings(8 * nw, 16 * nw, 64 * nw, rank=4)
    model = MFSGD(8 * nw, 16 * nw, MFSGDConfig(rank=4, algo="dense"),
                  mesh=mesh)
    model.set_ratings(users, items, vals)
    return model.train_epoch, ()


@register_driver("lda.epoch")
def _lda_epoch(device):
    """One Gibbs sweep of the dense tiled LDA (4 topics, 8 × 8 tiles,
    entries of 32) on 6 docs and 8 words a worker, 16 tokens a doc."""
    from harp_tpu_torch.models.lda import LDA, LDAConfig, synthetic_corpus

    mesh = _mesh(device)
    nw = mesh.num_workers
    d_ids, w_ids = synthetic_corpus(n_docs=6 * nw, vocab_size=8 * nw,
                                    n_topics_true=3, tokens_per_doc=16,
                                    seed=0)
    model = LDA(6 * nw, 8 * nw,
                LDAConfig(n_topics=4, algo="dense", d_tile=8, w_tile=8,
                          entry_cap=32), mesh, seed=0)
    model.set_tokens(d_ids, w_ids)
    return model.sample_epoch, ()


def _rf(device, hist_algo: str, n_features: int):
    from harp_tpu_torch.models.rf import RandomForest, RFConfig

    mesh = _mesh(device)
    nw = mesh.num_workers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16 * nw, n_features)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    cfg = RFConfig(n_trees=2 * nw, max_depth=2, n_bins=8, seed=0,
                   hist_algo=hist_algo)

    def grow(x, y):
        return RandomForest(cfg, mesh).fit(x, y).forest

    return grow, (x, y)


@register_driver("rf.grow")
def _rf_grow(device):
    """Forest growth (2 trees a worker, depth 2, 8 bins) on 16 rows a
    worker of 8 features: the dense histogram arm."""
    return _rf(device, "dense", 8)


@register_driver("rf.grow_pallas")
def _rf_grow_pallas(device):
    """The same growth on K7 (``hist_algo="pallas"``), at 16 features."""
    return _rf(device, "pallas", 16)


def _svm(device, algo: str):
    from harp_tpu_torch.models.svm import SVM, SVMConfig

    mesh = _mesh(device)
    n = 8 * mesh.num_workers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = np.where(x[:, 0] + 0.1 * rng.normal(size=n) > 0, 1.0, -1.0).astype(
        np.float32)
    cfg = SVMConfig(algo=algo, inner_steps=4, outer_rounds=2,
                    sv_per_worker=4)

    def train(x, y):
        return SVM(cfg, mesh).fit(x, y).w

    return train, (x, y)


@register_driver("svm.train")
def _svm_train(device):
    """The SVM outer loop (4 Pegasos steps × 2 rounds, 4 support vectors a
    worker) on 8 rows a worker of 16 features: the plain torch solve."""
    return _svm(device, "xla")


@register_driver("svm.train_pallas")
def _svm_train_pallas(device):
    """The same loop on K5 (``algo="pallas"``)."""
    return _svm(device, "pallas")


def _wdamds(device, algo: str, n: int):
    from harp_tpu_torch.models.wdamds import MDSConfig, mds

    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3))
    delta = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(
        np.float32)
    cfg = MDSConfig(algo=algo, dim=2, iters=2)

    def smacof(delta):
        return mds(delta, cfg, mesh, seed=0)

    return smacof, (delta,)


@register_driver("wdamds.smacof")
def _wdamds_smacof(device):
    """The unweighted SMACOF run (dim 2, 2 iterations) on 4 points a
    worker: the plain torch Guttman step."""
    return _wdamds(device, "xla", 4 * _mesh(device).num_workers)


@register_driver("wdamds.smacof_pallas")
def _wdamds_smacof_pallas(device):
    """The same run on K6 (``algo="pallas"``), on 16 points a worker."""
    return _wdamds(device, "pallas", 16 * _mesh(device).num_workers)


@register_driver("subgraph.count")
def _subgraph_count(device):
    """One color-coding count of the u3-path on 8 vertices a worker of
    degree 4 (max_degree 4: the exact segment tail takes the rest), one
    trial."""
    from harp_tpu_torch.models.subgraph import SubgraphConfig, count_template

    mesh = _mesh(device)
    n = 8 * mesh.num_workers
    rng = np.random.default_rng(0)
    edges = np.stack([rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)],
                     1)
    cfg = SubgraphConfig(template="u3-path", n_trials=1, trial_chunk=1,
                         max_degree=4, seed=0)

    def count(edges):
        return count_template(edges, n, cfg, mesh)[0]

    return count, (edges,)


@register_driver("serve.kmeans_assign")
def _serve_kmeans_assign(device):
    """The KMeans serving step (k = 8, d = 32) at the ladder's 8-row rung:
    the steady-state step the serve plane captures, run eagerly."""
    import torch

    from harp_tpu_torch.serve.engines import KMeansAssign

    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    eng = KMeansAssign(KMeansAssign.synthetic_state(rng, k=8, d=32), mesh)
    step = eng.step()
    x = torch.from_numpy(rng.normal(size=eng.input_shape(8)).astype(
        np.float32)).to(mesh.device)

    def assign(*args):
        return step(*args).cpu()

    return assign, (*eng.state_args(), x)
