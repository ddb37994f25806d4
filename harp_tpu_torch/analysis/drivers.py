"""Registered driver programs and host protocols: the port of
``harp_tpu.analysis.drivers``.

Each build function takes a ``device`` and returns ``(fn, args)``: one call of
``fn(*args)`` runs the program once at the reference's registered shape and
algo, on the worker group in use (one worker on ``device`` outside a
``torch.distributed`` world), and ends in the readback the app's own loop
ends in.  ``profile`` captures eleven of them (``profile.attribution.
PROFILE_APPS``); the wire audit (:mod:`harp_tpu_torch.analysis.commgraph`)
runs every one under its interceptor of ``torch.distributed``:

- ``kmeans.fit``, ``kmeans.fit_hier`` (the two-stage ``allreduce_hier``),
  ``mfsgd.epoch``, ``lda.epoch``, ``rf.grow``, ``rf.grow_pallas``,
  ``svm.train``, ``svm.train_pallas``, ``wdamds.smacof``,
  ``wdamds.smacof_pallas`` and ``subgraph.count``: the apps' programs (the
  ``_pallas`` arms launch K7, K5 and K6 on the card);
- ``ring_attention``: the K/V ring with its local online-softmax block;
- ``rotate.pipeline_chunked``: the chunked rotation epoch (two chunks);
- ``ingest.accum_chunk`` and ``ingest.finish_epoch``: the streaming
  KMeans chunk accumulate (collective-free by design) and its epoch tail
  (the one allreduce);
- ``collective.reshard`` and ``collective.reshard_wire``: the reshard
  verb's exact moves, and its chunked and int8 wires;
- ``elastic.regather``: the elastic row move;
- ``serve.kmeans_assign``, ``serve.mfsgd_topk``, ``serve.lda_infer``,
  ``serve.mlp_logits``, ``serve.rf_vote``, ``serve.svm_scores``: every
  serving engine's step at the ladder's 8-row rung, run eagerly.

Each program's inputs come from a seeded ``np.random.default_rng``, so a
test can feed the same arrays to the reference's program.

``PROTOCOLS`` registers host protocols for the staging audit (HL303): a
build function returns ``drive(audit)``, which wraps its staging executables
through ``audit.wrap`` and runs the real loop: the serve
``ContinuousRunner``'s depth-2 pipeline for KMeans and MF-SGD, its retry
path under injected dispatch faults, and an elastic restage after a
permanent worker loss.

Build functions import lazily and build on call: importing this module does
nothing.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh

DRIVERS: dict[str, Callable[[Any], tuple[Callable, tuple[Any, ...]]]] = {}

#: host protocols for the staging audit: name -> build(device) -> drive,
#: drive(commgraph.StagingAudit) -> None
PROTOCOLS: dict[str, Callable[[Any], Callable]] = {}


def register_driver(name: str):
    def deco(build):
        DRIVERS[name] = build
        return build
    return deco


def register_protocol(name: str):
    def deco(build):
        PROTOCOLS[name] = build
        return build
    return deco


def _mesh(device):
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


def _serve(device, app: str, state_kw: dict, **engine_kw):
    """An engine's step at the 8-row rung on a synthetic request of 8
    rows: ``(step, (*state, x))``, the step ending in the readback."""
    import torch

    from harp_tpu_torch.serve.engines import ENGINES

    cls = ENGINES[app]
    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    eng = cls(cls.synthetic_state(rng, **state_kw), mesh, **engine_kw)
    rows = eng.rows_from_request(eng.synthetic_request(rng, 8))
    x = torch.from_numpy(eng.make_input(rows, 8)).to(mesh.device)
    step = eng.step()

    def serve_step(*args):
        return step(*args).cpu()

    return serve_step, (*eng.state_args(), x)


@register_driver("serve.mfsgd_topk")
def _serve_mfsgd_topk(device):
    """The sharded-H top-4 recommendation step (16 users and 8 items a
    worker, rank 8): a local top-k, then one allgather merge."""
    from harp_tpu_torch.parallel.mesh import num_workers

    nw = num_workers()
    return _serve(device, "mfsgd", {"n_users": 16 * nw, "n_items": 8 * nw,
                                    "rank": 8}, topk=4)


@register_driver("serve.lda_infer")
def _serve_lda_infer(device):
    """The LDA fold-in step (64 words, 8 topics, 4 EM iterations): the one
    engine with a loop on the device, collective-free at every trip."""
    return _serve(device, "lda", {"vocab_size": 64, "n_topics": 8},
                  em_iters=4)


@register_driver("serve.mlp_logits")
def _serve_mlp_logits(device):
    """The MLP forward (32 → 16 → 4) through models/mlp.forward."""
    return _serve(device, "mlp", {"sizes": (32, 16, 4)})


@register_driver("serve.rf_vote")
def _serve_rf_vote(device):
    """Majority-vote routing of a 4-tree forest of depth 3 on 8 features."""
    return _serve(device, "rf", {"n_trees": 4, "max_depth": 3,
                                 "n_features": 8})


@register_driver("serve.svm_scores")
def _serve_svm_scores(device):
    """The linear decision function at d = 32."""
    return _serve(device, "svm", {"d": 32})


@register_driver("kmeans.fit_hier")
def _kmeans_fit_hier(device):
    """The fit of ``kmeans.fit`` on the two-stage ``allreduce_hier``
    schedule (``psum_schedule="hier"``): both stages on the sheet."""
    from harp_tpu_torch.models import kmeans as KM

    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(16 * mesh.num_workers, 32)).astype(np.float32)

    def fit(points):
        return KM.fit(points, k=8, iters=2, mesh=mesh, seed=None,
                      psum_schedule="hier")

    return fit, (pts,)


@register_driver("ring_attention")
def _ring_attention(device):
    """Causal ring attention on [2, 8 a worker, 4 heads, 16] f32: each
    step rotates K and V one worker on and folds the resident block into
    the online softmax; the output is pulled whole."""
    from harp_tpu_torch.ops.ring_attention import make_ring_attention_fn

    mesh = _mesh(device)
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 8 * mesh.num_workers, 4, 16)).astype(
        np.float32) for _ in range(3))
    fn = make_ring_attention_fn(mesh, causal=True)

    def attend(q, k, v):
        return fn(q, k, v).cpu()

    return attend, (q, k, v)


@register_driver("rotate.pipeline_chunked")
def _rotate_pipeline_chunked(device):
    """The chunked rotation epoch (two chunks) with a step that updates
    each chunk, on 8 rows a worker of 16: the ring traffic is two hops a
    step, the payload the updated chunk."""
    from harp_tpu_torch.parallel.rotate import rotate_pipeline

    mesh = _mesh(device)
    nw = mesh.num_workers
    rng = np.random.default_rng(0)
    acc = np.zeros(nw, np.float32)
    sl = rng.normal(size=(8 * nw, 16)).astype(np.float32)

    def step(c, chunk, t):
        return c + chunk.sum(), chunk * 1.01

    def epoch(acc, sl):
        with use_mesh(mesh):
            c, out = rotate_pipeline(step, mesh.shard_array(acc, 0),
                                     mesh.shard_array(sl, 0), n_chunks=2)
        return c.cpu(), out.cpu()

    return epoch, (acc, sl)


def _ingest_inputs(mesh) -> dict:
    """A chunk of 8 points a worker (d = 16), k = 8 centroids and this
    worker's running partials."""
    nw = mesh.num_workers
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(8 * nw, 16)).astype(np.float32)
    return {"pts": pts, "cents": pts[:8].copy(),
            "sums": rng.normal(size=(8, 16)).astype(np.float32),
            "counts": rng.integers(0, 4, 8).astype(np.float32),
            "inertia": np.float32(rng.uniform(0, 10))}


@register_driver("ingest.accum_chunk")
def _ingest_accum_chunk(device):
    """The per-chunk accumulate every pipeline-shipped streaming KMeans
    chunk rides: this worker's partials added to its running sums, with no
    collective (the epoch tail carries the one allreduce); registering it
    pins that emptiness on the sheet."""
    import torch

    from harp_tpu_torch.models.kmeans import chunk_partials, epoch_operands

    mesh = _mesh(device)
    inp = _ingest_inputs(mesh)
    dev = mesh.device

    def accum(pts, cents, sums, counts, inertia):
        x = mesh.shard_array(pts, 0)
        s, c, i = chunk_partials(x, epoch_operands(
            torch.from_numpy(cents).to(dev)))
        return ((torch.from_numpy(sums).to(dev) + s).cpu(),
                (torch.from_numpy(counts).to(dev) + c).cpu(),
                (torch.tensor(float(inertia), device=dev) + i).cpu())

    return accum, (inp["pts"], inp["cents"], inp["sums"], inp["counts"],
                   inp["inertia"])


@register_driver("ingest.finish_epoch")
def _ingest_finish_epoch(device):
    """The streaming epoch tail: the one allreduce of the partials, then
    the new centroids (an empty cluster keeps its old one)."""
    import torch

    from harp_tpu_torch.models.kmeans import _normalize_centroids
    from harp_tpu_torch.parallel import collective as C

    mesh = _mesh(device)
    inp = _ingest_inputs(mesh)
    dev = mesh.device

    def finish(sums, counts, inertia, cents):
        t = [torch.as_tensor(a).to(dev) for a in (sums, counts, inertia,
                                                    cents)]
        with use_mesh(mesh):
            s, c, i = C.allreduce((t[0], t[1], t[2]))
        return _normalize_centroids(s, c, t[3]).cpu(), i.cpu()

    return finish, (inp["sums"], inp["counts"], inp["inertia"],
                    inp["cents"])


@register_driver("collective.reshard")
def _collective_reshard(device):
    """The reshard verb's exact moves in one program on [8 a worker, nw]
    f32: a ring rotation, a dim change, a replication, and the local slice
    back (wire-free: its absence from the sheet pins that a replicated to
    blocked move costs nothing)."""
    from harp_tpu_torch.parallel.collective import ShardSpec, reshard

    mesh = _mesh(device)
    nw = mesh.num_workers
    x = np.random.default_rng(0).normal(size=(8 * nw, nw)).astype(
        np.float32)
    B, R = ShardSpec.blocked, ShardSpec.replicated

    def prog(x):
        with use_mesh(mesh):
            xb = mesh.shard_array(x, 0)
            rot = reshard(xb, B(0), B(0, 1))
            swap = reshard(xb, B(0), B(1))
            full = reshard(xb, B(0), R())
            back = reshard(full, R(), B(0))
        return rot.cpu(), swap.cpu(), full.sum().cpu(), back.cpu()

    return prog, (x,)


@register_driver("collective.reshard_wire")
def _collective_reshard_wire(device):
    """The reshard verb's other wires on [8 a worker, 16] f32: the chunked
    ring hop (two chunks) and the int8 wire (its scale exchange and the
    narrow hop; the ledger's wire_dtype exempts it from the byte check)."""
    from harp_tpu_torch.parallel.collective import ShardSpec, reshard

    mesh = _mesh(device)
    nw = mesh.num_workers
    x = np.random.default_rng(0).normal(size=(8 * nw, 16)).astype(
        np.float32)
    B = ShardSpec.blocked

    def prog(x):
        with use_mesh(mesh):
            xb = mesh.shard_array(x, 0)
            chunked = reshard(xb, B(0), B(0, 1), n_chunks=2)
            narrow = reshard(xb, B(0), B(0, 2), wire="int8")
        return chunked.cpu(), narrow.cpu()

    return prog, (x,)


@register_driver("elastic.regather")
def _elastic_regather(device):
    """The elastic row move on [8 a worker, 16] f32: one replication over
    the reshard verb, then a wire-free local gather of this worker's new
    rows (the new layout reverses the rows and pads the last worker's
    final slot)."""
    from harp_tpu_torch.elastic.move import regather_rows

    mesh = _mesh(device)
    nw = mesh.num_workers
    x = np.random.default_rng(0).normal(size=(8 * nw, 16)).astype(
        np.float32)
    rows = np.arange(8 * nw)[::-1].copy()
    rows[-1] = -1

    def move(x, rows):
        return regather_rows(mesh, mesh.shard_array(x, 0), rows).cpu()

    return move, (x, rows)


# ---------------------------------------------------------------------------
# Staging-audit protocols (the wire layer's HL303)
# ---------------------------------------------------------------------------

def _serve_continuous_drive(device, app: str, state_kw: dict,
                            req_rows: int):
    """The real ContinuousRunner depth-2 pipeline for one app under a
    StagingAudit: synthetic state, a two-rung ladder, six requests
    interleaved with steps so that batches overlap in flight.  The
    pipeline's discipline (a fresh staging a batch, a buffer set written
    only once its batch was read back) must come out clean."""

    def drive(audit):
        from harp_tpu_torch.serve.engines import ENGINES
        from harp_tpu_torch.serve.server import Server

        rng = np.random.default_rng(0)
        srv = Server(app, state=ENGINES[app].synthetic_state(rng, **state_kw),
                     mesh=_mesh(device), ladder=(1, 8))
        srv.startup()
        audit.watch_server(srv)
        runner = srv.make_runner(depth=2)
        for i in range(6):
            runner.submit(i, srv.engine.synthetic_request(rng, req_rows))
            runner.step()
        runner.drain()
        assert runner.completed == 6, "the pipeline lost responses"

    return drive


@register_protocol("serve.kmeans_continuous")
def _serve_kmeans_protocol(device):
    return _serve_continuous_drive(device, "kmeans", {"k": 8, "d": 32},
                                   req_rows=3)


@register_protocol("serve.mfsgd_continuous")
def _serve_mfsgd_protocol(device):
    """The model-parallel engine (sharded H, a staged user-id batch)."""
    return _serve_continuous_drive(
        device, "mfsgd", {"n_users": 64, "n_items": 32, "rank": 8},
        req_rows=3)


@register_protocol("serve.retry_restage")
def _serve_retry_restage_protocol(device):
    """The retry path: a seeded FaultInjector fails the second dispatch and
    the ContinuousRunner retries the batch through a freshly staged
    buffer, never the failed attempt's.  The drive asserts the fault fired
    and was retried, so a refactor that unhooks the injector fails the
    lint instead of passing vacuously."""

    def drive(audit):
        from harp_tpu_torch.serve.engines import KMeansAssign
        from harp_tpu_torch.serve.server import Server
        from harp_tpu_torch.utils.fault import FaultInjector

        rng = np.random.default_rng(0)
        srv = Server("kmeans",
                     state=KMeansAssign.synthetic_state(rng, k=8, d=32),
                     mesh=_mesh(device), ladder=(1, 8))
        srv.startup()
        audit.watch_server(srv)
        runner = srv.make_runner(depth=2, max_retries=2)
        inj = FaultInjector(seed=0, fail={"dispatch": (2,)})
        with inj.arm():
            for i in range(6):
                runner.submit(i, srv.engine.synthetic_request(rng, 3))
                runner.step()
            runner.drain()
        assert inj.injected["dispatch"] == 1, "no fault fired: vacuous"
        assert runner.fault_retries == 1, "fault fired but no retry ran"
        assert runner.completed == 6, "retry path lost responses"

    return drive


def elastic_step(audit, tag: str):
    """The elastic protocol's step: ``(carry, x) -> (carry + Σx, 2x)``,
    tracked as one dispatch and wrapped by the audit (``x``, argument 1,
    is the staged batch)."""
    from harp_tpu_torch.utils import flightrec

    def step(c, x):
        return c + x.sum(), x * 2.0

    return audit.wrap(flightrec.track(step, tag), (1,), tag)


@register_protocol("elastic.rebalance_restage")
def _elastic_rebalance_restage_protocol(device):
    """The restage after a permanent worker loss: a host loop stages a
    fresh batch a dispatch; an injected permanent loss kills the second
    dispatch, the loop moves to the surviving world, rebuilds its step
    there and restages every later batch from host data (the pre-loss
    buffer lives in the old world).  On one worker the surviving world is
    the group rebuilt on the same card, as a restart from a checkpoint
    makes it.  The drive asserts the loss fired and the survivors ran."""

    def drive(audit):
        import torch

        from harp_tpu_torch.utils.fault import (FaultInjector,
                                                PermanentWorkerLoss)

        mesh = _mesh(device)
        audit.set_world(mesh)
        step = elastic_step(audit, "elastic.step_full")
        carry = torch.zeros((), device=mesh.device)
        rng = np.random.default_rng(0)
        # 12 rows a worker: they divide over the world and over any world
        # one worker smaller
        nw = mesh.num_workers
        batches = [rng.normal(size=(12 * nw * max(nw - 1, 1), 4)).astype(
            np.float32) for _ in range(4)]
        inj = FaultInjector(seed=0, permanent={"dispatch": (2,)},
                            lost_worker=nw - 1)
        survived = False
        with inj.arm():
            try:
                for b in batches[:2]:
                    staged = audit.staged(mesh.shard_array(b, 0))
                    carry, _ = step(carry, staged)
            except PermanentWorkerLoss as e:
                surv = (mesh.survivors(e.worker) if nw > 1
                        else WorkerMesh(mesh.device))
                if surv.is_member:
                    audit.set_world(surv)
                    step2 = elastic_step(audit, "elastic.step_surv")
                    carry = torch.tensor(float(carry), device=surv.device)
                    for b in batches[2:]:
                        staged = audit.staged(surv.shard_array(b, 0))
                        carry, _ = step2(carry, staged)
                survived = True
        assert inj.permanent_fired, "no permanent loss fired: vacuous"
        assert survived, "the loss fired but the survivor loop never ran"

    return drive
