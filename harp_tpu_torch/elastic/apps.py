"""Elastic training adapters: MF-SGD, LDA and streaming KMeans on the
elastic loop — the port of ``harp_tpu.elastic.apps``.

Each adapter owns the original corpus, the pack structure
(:class:`~harp_tpu_torch.elastic.rebalance.Packs` over the app's partition
key: users, docs or point rows), the current pack → worker assignment and
the live model, and knows how to

- run one superstep (``train_one``: the model's own epoch loop, with
  the pack grains on the skew execution record, so the sentinel's trigger
  plan moves whole packs).  MF-SGD's default algo runs kernel K3, LDA's
  kernel K4; streaming KMeans is f32 through ``kmeans.chunk_partials``;
- apply a new assignment mid-run (``apply_assignment``: MF-SGD's W rows
  move over the ``reshard`` verb, :func:`harp_tpu_torch.elastic.move.
  regather_rows`; LDA's count tables are rebuilt exactly from the chain
  state, the (doc, word, topic) token multiset);
- round-trip a canonical, mesh-independent checkpoint state
  (``canonical_state`` / ``install``: external-id numpy arrays plus the
  pack assignment), so a checkpoint restores onto any survivor mesh.
  ``install`` is a deterministic function of (state, mesh): the elastic
  resume is bit-equal to a survivors-only run from the same checkpoint.

:func:`elastic_fit` is the shared superstep loop: train, take a latched
``skew_trigger`` (``maybe_rebalance``), checkpoint the canonical state.
A worker loss rides ``run_with_recovery``'s ``on_permanent`` hook
(:meth:`ElasticAdapter.shrink`): the mesh becomes the survivors' process
group (:meth:`~harp_tpu_torch.parallel.mesh.WorkerMesh.survivors`), the
lost worker leaves the loop (:attr:`ElasticAdapter.sat_out`), and the
survivors' next restore replays the repartition plan.  Every adapter
method runs its collectives on the adapter's mesh.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any

import numpy as np
import torch

from harp_tpu_torch.elastic import ledger as eledger
from harp_tpu_torch.elastic import move
from harp_tpu_torch.elastic.rebalance import (IdRemap, Packs, maybe_rebalance,
                                              pack_units, replay_repartition,
                                              wasted_frac, worker_loads)
from harp_tpu_torch.parallel.mesh import (WorkerMesh, mesh_in_use,
                                          resolve_mesh, set_mesh, use_mesh)
from harp_tpu_torch.utils.fault import PermanentWorkerLoss, run_with_recovery


class SatOut(Exception):
    """Raised on the lost worker by :meth:`ElasticAdapter.shrink`: it is not
    a member of the survivors' mesh and leaves the run."""


def _on_mesh(method):
    """Run an adapter method with the adapter's mesh in use (the verbs and
    the checkpoint manager read its process group)."""
    @functools.wraps(method)
    def wrapped(self, *args, **kw):
        with use_mesh(self.mesh):
            return method(self, *args, **kw)

    return wrapped


class ElasticAdapter:
    """Shared pack/assignment/mesh state machine (see module doc)."""

    phase = "elastic"

    def __init__(self, mesh: WorkerMesh, packs: Packs, loads,
                 max_worker_loss: int = 1):
        self.mesh = mesh
        self.packs = packs
        self.loads = np.asarray(loads, np.float64)
        self.assignment = packs.home_assignment()
        self.max_worker_loss = int(max_worker_loss)
        self.losses = 0
        self.sat_out = False
        self._live: Any = None
        self._stale = False

    # -- the trigger's view ------------------------------------------------
    def worker_loads(self) -> np.ndarray:
        return worker_loads(self.assignment, self.loads,
                            self.mesh.num_workers)

    def pack_units(self) -> list[list[tuple]]:
        return pack_units(self.assignment, self.loads,
                          self.mesh.num_workers)

    def apply_assignment(self, assignment) -> None:  # subclass hook
        raise NotImplementedError

    # -- loss + resume -----------------------------------------------------
    def shrink(self, e: PermanentWorkerLoss) -> None:
        """``run_with_recovery``'s ``on_permanent`` hook: drop the lost
        worker, within the loss budget; the survivors' next ``install``
        (the restore at the top of the recovery loop) replays the
        repartition plan.  Every worker of the mesh calls it; on the lost
        one it raises :class:`SatOut`."""
        self.losses += 1
        if self.losses > self.max_worker_loss:
            raise e  # loss budget exhausted: fail loudly, not elastically
        old = self.mesh
        nb = old.num_workers
        self.mesh = old.survivors(e.worker)
        if mesh_in_use() is old:
            set_mesh(self.mesh)
        self._stale = True
        eledger.record(
            "shrink", self.phase, lost_worker=int(e.worker),
            site=e.site, ordinal=int(e.ordinal),
            n_workers_before=nb, n_workers_after=nb - 1,
            capacity_frac=round((nb - 1) / nb, 6))
        if not self.mesh.is_member:
            self.sat_out = True
            raise SatOut(f"worker {e.worker} left the run")

    @_on_mesh
    def install(self, state) -> None:
        """Restore a canonical checkpoint state onto the current mesh.

        A no-op when ``state`` is this adapter's own live state and no
        shrink intervened.  A checkpoint written on a different number of
        workers replays the whole-unit repartition plan over the survivors
        (:func:`replay_repartition`, deterministic); a same-size restore
        reuses the stored assignment, so a transient restart reproduces
        the layout from before the crash."""
        if state is self._live and not self._stale:
            return
        n = self.mesh.num_workers
        # the pack grid is canonical state too: an adapter made on a
        # survivor mesh would otherwise derive another grain and layout
        grid = tuple(int(x) for x in np.asarray(state["pack_grid"]))
        if grid != (self.packs.n_ids, self.packs.n_home,
                    self.packs.per_worker):
            self.packs = Packs(*grid)
            self.loads = self._pack_loads()
        asg = np.asarray(state["assignment"], np.int64)
        shrunk = int(state["n_workers"]) != n
        if shrunk:
            asg, _ = replay_repartition(self.packs, self.loads, asg, n,
                                        self.phase)
        self.assignment = asg
        self._rebuild(state)
        lw = self.worker_loads()
        step = state.get("step")
        eledger.record(
            "resume", self.phase, n_workers=n,
            from_step=None if step is None else int(step),
            loads=[round(float(x), 4) for x in lw],
            total=round(float(lw.sum()), 4),
            wasted_frac=round(wasted_frac(lw), 4),
            replayed_plan=bool(shrunk))
        self._stale = False
        self._live = state

    @_on_mesh
    def canonical_state(self) -> dict:
        st = self._extract()
        st["assignment"] = np.asarray(self.assignment, np.int64)
        st["n_workers"] = self.mesh.num_workers
        st["pack_grid"] = np.asarray(
            [self.packs.n_ids, self.packs.n_home, self.packs.per_worker],
            np.int64)
        self._live = st
        return st

    def _remap(self) -> IdRemap:
        return IdRemap(self.packs, self.assignment, self.mesh.num_workers)

    def _pack_loads(self) -> np.ndarray:  # subclass hook
        raise NotImplementedError

    def _extract(self) -> dict:  # subclass hook
        raise NotImplementedError

    def _rebuild(self, state) -> None:  # subclass hook
        raise NotImplementedError

    def train_one(self) -> None:  # subclass hook
        raise NotImplementedError


# ---------------------------------------------------------------------------
# MF-SGD
# ---------------------------------------------------------------------------

def _user_storage_rows(model, ext_ids) -> np.ndarray:
    """External user id → W storage row (the dense algos pad each worker's
    range to a tile multiple; for scatter ``u_own == u_bound``)."""
    g = np.asarray(ext_ids, np.int64)
    return (g // model.u_own) * model.u_bound + g % model.u_own


def _item_storage(model, H_ext: np.ndarray) -> np.ndarray:
    """External item table → H storage layout (padding per rotation
    chunk, the inverse of ``MFSGD.factors``' strip)."""
    from harp_tpu_torch.models.mfsgd import rotate_chunks_resolved

    nc = rotate_chunks_resolved(model.cfg)
    ibc = model.i_bound // nc
    n = model.mesh.num_workers
    out = np.zeros((model.i_bound * n, H_ext.shape[1]), np.float32)
    g = np.arange(model.n_items, dtype=np.int64)
    out[(g // model.i_own) * ibc + g % model.i_own] = H_ext
    return out


class MFSGDElastic(ElasticAdapter):
    """MF-SGD on the elastic loop: packs over user ids, loads = rating
    counts; W rows move over the reshard verb."""

    phase = "mfsgd.epochs"

    def __init__(self, n_users, n_items, cfg=None, mesh=None, seed=0, *,
                 users, items, vals, packs_per_worker: int = 4,
                 max_worker_loss: int = 1, device=None):
        from harp_tpu_torch.models.mfsgd import MFSGDConfig

        mesh = resolve_mesh(mesh, device)
        self.users = np.asarray(users, np.int64)
        self.items = np.asarray(items, np.int64)
        self.vals = np.asarray(vals, np.float32)
        self.n_items = int(n_items)
        self.cfg = cfg or MFSGDConfig()
        self.seed = seed
        self.model = None
        self._layout = None
        packs = Packs(int(n_users), mesh.num_workers, packs_per_worker)
        super().__init__(mesh, packs, packs.loads(self.users),
                         max_worker_loss=max_worker_loss)
        with use_mesh(self.mesh):
            self._rebuild(None)

    def _make_model(self, remap: IdRemap):
        from harp_tpu_torch.models.mfsgd import MFSGD

        model = MFSGD(remap.new_n, self.n_items, self.cfg, self.mesh,
                      self.seed)
        model.set_ratings(remap.fwd[self.users], self.items, self.vals)
        model.skew_units = self.pack_units()
        return model

    def _rebuild(self, state) -> None:
        layout = (self.mesh.group, self.assignment.tobytes())
        remap = self._remap()
        if self.model is not None and layout == self._layout:
            model = self.model  # same layout: keep the partitioned ratings
        else:
            model = self._make_model(remap)
        if state is not None:
            r = self.cfg.rank
            n = self.mesh.num_workers
            W_ext = np.zeros((remap.new_n, r), np.float32)
            W_ext[remap.fwd] = np.asarray(state["W"], np.float32)
            W_store = np.zeros((model.u_bound * n, r), np.float32)
            g = np.arange(remap.new_n, dtype=np.int64)
            W_store[_user_storage_rows(model, g)] = W_ext
            model.W = self.mesh.shard_array(W_store, 0)
            model.H = self.mesh.shard_array(
                _item_storage(model, np.asarray(state["H"], np.float32)), 0)
        self.model, self.remap, self._layout = model, remap, layout

    @_on_mesh
    def apply_assignment(self, assignment) -> None:
        """A move on the same mesh: W rows travel over the reshard verb
        (one all-gather); the item slices do not move, so H is kept, and
        only the rating layout repacks on the host."""
        old_model, old_remap = self.model, self.remap
        self.assignment = np.asarray(assignment, np.int64)
        remap = self._remap()
        model = self._make_model(remap)
        n = self.mesh.num_workers
        orig = np.arange(self.packs.n_ids, dtype=np.int64)
        rows = np.full(model.u_bound * n, -1, np.int64)
        rows[_user_storage_rows(model, remap.fwd[orig])] = \
            _user_storage_rows(old_model, old_remap.fwd[orig])
        model.W = move.regather_rows(self.mesh, old_model.W, rows)
        model.H = old_model.H  # the item layout is unchanged: no wire
        self.model, self.remap = model, remap
        self._layout = (self.mesh.group, self.assignment.tobytes())

    def _pack_loads(self) -> np.ndarray:
        return self.packs.loads(self.users)

    def _extract(self) -> dict:
        W_pad, H = self.model.factors()
        return {"W": np.asarray(W_pad)[self.remap.fwd].copy(),
                "H": np.asarray(H).copy()}

    @_on_mesh
    def train_one(self) -> None:
        self.last_rmse = self.model.train_epoch()

    @_on_mesh
    def metric(self) -> float:
        """Training RMSE in the original id space."""
        return self.model.predict_rmse(self.remap.fwd[self.users],
                                       self.items, self.vals)


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

def _next_key_seed(seed: int) -> int:
    return (seed * 0x9E3779B1 + 0x5851) % (1 << 31)


class LDAElastic(ElasticAdapter):
    """LDA-CGS on the elastic loop: packs over doc ids, loads = token
    counts.  The chain state is the (doc, word, topic) token multiset and
    the key seed; the count tables derive exactly from it, so a
    repartition keeps the chain bit for bit at the move."""

    phase = "lda.epochs"

    def __init__(self, n_docs, vocab_size, cfg=None, mesh=None, seed=0, *,
                 doc_ids, word_ids, packs_per_worker: int = 4,
                 max_worker_loss: int = 1, device=None):
        from harp_tpu_torch.models.lda import LDAConfig

        mesh = resolve_mesh(mesh, device)
        self.doc_ids = np.asarray(doc_ids, np.int64)
        self.word_ids = np.asarray(word_ids, np.int64)
        self.vocab_size = int(vocab_size)
        self.cfg = cfg or LDAConfig()
        self.seed = seed
        self.key_seed = int(seed)
        packs = Packs(int(n_docs), mesh.num_workers, packs_per_worker)
        super().__init__(mesh, packs, packs.loads(self.doc_ids),
                         max_worker_loss=max_worker_loss)
        with use_mesh(self.mesh):
            self._rebuild(None)

    def _build_model(self, remap: IdRemap, d, w, z):
        from harp_tpu_torch.models.lda import LDA

        model = LDA(remap.new_n, self.vocab_size, self.cfg, self.mesh,
                    self.seed)
        model._install_pack(model.pack_tokens(remap.fwd[np.asarray(d)],
                                              np.asarray(w), z0=z))
        model.skew_units = self.pack_units()
        return model

    def _rebuild(self, state) -> None:
        remap = self._remap()
        if state is None:
            d, w, z = self.doc_ids, self.word_ids, None
        else:
            d, w, z = state["d"], state["w"], state["z"]
            self.key_seed = int(state["key_seed"])
        self.model = self._build_model(remap, d, w, z)
        self.remap = remap

    def _triples(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The chain state in the original doc-id space."""
        d_ext, w_ext, z = self.model.token_state()
        return self.remap.inv[d_ext], w_ext, z

    @_on_mesh
    def apply_assignment(self, assignment) -> None:
        d, w, z = self._triples()
        self.assignment = np.asarray(assignment, np.int64)
        remap = self._remap()
        self.model = self._build_model(remap, d, w, z)
        self.remap = remap

    def _pack_loads(self) -> np.ndarray:
        return self.packs.loads(self.doc_ids)

    def _extract(self) -> dict:
        d, w, z = self._triples()
        return {"d": d, "w": w, "z": z, "key_seed": self.key_seed}

    @_on_mesh
    def train_one(self) -> None:
        # the generator restarts from the adapter's own seed chain, so the
        # canonical state fixes the next sweep on any mesh
        self.model._gen.manual_seed(self.key_seed * 65_537 + self.mesh.rank)
        self.model.sample_epoch()
        self.key_seed = _next_key_seed(self.key_seed)

    @_on_mesh
    def metric(self) -> float:
        return self.model.log_likelihood()


# ---------------------------------------------------------------------------
# streaming KMeans
# ---------------------------------------------------------------------------

class KMeansStreamElastic(ElasticAdapter):
    """Streaming KMeans's Lloyd epoch on the elastic loop: packs over point
    rows, loads = rows a pack.  Each worker holds the rows its packs own
    (no pad rows: a remapped layout's pads own no point) and streams them
    through ``kmeans.chunk_partials`` (f32) in pieces of ``chunk_rows``;
    the centroids are replicated, so the canonical state is
    mesh-independent and a repartition moves only the points."""

    phase = "kmeans_stream.epochs"

    def __init__(self, points, k: int, mesh=None, seed=0, *,
                 packs_per_worker: int = 4, max_worker_loss: int = 1,
                 chunk_rows: int = 262_144, device=None):
        from harp_tpu_torch.models.kmeans_stream import _init_centroids

        mesh = resolve_mesh(mesh, device)
        self.points = np.asarray(points, np.float32)
        self.k = int(k)
        self.chunk_rows = int(chunk_rows)
        n_pts = self.points.shape[0]
        packs = Packs(n_pts, mesh.num_workers, packs_per_worker)
        super().__init__(mesh, packs, packs.widths().astype(np.float64),
                         max_worker_loss=max_worker_loss)
        self.centroids = np.asarray(
            _init_centroids(self.points, n_pts, self.k, seed, "random"),
            np.float32)
        self.inertia = float("nan")
        self._pts = None
        self._layout = None
        with use_mesh(self.mesh):
            self._rebuild(None)

    def _rebuild(self, state) -> None:
        from harp_tpu_torch.utils import flightrec

        if state is not None:
            self.centroids = np.asarray(state["centroids"], np.float32)
        layout = (self.mesh.group, self.assignment.tobytes())
        if layout != self._layout:
            remap = self._remap()
            lo = self.mesh.rank * remap.bound
            rows = remap.inv[lo:lo + remap.bound]
            mine = np.ascontiguousarray(self.points[rows[rows >= 0]])
            flightrec.record_h2d(mine.nbytes)
            self._pts = torch.from_numpy(mine).to(self.mesh.device)
            self.remap, self._layout = remap, layout
        self._units = self.pack_units()

    @_on_mesh
    def apply_assignment(self, assignment) -> None:
        self.assignment = np.asarray(assignment, np.int64)
        self._rebuild({"centroids": self.centroids})

    def _pack_loads(self) -> np.ndarray:
        return self.packs.widths().astype(np.float64)

    def _extract(self) -> dict:
        return {"centroids": self.centroids.copy()}

    def _epoch(self, cents: torch.Tensor):
        """This worker's partials over its rows, combined over the group:
        (new centroids, inertia)."""
        from harp_tpu_torch.models.kmeans import (_normalize_centroids,
                                                  chunk_partials,
                                                  epoch_operands)
        from harp_tpu_torch.parallel import collective as C

        k, d = cents.shape
        dev = cents.device
        sums = torch.zeros((k, d), device=dev)
        counts = torch.zeros((k,), device=dev)
        inertia = torch.zeros((), device=dev)
        ops = epoch_operands(cents)
        for lo in range(0, max(self._pts.shape[0], 1), self.chunk_rows):
            s, c, i = chunk_partials(self._pts[lo:lo + self.chunk_rows], ops)
            sums += s
            counts += c
            inertia += i
        s, c, ep = C.allreduce((sums, counts, inertia))
        return _normalize_centroids(s, c, cents), ep

    @_on_mesh
    def train_one(self) -> None:
        from harp_tpu_torch.utils import flightrec, skew, telemetry

        epoch = flightrec.track(self._epoch, "kmeans_stream.epoch")
        with telemetry.span("kmeans_stream.epoch"), \
                telemetry.ledger.run(self.phase, steps=1):
            t0 = time.perf_counter()
            cents = self.mesh.replicated(self.centroids)
            new_c, ep = epoch(cents)
            # one readback: the inertia and the new centroids
            st = flightrec.readback(torch.cat([ep.reshape(1),
                                               new_c.reshape(-1)]))
            self.inertia = float(st[0])
            self.centroids = st[1:].reshape(self.k, -1).astype(np.float32)
            skew.record_execution(
                self.phase, self.worker_loads(), unit="points",
                wall_s=time.perf_counter() - t0, units=self._units)

    def metric(self) -> float:
        return self.inertia


# ---------------------------------------------------------------------------
# The shared superstep loop
# ---------------------------------------------------------------------------

def elastic_fit(adapter: ElasticAdapter, epochs: int,
                ckpt_dir: str | None = None, *, ckpt_every: int = 1,
                max_restarts: int = 3, fault=None,
                rebalance: bool = True) -> ElasticAdapter:
    """Run ``epochs`` supersteps elastically (see module doc).

    A mid-run rebalance needs no checkpoints (taking the trigger is host
    work between supersteps); surviving a
    :class:`~harp_tpu_torch.utils.fault.PermanentWorkerLoss` needs
    ``ckpt_dir`` (the survivors resume from the last checkpoint; a
    ``fault`` without one is refused, the ``fit_epochs`` contract).
    Checkpoints hold the adapter's canonical state, written once by worker
    0 of the mesh (``CheckpointManager(replicated=True)``), so they restore
    on any number of workers.  On the lost worker the call returns with
    ``adapter.sat_out`` set and its mesh outside the survivors' group."""
    from harp_tpu_torch.utils import steptrace

    def sweep():
        adapter.train_one()
        if rebalance:
            with use_mesh(adapter.mesh):
                maybe_rebalance(adapter)

    arm = fault.arm() if fault is not None else contextlib.nullcontext()
    if ckpt_dir is None:
        if fault is not None:
            raise ValueError(
                "fault injection requires ckpt_dir (recovery restarts "
                "from checkpoints; without one the injector would be "
                "silently ignored)")
        with arm, steptrace.run(adapter.phase):
            for i in range(epochs):
                with steptrace.superstep(adapter.phase, i):
                    sweep()
        return adapter

    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir, replicated=True)

    def step(i, state):
        # install() stays outside the span: a real restore records its
        # "resume" row there, which flags the next span "resumed"
        adapter.install(state)
        with steptrace.superstep(adapter.phase, i):
            sweep()
        st = adapter.canonical_state()
        st["step"] = i
        return st

    # the checkpoint manager's barriers run on the mesh in use, which
    # shrink() moves to the survivors
    with use_mesh(adapter.mesh), arm, steptrace.run(adapter.phase):
        try:
            run_with_recovery(adapter.canonical_state, step, epochs, mgr,
                              ckpt_every=ckpt_every,
                              max_restarts=max_restarts, fault=fault,
                              on_permanent=adapter.shrink)
        except SatOut:
            pass  # this worker was lost: the survivors train on
    return adapter


# ---------------------------------------------------------------------------
# CLI fit entries (the --elastic / --max-worker-loss knobs route here)
# ---------------------------------------------------------------------------

def mfsgd_elastic_fit(users, items, vals, *, n_users, n_items, cfg=None,
                      epochs=1, ckpt_dir=None, ckpt_every=1,
                      max_worker_loss=1, packs_per_worker=4, mesh=None,
                      seed=0, fault=None, device=None) -> MFSGDElastic:
    ad = MFSGDElastic(n_users, n_items, cfg, mesh, seed, users=users,
                      items=items, vals=vals,
                      packs_per_worker=packs_per_worker,
                      max_worker_loss=max_worker_loss, device=device)
    return elastic_fit(ad, epochs, ckpt_dir, ckpt_every=ckpt_every,
                       fault=fault)


def lda_elastic_fit(doc_ids, word_ids, *, n_docs, vocab_size, cfg=None,
                    epochs=1, ckpt_dir=None, ckpt_every=1,
                    max_worker_loss=1, packs_per_worker=4, mesh=None,
                    seed=0, fault=None, device=None) -> LDAElastic:
    ad = LDAElastic(n_docs, vocab_size, cfg, mesh, seed,
                    doc_ids=doc_ids, word_ids=word_ids,
                    packs_per_worker=packs_per_worker,
                    max_worker_loss=max_worker_loss, device=device)
    return elastic_fit(ad, epochs, ckpt_dir, ckpt_every=ckpt_every,
                       fault=fault)


def kmeans_stream_elastic_fit(points, *, k, iters=1, ckpt_dir=None,
                              ckpt_every=1, max_worker_loss=1,
                              packs_per_worker=4, mesh=None, seed=0,
                              fault=None, chunk_rows=262_144,
                              device=None) -> KMeansStreamElastic:
    ad = KMeansStreamElastic(points, k, mesh, seed,
                             packs_per_worker=packs_per_worker,
                             max_worker_loss=max_worker_loss,
                             chunk_rows=chunk_rows, device=device)
    return elastic_fit(ad, iters, ckpt_dir, ckpt_every=ckpt_every,
                       fault=fault)
