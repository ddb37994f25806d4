"""MF-SGD with model rotation — MovieLens-20M width, the port of
``harp_tpu.models.mfsgd``.

Harp's ``edu.iu.sgd``: R ≈ W·Hᵀ by SGD.  Each worker owns a user range of
the ratings and of W; H is split into ``rotate_chunks`` chunks per worker
that travel the ring (:func:`~harp_tpu_torch.parallel.rotate.
rotate_pipeline`), and at each rotation step a worker trains on the block
of its ratings that touches the resident chunk, so every rating is visited
once an epoch.  Harp's Hogwild threads become deterministic mini-batched
SGD, as in the reference.  Three update algos (``MFSGDConfig.algo``):

- ``"pallas"`` (the config's default): kernel K3
  (:func:`harp_tpu_torch.ops.mfsgd_kernel.sgd_tile_update`), one CUDA
  launch per rotation step, over the dense tile entries of
  :func:`partition_ratings_tiles`;
- ``"dense"``: the same entries through K3's plain version (row gathers
  and ``index_add_`` in place of the reference's one-hot matmuls, with the
  same entry math) — the reference's comparator for ``pallas``;
- ``"scatter"``: minibatch chunks with plain gather / ``index_add`` over
  :func:`partition_ratings` blocks, the readable reference formulation.

``benchmark()`` and the CLI default to ``dense``, as the reference's do.
The pallas path needs no ``insert_coverage_entries``: that host step exists
so the TPU's W-block streaming writes every output block, and K3's level
schedule skips entries without a rating.

``fit(epochs, ckpt_dir)`` checkpoints each worker's W and H shards through
:func:`harp_tpu_torch.utils.fault.fit_epochs`; the CLI trains with
``--ckpt-dir``/``--resume`` and reads rating triples with ``--input``, and
``--elastic``/``--max-worker-loss`` train through
:func:`harp_tpu_torch.elastic.apps.mfsgd_elastic_fit`.

``train_epoch`` is one dispatch (``mfsgd.epoch`` on the flight recorder)
and one readback of its statistics, which carries the per-worker rating
counts to the skew ledger (``skew.record_execution``); ``train_epochs``
is one dispatch (``mfsgd.epochs``) and one readback for all its epochs.
With telemetry on, ``set_ratings`` records the partition's per-worker
ratings.

``carry_w`` (dense only, validated as in the reference): the reference
carries a W tile across its run of entries instead of slicing and
updating it per entry, a device of its slice-and-update-slice XLA path.
Here K3's plain version updates W and H in place through views of the tile
rows (:func:`harp_tpu_torch.ops.mfsgd_kernel.entries_update_plain`), so
carry and non-carry run the same code and give the same chain, as the
reference pins for its own two paths; the port's LDA ``carry_db`` is the
same.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from harp_tpu_torch.ops import mfsgd_kernel as K3
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.parallel.rotate import (ROTATE_WIRES, resident_chunk_index,
                                           rotate_pipeline)
from harp_tpu_torch.utils import flightrec, skew, telemetry


@dataclasses.dataclass
class MFSGDConfig:
    """The reference's knobs, defaults and validation."""

    rank: int = 64
    lr: float = 0.01
    reg: float = 0.05  # λ, applied to touched rows only (as SGD does)
    algo: str = "pallas"  # "pallas" (K3) | "dense" | "scatter"
    # dense/pallas tile sizes; None = auto per algo, resolved by tiles()
    u_tile: int | None = None
    i_tile: int | None = None
    # max ratings per dense entry; overfull tiles split into several entries
    entry_cap: int = 2048
    # dense/pallas: gathered rows and per-rating gradients round to this
    compute_dtype: Any = torch.bfloat16
    # scatter: minibatch size inside a block (clamped to the block width)
    chunk: int = 32768
    # dense: the reference's W-tile carry; the port's chain does not depend
    # on it (module docstring)
    carry_w: bool = False
    # H chunks per worker in the rotation pipeline; None = 2
    rotate_chunks: int | None = None
    # ring payload for the in-flight chunk: "exact", "bf16" or "int8"
    rotate_wire: str = "exact"

    def __post_init__(self):
        if self.algo not in ("dense", "scatter", "pallas"):
            raise ValueError(
                f"algo must be 'dense', 'scatter' or 'pallas', got {self.algo!r}")
        if self.carry_w and self.algo != "dense":
            raise ValueError(
                "carry_w applies to algo='dense' only (the pallas kernel "
                "already keeps W resident across its block runs; scatter "
                "has no tile slicing to amortize)")
        if self.rotate_chunks is not None and self.rotate_chunks < 1:
            raise ValueError(
                f"rotate_chunks must be >= 1, got {self.rotate_chunks}")
        if self.rotate_wire not in ROTATE_WIRES:
            raise ValueError(
                f"rotate_wire must be one of {ROTATE_WIRES}, "
                f"got {self.rotate_wire!r}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.compute_dtype}")


def tiles(cfg: MFSGDConfig) -> tuple[int, int]:
    """Resolved ``(u_tile, i_tile)``: None means 256 for pallas, 512 for
    dense, as in the reference."""
    auto = 256 if cfg.algo == "pallas" else 512
    return (cfg.u_tile if cfg.u_tile is not None else auto,
            cfg.i_tile if cfg.i_tile is not None else auto)


def rotate_chunks_resolved(cfg) -> int:
    """Resolved rotation chunk count: None means 2."""
    return cfg.rotate_chunks if cfg.rotate_chunks is not None else 2


_DENSE_ALGOS = ("dense", "pallas")


# ---------------------------------------------------------------------------
# Host preprocessing (numpy copies of the reference's; bit-equal arrays).
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def partition_ratings(users, items, vals, n_users, n_items, n_workers, chunk,
                      n_slices: int | None = None):
    """Rating triples → the (user range × item slice) grid of the scatter
    algo: worker-major ``u, i, v, mask [n * n_slices, B]`` with ids local
    to their range / slice, ``B`` the largest block rounded up to
    ``chunk`` (or to 8 below it), then ``(u_bound, i_bound)``."""
    users = np.asarray(users)
    items = np.asarray(items)
    vals = np.asarray(vals, dtype=np.float32)
    n = n_workers
    ns = n_slices if n_slices is not None else 2 * n
    u_bound = -(-n_users // n)
    i_bound = -(-n_items // ns)
    wid = users // u_bound
    sid = items // i_bound
    order = np.lexsort((items, sid, wid))
    users, items, vals, wid, sid = (
        a[order] for a in (users, items, vals, wid, sid))
    counts = np.zeros((n, ns), np.int64)
    np.add.at(counts, (wid, sid), 1)
    bmax = int(counts.max())
    if bmax >= chunk:
        B = -(-bmax // chunk) * chunk
    else:
        B = min(chunk, max(8, -(-bmax // 8) * 8))
    u = np.zeros((n, ns, B), np.int32)
    i = np.zeros((n, ns, B), np.int32)
    v = np.zeros((n, ns, B), np.float32)
    m = np.zeros((n, ns, B), np.float32)
    starts = np.zeros((n, ns), np.int64)
    starts.flat[1:] = counts.cumsum()[:-1]
    for w in range(n):
        for s in range(ns):
            lo, c = starts[w, s], counts[w, s]
            sl = slice(lo, lo + c)
            u[w, s, :c] = users[sl] - w * u_bound
            i[w, s, :c] = items[sl] - s * i_bound
            v[w, s, :c] = vals[sl]
            m[w, s, :c] = 1.0
    return (u.reshape(n * ns, B), i.reshape(n * ns, B),
            v.reshape(n * ns, B), m.reshape(n * ns, B), u_bound, i_bound)


def _dense_bounds(n_users, n_items, n_workers, n_slices, u_tile, i_tile):
    """``(u_own, i_own, u_bound, ib2)``: balanced ownership sizes and their
    tile-rounded storage sizes (pad rows own no ids and stay untrained)."""
    u_own = _ceil_div(n_users, n_workers)
    i_own = _ceil_div(n_items, n_slices)
    u_bound = u_tile * _ceil_div(u_own, u_tile)
    ib2 = i_tile * _ceil_div(i_own, i_tile)
    return u_own, i_own, u_bound, ib2


def partition_ratings_tiles(users, items, vals, n_users, n_items, n_workers,
                            u_tile, i_tile, entry_cap, n_slices=None):
    """Triples → dense (u_tile × i_tile) sub-tile entries per (worker,
    slice) block, u-major: worker-major ``eu/ei/ev [n*ns, NE, C]`` (ids
    local to their tile, pad id = tile width), ``ou/oi [n*ns, NE]`` tile
    offsets, then ``(u_own, i_own, u_bound, ib2)``."""
    users = np.asarray(users)
    items = np.asarray(items)
    vals = np.asarray(vals, dtype=np.float32)
    n = n_workers
    ns = n_slices if n_slices is not None else 2 * n
    u_own, i_own, u_bound, ib2 = _dense_bounds(
        n_users, n_items, n, ns, u_tile, i_tile)
    wid = users // u_own
    sid = items // i_own
    lu = users - wid * u_own
    li = items - sid * i_own
    tu = lu // u_tile
    ti = li // i_tile
    ntu, nti = u_bound // u_tile, ib2 // i_tile
    gtile = ((wid * ns + sid) * ntu + tu) * nti + ti
    order = np.argsort(gtile, kind="stable")
    lu, li, vals, gtile = lu[order], li[order], vals[order], gtile[order]
    n_tiles = n * ns * ntu * nti
    counts = np.bincount(gtile, minlength=n_tiles)
    C_ = int(min(entry_cap, max(8, 8 * _ceil_div(int(counts.max(initial=0)),
                                                 8))))
    ent_per_tile = _ceil_div(counts, C_)
    ws_of_tile = np.arange(n_tiles) // (ntu * nti)
    NE = max(1, int(np.bincount(ws_of_tile, weights=ent_per_tile,
                                minlength=n * ns).max()))
    eu = np.full((n * ns, NE, C_), u_tile, np.int32)
    ei = np.full((n * ns, NE, C_), i_tile, np.int32)
    ev = np.zeros((n * ns, NE, C_), np.float32)
    ou = np.zeros((n * ns, NE), np.int32)
    oi = np.zeros((n * ns, NE), np.int32)
    starts = np.zeros(n_tiles, np.int64)
    starts[1:] = counts.cumsum()[:-1]
    e_next = np.zeros(n * ns, np.int64)
    # one contiguous copy per entry (memcpy speed)
    for t in np.nonzero(counts)[0]:
        ws = t // (ntu * nti)
        t_u = (t // nti) % ntu
        t_i = t % nti
        lo, cnt = int(starts[t]), int(counts[t])
        for off in range(0, cnt, C_):
            e = int(e_next[ws])
            e_next[ws] = e + 1
            c = min(C_, cnt - off)
            sl = slice(lo + off, lo + off + c)
            eu[ws, e, :c] = lu[sl] - t_u * u_tile
            ei[ws, e, :c] = li[sl] - t_i * i_tile
            ev[ws, e, :c] = vals[sl]
            ou[ws, e] = t_u * u_tile
            oi[ws, e] = t_i * i_tile
    return eu, ei, ev, ou, oi, u_own, i_own, u_bound, ib2


# ---------------------------------------------------------------------------
# Device compute.
# ---------------------------------------------------------------------------

def _chunk_update(W, H, batch, cfg: MFSGDConfig):
    """One minibatch SGD step: gradients of ½Σm(r − w·h)² + ½λΣ(‖w‖²+‖h‖²)
    over the chunk; duplicate rows get summed gradients."""
    bu, bi, bv, bm = batch
    bu, bi = bu.long(), bi.long()
    wu, hi = W[bu], H[bi]
    err = bm * (bv - (wu * hi).sum(-1))
    gw = err[:, None] * hi - cfg.reg * bm[:, None] * wu
    gh = err[:, None] * wu - cfg.reg * bm[:, None] * hi
    W = W.index_add(0, bu, cfg.lr * gw)
    H = H.index_add(0, bi, cfg.lr * gh)
    return W, H, (err * err).sum(), bm.sum()


def _block_update(W, H, block, cfg: MFSGDConfig):
    """The scatter algo: minibatch chunks over one block, in order (the
    chunk is clamped to the block width)."""
    c = min(cfg.chunk, block[0].shape[0])
    se = cnt = torch.zeros((), dtype=torch.float32, device=W.device)
    for batch in zip(*(a.split(c) for a in block)):
        W, H, dse, dcnt = _chunk_update(W, H, batch, cfg)
        se, cnt = se + dse, cnt + dcnt
    return W, H, se, cnt


def _tile_block_update(W, H, block, cfg: MFSGDConfig,
                       schedule: K3.LevelSchedule | None = None):
    """The dense and pallas algos: the tile entries ``block = (eu, ei, ev,
    ou, oi)`` of one block → ``(W', H', se, cnt)``, through K3 (pallas) or
    its plain version (dense), in ``schedule``'s order (built here when
    None).  ``cfg.carry_w`` takes no part: both chains are this one
    (module docstring)."""
    fn = (K3.sgd_tile_update if cfg.algo == "pallas"
          else K3.sgd_tile_update_plain)
    ut, it = tiles(cfg)
    return fn(W, H, *block, lr=cfg.lr, reg=cfg.reg, u_tile=ut, i_tile=it,
              compute_dtype=cfg.compute_dtype, schedule=schedule)


class MFSGD:
    """Host driver (the ``mapCollective`` residue of ``edu.iu.sgd``).

    W and H are drawn uniform in ``[0, 1/sqrt(rank))`` from a
    ``torch.Generator`` seeded with ``seed``, or taken from ``state``
    (:func:`harp_tpu_torch.convert.mfsgd_state_from_numpy`: the global
    factors in the reference's storage layout).  Each worker holds its W
    range and its H slice on ``mesh.device``."""

    def __init__(self, n_users, n_items, cfg: MFSGDConfig | None = None,
                 mesh: WorkerMesh | None = None, seed=0, *, device=None,
                 state: dict | None = None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or MFSGDConfig()
        self.n_users, self.n_items = n_users, n_items
        n = self.mesh.num_workers
        nc = rotate_chunks_resolved(self.cfg)
        self._n_slices = nc * n
        if self.cfg.algo in _DENSE_ALGOS:
            self.u_own, self.i_own, self.u_bound, ibc = _dense_bounds(
                n_users, n_items, n, self._n_slices, *tiles(self.cfg))
            self.i_bound = nc * ibc
        else:
            self.u_bound = self.u_own = _ceil_div(n_users, n)
            self.i_bound = nc * _ceil_div(n_items, self._n_slices)
            self.i_own = self.i_bound // nc
        shapes = {"W": (self.u_bound * n, self.cfg.rank),
                  "H": (self.i_bound * n, self.cfg.rank)}
        if state is None:
            gen = torch.Generator(device=self.mesh.device)
            gen.manual_seed(seed)
            scale = 1.0 / np.sqrt(self.cfg.rank)
            state = {k: torch.rand(s, generator=gen, device=self.mesh.device)
                     * scale for k, s in shapes.items()}
        for k, s in shapes.items():
            if tuple(state[k].shape) != s:
                raise ValueError(f"state[{k!r}] has shape "
                                 f"{tuple(state[k].shape)}, expected {s}")
        self.W = self.mesh.shard_array(state["W"], 0)
        self.H = self.mesh.shard_array(state["H"], 0)
        self._blocks = None
        self._schedules = None
        # per-worker [(pack_id, load)] grains the elastic loop sets, so
        # the skew trigger's plan moves whole packs
        self.skew_units = None
        self._epoch_fn = flightrec.track(self._epoch, "mfsgd.epoch")
        self._epochs_fn = flightrec.track(self._epochs, "mfsgd.epochs")

    def set_ratings(self, users, items, vals):
        """Partition the global rating triples (every worker passes the
        same ones) and keep this worker's blocks on its device; for the
        dense algos, also each block's K3 level schedule.  Spans:
        ``mfsgd.set_ratings`` around ``mfsgd.partition``,
        ``mfsgd.schedule`` (every ``LevelSchedule.build``) and
        ``mfsgd.shard`` (the copies to the device)."""
        with telemetry.span("mfsgd.set_ratings"):
            n = self.mesh.num_workers
            nc = rotate_chunks_resolved(self.cfg)
            ns = self._n_slices
            if self.cfg.algo in _DENSE_ALGOS:
                ut, it = tiles(self.cfg)
                with telemetry.span("mfsgd.partition"):
                    eu, ei, ev, ou, oi, uo, io, ub, ibc = \
                        partition_ratings_tiles(
                            users, items, vals, self.n_users, self.n_items,
                            n, ut, it, self.cfg.entry_cap, n_slices=ns)
                assert (uo, io) == (self.u_own, self.i_own)
                if telemetry.enabled():
                    valid = eu < ut  # the real ratings of each block
                    skew.record_partition(
                        "mfsgd.partition", valid.reshape(n, -1).sum(1),
                        unit="ratings", padded_total=valid.size)
                blocks = (eu, ei, ev, ou, oi)
                lo = self.mesh.rank * ns
                with telemetry.span("mfsgd.schedule"):
                    self._schedules = [K3.LevelSchedule.build(
                        eu[lo + s], ei[lo + s], ou[lo + s], oi[lo + s], ut,
                        it, ub, ibc, self.mesh.device) for s in range(ns)]
            else:
                with telemetry.span("mfsgd.partition"):
                    bu, bi, bv, bm, ub, ibc = partition_ratings(
                        users, items, vals, self.n_users, self.n_items, n,
                        self.cfg.chunk, n_slices=ns)
                if telemetry.enabled():
                    skew.record_partition(
                        "mfsgd.partition", (bm > 0).reshape(n, -1).sum(1),
                        unit="ratings", padded_total=bm.size)
                blocks = (bu, bi, bv, bm)
            assert (ub, nc * ibc) == (self.u_bound, self.i_bound)
            with telemetry.span("mfsgd.shard"):
                self._blocks = tuple(self.mesh.shard_array(a, 0)
                                     for a in blocks)
            self.nnz = len(np.asarray(vals))

    def _update(self, W, H, s: int):
        """Block update of W and the resident H chunk on block row ``s``."""
        cfg = self.cfg
        block = tuple(a[s] for a in self._blocks)
        if cfg.algo == "scatter":
            return _block_update(W, H, block, cfg)
        with telemetry.span("mfsgd.k3"):
            return _tile_block_update(W, H, block, cfg, self._schedules[s])

    def _epoch(self, W, H):
        """One rotation epoch: every rating visited once.  Returns
        ``(W, H, se, cnt, work)``: se and cnt combined over the workers,
        work the per-worker visited counts."""
        nc = rotate_chunks_resolved(self.cfg)

        def step(st, chunk, t):
            W, se, cnt = st
            W, chunk, dse, dcnt = self._update(
                W, chunk, resident_chunk_index(t, nc))
            return (W, se + dse, cnt + dcnt), chunk

        zero = torch.zeros((), dtype=torch.float32, device=W.device)
        (W, se, cnt), H = rotate_pipeline(step, (W, zero, zero), H,
                                          n_chunks=nc,
                                          wire=self.cfg.rotate_wire)
        # the per-worker visited count before the sum (the reference's skew
        # counter), then the loss partials over the workers
        with telemetry.span("mfsgd.combine"):
            work = C.allgather(cnt[None])
            se, cnt = C.allreduce((se, cnt))
        return W, H, se, cnt, work

    def _epochs(self, W, H, epochs: int):
        """``epochs`` epochs in one call: ``(W, H, stats)``, stats every
        epoch's (se, cnt) then the last epoch's per-worker counts."""
        stats = []
        for _ in range(epochs):
            W, H, se, cnt, work = self._epoch(W, H)
            stats += [se, cnt]
        return W, H, torch.cat([torch.stack(stats), work.reshape(-1)])

    def _require_ratings(self, what: str) -> None:
        if self._blocks is None:
            raise RuntimeError(f"call set_ratings() before {what}()")

    def train_epoch(self) -> float:
        """One rotation epoch (one dispatch); returns the training RMSE
        over the visited ratings.  Its one readback also carries the
        per-worker rating counts to the skew ledger."""
        self._require_ratings("train_epoch")
        with telemetry.span("mfsgd.epoch"), \
                telemetry.ledger.run("mfsgd.epochs", steps=1):
            t0 = time.perf_counter()
            self.W, self.H, se, cnt, work = self._epoch_fn(self.W, self.H)
            with telemetry.span("mfsgd.readback"):
                stats = flightrec.readback(torch.cat(
                    [torch.stack([se, cnt]), work.reshape(-1)]))
            skew.record_execution("mfsgd.epochs", stats[2:],
                                  unit="ratings",
                                  wall_s=time.perf_counter() - t0,
                                  units=self.skew_units)
        return float(np.sqrt(max(float(stats[0]), 0.0)
                             / max(float(stats[1]), 1.0)))

    def train_epochs(self, epochs: int) -> list[float]:
        """``epochs`` epochs as a Python loop that never waits for the
        device, with ONE readback of every epoch's statistics (and the
        last epoch's per-worker rating counts) at its end; returns the
        per-epoch RMSEs."""
        self._require_ratings("train_epochs")
        if epochs <= 0:
            return []
        with telemetry.span("mfsgd.epochs", epochs=epochs), \
                telemetry.ledger.run("mfsgd.epochs", steps=epochs):
            t0 = time.perf_counter()
            self.W, self.H, stats = self._epochs_fn(self.W, self.H, epochs)
            with telemetry.span("mfsgd.readback"):
                got = flightrec.readback(stats)
            skew.record_execution("mfsgd.epochs", got[2 * epochs:],
                                  unit="ratings",
                                  wall_s=time.perf_counter() - t0,
                                  units=self.skew_units)
        pairs = got[:2 * epochs].reshape(epochs, 2)
        return [float(np.sqrt(max(s, 0.0) / max(c, 1.0))) for s, c in pairs]

    def fit(self, epochs: int, ckpt_dir: str | None = None, *,
            ckpt_every: int = 5, max_restarts: int = 3, fault=None):
        """Train ``epochs`` epochs one by one, with optional
        checkpoint/resume: with ``ckpt_dir`` the W and H shards are saved
        every ``ckpt_every`` epochs, and a crashed run (or a rerun on the
        same directory) resumes from the latest saved epoch.  Returns the
        RMSEs of the epochs this call ran."""
        from harp_tpu_torch.utils.fault import (factor_state_io, fit_epochs,
                                                to_device)

        rmses: list[float] = []
        dev = self.mesh.device
        get_state, set_state = factor_state_io(self, {
            "W": lambda a: to_device(a, dev), "H": lambda a: to_device(a, dev)})
        fit_epochs(lambda: rmses.append(self.train_epoch()), get_state,
                   set_state, epochs, ckpt_dir, ckpt_every=ckpt_every,
                   max_restarts=max_restarts, fault=fault,
                   phase="mfsgd.epochs")
        return rmses

    def factors(self):
        """Global ``(W, H)`` as numpy, storage padding stripped: user ``g``
        lives at row ``(g // u_own) * u_bound + g % u_own`` (dense algos),
        likewise the items per chunk."""
        n = self.mesh.num_workers
        W, H = (x.cpu().numpy() for x in C.allgather((self.W, self.H)))
        if self.cfg.algo in _DENSE_ALGOS:
            nc = rotate_chunks_resolved(self.cfg)
            r = W.shape[-1]
            W = W.reshape(n, self.u_bound, r)[:, : self.u_own].reshape(-1, r)
            ibc = self.i_bound // nc
            H = H.reshape(nc * n, ibc, r)[:, : self.i_own].reshape(-1, r)
        return W[: self.n_users], H[: self.n_items]

    def predict_rmse(self, users, items, vals) -> float:
        W, H = self.factors()
        pred = (W[np.asarray(users)] * H[np.asarray(items)]).sum(-1)
        return float(np.sqrt(np.mean((pred - np.asarray(vals)) ** 2)))


# ---------------------------------------------------------------------------
# Synthetic MovieLens-20M-shaped data + benchmark.
# ---------------------------------------------------------------------------

def synthetic_ratings(n_users, n_items, nnz, rank=8, noise=0.1, seed=0):
    """Low-rank ground truth + noise, uniform random (u, i) pairs (numpy,
    the reference's generator)."""
    rng = np.random.default_rng(seed)
    Wt = rng.normal(size=(n_users, rank)) / np.sqrt(rank)
    Ht = rng.normal(size=(n_items, rank)) / np.sqrt(rank)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    v = (Wt[u] * Ht[i]).sum(-1) + noise * rng.normal(size=nnz)
    return u.astype(np.int32), i.astype(np.int32), v.astype(np.float32)


def algo_kwargs(algo: str, groups: dict) -> dict:
    """Validated algo-specific config kwargs: ``{owner algo(s): {knob:
    value}}``; None inherits the default, a knob set for an algo that does
    not own it raises."""
    kw: dict[str, Any] = {"algo": algo}
    for owners, knobs in groups.items():
        owners_t = (owners,) if isinstance(owners, str) else tuple(owners)
        for name, val in knobs.items():
            if val is None:
                continue
            if algo not in owners_t:
                raise ValueError(
                    f"{name} is {'/'.join(owners_t)}-only; pass one of "
                    f"those algos or tune the {algo!r} knobs instead")
            kw[name] = val
    return kw


def _make_config(rank: int, chunk: int | None, algo: str = "dense",
                 u_tile: int | None = None, i_tile: int | None = None,
                 entry_cap: int | None = None,
                 carry_w: bool | None = None,
                 rotate_chunks: int | None = None,
                 rotate_wire: str | None = None) -> MFSGDConfig:
    return MFSGDConfig(rank=rank, **algo_kwargs(algo, {
        "scatter": {"chunk": chunk},
        _DENSE_ALGOS: {"u_tile": u_tile, "i_tile": i_tile,
                       "entry_cap": entry_cap},
        "dense": {"carry_w": carry_w},
        ("dense", "scatter", "pallas"): {"rotate_chunks": rotate_chunks,
                                         "rotate_wire": rotate_wire},
    }))


def benchmark(n_users=138_493, n_items=26_744, nnz=20_000_000, rank=64,
              epochs=3, mesh=None, seed=0, chunk=None, algo="dense",
              u_tile=None, i_tile=None, entry_cap=None, carry_w=None,
              rotate_chunks=None, rotate_wire=None, device=None):
    """Updates/sec per card on MovieLens-20M shapes (the system's second
    metric).  One update is one rating visit.  Host prep (synthetic
    ratings are made with numpy from ``seed``; partition and schedule) is
    ``prep_sec``; one untimed epoch runs first (``rmse_first_epoch``); the
    timed window is ``train_epochs(epochs)``, ending in its readback."""
    mesh = resolve_mesh(mesh, device)
    cfg = _make_config(rank, chunk, algo, u_tile, i_tile, entry_cap,
                       carry_w, rotate_chunks, rotate_wire)
    model = MFSGD(n_users, n_items, cfg, mesh, seed)
    u, i, v = synthetic_ratings(n_users, n_items, nnz, seed=seed)
    t0 = time.perf_counter()
    model.set_ratings(u, i, v)
    prep = time.perf_counter() - t0
    rmse0 = model.train_epoch()
    t0 = time.perf_counter()
    rmse = model.train_epochs(epochs)[-1]
    dt = time.perf_counter() - t0
    return {
        "updates_per_sec_per_chip": nnz * epochs / dt / mesh.num_workers,
        "sec_per_epoch": dt / epochs,
        "rmse_first_epoch": rmse0,
        "rmse_final": rmse,
        "prep_sec": prep,
        "nnz": nnz, "rank": rank, "num_workers": mesh.num_workers,
        "algo": algo,
    }


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu MF-SGD on PyTorch (edu.iu.sgd parity)")
    p.add_argument("--users", type=int, default=None,
                   help="default: 138493 (ML-20M)")
    p.add_argument("--items", type=int, default=None,
                   help="default: 26744 (ML-20M)")
    p.add_argument("--nnz", type=int, default=20_000_000)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--algo", choices=["dense", "scatter", "pallas"],
                   default="dense",
                   help="dense: tile entries through K3's plain version "
                        "(default); pallas: kernel K3; scatter: minibatch "
                        "gather/index_add reference")
    p.add_argument("--chunk", type=int, default=None,
                   help="scatter-only: minibatch size (default 32768)")
    p.add_argument("--u-tile", type=int, default=None,
                   help="dense/pallas: W tile rows (default 512 / 256)")
    p.add_argument("--i-tile", type=int, default=None,
                   help="dense/pallas: H tile rows (default 512 / 256)")
    p.add_argument("--entry-cap", type=int, default=None,
                   help="dense/pallas: max ratings per tile entry "
                        "(default 2048)")
    p.add_argument("--rotate-chunks", type=int, default=None,
                   help="H chunks per worker in the rotation pipeline "
                        "(default 2)")
    p.add_argument("--rotate-wire", choices=list(ROTATE_WIRES), default=None,
                   help="ring payload for in-flight chunks (default exact)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    p.add_argument("--ckpt-dir", default=None,
                   help="train with checkpoint/resume instead of "
                        "benchmarking; a rerun on the same directory "
                        "resumes from the latest saved epoch")
    p.add_argument("--ckpt-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="require a resume: --ckpt-dir must already hold a "
                        "checkpoint")
    p.add_argument("--input", default=None, metavar="FILE_OR_GLOB",
                   help="rating triple files ('user item rating' rows, e.g. "
                        "MovieLens); implies training mode. --users/--items "
                        "default to max id + 1")
    p.add_argument("--elastic", action="store_true",
                   help="elastic training: take mid-run skew_trigger "
                        "findings between epochs (rebalance user packs "
                        "over the reshard verb) and checkpoint "
                        "mesh-independent state")
    p.add_argument("--max-worker-loss", type=int, default=0,
                   help="elastic: survive up to N permanent worker losses "
                        "by shrinking to the survivors and replaying the "
                        "repartition plan from the last checkpoint "
                        "(implies --elastic; needs --ckpt-dir to resume)")
    args = p.parse_args(argv)
    from harp_tpu_torch.report import maybe_emit
    from harp_tpu_torch.utils.fault import resolve_resume

    resumed_from = resolve_resume(args.ckpt_dir, args.resume)
    mesh = WorkerMesh(args.device)
    if args.elastic or args.max_worker_loss:
        if args.input:
            raise SystemExit(
                "--elastic pairs with the synthetic corpus; use "
                "--users/--items/--nnz (file inputs ride the non-elastic "
                "fit)")
        from harp_tpu_torch.elastic.apps import mfsgd_elastic_fit

        n_users = args.users or 138_493
        n_items = args.items or 26_744
        u, i, v = synthetic_ratings(n_users, n_items, args.nnz)
        ad = mfsgd_elastic_fit(
            u, i, v, n_users=n_users, n_items=n_items,
            cfg=_make_config(args.rank, args.chunk, args.algo,
                             args.u_tile, args.i_tile, args.entry_cap,
                             rotate_chunks=args.rotate_chunks,
                             rotate_wire=args.rotate_wire),
            epochs=args.epochs, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            max_worker_loss=max(args.max_worker_loss, 0), mesh=mesh)
        print(benchmark_json("mfsgd_elastic_cli", {
            "epochs": args.epochs,
            "rmse_final": None if ad.sat_out else ad.metric(),
            "n_workers": ad.mesh.num_workers if ad.mesh.is_member else 0,
            "worker_losses": ad.losses, "ckpt_dir": args.ckpt_dir},
            mesh.device))
        maybe_emit("mfsgd")
        return 0
    if args.input or args.ckpt_dir:
        if args.input:
            from harp_tpu_torch.native.datasource import load_triples_glob

            try:
                u, i, v, has_rating = load_triples_glob(args.input)
            except ValueError as e:
                raise SystemExit(str(e))
            if not has_rating:
                raise SystemExit(
                    f"{args.input}: rows have no rating column — MF-SGD "
                    "needs 'user item rating' triples (training on the "
                    "implied zeros would silently fit nothing)")
            if int(u.min()) < 0 or int(i.min()) < 0:
                raise SystemExit(
                    f"{args.input}: negative user/item ids (ids index model "
                    "rows)")
            # explicit sizes are raised to fit the data
            n_users = max(args.users or 0, int(u.max()) + 1)
            n_items = max(args.items or 0, int(i.max()) + 1)
        else:
            n_users = args.users or 138_493
            n_items = args.items or 26_744
            u, i, v = synthetic_ratings(n_users, n_items, args.nnz)
        model = MFSGD(n_users, n_items,
                      _make_config(args.rank, args.chunk, args.algo,
                                   args.u_tile, args.i_tile, args.entry_cap,
                                   rotate_chunks=args.rotate_chunks,
                                   rotate_wire=args.rotate_wire), mesh)
        model.set_ratings(u, i, v)
        rmses = model.fit(args.epochs, args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
        print(benchmark_json("mfsgd_fit_cli", {
            "epochs_run": len(rmses),
            "rmse_final": rmses[-1] if rmses else None,
            "nnz": len(u), "users": n_users, "items": n_items,
            "ckpt_dir": args.ckpt_dir, "resumed_from": resumed_from},
            mesh.device))
        maybe_emit("mfsgd")
        return 0
    print(benchmark_json("mfsgd_cli", benchmark(
        args.users or 138_493, args.items or 26_744, args.nnz, args.rank,
        args.epochs, mesh=mesh, chunk=args.chunk, algo=args.algo,
        u_tile=args.u_tile, i_tile=args.i_tile, entry_cap=args.entry_cap,
        rotate_chunks=args.rotate_chunks, rotate_wire=args.rotate_wire),
        mesh.device))
    maybe_emit("mfsgd")
    return 0


if __name__ == "__main__":
    main()
