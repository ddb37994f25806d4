"""LDA via collapsed Gibbs sampling with model rotation — the port of
``harp_tpu.models.lda`` (its rotation algos).

Harp's ``edu.iu.lda`` (rotation variant): tokens are partitioned into the
(doc range × word slice) grid of :func:`~harp_tpu_torch.models.mfsgd.
partition_ratings_tiles` / ``partition_ratings``; each worker owns a doc
range and its doc-topic rows (Ndk), the word-topic rows (Nwk) are split into
``rotate_chunks`` chunks per worker that travel the ring
(:func:`~harp_tpu_torch.parallel.rotate.rotate_pipeline`), and at each
rotation step a worker resamples the tokens of its block that touch the
resident chunk.  The topic totals Nk are synchronised every step with an
allreduce of the step's deltas.  Parallel CGS is approximate by
construction; within one worker the port's chain is the reference's chain.
Three algos (``LDAConfig.algo``):

- ``"pallas"`` (the config's default): kernel K4
  (:func:`harp_tpu_torch.ops.lda_kernel.cgs_step`), one call per rotation
  step, over dense tile entries; an entry samples in ``cc``-token chunks
  (:func:`~harp_tpu_torch.ops.lda_kernel.chunk_width`), each chunk against
  the counts the chunks before it left;
- ``"dense"``: the same entries, each sampled against one whole-entry
  snapshot (the reference's XLA path), with gathers and ``index_add_``;
- ``"scatter"``: fixed-size token chunks over ``partition_ratings`` blocks
  against the whole local tables, the readable reference formulation.

The tables are updated in place, through views of the tile rows: the
reference's ``carry_db`` (keeping a doc tile resident across its run of
entries) is a device for its slice-and-update-slice XLA path, so here
carry and non-carry run the same code and give the same chain, as the
reference pins for its own two paths.  ``carry_db`` is accepted and
validated as there.

Random numbers: ``sampler`` ("exprace" or "gumbel") and ``rng_impl``
("threefry" or "rbg") keep their validation (pallas requires exprace and
rbg), but both ``rng_impl`` values draw from the port's
``torch.Generator``: a different stream with the same distribution, which
the reference documents for its own two generators.  ``sample_epoch(noise=
...)`` injects draws instead (the tests hand in the reference's).

Not ported yet: ``algo="pushpull"`` (ROADMAP.md, Queue 1, item 3),
``fit``'s checkpoint/fault path, the CLI's ``--ckpt-dir``/``--resume`` and
``--input`` (item 5), ``--elastic``/``--max-worker-loss`` (item 8) and
``benchmark(pack_cache=...)`` (item 4); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from harp_tpu_torch.models.mfsgd import (_ceil_div, _dense_bounds,
                                         algo_kwargs, partition_ratings,
                                         partition_ratings_tiles,
                                         rotate_chunks_resolved)
from harp_tpu_torch.ops import lda_kernel as K4
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.parallel.rotate import (ROTATE_WIRES, resident_chunk_index,
                                           rotate_pipeline)
from harp_tpu_torch.utils import telemetry

_ITEM = "not ported yet (ROADMAP.md, Queue 1, item {})"

#: algos that consume the dense (d_tile × w_tile) entry layout
_TILED_ALGOS = ("dense", "pallas")

#: pallas prep: entry width is padded to a multiple of this
_PALLAS_C = 256


@dataclasses.dataclass
class LDAConfig:
    """The reference's knobs, defaults and validation."""

    n_topics: int = 100
    alpha: float = 0.1  # doc-topic Dirichlet prior
    beta: float = 0.01  # word-topic Dirichlet prior
    algo: str = "pallas"  # "pallas" (K4) | "dense" | "scatter" | "pushpull"
    d_tile: int = 512   # dense/pallas: doc-topic tile rows
    w_tile: int = 512   # dense/pallas: word-topic tile rows
    entry_cap: int = 2048  # dense/pallas: max tokens per tile entry
    chunk: int = 8192   # scatter: tokens sampled per count snapshot
    pull_cap: int | None = None   # pushpull only
    dedup_pulls: bool = True      # pushpull only
    # tiled algos; None = on for pallas (carry_db_resolved).  The port's
    # chain does not depend on it (module docstring)
    carry_db: bool | None = None
    # pallas: exact count gathers; False rounds them to bf16
    pallas_exact_gathers: bool = True
    ndk_dtype: str = "float32"  # or "int16" (exact: counts ≤ doc length)
    sampler: str = "exprace"    # or "gumbel"
    rng_impl: str = "rbg"       # or "threefry" (both: torch.Generator)
    rotate_chunks: int | None = None  # None = 2
    rotate_wire: str = "exact"

    def __post_init__(self):
        if self.ndk_dtype not in ("float32", "int16"):
            raise ValueError(
                f"ndk_dtype must be 'float32' or 'int16', got {self.ndk_dtype!r}")
        if self.algo not in ("dense", "scatter", "pushpull", "pallas"):
            raise ValueError(
                f"algo must be 'dense', 'scatter', 'pushpull' or "
                f"'pallas', got {self.algo!r}")
        if self.algo == "pallas" and (self.sampler != "exprace"
                                      or self.rng_impl != "rbg"):
            raise ValueError(
                "algo='pallas' fuses the exprace draw over hardware "
                "random bits; pass sampler='exprace', rng_impl='rbg'")
        if self.sampler not in ("gumbel", "exprace"):
            raise ValueError(
                f"sampler must be 'gumbel' or 'exprace', got {self.sampler!r}")
        if self.rng_impl not in ("threefry", "rbg"):
            raise ValueError(
                f"rng_impl must be 'threefry' or 'rbg', got {self.rng_impl!r}")
        if self.pull_cap is not None and self.algo != "pushpull":
            raise ValueError("pull_cap only applies to algo='pushpull'")
        if self.carry_db and self.algo not in _TILED_ALGOS:
            raise ValueError("carry_db applies to the tiled algos "
                             f"{_TILED_ALGOS}, not algo={self.algo!r}")
        if self.rotate_chunks is not None and self.rotate_chunks < 1:
            raise ValueError(
                f"rotate_chunks must be >= 1, got {self.rotate_chunks}")
        if self.rotate_wire not in ROTATE_WIRES:
            raise ValueError(
                f"rotate_wire must be one of {ROTATE_WIRES}, "
                f"got {self.rotate_wire!r}")
        if self.algo == "pushpull" and (self.rotate_chunks is not None
                                        or self.rotate_wire != "exact"):
            raise ValueError(
                "rotate_chunks/rotate_wire apply to the rotation algos; "
                "algo='pushpull' never rotates (a silently-ignored "
                "tuning flag wastes benchmark sweeps)")
        if self.pull_cap is not None and self.pull_cap < 1:
            raise ValueError(
                f"pull_cap must be >= 1, got {self.pull_cap} (0 would "
                "silently fall back to the full-chunk default)")
        if self.algo == "pushpull":
            raise NotImplementedError(
                "algo='pushpull' (table pull/push and regroup) is "
                + _ITEM.format(3))


def carry_db_resolved(cfg: LDAConfig) -> bool:
    """Resolved doc-tile carry: None means on for the pallas stack only."""
    return cfg.carry_db if cfg.carry_db is not None else cfg.algo == "pallas"


# ---------------------------------------------------------------------------
# The samplers (plain torch; K4 is the pallas algo's).
# ---------------------------------------------------------------------------

def _cgs_resample(ndk, nwk, nk, z, mask, noise, cfg: LDAConfig, vocab_size):
    """The CGS posterior and draw shared by dense and scatter: ``noise``
    holds Exp(1) draws (exprace: argmin E·c/(a·b)) or Gumbel draws
    (gumbel: argmax log a + log b − log c + G), shaped like ``ndk``."""
    a = torch.clamp_min(ndk + cfg.alpha, 1e-10)
    b = torch.clamp_min(nwk + cfg.beta, 1e-10)
    c = torch.clamp_min(nk + vocab_size * cfg.beta, 1e-10)
    if cfg.sampler == "exprace":
        z_new = torch.argmin(noise * c / (a * b), dim=-1)
    else:
        logp = torch.log(a) + torch.log(b) - torch.log(c)
        z_new = torch.argmax(logp + noise, dim=-1)
    return torch.where(mask, z_new.to(z.dtype), z)


def _one_hot(z, K, mask):
    topics = torch.arange(K, device=z.device)
    return ((topics == z.long()[:, None]) & mask[:, None]).to(torch.float32)


def _sample_chunk(Ndk, Nwk, Nk, z, chunk, noise, cfg: LDAConfig,
                  vocab_size):
    """Blocked-Gibbs resample of one token chunk against the whole local
    tables (scatter algo).  Updates ``Ndk`` and ``Nwk`` in place; returns
    ``(dNk, z_new)``."""
    d, w, m = chunk
    d, w, m = d.long(), w.long(), m > 0
    K = cfg.n_topics
    oh_old = _one_hot(z, K, m)
    ndk = Ndk[d].to(torch.float32) - oh_old
    nwk = Nwk[w] - oh_old
    nk = Nk[None, :] - oh_old
    z_new = _cgs_resample(ndk, nwk, nk, z, m, noise, cfg, vocab_size)
    delta = _one_hot(z_new, K, m) - oh_old
    Ndk.index_add_(0, d[m], delta[m].to(Ndk.dtype))
    Nwk.index_add_(0, w[m], delta[m])
    return delta.sum(0), z_new


def _sample_entry_tiles(Db, Wb, Nk_eff, z, cd, cw, noise, cfg: LDAConfig,
                        vocab_size):
    """Whole-entry-snapshot resample of one entry against tile views
    ``Db [d_tile, K]`` / ``Wb [w_tile, K]`` (dense algo; K4's plain twin
    with one snapshot per entry).  Updates the views in place; returns
    ``(dNk, z_new)``."""
    DR, WR = cfg.d_tile, cfg.w_tile
    m = cd < DR
    rd = torch.where(m, cd, 0).long()
    rw = torch.where(m, cw, 0).long()
    oh_old = _one_hot(z, cfg.n_topics, m)
    ndk = Db[rd].to(torch.float32) - oh_old
    nwk = Wb[rw] - oh_old
    nk = Nk_eff[None, :] - oh_old
    z_new = _cgs_resample(ndk, nwk, nk, z, m, noise, cfg, vocab_size)
    delta = _one_hot(z_new, cfg.n_topics, m) - oh_old
    Db.index_add_(0, rd[m], delta[m].to(Db.dtype))
    Wb.index_add_(0, rw[m], delta[m])
    return delta.sum(0), z_new


# ---------------------------------------------------------------------------
# The host driver.
# ---------------------------------------------------------------------------

#: ``noise(t, s)`` → the draws of rotation step ``t`` on block row ``s``:
#: pallas uniforms [NE, C, K]; dense Exp(1) or Gumbel draws [NE, C, K];
#: scatter the same per token of the block, [B, K]
NoiseFn = Callable[[int, int], torch.Tensor]


class LDA:
    """Host driver (the ``mapCollective`` residue of ``edu.iu.lda``).

    Each worker keeps its doc rows (``Ndk``), its word slice (``Nwk``, in
    ``rotate_chunks`` chunks that rotate), the replicated topic totals
    (``Nk``), its token blocks and their topics (``z_grid``) on
    ``mesh.device``.  The table readers (``doc_topic_table``,
    ``word_topic_table``, ``token_state``, ``log_likelihood``) gather the
    workers' tables, so every worker calls them together."""

    def __init__(self, n_docs, vocab_size, cfg: LDAConfig | None = None,
                 mesh: WorkerMesh | None = None, seed=0, *, device=None):
        self.mesh = resolve_mesh(mesh, device)
        self.cfg = cfg or LDAConfig()
        self.n_docs, self.vocab_size = n_docs, vocab_size
        n = self.mesh.num_workers
        nc = rotate_chunks_resolved(self.cfg)
        self._n_slices = nc * n
        if self.cfg.algo in _TILED_ALGOS:
            self.d_own, self.w_own, self.d_bound, wbc = _dense_bounds(
                n_docs, vocab_size, n, self._n_slices,
                self.cfg.d_tile, self.cfg.w_tile)
            self.w_bound = nc * wbc
        else:
            self.d_bound = self.d_own = _ceil_div(n_docs, n)
            self.w_bound = nc * _ceil_div(vocab_size, self._n_slices)
            self.w_own = self.w_bound // nc
        self._count_bounds = (None, None)
        self._seed = seed
        self._gen = torch.Generator(device=self.mesh.device)
        self._gen.manual_seed(seed * 65_537 + self.mesh.rank)
        self._tokens = None
        self.last_work = None
        self.cc = None  # pallas: K4's chunk width, set by set_tokens

    # -- corpus ---------------------------------------------------------------

    def set_tokens(self, doc_ids, word_ids):
        """Load the token corpus (one entry per token occurrence; every
        worker passes the same global corpus)."""
        self._install_pack(self.pack_tokens(doc_ids, word_ids))

    def pack_tokens(self, doc_ids, word_ids, z0=None) -> dict:
        """Host half of :meth:`set_tokens`: the reference's pack, bit for
        bit — the global token layout, ``z_grid`` and the initial tables
        as numpy arrays.  ``z0``: explicit initial topics instead of the
        seeded random ones."""
        n = self.mesh.num_workers
        K = self.cfg.n_topics
        if self.cfg.ndk_dtype == "int16":
            longest = int(np.bincount(np.asarray(doc_ids)).max()) \
                if len(doc_ids) else 0
            if longest > np.iinfo(np.int16).max:
                raise ValueError(
                    f"ndk_dtype='int16': longest document has {longest} "
                    f"tokens > {np.iinfo(np.int16).max} — counts would "
                    "wrap; use ndk_dtype='float32' or split the document")
        if z0 is None:
            rng = np.random.default_rng(self._seed)
            z0 = rng.integers(0, K, len(doc_ids)).astype(np.float32)
        else:
            z0 = np.asarray(z0, np.float32)
            if z0.shape != np.shape(doc_ids):
                raise ValueError(
                    f"z0 has shape {z0.shape} but the corpus has "
                    f"{len(doc_ids)} tokens")
        nc = rotate_chunks_resolved(self.cfg)
        if self.cfg.algo in _TILED_ALGOS:
            ed, ew, ez, od, ow, do, wo, db, wbc = partition_ratings_tiles(
                doc_ids, word_ids, z0, self.n_docs, self.vocab_size, n,
                self.cfg.d_tile, self.cfg.w_tile, self.cfg.entry_cap,
                n_slices=self._n_slices)
            assert (do, wo, db, nc * wbc) == (
                self.d_own, self.w_own, self.d_bound, self.w_bound)
            if self.cfg.algo == "pallas":
                Cw = ed.shape[-1]
                Cp = _PALLAS_C * _ceil_div(Cw, _PALLAS_C)
                if Cp != Cw:
                    pad = ((0, 0), (0, 0), (0, Cp - Cw))
                    ed = np.pad(ed, pad, constant_values=self.cfg.d_tile)
                    ew = np.pad(ew, pad, constant_values=self.cfg.w_tile)
                    ez = np.pad(ez, pad, constant_values=0.0)
            z_grid = ez.astype(np.int32)
            tokens = (ed, ew, od, ow)
        else:
            bd, bw, bz, bm, db, wbc = partition_ratings(
                doc_ids, word_ids, z0, self.n_docs, self.vocab_size, n,
                self.cfg.chunk, n_slices=self._n_slices)
            assert (db, nc * wbc) == (self.d_bound, self.w_bound)
            z_grid = bz.astype(np.int32)
            tokens = (bd, bw, bm)
        # initial tables from the assignments (host, exact; bincount in
        # place of the reference's np.add.at gives the same counts faster)
        gd, gw, gm = self._global_token_ids(tokens)
        gz = z_grid.reshape(-1)[gm].astype(np.int64)
        Ndk = np.bincount(gd[gm] * K + gz, minlength=self.d_bound * n * K
                          ).astype(np.dtype(self.cfg.ndk_dtype)).reshape(-1, K)
        Nwk = np.bincount(gw[gm] * K + gz, minlength=self.w_bound * n * K
                          ).astype(np.float32).reshape(-1, K)
        Nk = Nwk.sum(0)
        return {"tokens": tuple(tokens), "z_grid": z_grid, "Ndk": Ndk,
                "Nwk": Nwk, "Nk": Nk, "n_tokens": int(gm.sum())}

    def _install_pack(self, pack: dict) -> None:
        """Device half of :meth:`set_tokens`: this worker's shards of a
        :meth:`pack_tokens` dict (or of ``convert.lda_state_from_numpy``'s
        tensors) on its device, and K4's entry plans."""
        from harp_tpu_torch import convert

        cfg = self.cfg
        sh = self.mesh.shard_array
        n = self.mesh.num_workers
        K = cfg.n_topics
        st = convert.lda_state_from_numpy(pack, "cpu")
        shapes = {"Ndk": (self.d_bound * n, K), "Nwk": (self.w_bound * n, K),
                  "Nk": (K,)}
        for k, s in shapes.items():
            if tuple(st[k].shape) != s:
                raise ValueError(f"pack[{k!r}] has shape "
                                 f"{tuple(st[k].shape)}, expected {s}")
        if st["Ndk"].dtype != getattr(torch, cfg.ndk_dtype):
            raise ValueError(f"pack['Ndk'] is {st['Ndk'].dtype}, the config "
                             f"says {cfg.ndk_dtype}")
        self.Ndk, self.Nwk = sh(st["Ndk"], 0), sh(st["Nwk"], 0)
        self.Nk = self.mesh.replicated(st["Nk"])
        self.z_grid = sh(st["z_grid"], 0)
        self._tokens = tuple(sh(a, 0) for a in st["tokens"])
        self._tokens_host = tuple(np.asarray(a) for a in pack["tokens"])
        self.n_tokens = int(pack["n_tokens"])
        self._plans = None
        if cfg.algo in _TILED_ALGOS:
            lo = self.mesh.rank * self._n_slices
            self._offsets = [(self._tokens_host[2][lo + s].tolist(),
                              self._tokens_host[3][lo + s].tolist())
                             for s in range(self._n_slices)]
        if cfg.algo == "pallas":
            # chain invariants (doc-topic ≤ doc length, word-topic ≤ word
            # frequency) that pick the reference's chunk width
            self._count_bounds = (
                int(np.asarray(pack["Ndk"]).sum(1, dtype=np.int64).max()),
                int(np.asarray(pack["Nwk"]).sum(1, dtype=np.int64).max()))
            ed = self._tokens_host[0]
            self.cc = K4.chunk_width(
                K, cfg.d_tile, cfg.w_tile, ed.shape[-1], cfg.ndk_dtype,
                cfg.pallas_exact_gathers, self._count_bounds)
            wbc = self.w_bound // rotate_chunks_resolved(cfg)
            lo = self.mesh.rank * self._n_slices
            self._plans = [K4.EntryPlan.build(
                *(a[lo + s] for a in self._tokens_host), cfg.d_tile,
                cfg.w_tile, self.d_bound, wbc, self.cc)
                for s in range(self._n_slices)]

    def _global_token_ids(self, tokens):
        """Grid-local → global storage (doc, word) rows + valid mask (the
        reference's, on the global token arrays)."""
        n = self.mesh.num_workers
        ns = self._n_slices
        db = self.d_bound
        wbc = self.w_bound // rotate_chunks_resolved(self.cfg)
        rows = np.arange(n * ns)
        if self.cfg.algo in _TILED_ALGOS:
            ed, ew, od, ow = (np.asarray(a) for a in tokens)
            gm = (ed < self.cfg.d_tile).reshape(-1)
            ld = np.minimum(ed, self.cfg.d_tile - 1) + od[:, :, None]
            lw = np.minimum(ew, self.cfg.w_tile - 1) + ow[:, :, None]
            gd = (ld + (rows // ns * db)[:, None, None]).reshape(-1)
            gw = (lw + (rows % ns * wbc)[:, None, None]).reshape(-1)
            return gd, gw, gm
        bd, bw, bm = (np.asarray(a) for a in tokens)
        gd = (bd + (rows // ns * db)[:, None]).reshape(-1)
        gw = (bw + (rows % ns * wbc)[:, None]).reshape(-1)
        return gd, gw, bm.reshape(-1) > 0

    # -- one rotation epoch ---------------------------------------------------

    def _draw(self, shape):
        """Exp(1) (exprace) or Gumbel (gumbel) draws from the generator."""
        e = torch.empty(shape, dtype=torch.float32, device=self.mesh.device)
        e.exponential_(generator=self._gen)
        return e if self.cfg.sampler == "exprace" else -torch.log(e)

    def _sample_block(self, Nwk, Nk, s: int, t: int, noise):
        """Resample block row ``s`` against the resident chunk ``Nwk`` and
        the step-start totals ``Nk``; returns the step's ``dNk``."""
        cfg, V, K = self.cfg, self.vocab_size, self.cfg.n_topics
        z = self.z_grid[s]
        if cfg.algo == "pallas":
            ed, ew, od, ow = (a[s] for a in self._tokens)
            drawn = {"u": noise(t, s)} if noise is not None else {
                "seeds": torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (ed.shape[0], 2),
                    dtype=torch.int32, generator=self._gen,
                    device=self.mesh.device)}
            return K4.cgs_step(
                self.Ndk, Nwk, Nk, z, ed, ew, od, ow, alpha=cfg.alpha,
                beta=cfg.beta, vbeta=V * cfg.beta, d_tile=cfg.d_tile,
                w_tile=cfg.w_tile, cc=self.cc,
                exact_gathers=cfg.pallas_exact_gathers,
                plan=self._plans[s], **drawn)
        dNk = torch.zeros(K, dtype=torch.float32, device=Nk.device)
        if cfg.algo == "dense":
            ed, ew = self._tokens[0][s], self._tokens[1][s]
            od, ow = self._offsets[s]
            draws = noise(t, s) if noise is not None else None
            for e in range(ed.shape[0]):
                ne = draws[e] if draws is not None else \
                    self._draw((ed.shape[1], K))
                d, z_new = _sample_entry_tiles(
                    self.Ndk[od[e]:od[e] + cfg.d_tile],
                    Nwk[ow[e]:ow[e] + cfg.w_tile], Nk + dNk, z[e], ed[e],
                    ew[e], ne, cfg, V)
                dNk += d
                z[e] = z_new
            return dNk
        bd, bw, bm = (a[s] for a in self._tokens)
        c = min(cfg.chunk, bd.shape[0])
        draws = noise(t, s) if noise is not None else None
        for lo in range(0, bd.shape[0], c):
            sl = slice(lo, lo + c)
            nz = draws[sl] if draws is not None else self._draw((c, K))
            d, z_new = _sample_chunk(self.Ndk, Nwk, Nk + dNk, z[sl],
                                     (bd[sl], bw[sl], bm[sl]), nz, cfg, V)
            dNk += d
            z[sl] = z_new
        return dNk

    def _epoch(self, noise: NoiseFn | None = None) -> torch.Tensor:
        """One rotation epoch: every token resampled once.  Ndk and z_grid
        change in place; returns the per-worker token counts [n] (the
        reference's skew counter)."""
        cfg = self.cfg
        nc = rotate_chunks_resolved(cfg)
        tok = self._tokens
        valid = ((tok[0] < cfg.d_tile) if cfg.algo in _TILED_ALGOS
                 else (tok[2] > 0)).sum()
        work = C.allgather(valid.to(torch.float32)[None])

        def step(Nk, chunk, t):
            dNk = self._sample_block(chunk, Nk, resident_chunk_index(t, nc),
                                     t, noise)
            return Nk + C.allreduce(dNk), chunk

        self.Nk, self.Nwk = rotate_pipeline(step, self.Nk, self.Nwk,
                                            n_chunks=nc, wire=cfg.rotate_wire)
        return work

    def _require_tokens(self, what: str) -> None:
        if self._tokens is None:
            raise RuntimeError(f"call set_tokens() before {what}()")

    def sample_epoch(self, noise: NoiseFn | None = None):
        """One Gibbs sweep, ending in one readback (the work vector).
        ``noise``: the step draws to use instead of the generator's
        (:data:`NoiseFn`)."""
        self._require_tokens("sample_epoch")
        with telemetry.span("lda.epoch"), \
                telemetry.ledger.run("lda.epochs", steps=1):
            self.last_work = self._epoch(noise).cpu().numpy()

    def sample_epochs(self, epochs: int):
        """``epochs`` sweeps as a Python loop that never waits for the
        device, with one readback at its end."""
        self._require_tokens("sample_epochs")
        with telemetry.span("lda.epochs", epochs=epochs), \
                telemetry.ledger.run("lda.epochs", steps=epochs):
            work = None
            for _ in range(epochs):
                work = self._epoch()
            if work is not None:
                self.last_work = work.cpu().numpy()

    def fit(self, epochs: int, ckpt_dir: str | None = None, *,
            ckpt_every: int = 5, max_restarts: int = 3, fault=None):
        """Sample ``epochs`` sweeps one by one.  The checkpoint/fault path
        (``ckpt_dir``, ``fault``) is not ported yet."""
        if ckpt_dir is not None or fault is not None:
            raise NotImplementedError(
                "fit's checkpoint/fault path (ckpt_dir, fault) is "
                + _ITEM.format(5))
        self._require_tokens("fit")
        for _ in range(epochs):
            self.sample_epoch()

    # -- readers (collective: every worker calls them) ------------------------

    def _global(self, x: torch.Tensor) -> np.ndarray:
        return C.allgather(x).cpu().numpy()

    def doc_topic_table(self):
        """[n_docs, K] doc-topic counts with storage padding stripped."""
        n = self.mesh.num_workers
        Ndk = self._global(self.Ndk)
        if self.cfg.algo in _TILED_ALGOS:
            K = Ndk.shape[-1]
            Ndk = Ndk.reshape(n, self.d_bound, K)[:, : self.d_own].reshape(-1, K)
        return Ndk[: self.n_docs]

    def word_topic_table(self):
        """[vocab_size, K] word-topic counts with storage padding stripped."""
        Nwk = self._global(self.Nwk)
        if self.cfg.algo in _TILED_ALGOS:
            K = Nwk.shape[-1]
            wbc = self.w_bound // rotate_chunks_resolved(self.cfg)
            Nwk = Nwk.reshape(self._n_slices, wbc, K)[:, : self.w_own] \
                .reshape(-1, K)
        return Nwk[: self.vocab_size]

    def token_state(self):
        """The chain as external ``(doc, word, z)`` token triples."""
        self._require_tokens("token_state")
        gd, gw, gm = self._global_token_ids(self._tokens_host)
        gz = self._global(self.z_grid).reshape(-1)
        d_st, w_st, z = gd[gm], gw[gm], gz[gm]
        wbc = self.w_bound // rotate_chunks_resolved(self.cfg)
        d_ext = (d_st // self.d_bound) * self.d_own + d_st % self.d_bound
        w_ext = (w_st // wbc) * self.w_own + w_st % wbc
        return d_ext, w_ext, z

    def log_likelihood(self):
        """Mean per-token predictive log-likelihood of the current
        assignments (the reference's numpy formula)."""
        self._require_tokens("log_likelihood")
        Ndk = self._global(self.Ndk)
        Nwk = self._global(self.Nwk)
        Nk = self.Nk.cpu().numpy()
        cfg = self.cfg
        gd, gw, gm = self._global_token_ids(self._tokens_host)
        gz = self._global(self.z_grid).reshape(-1)
        d, w, zz = gd[gm], gw[gm], gz[gm]
        nd = Ndk.sum(1)
        theta = (Ndk[d, zz] + cfg.alpha) / (nd[d] + cfg.n_topics * cfg.alpha)
        phi = (Nwk[w, zz] + cfg.beta) / (Nk[zz] + self.vocab_size * cfg.beta)
        return float(np.mean(np.log(np.maximum(theta * phi, 1e-12))))


# ---------------------------------------------------------------------------
# Corpora, benchmark, CLI.
# ---------------------------------------------------------------------------

def synthetic_corpus(n_docs, vocab_size, n_topics_true, tokens_per_doc,
                     seed=0):
    """Documents generated from a true LDA model (peaked topics), numpy:
    the reference's generator."""
    rng = np.random.default_rng(seed)
    band = vocab_size // n_topics_true
    doc_ids, word_ids = [], []
    for d in range(n_docs):
        topics = rng.dirichlet(np.full(n_topics_true, 0.2))
        zs = rng.choice(n_topics_true, size=tokens_per_doc, p=topics)
        ws = (zs * band + rng.integers(0, band, tokens_per_doc)) % vocab_size
        doc_ids += [d] * tokens_per_doc
        word_ids += ws.tolist()
    return np.asarray(doc_ids, np.int32), np.asarray(word_ids, np.int32)


def benchmark_corpus(n_docs, vocab_size, tokens_per_doc, seed):
    """The i.i.d. synthetic corpus :func:`benchmark` times (the
    reference's)."""
    rng = np.random.default_rng(seed)
    n_tok = n_docs * tokens_per_doc
    d_ids = np.repeat(np.arange(n_docs, dtype=np.int32), tokens_per_doc)
    w_ids = rng.integers(0, vocab_size, n_tok).astype(np.int32)
    return d_ids, w_ids


def _make_cfg(n_topics, algo="dense", chunk=None, d_tile=None, w_tile=None,
              entry_cap=None, pull_cap=None, ndk_dtype="float32",
              dedup_pulls=None, sampler=None, rng_impl=None,
              pallas_exact_gathers=None, carry_db=None,
              rotate_chunks=None, rotate_wire=None):
    """The reference's: None inherits LDAConfig's defaults; algo-specific
    knobs raise with a non-owning algo."""
    if sampler is None:
        sampler = "exprace" if algo == "pallas" else "gumbel"
    if rng_impl is None:
        rng_impl = "rbg" if algo == "pallas" else "threefry"
    if carry_db is None and algo in _TILED_ALGOS:
        carry_db = False
    return LDAConfig(n_topics=n_topics, ndk_dtype=ndk_dtype, sampler=sampler,
                     rng_impl=rng_impl,
                     **algo_kwargs(algo, {
        ("scatter", "pushpull"): {"chunk": chunk},
        _TILED_ALGOS: {"d_tile": d_tile, "w_tile": w_tile,
                       "entry_cap": entry_cap, "carry_db": carry_db},
        "pushpull": {"pull_cap": pull_cap, "dedup_pulls": dedup_pulls},
        "pallas": {"pallas_exact_gathers": pallas_exact_gathers},
        ("dense", "scatter", "pallas"): {"rotate_chunks": rotate_chunks,
                                         "rotate_wire": rotate_wire},
    }))


def benchmark(n_docs=100_000, vocab_size=50_000, n_topics=1000,
              tokens_per_doc=100, epochs=2, mesh=None, chunk=None, seed=0,
              algo="dense", d_tile=None, w_tile=None, entry_cap=None,
              pull_cap=None, ndk_dtype="float32", dedup_pulls=None,
              sampler=None, rng_impl=None, pallas_exact_gathers=None,
              carry_db=None, rotate_chunks=None, rotate_wire=None,
              pack_cache=None, device=None):
    """Tokens/s per card on the reference's enwiki-scaled corpus (graded
    config #3).  Host prep (corpus, pack, device tables) is ``prep_sec``;
    one untimed sweep runs first; the timed window is
    ``sample_epochs(epochs)``, ending in its readback."""
    if pack_cache is not None:
        raise NotImplementedError("benchmark(pack_cache=...) is not ported "
                                  "yet (ROADMAP.md, Queue 1, item 4)")
    mesh = resolve_mesh(mesh, device)
    cfg = _make_cfg(n_topics, algo, chunk, d_tile, w_tile, entry_cap,
                    pull_cap, ndk_dtype, dedup_pulls, sampler, rng_impl,
                    pallas_exact_gathers, carry_db, rotate_chunks,
                    rotate_wire)
    model = LDA(n_docs, vocab_size, cfg, mesh, seed)
    n_tok = n_docs * tokens_per_doc
    d_ids, w_ids = benchmark_corpus(n_docs, vocab_size, tokens_per_doc, seed)
    t0 = time.perf_counter()
    model.set_tokens(d_ids, w_ids)
    prep = time.perf_counter() - t0
    model.sample_epoch()
    t0 = time.perf_counter()
    model.sample_epochs(epochs)
    dt = time.perf_counter() - t0
    out = {
        "tokens_per_sec_per_chip": n_tok * epochs / dt / mesh.num_workers,
        "sec_per_epoch": dt / epochs,
        "n_tokens": n_tok, "n_topics": n_topics,
        "prep_sec": prep, "num_workers": mesh.num_workers,
    }
    if n_tok <= 20_000_000:  # host-side numpy over every token
        out["log_likelihood"] = model.log_likelihood()
    return out


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu LDA-CGS on PyTorch (edu.iu.lda parity)")
    p.add_argument("--docs", type=int, default=None, help="default: 100000")
    p.add_argument("--vocab", type=int, default=None, help="default: 50000")
    p.add_argument("--topics", type=int, default=1000)
    p.add_argument("--tokens-per-doc", type=int, default=100)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--algo", choices=["dense", "scatter", "pushpull",
                                      "pallas"], default="dense",
                   help="pallas: kernel K4; dense: whole-entry snapshots "
                        "(default); scatter: chunked gather/index_add "
                        "reference; pushpull: not ported yet")
    p.add_argument("--chunk", type=int, default=None,
                   help="scatter: tokens per count snapshot (default 8192)")
    p.add_argument("--pull-cap", type=int, default=None,
                   help="pushpull only (not ported yet)")
    p.add_argument("--no-dedup-pulls", action="store_true",
                   help="pushpull only (not ported yet)")
    p.add_argument("--sampler", choices=["gumbel", "exprace"], default=None)
    p.add_argument("--rng-impl", choices=["threefry", "rbg"], default=None)
    p.add_argument("--ndk-dtype", choices=["float32", "int16"],
                   default="float32")
    p.add_argument("--d-tile", type=int, default=None,
                   help="dense/pallas: doc-topic tile rows (default 512)")
    p.add_argument("--w-tile", type=int, default=None,
                   help="dense/pallas: word-topic tile rows (default 512)")
    p.add_argument("--entry-cap", type=int, default=None,
                   help="dense/pallas: max tokens per tile entry "
                        "(default 2048)")
    p.add_argument("--rotate-chunks", type=int, default=None,
                   help="word-slice chunks per worker (default 2)")
    p.add_argument("--rotate-wire", choices=list(ROTATE_WIRES), default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    for flag in ("--ckpt-dir", "--input"):
        p.add_argument(flag, default=None, help="not ported yet")
    p.add_argument("--ckpt-every", type=int, default=5, help="not ported yet")
    p.add_argument("--max-worker-loss", type=int, default=0,
                   help="not ported yet")
    for flag in ("--resume", "--elastic"):
        p.add_argument(flag, action="store_true", help="not ported yet")
    args = p.parse_args(argv)
    unported = [(f, item) for f, on, item in (
        ("--ckpt-dir", args.ckpt_dir, 5), ("--resume", args.resume, 5),
        ("--input", args.input, 5), ("--elastic", args.elastic, 8),
        ("--max-worker-loss", args.max_worker_loss, 8)) if on]
    if unported:
        raise NotImplementedError("; ".join(
            f"{f} is " + _ITEM.format(item) for f, item in unported))
    mesh = WorkerMesh(args.device)
    print(benchmark_json("lda_cli", benchmark(
        args.docs or 100_000, args.vocab or 50_000, args.topics,
        args.tokens_per_doc, args.epochs, mesh=mesh, chunk=args.chunk,
        algo=args.algo, d_tile=args.d_tile, w_tile=args.w_tile,
        entry_cap=args.entry_cap, pull_cap=args.pull_cap,
        ndk_dtype=args.ndk_dtype,
        dedup_pulls=False if args.no_dedup_pulls else None,
        sampler=args.sampler, rng_impl=args.rng_impl,
        rotate_chunks=args.rotate_chunks, rotate_wire=args.rotate_wire),
        mesh.device))
    return 0


if __name__ == "__main__":
    main()
