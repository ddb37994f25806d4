"""LDA via collapsed Gibbs sampling — the port of ``harp_tpu.models.lda``:
model rotation, and Harp's push/pull variant.

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
Three rotation algos (``LDAConfig.algo``):

- ``"pallas"`` (the config's default): kernel K4
  (:func:`harp_tpu_torch.ops.lda_kernel.cgs_step`), one call per rotation
  step, over dense tile entries; an entry samples in ``cc``-token chunks
  (:func:`~harp_tpu_torch.ops.lda_kernel.chunk_width`), each chunk against
  the counts the chunks before it left;
- ``"dense"``: the same entries, each sampled against one whole-entry
  snapshot (the reference's XLA path), with gathers and ``index_add_``;
- ``"scatter"``: fixed-size token chunks over ``partition_ratings`` blocks
  against the whole local tables, the readable reference formulation.

``"pushpull"`` is Harp's other ``edu.iu.lda`` variant: nothing rotates.
Tokens go to the worker that owns their doc
(:func:`partition_tokens_by_doc`); the word-topic table stays row-sharded
(worker ``w`` owns words ``[w · w_own, (w + 1) · w_own)``) and each
``chunk`` of tokens pulls the word rows it touches
(:func:`harp_tpu_torch.table.pull_rows_sparse`, or its ``_dedup`` form),
samples, and pushes its deltas back (``push_rows_sparse``), then
allreduces its topic-total deltas.  The exchange travels in ``[nw,
pull_cap, K]`` buffers; a token whose request drops past ``pull_cap``
keeps its topic that sweep (a skipped Gibbs site) and is counted in
``last_dropped``.  :func:`suggest_pull_cap` gives the exact zero-drop cap.
The path is plain PyTorch, as the reference's is.

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

``fit(epochs, ckpt_dir)`` checkpoints each worker's counts, topics and
generator state through :func:`harp_tpu_torch.utils.fault.fit_epochs`, so a
recovered chain is the uninterrupted one; the CLI samples with
``--ckpt-dir``/``--resume`` and reads ``doc word [count]`` rows with
``--input``.

``--elastic``/``--max-worker-loss`` sample through
:func:`harp_tpu_torch.elastic.apps.lda_elastic_fit`.  A sweep call is one
dispatch (``lda.epoch`` on the flight recorder) ending in one readback,
which carries the per-worker token counts to the skew ledger; with
telemetry on, loading a corpus records the partition's per-worker tokens.

Not ported yet (ROADMAP.md, Queue 1, item 4): ``benchmark(pack_cache=...)``;
it raises ``NotImplementedError``.
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
from harp_tpu_torch import table as T
from harp_tpu_torch.ops import lda_kernel as K4
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.parallel.rotate import (ROTATE_WIRES, resident_chunk_index,
                                           rotate_pipeline)
from harp_tpu_torch.utils import flightrec, skew, telemetry

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
    chunk: int = 8192   # scatter/pushpull: tokens sampled per snapshot
    # pushpull: request slots per (worker, owner) pair and chunk; None =
    # chunk, which never drops (suggest_pull_cap: the exact zero-drop cap)
    pull_cap: int | None = None
    # pushpull: duplicate word rows of a chunk share one wire slot
    dedup_pulls: bool = True
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


def _sample_chunk_pushpull(Ndk, Nwk_shard, Nk, z, chunk, noise,
                           cfg: LDAConfig, vocab_size):
    """Pull → sample → push for one token chunk (the pushpull algo).

    ``Nwk_shard`` is this worker's row block of the global word-topic
    table; the chunk's word rows arrive by ``pull_rows_sparse`` (or its
    ``_dedup`` form) and its deltas return by ``push_rows_sparse``.  A
    token whose request dropped keeps its topic and so has a zero delta.
    Updates ``Ndk`` in place; returns ``(Nwk_shard, dNk, z_new,
    tok_drop)``, ``tok_drop`` the tokens skipped in this chunk over all
    workers."""
    d, w, m = chunk  # worker-local doc rows, GLOBAL word ids, valid mask
    K = cfg.n_topics
    cap = cfg.pull_cap if cfg.pull_cap is not None else d.shape[0]
    pull = T.pull_rows_sparse_dedup if cfg.dedup_pulls else T.pull_rows_sparse
    push = T.push_rows_sparse_dedup if cfg.dedup_pulls else T.push_rows_sparse
    real = m > 0
    # padding tokens send no request and take no slot
    rows, ok, _ = pull(Nwk_shard, w, capacity=cap, valid=real)
    tok_drop = C.allreduce((real & ~ok).sum().to(torch.int32))
    live = real & ok
    d = d.long()
    oh_old = _one_hot(z, K, live)
    ndk = Ndk[d].to(torch.float32) - oh_old
    nwk = rows - oh_old
    nk = Nk[None, :] - oh_old
    z_new = _cgs_resample(ndk, nwk, nk, z, live, noise, cfg, vocab_size)
    delta = _one_hot(z_new, K, live) - oh_old
    Ndk.index_add_(0, d, delta.to(Ndk.dtype))
    # the push takes the pull's mask: a dropped token's slot carries a
    # zero delta either way
    Nwk_shard, _ = push(Nwk_shard, w, delta, capacity=cap, valid=real)
    return Nwk_shard, delta.sum(0), z_new, tok_drop


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
#: scatter the same per token of the block, [B, K]; pushpull (one step,
#: one block: ``noise(0, 0)``) per token of this worker, [T_pad, K]
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
        elif self.cfg.algo == "pushpull":
            self.d_bound = self.d_own = _ceil_div(n_docs, n)
            # the word-topic rows this worker owns of the row-sharded table
            self.w_bound = self.w_own = _ceil_div(vocab_size, n)
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
        # per-worker [(pack_id, load)] grains the elastic loop sets, so
        # the skew trigger's plan moves whole packs
        self.skew_units = None
        self._sweeps_fn = flightrec.track(self._sweeps, "lda.epoch")
        # pushpull: tokens skipped by pull_cap drops in the last
        # sample_epoch/sample_epochs call, over all workers
        self.last_dropped = 0
        self.cc = None  # pallas: K4's chunk width, set by set_tokens

    # -- corpus ---------------------------------------------------------------

    def suggest_pull_cap(self, apply=False) -> int:
        """The exact zero-drop ``pull_cap`` of the loaded corpus (pushpull
        only; :func:`suggest_pull_cap`).  ``apply=True`` installs it in the
        config for the next sweeps."""
        if self.cfg.algo != "pushpull":
            raise ValueError("suggest_pull_cap applies to algo='pushpull'")
        if self._tokens is None:
            raise RuntimeError("call set_tokens() before suggest_pull_cap()")
        _, pw, pm = self._tokens_host
        cap = suggest_pull_cap(pw, pm, self.mesh.num_workers,
                               self.cfg.chunk, self.vocab_size,
                               dedup=self.cfg.dedup_pulls)
        if apply:
            self.cfg.pull_cap = cap
        return cap

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
        elif self.cfg.algo == "pushpull":
            pd, pw, pz, pm, db = partition_tokens_by_doc(
                doc_ids, word_ids, z0, self.n_docs, n, self.cfg.chunk)
            assert db == self.d_bound
            z_grid = pz.reshape(-1)
            tokens = (pd.reshape(-1), pw.reshape(-1), pm.reshape(-1))
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
        if telemetry.enabled():
            _, _, gm = self._global_token_ids(self._tokens_host)
            skew.record_partition("lda.partition", gm.reshape(n, -1).sum(1),
                                  unit="tokens", padded_total=gm.size)
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
        if self.cfg.algo == "pushpull":
            pd, pw, pm = (np.asarray(a) for a in tokens)
            gd = pd + np.arange(n).repeat(pd.shape[0] // n) * self.d_bound
            return gd, pw, pm > 0  # word ids are global already
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

    def _pushpull_epoch(self, noise: NoiseFn | None = None):
        """One push/pull sweep: pull → sample → push for each ``chunk`` of
        this worker's tokens, ``Nk += allreduce(dNk)`` after each.  Returns
        (the per-worker token counts [n], the tokens dropped over all
        workers), both left on the device."""
        cfg, V = self.cfg, self.vocab_size
        d, w, m = self._tokens
        z = self.z_grid
        c = min(cfg.chunk, d.shape[0])
        draws = noise(0, 0) if noise is not None else None
        drop = torch.zeros((), dtype=torch.int32, device=d.device)
        for lo in range(0, d.shape[0], c):
            sl = slice(lo, lo + c)
            nz = draws[sl] if draws is not None else self._draw(
                (c, cfg.n_topics))
            self.Nwk, dNk, z_new, tok_drop = _sample_chunk_pushpull(
                self.Ndk, self.Nwk, self.Nk, z[sl], (d[sl], w[sl], m[sl]), nz,
                cfg, V)
            self.Nk = self.Nk + C.allreduce(dNk)
            drop = drop + tok_drop
            z[sl] = z_new
        work = C.allgather((m > 0).sum().to(torch.float32)[None])
        return work, drop

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

    def _sweeps(self, epochs: int, noise: NoiseFn | None = None) -> None:
        """``epochs`` sweeps with one readback at the end: the work vector
        and, for pushpull, the drop count summed over the sweeps."""
        work, drop = None, None
        for _ in range(epochs):
            if self.cfg.algo == "pushpull":
                work, d = self._pushpull_epoch(noise)
                drop = d if drop is None else drop + d
            else:
                work = self._epoch(noise)
        if drop is not None:  # one stacked readback
            stats = flightrec.readback(
                torch.cat([drop.to(torch.float32)[None], work]))
            self.last_dropped = int(stats[0])
            self.last_work = stats[1:]
        elif work is not None:
            self.last_work = flightrec.readback(work)

    def sample_epoch(self, noise: NoiseFn | None = None):
        """One Gibbs sweep, ending in one readback (the work vector, and
        the drop count for pushpull).  ``noise``: the step draws to use
        instead of the generator's (:data:`NoiseFn`)."""
        self._require_tokens("sample_epoch")
        with telemetry.span("lda.epoch"), \
                telemetry.ledger.run("lda.epochs", steps=1):
            t0 = time.perf_counter()
            self._sweeps_fn(1, noise)
            skew.record_execution("lda.epochs", self.last_work,
                                  unit="tokens",
                                  wall_s=time.perf_counter() - t0,
                                  units=self.skew_units)

    def sample_epochs(self, epochs: int):
        """``epochs`` sweeps as a Python loop that never waits for the
        device, with one readback at its end."""
        self._require_tokens("sample_epochs")
        with telemetry.span("lda.epochs", epochs=epochs), \
                telemetry.ledger.run("lda.epochs", steps=epochs):
            t0 = time.perf_counter()
            self._sweeps_fn(epochs)
            if self.last_work is not None:
                skew.record_execution("lda.epochs", self.last_work,
                                      unit="tokens",
                                      wall_s=time.perf_counter() - t0,
                                      units=self.skew_units)

    def fit(self, epochs: int, ckpt_dir: str | None = None, *,
            ckpt_every: int = 5, max_restarts: int = 3, fault=None):
        """Sample ``epochs`` sweeps one by one, with optional
        checkpoint/resume (the contract of :meth:`MFSGD.fit
        <harp_tpu_torch.models.mfsgd.MFSGD.fit>`).  The checkpoint holds the
        generator's state beside ``Ndk``/``Nwk``/``Nk``/``z``, so a
        recovered run samples the chain it would have sampled without the
        crash."""
        from harp_tpu_torch.utils.fault import (check_restored_shapes,
                                                fit_epochs, to_device)

        self._require_tokens("fit")
        dev = self.mesh.device

        def get_state():
            return {"Ndk": self.Ndk, "Nwk": self.Nwk, "Nk": self.Nk,
                    "z": self.z_grid, "gen": self._gen.get_state()}

        def set_state(state):
            check_restored_shapes([("Ndk", state["Ndk"], self.Ndk),
                                   ("Nwk", state["Nwk"], self.Nwk),
                                   ("z", state["z"], self.z_grid)])
            # a restore casts Ndk to the configured dtype (integer counts,
            # exact in either)
            self.Ndk = to_device(state["Ndk"], dev, self.Ndk.dtype)
            self.Nwk = to_device(state["Nwk"], dev, self.Nwk.dtype)
            self.Nk = to_device(state["Nk"], dev, self.Nk.dtype)
            self.z_grid = to_device(state["z"], dev, self.z_grid.dtype)
            self._gen.set_state(to_device(state["gen"], "cpu"))

        fit_epochs(self.sample_epoch, get_state, set_state, epochs, ckpt_dir,
                   ckpt_every=ckpt_every, max_restarts=max_restarts,
                   fault=fault, phase="lda.epochs")

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
        if self.cfg.algo == "pushpull":
            # unpadded doc storage (d_bound == d_own), global word ids
            return d_st, w_st, z
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


def partition_tokens_by_doc(doc_ids, word_ids, z0, n_docs, n_workers,
                            chunk):
    """Tokens to the worker that owns their doc (the pushpull layout; the
    reference's, bit for bit).

    Worker ``w`` owns docs ``[w · d_bound, (w + 1) · d_bound)``.  Returns
    ``(d [n, T_pad] worker-local doc rows, w [n, T_pad] global word ids,
    z [n, T_pad], m [n, T_pad] mask, d_bound)``, ``T_pad`` a multiple of
    ``chunk``; padding slots hold doc and word 0 and mask 0."""
    d_bound = _ceil_div(n_docs, n_workers)
    owner = np.asarray(doc_ids) // d_bound
    per = [np.flatnonzero(owner == wk) for wk in range(n_workers)]
    t_max = max((len(p) for p in per), default=0)
    T_pad = max(chunk, _ceil_div(t_max, chunk) * chunk) if t_max else chunk
    d = np.zeros((n_workers, T_pad), np.int32)
    w = np.zeros((n_workers, T_pad), np.int32)
    z = np.zeros((n_workers, T_pad), np.int32)
    m = np.zeros((n_workers, T_pad), np.float32)
    for wk, idx in enumerate(per):
        t = len(idx)
        d[wk, :t] = np.asarray(doc_ids)[idx] - wk * d_bound
        w[wk, :t] = np.asarray(word_ids)[idx]
        z[wk, :t] = np.asarray(z0)[idx]
        m[wk, :t] = 1.0
    return d, w, z, m, d_bound


def suggest_pull_cap(word_ids, mask, n_workers, chunk, vocab_size,
                     dedup=True) -> int:
    """The EXACT zero-drop ``pull_cap`` of a :func:`partition_tokens_by_doc`
    layout: over every (worker, chunk), the most requests one owner
    receives — distinct word rows with ``dedup`` (the ``dedup_pulls``
    wire), tokens without.  One host pass over the corpus."""
    w = np.asarray(word_ids).reshape(n_workers, -1)
    m = np.asarray(mask).reshape(n_workers, -1) > 0
    rows_local = _ceil_div(vocab_size, n_workers)
    c = min(chunk, w.shape[1])
    cap = 1
    for wk in range(n_workers):
        ww, mm = w[wk].reshape(-1, c), m[wk].reshape(-1, c)
        for j in range(ww.shape[0]):
            ids = ww[j][mm[j]]
            if dedup:
                ids = np.unique(ids)
            if ids.size:
                cap = max(cap, int(np.bincount(ids // rows_local,
                                               minlength=n_workers).max()))
    return cap


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
    ``sample_epochs(epochs)``, ending in its readback.  pushpull adds
    ``dropped_tokens``, the timed sweeps' ``last_dropped``."""
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
    if algo == "pushpull":
        out["dropped_tokens"] = model.last_dropped  # pull_cap overflow
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
                        "reference; pushpull: row-sharded word-topic "
                        "table, sparse pull/push of the rows a chunk "
                        "touches")
    p.add_argument("--chunk", type=int, default=None,
                   help="scatter/pushpull: tokens per count snapshot "
                        "(default 8192)")
    p.add_argument("--pull-cap", type=int, default=None,
                   help="pushpull only: request slots per (worker, owner) "
                        "pair and chunk (default: the chunk, never drops; "
                        "LDA.suggest_pull_cap gives the exact zero-drop "
                        "cap)")
    p.add_argument("--no-dedup-pulls", action="store_true",
                   help="pushpull only: one wire slot per token instead of "
                        "one per distinct word row of a chunk")
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
    p.add_argument("--ckpt-dir", default=None,
                   help="sample with checkpoint/resume instead of "
                        "benchmarking; a rerun on the same directory "
                        "resumes the chain from the latest saved epoch")
    p.add_argument("--ckpt-every", type=int, default=5)
    p.add_argument("--resume", action="store_true",
                   help="require a resume: --ckpt-dir must already hold a "
                        "checkpoint")
    p.add_argument("--input", default=None, metavar="FILE_OR_GLOB",
                   help="token files ('doc word [count]' rows); implies "
                        "sampling mode. --docs/--vocab are raised to max "
                        "id + 1 as needed")
    p.add_argument("--elastic", action="store_true",
                   help="elastic training: take mid-run skew_trigger "
                        "findings between sweeps (rebalance doc packs, "
                        "chain kept) and checkpoint mesh-independent state")
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
                "--docs/--vocab/--tokens-per-doc (file inputs ride the "
                "non-elastic fit)")
        from harp_tpu_torch.elastic.apps import lda_elastic_fit

        n_docs, vocab = args.docs or 100_000, args.vocab or 50_000
        d_ids, w_ids = synthetic_corpus(n_docs, vocab,
                                        max(2, args.topics // 8),
                                        args.tokens_per_doc)
        ad = lda_elastic_fit(
            d_ids, w_ids, n_docs=n_docs, vocab_size=vocab,
            cfg=_make_cfg(args.topics, args.algo, args.chunk,
                          args.d_tile, args.w_tile, args.entry_cap,
                          args.pull_cap, args.ndk_dtype,
                          False if args.no_dedup_pulls else None,
                          args.sampler, args.rng_impl,
                          rotate_chunks=args.rotate_chunks,
                          rotate_wire=args.rotate_wire),
            epochs=args.epochs, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            max_worker_loss=max(args.max_worker_loss, 0), mesh=mesh)
        print(benchmark_json("lda_elastic_cli", {
            "epochs": args.epochs,
            "log_likelihood": (None if ad.sat_out
                               else round(ad.metric(), 4)),
            "n_workers": ad.mesh.num_workers if ad.mesh.is_member else 0,
            "worker_losses": ad.losses, "ckpt_dir": args.ckpt_dir},
            mesh.device))
        maybe_emit("lda")
        return 0
    if args.input or args.ckpt_dir:
        if args.input:
            from harp_tpu_torch.native.datasource import load_triples_glob

            try:
                d_ids, w_ids, counts, has_counts = load_triples_glob(
                    args.input)
            except ValueError as e:
                raise SystemExit(str(e))
            if int(d_ids.min()) < 0 or int(w_ids.min()) < 0:
                raise SystemExit(f"{args.input}: negative doc/word ids")
            if has_counts:
                # an explicit count column: 0 means absent (dropped)
                reps = np.maximum(counts.astype(np.int64), 0)
            else:
                reps = np.ones(len(d_ids), np.int64)  # a bare pair: 1 token
            d_ids = np.repeat(d_ids, reps)
            w_ids = np.repeat(w_ids, reps)
            if len(d_ids) == 0:
                raise SystemExit(f"{args.input}: all token counts are zero")
            n_docs = max(args.docs or 0, int(d_ids.max()) + 1)
            vocab = max(args.vocab or 0, int(w_ids.max()) + 1)
        else:
            n_docs, vocab = args.docs or 100_000, args.vocab or 50_000
            d_ids, w_ids = synthetic_corpus(n_docs, vocab,
                                            max(2, args.topics // 8),
                                            args.tokens_per_doc)
        model = LDA(n_docs, vocab,
                    _make_cfg(args.topics, args.algo, args.chunk,
                              args.d_tile, args.w_tile, args.entry_cap,
                              args.pull_cap, args.ndk_dtype,
                              False if args.no_dedup_pulls else None,
                              args.sampler, args.rng_impl,
                              rotate_chunks=args.rotate_chunks,
                              rotate_wire=args.rotate_wire), mesh)
        model.set_tokens(d_ids, w_ids)
        model.fit(args.epochs, args.ckpt_dir, ckpt_every=args.ckpt_every)
        print(benchmark_json("lda_fit_cli", {
            "epochs": args.epochs, "ckpt_dir": args.ckpt_dir,
            "resumed_from": resumed_from,
            "log_likelihood": round(model.log_likelihood(), 4)},
            mesh.device))
        maybe_emit("lda")
        return 0
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
    maybe_emit("lda")
    return 0


if __name__ == "__main__":
    main()
