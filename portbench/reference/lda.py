"""The plain reference of LDA by collapsed Gibbs sampling with model
rotation on one worker: the stated algorithm, in plain PyTorch, from the
corpus, the seed's initial topics and the seed's random draws alone.

The collapsed Gibbs update as published (Griffiths and Steyvers, Finding
scientific topics, PNAS 2004): token ``i`` of document ``d`` and word
``w`` takes topic ``k`` with probability proportional to

    (n_dk + α) (n_wk + β) / (n_k + Vβ),

the counts taken without the token itself.  The configuration
(``configs/lda-*.json``) states how the tokens are visited; the
departures from one token at a time, as stated:

- the words split into ``rotate_chunks`` slices of ``ceil(V /
  rotate_chunks)`` ids; a sweep resamples slice 0's tokens, then slice
  1's (model rotation on one worker);
- inside a slice the tokens fall into ``d_tile × w_tile`` tiles, taken
  doc-tile-major; a tile's tokens, in corpus order, are cut into entries
  of ``C`` slots, ``C = min(entry_cap, 8·ceil(m / 8))`` (at least 8) with
  ``m`` the most tokens any tile holds, and the slot count is padded to a
  multiple of 256; each slice numbers its entries from 0;
- an entry is walked in chunks of ``cc`` slots (:func:`chunk_width`):
  every token of a chunk samples against the counts as the chunks and
  entries before it left them, and the chunk's ±1 changes land together
  (a blocked Gibbs step);
- the draw is the exponential race: ``argmin_k (−log u_k)·c_k / (a_k
  b_k)`` with ``a = max(n_dk − old + α, 1e-10)``, ``b = max(n_wk − old +
  β, 1e-10)``, ``c = max(n_k − old + Vβ, 1e-10)`` (``old`` is 1 at the
  token's topic), ties to the lowest topic: the same law as the
  proportional draw;
- the uniforms are Philox4x32-10 (Salmon et al., SC 2011): entry ``e`` of
  a rotation step holds two seed words ``(s0, s1)``; slot ``p`` of chunk
  ``j = p // cc`` draws topic ``k`` from word ``k % 4`` of Philox under
  key ``(s0, s1 ^ j·0x9E3779B9)`` at counter ``(p, k // 4, 0, 0)``, ``u
  = (bits >> 8)·2⁻²⁴ + 2⁻²⁵``.

Counts are float32 integers here (exact below 2²⁴); the recount and the
likelihood are int64 and float64.
"""

from __future__ import annotations

import torch

#: slots of an entry are padded to a multiple of this
_SLOT_PAD = 256
#: the chunk rule's budget and least chunk (module docstring of chunk_width)
_BUDGET = 14 << 20
_LEAST_CHUNK = 128


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class Layout:
    """Where each token of the corpus sits: its slice, entry and slot, its
    tile-local ids and its tile offsets, and the chunk width ``cc``,
    worked out from the corpus and the configuration alone.

    ``order`` lists the corpus's tokens slice by slice, entry by entry,
    slot by slot; every per-token tensor below is in that order."""

    def __init__(self, docs: torch.Tensor, words: torch.Tensor,
                 config: dict):
        dev = docs.device
        n_docs, V = config["n_docs"], config["vocab_size"]
        nc, dt, wt = (config["rotate_chunks"], config["d_tile"],
                      config["w_tile"])
        w_own = _ceil(V, nc)
        self.d_rows = dt * _ceil(n_docs, dt)
        self.w_rows = wt * _ceil(w_own, wt)  # a slice's word rows
        ntd, ntw = self.d_rows // dt, self.w_rows // wt
        docs, words = docs.long(), words.long()
        sl = words // w_own
        lw = words - sl * w_own
        tile = (sl * ntd + docs // dt) * ntw + lw // wt
        tile, order = torch.sort(tile, stable=True)
        n_tiles = nc * ntd * ntw
        counts = torch.bincount(tile, minlength=n_tiles)
        C = int(min(config["entry_cap"],
                    max(8, 8 * _ceil(int(counts.max()), 8))))
        per_tile = (counts + C - 1) // C
        first = torch.cumsum(per_tile, 0) - per_tile
        tile_slice = torch.arange(n_tiles, device=dev) // (ntd * ntw)
        slice_first = first.reshape(nc, -1)[:, 0]
        first = first - slice_first[tile_slice]
        self.entries = per_tile.reshape(nc, -1).sum(1)  # real, per slice
        self.NE = max(1, int(self.entries.max()))
        self.C = _SLOT_PAD * _ceil(C, _SLOT_PAD)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(tile.numel(), device=dev) - starts[tile]
        self.order = order
        self.slice = tile_slice[tile]
        self.entry = first[tile] + pos // C
        self.slot = pos % C
        d, lw = docs[order], lw[order]
        self.doc = d
        self.word = words[order]
        self.word_row = self.slice * self.w_rows + lw  # Nwk storage row
        self.od = (d // dt) * dt
        self.ow = (lw // wt) * wt
        self.cd = d - self.od
        self.cw = lw - self.ow
        self.n_tokens = int(order.numel())
        self.d_tile, self.w_tile, self.n_slices = dt, wt, nc
        self.cc = chunk_width(config["n_topics"], dt, wt, self.C,
                              config["ndk_dtype"] == "int16",
                              int(torch.bincount(d).max()),
                              int(torch.bincount(self.word_row).max()))

    def flat(self) -> torch.Tensor:
        """Each token's index into a flattened ``[slices, NE, C]`` grid."""
        return (self.slice * self.NE + self.entry) * self.C + self.slot


def _planes(bound: int) -> int:
    return 1 if bound <= 256 else 2 if bound < 2 ** 16 else 3


def chunk_width(K: int, d_tile: int, w_tile: int, C: int, int16: bool,
                doc_bound: int, word_bound: int) -> int:
    """Tokens a chunk, as the configuration states it: start at ``min(C,
    256)`` and halve, down to 128, while ``((2 if int16 else 4) + 4)·K·
    d_tile + 8·K·w_tile + 24·K·cc + p·K·max(d_tile, w_tile)`` exceeds 14
    MiB, with ``p`` 6 where the longest document (``doc_bound``) or the
    most frequent word (``word_bound``) needs two or more base-256 digits
    (more than 256), else 2.  (The rule of Harp's TPU kernel, whose chunk
    decides which tokens share a snapshot.)"""
    nd, nw = _planes(doc_bound), _planes(word_bound)
    per = 6 if max(nd, nw) >= 2 else 2

    def est(cc):
        return ((2 if int16 else 4) + 4) * K * d_tile + 8 * K * w_tile \
            + 24 * K * cc + per * K * max(d_tile, w_tile)

    cc = min(C, 256)
    while est(cc) > _BUDGET and cc > _LEAST_CHUNK and cc % 2 == 0:
        cc //= 2
    return cc


# ---- Philox4x32-10 ----------------------------------------------------------

_MASK = 0xFFFFFFFF
_MUL = (0xD2511F53, 0xCD9E8D57)
_BUMP = (0x9E3779B9, 0xBB67AE85)


def _mul32(a: torch.Tensor, m: int):
    """(high, low) 32-bit halves of ``a · m`` for 32-bit ``a`` in int64."""
    lo16 = (a & 0xFFFF) * m
    hi16 = (a >> 16) * m
    low = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (low >> 32), low & _MASK


def philox(c0, c1, k0, k1):
    """The four output words of Philox4x32-10 at counter ``(c0, c1, 0,
    0)`` under key ``(k0, k1)`` (int64 tensors holding 32-bit words)."""
    c0, c1 = torch.broadcast_tensors(c0, c1)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        h0, l0 = _mul32(c0, _MUL[0])
        h1, l1 = _mul32(c2, _MUL[1])
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
        k0 = (k0 + _BUMP[0]) & _MASK
        k1 = (k1 + _BUMP[1]) & _MASK
    return c0, c1, c2, c3


def uniforms(seed2: torch.Tensor, slots: torch.Tensor, cc: int,
             K: int) -> torch.Tensor:
    """``[len(slots), K]`` float32 uniforms of the given slots (module
    docstring): ``seed2`` is the entry's two seed words ``[2]``, or each
    slot's entry's ``[len(slots), 2]``."""
    s = seed2.long().reshape(-1, 2) & _MASK
    slots = slots.long()[:, None]
    grp = torch.arange(_ceil(K, 4), device=slots.device)[None, :]
    k1 = s[:, 1:] ^ (((slots // cc) * _BUMP[0]) & _MASK)
    words = torch.stack(philox(slots, grp, s[:, :1], k1), dim=-1)
    bits = words.reshape(slots.shape[0], -1)[:, :K]
    return (bits >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25


# ---- the sampler ------------------------------------------------------------

#: tokens whose draws are made at once
_DRAW_BLOCK = 1 << 16
#: tokens whose draws are held at once on the card (a block of chunks)
_RACE_ROWS = {"cuda": 1 << 18, "cpu": 1 << 14}
#: chunks a captured CUDA graph walks
_GRAPH_CHUNKS = 8


class Chain:
    """The reference's own chain: every token's topic and the tables
    counted from them, resampled rotation step by rotation step, chunk by
    chunk, as the module docstring states.

    ``z`` is each token's topic in ``layout.order``.  On the card the
    chunks are walked by replaying a captured CUDA graph of
    ``_GRAPH_CHUNKS`` chunk updates (the same operations, launched
    together; a chunk's index is read from the card); on the CPU they run
    one call a chunk."""

    def __init__(self, layout: Layout, z: torch.Tensor, config: dict):
        dev = z.device
        K = config["n_topics"]
        self.lay, self.K, self.cc, self.n = layout, K, layout.cc, \
            layout.n_tokens
        self.alpha, self.beta = float(config["alpha"]), float(config["beta"])
        self.vbeta = config["vocab_size"] * config["beta"]
        one = torch.ones(1, dtype=torch.long, device=dev)
        wrows = layout.n_slices * layout.w_rows
        # one more slot and table row each: where a chunk's pad points
        self.z = torch.cat([z.long(), 0 * one])
        self.doc = torch.cat([layout.doc, layout.d_rows * one])
        self.wrow = torch.cat([layout.word_row, wrows * one])
        self.Ndk = self._count(self.doc, layout.d_rows + 1)
        self.Nwk = self._count(self.wrow, wrows + 1)
        self.nk = torch.bincount(self.z[:self.n], minlength=K).to(
            torch.float32)
        self.topics = torch.arange(K, device=dev)
        self.R = _RACE_ROWS.get(dev.type, _RACE_ROWS["cpu"])
        self.race = torch.ones((self.R + 1, K), dtype=torch.float32,
                               device=dev)
        self.graphs = dev.type == "cuda"
        rows = self.R + _GRAPH_CHUNKS
        self.CT = torch.full((rows, self.cc), self.n, dtype=torch.long,
                             device=dev)
        self.RT = torch.full((rows, self.cc), self.R, dtype=torch.long,
                             device=dev)
        self.J = torch.zeros(1, dtype=torch.long, device=dev)
        self._graph = None

    def _count(self, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
        t = torch.zeros((n_rows, self.K), dtype=torch.float32,
                        device=rows.device)
        t.index_put_((rows[:self.n], self.z[:self.n]),
                     torch.ones(self.n, dtype=torch.float32,
                                device=rows.device), accumulate=True)
        return t

    def _chunk(self) -> None:
        """The chunk in row ``J`` of the chunk table: every token samples
        against the counts the chunks before it left, then the chunk's
        ±1 changes land; ``J`` moves on."""
        t = self.CT.index_select(0, self.J)[0]
        r = self.RT.index_select(0, self.J)[0]
        real = (t < self.n).to(torch.float32)[:, None]
        d, w, zj = self.doc[t], self.wrow[t], self.z[t]
        old = (self.topics == zj[:, None]).to(torch.float32)
        a = torch.clamp_min((self.Ndk[d] - old) + self.alpha, 1e-10)
        b = torch.clamp_min((self.Nwk[w] - old) + self.beta, 1e-10)
        c = torch.clamp_min((self.nk[None, :] - old) + self.vbeta, 1e-10)
        ratio = self.race[r] * c / (a * b)
        best = ratio.min(dim=1, keepdim=True).values
        pick = torch.where(ratio == best, self.topics, self.K).min(
            dim=1).values
        delta = ((self.topics == pick[:, None]).to(torch.float32) - old) \
            * real
        self.Ndk.index_add_(0, d, delta)
        self.Nwk.index_add_(0, w, delta)
        self.nk += delta.sum(0)
        self.z[t] = torch.where(real[:, 0] > 0, pick, zj)
        self.J += 1

    def _walk(self, n_chunks: int) -> None:
        """Run rows ``0 .. n_chunks - 1`` of the chunk table (rows past
        them hold pads, which change nothing)."""
        self.J.zero_()
        if not self.graphs:
            for _ in range(n_chunks):
                self._chunk()
            return
        if self._graph is None:
            saved = (self.CT[:_GRAPH_CHUNKS].clone(),
                     self.RT[:_GRAPH_CHUNKS].clone())
            self.CT[:_GRAPH_CHUNKS] = self.n
            self.RT[:_GRAPH_CHUNKS] = self.R
            side = torch.cuda.Stream(self.J.device)
            side.wait_stream(torch.cuda.current_stream(self.J.device))
            with torch.cuda.stream(side):
                for _ in range(_GRAPH_CHUNKS):  # pads: a warm-up that
                    self._chunk()               # changes no count
            torch.cuda.current_stream(self.J.device).wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            self.J.zero_()
            with torch.cuda.graph(self._graph):
                for _ in range(_GRAPH_CHUNKS):
                    self._chunk()
            self.CT[:_GRAPH_CHUNKS], self.RT[:_GRAPH_CHUNKS] = saved
            self.J.zero_()
        for _ in range(_ceil(n_chunks, _GRAPH_CHUNKS)):
            self._graph.replay()

    def step(self, s: int, seeds: torch.Tensor,
             least_chunks: int | None = None) -> tuple[int, int, int]:
        """Rotation step over slice ``s`` under its seed words ``seeds [NE,
        2]``: every entry, or the first ones spanning at least
        ``least_chunks`` chunks.  Returns ``(lo, hi, chunks)``: the tokens
        resampled are ``layout.order[lo:hi]``."""
        lay, cc, dev = self.lay, self.cc, self.z.device
        lo = int((lay.slice < s).sum())
        hi = lo + int((lay.slice == s).sum())
        per_entry = torch.bincount(lay.entry[lo:hi])
        n_ch = (per_entry + cc - 1) // cc
        if least_chunks is not None:
            n_pre = min(int(torch.searchsorted(torch.cumsum(n_ch, 0),
                                               least_chunks)) + 1,
                        n_ch.numel())
            per_entry, n_ch = per_entry[:n_pre], n_ch[:n_pre]
            hi = lo + int(per_entry.sum())
        first_chunk = torch.cumsum(n_ch, 0) - n_ch
        ch_entry = torch.repeat_interleave(
            torch.arange(n_ch.numel(), device=dev), n_ch)
        j = torch.arange(ch_entry.numel(), device=dev) - first_chunk[ch_entry]
        start = (lo + torch.cumsum(per_entry, 0) - per_entry)[ch_entry] \
            + j * cc
        length = torch.clamp(per_entry[ch_entry] - j * cc, max=cc)
        end = (start + length).cpu()
        lane = torch.arange(cc, device=dev)[None, :]
        c0, n_chunks = 0, end.numel()
        while c0 < n_chunks:
            t_lo = int(start[c0])
            # the chunks whose tokens fit the race rows
            c1 = c0 + max(1, int(torch.searchsorted(end[c0:], t_lo + self.R,
                                                    right=True)))
            c1 = min(c1, n_chunks, c0 + self.R)
            t_hi = int(end[c1 - 1])
            for a in range(t_lo, t_hi, _DRAW_BLOCK):
                b = min(a + _DRAW_BLOCK, t_hi)
                self.race[a - t_lo:b - t_lo] = -torch.log(uniforms(
                    seeds[lay.entry[a:b]], lay.slot[a:b], cc, self.K))
            t = start[c0:c1, None] + lane
            pad = lane >= length[c0:c1, None]
            nb = c1 - c0
            self.CT[:nb] = torch.where(pad, self.n, t)
            self.RT[:nb] = torch.where(pad, self.R, t - t_lo)
            self.CT[nb:nb + _GRAPH_CHUNKS] = self.n
            self.RT[nb:nb + _GRAPH_CHUNKS] = self.R
            self._walk(nb)
            c0 = c1
        return lo, hi, n_chunks

    def topics_now(self) -> torch.Tensor:
        """Each token's topic, in ``layout.order``."""
        return self.z[:self.n]


# ---- the recount and the likelihood ----------------------------------------

#: document or word rows recounted at once
_ROW_BLOCK = 1 << 16


def recount(docs: torch.Tensor, words: torch.Tensor, z: torch.Tensor,
            n_docs: int, V: int, K: int, alpha: float, beta: float,
            tables=None) -> tuple[int, float]:
    """From the tokens ``(docs, words)`` (global ids) and their topics
    ``z``, the tables counted anew in int64, and ``(mismatches,
    log-likelihood a token)``: the entries of ``tables`` = ``(Ndk [n_docs,
    K], Nwk [V, K], Nk [K])`` that differ from the recount (0 when
    ``tables`` is None), and the joint log-likelihood log p(w, z) of the
    collapsed model, in float64:

        Σ_k [lnΓ(Vβ) − lnΓ(n_k + Vβ) + Σ_w (lnΓ(n_wk + β) − lnΓ(β))]
      + Σ_d [lnΓ(Kα) − lnΓ(n_d + Kα) + Σ_k (lnΓ(n_dk + α) − lnΓ(α))]."""
    z, docs, words = z.long(), docs.long(), words.long()
    dev = z.device
    bad = 0
    ll = torch.zeros((), dtype=torch.float64, device=dev)
    lg = torch.lgamma
    a = torch.tensor(alpha, dtype=torch.float64, device=dev)
    b = torch.tensor(beta, dtype=torch.float64, device=dev)

    def counts(ids, lo, hi):
        sel = (ids >= lo) & (ids < hi)
        return torch.bincount((ids[sel] - lo) * K + z[sel],
                              minlength=(hi - lo) * K).reshape(hi - lo, K)

    def differ(table, lo, hi, n):
        t = torch.as_tensor(table[lo:hi]).to(dev)
        if tuple(t.shape) != tuple(n.shape):
            return n.numel()
        return int((t.double() != n.double()).sum())

    shapes_ok = tables is None or (
        tuple(tables[0].shape) == (n_docs, K)
        and tuple(tables[1].shape) == (V, K)
        and tuple(tables[2].shape) == (K,))
    if not shapes_ok:
        bad += (n_docs + V + 1) * K
    for lo in range(0, n_docs, _ROW_BLOCK):
        hi = min(lo + _ROW_BLOCK, n_docs)
        n = counts(docs, lo, hi)
        if tables is not None and shapes_ok:
            bad += differ(tables[0], lo, hi, n)
        nd = n.sum(1).double()
        n = n.double()
        ll += (lg(n + a) - lg(a)).sum() + (lg(K * a) - lg(nd + K * a)).sum()
    for lo in range(0, V, _ROW_BLOCK):
        hi = min(lo + _ROW_BLOCK, V)
        n = counts(words, lo, hi)
        if tables is not None and shapes_ok:
            bad += differ(tables[1], lo, hi, n)
        ll += (lg(n.double() + b) - lg(b)).sum()
    nk = torch.bincount(z, minlength=K)
    if tables is not None and shapes_ok:
        bad += differ(tables[2], 0, K, nk)
    ll += (lg(V * b) - lg(nk.double() + V * b)).sum()
    return bad, float(ll) / max(int(z.numel()), 1)


def initial_topics(seed: int, n_tokens: int, K: int, device):
    """The seed's initial topics in corpus order, as the configuration's
    program states it draws them: numpy's ``default_rng(seed).integers(0,
    K, n_tokens)``."""
    import numpy as np

    z = np.random.default_rng(seed).integers(0, K, n_tokens)
    return torch.from_numpy(z).to(device)


def step_seeds(seed: int, n_entries: int, device,
               steps: int = 1) -> torch.Tensor:
    """The seed words ``[steps, n_entries, 2]`` int32 of the first
    ``steps`` rotation steps, as the configuration's program states it
    draws them: one ``torch.randint(-2³¹, 2³¹ − 1, (n_entries, 2))`` call a
    step from a ``torch.Generator`` on the device seeded ``seed · 65,537``
    (worker 0)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 65_537)
    return torch.stack([torch.randint(-2 ** 31, 2 ** 31 - 1, (n_entries, 2),
                                      dtype=torch.int32, generator=g,
                                      device=device)
                        for _ in range(steps)])
