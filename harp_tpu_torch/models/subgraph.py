"""Subgraph counting by color coding — graded config #5a, the port of
``harp_tpu.models.subgraph``.

Harp's ``edu.iu.subgraph`` counts tree templates (u3 … u12) in a large
graph: color the vertices with k ≥ s colors (s = template size), count the
*colorful* embeddings (all colors distinct) by a dynamic program over a
rooted decomposition of the template, and unbias by the probability that an
embedding is colorful.  Vertices are partitioned over the workers, and each
DP level exchanges the child's per-vertex count table with ``allgather``.

The table of a partial that has absorbed j template vertices lives
compactly over the C(k, j) size-j color subsets (a colorful partial uses
exactly j colors), so each DP level is

  ``counts_t[v, S] = Σ_{S₁⊎S₂=S} counts_{t₁}[v, S₁] · (A @ counts_{t₂})[v, S₂]``

— a neighbor aggregation over the padded-CSR table (``index_select`` and a
masked sum), plus an exact tail for the adjacency past ``max_degree``,
followed by a subset convolution through static position maps
(``index_add_`` along the column dimension, where the repeated target
columns accumulate).  A chunk of trials is one leading tensor dimension,
``[chunk, n_loc, C(k, j)]``, where the reference ``vmap``\\ s a trial.

The two overflow tails (``SubgraphConfig.overflow_algo``) keep their host
partitionings, which the tests compare with the reference's arrays, and
give the same counts.  On the card both add their entries with
``index_add_``: ``"segment"`` over the flattened row-sorted edge list,
``"onehot"`` over its tiles' rows (``t_lo + t_loc``; a padding entry,
``t_loc == row_tile``, adds nothing).  The tile layout no longer stands for
a one-hot matmul there: that form exists in the reference only because
Mosaic has no scatter.

Counts are f32, as in the reference; below 2^24 every sum is exact, so
small graphs agree bit for bit whatever the summation order.  The count
path's products run in full f32 (TF32 off on the card).

With telemetry on, the partition's real adjacency entries per worker go
to the skew ledger (``subgraph.partition``), and each trial chunk's DP is
one dispatch (``subgraph.count``) on the flight recorder.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter

import numpy as np
import torch

from harp_tpu_torch.models.kmeans import _exact_f32
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, resolve_mesh
from harp_tpu_torch.utils import flightrec, skew, telemetry

# ---------------------------------------------------------------------------
# Templates: rooted trees given as parent lists (parent[i] < i, parent[0] =
# -1), decomposed into (root keeps child subtree) partials.
# ---------------------------------------------------------------------------

TEMPLATES = {
    "u3-path": [-1, 0, 1],
    "u3-star": [-1, 0, 0],
    "u5-path": [-1, 0, 1, 2, 3],
    "u5-star": [-1, 0, 0, 0, 0],
    "u5-tree": [-1, 0, 0, 1, 1],
    "u7-tree": [-1, 0, 0, 1, 1, 2, 2],
    "u10-tree": [-1, 0, 0, 1, 1, 2, 2, 3, 3, 4],
    "u12-tree": [-1, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5],
}


def template_size(tpl) -> int:
    return len(tpl)


def _children(tpl):
    ch = [[] for _ in tpl]
    for i, p in enumerate(tpl):
        if p >= 0:
            ch[p].append(i)
    return ch


def _subtree_sizes(tpl):
    ch = _children(tpl)
    size = [1] * len(tpl)
    for i in reversed(range(len(tpl))):
        for c in ch[i]:
            size[i] += size[c]
    return size


def _dp_subset_tables(tpl, n_colors):
    """Static DP plan: ``combos(sz1, sz2)`` lists the (S, S1, S2) bitmask
    triples with |S1| = sz1, |S2| = sz2, S1 ∩ S2 = ∅ and S = S1 ∪ S2."""
    masks = list(range(1 << n_colors))
    popcnt = [bin(m).count("1") for m in masks]

    def combos(sz1, sz2):
        out = []
        for S1 in masks:
            if popcnt[S1] != sz1:
                continue
            for S2 in masks:
                if popcnt[S2] != sz2 or (S1 & S2):
                    continue
                out.append((S1 | S2, S1, S2))
        return out

    return combos


def _count_automorphism_roots(tpl):
    """Number of automorphisms of the template tree (the rooted DP counts
    each unrooted colorful embedding once per automorphism)."""
    ch = _children(tpl)

    def canon(i):
        return "(" + "".join(sorted(canon(c) for c in ch[i])) + ")"

    def autos(i):
        a = 1
        for c in ch[i]:
            a *= autos(c)
        for cnt in Counter(canon(c) for c in ch[i]).values():
            a *= math.factorial(cnt)
        return a

    # rooted automorphisms at 0, times the size of the root's orbit (the
    # vertices whose re-rooted canonical form equals the root's)
    root_form = canon(0)
    n = len(tpl)
    adj = [[] for _ in range(n)]
    for i, p in enumerate(tpl):
        if p >= 0:
            adj[i].append(p)
            adj[p].append(i)

    def canon_rerooted(v, parent):
        return "(" + "".join(
            sorted(canon_rerooted(u, v) for u in adj[v] if u != parent)
        ) + ")"

    orbit = sum(canon_rerooted(v, -1) == root_form for v in range(n))
    return autos(0) * orbit


# ---------------------------------------------------------------------------
# Host layout (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def pad_csr(edges, n_vertices, max_degree):
    """Edge list → padded neighbor table [n, max_degree], its mask, and the
    adjacency entries past ``max_degree`` as ``overflow [m, 2]`` (vertex,
    neighbor) rows, which the DP's tail adds exactly."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n_vertices))
    pos = np.arange(len(src)) - starts[src]
    keep = pos < max_degree
    nbr = np.zeros((n_vertices, max_degree), np.int32)
    msk = np.zeros((n_vertices, max_degree), np.float32)
    nbr[src[keep], pos[keep]] = dst[keep]
    msk[src[keep], pos[keep]] = 1.0
    overflow = np.stack([src[~keep], dst[~keep]], 1).astype(np.int64)
    return nbr, msk, overflow


def _partition_overflow(overflow, n_pad, nw):
    """Overflow edges → per-worker padded arrays, sharded like the rows:
    ``(o_nbr [nw·m], o_row [nw·m] worker-local rows, o_msk [nw·m])``,
    padding (id 0) first in each block, then rows ascending; m ≥ 1."""
    loc = n_pad // nw
    rows, nbrs = overflow[:, 0], overflow[:, 1]
    owner = rows // loc
    counts = (np.bincount(owner, minlength=nw) if len(rows)
              else np.zeros(nw, int))
    m_pad = max(1, int(counts.max()))
    o_nbr = np.zeros((nw, m_pad), np.int32)
    o_row = np.zeros((nw, m_pad), np.int32)
    o_msk = np.zeros((nw, m_pad), np.float32)
    for w in range(nw):
        idx = np.flatnonzero(owner == w)
        t = len(idx)
        order = np.argsort(rows[idx], kind="stable")
        o_row[w, m_pad - t:] = rows[idx][order] - w * loc
        o_nbr[w, m_pad - t:] = nbrs[idx][order]
        o_msk[w, m_pad - t:] = 1.0
    return o_nbr.reshape(-1), o_row.reshape(-1), o_msk.reshape(-1)


def _partition_overflow_tiles(overflow, n_pad, nw, row_tile, entry_tile):
    """Overflow edges → per-worker (entry × row-window) tiles: each tile
    holds ≤ ``entry_tile`` entries whose local rows lie in one ``[lo, lo +
    row_tile)`` window.  Returns ``(t_nbr [nw·NT, TE], t_loc [nw·NT, TE]``
    (row offsets in the window, ``row_tile`` for padding), ``t_msk [nw·NT,
    TE], t_lo [nw·NT])``, NT the most tiles a worker has (≥ 1) and TE ≤
    ``entry_tile`` rounded up to 8 from the fullest tile."""
    loc = n_pad // nw
    rows, nbrs = overflow[:, 0], overflow[:, 1]
    owner = rows // loc if len(rows) else np.zeros(0, np.int64)
    per_w = []
    for w in range(nw):
        idx = np.flatnonzero(owner == w)
        order = np.argsort(rows[idx], kind="stable")
        r = (rows[idx][order] - w * loc).astype(np.int64)
        nb = nbrs[idx][order].astype(np.int32)
        tiles = []
        i = 0
        while i < len(r):
            lo = int(r[i])
            j = i
            while j < len(r) and j - i < entry_tile and r[j] < lo + row_tile:
                j += 1
            tiles.append((lo, (r[i:j] - lo).astype(np.int32), nb[i:j]))
            i = j
        per_w.append(tiles)
    NT = max(1, max((len(t) for t in per_w), default=1))
    max_e = max((len(locs) for tiles in per_w for _, locs, _ in tiles),
                default=0)
    TE = min(entry_tile, max(8, -(-max_e // 8) * 8))
    t_nbr = np.zeros((nw, NT, TE), np.int32)
    t_loc = np.full((nw, NT, TE), row_tile, np.int32)
    t_msk = np.zeros((nw, NT, TE), np.float32)
    t_lo = np.zeros((nw, NT), np.int32)
    for w, tiles in enumerate(per_w):
        for t, (lo, locs, nb) in enumerate(tiles):
            e = len(locs)
            t_lo[w, t] = lo
            t_nbr[w, t, :e] = nb
            t_loc[w, t, :e] = locs
            t_msk[w, t, :e] = 1.0
    return (t_nbr.reshape(nw * NT, TE), t_loc.reshape(nw * NT, TE),
            t_msk.reshape(nw * NT, TE), t_lo.reshape(nw * NT))


# ---------------------------------------------------------------------------
# The DP
# ---------------------------------------------------------------------------

_FN_CACHE: dict = {}


def make_colorful_count_fn(tpl, k, mesh: WorkerMesh,
                           overflow_algo: str = "segment",
                           row_tile: int = 512):
    """The color-coding DP of this worker: ``fn(nbr [n_loc, deg], msk,
    *overflow, colors [chunk, n_loc]) → [chunk]`` colorful rooted counts,
    summed over the workers (every worker gets them).  ``overflow`` is the
    worker's block of :func:`_partition_overflow` (3 arrays, ``"segment"``)
    or of :func:`_partition_overflow_tiles` (4, ``"onehot"``).

    Counts maps φ: template → graph with all image colors distinct, rooted
    at template vertex 0.  Cached per (template, colors, world size, device,
    overflow formulation)."""
    cache_key = (tuple(tpl), k, mesh.num_workers, str(mesh.device),
                 overflow_algo,
                 row_tile if overflow_algo == "onehot" else None)
    if cache_key in _FN_CACHE:
        return _FN_CACHE[cache_key]
    dev = mesh.device
    ch = _children(tpl)
    sizes = _subtree_sizes(tpl)
    combos = _dp_subset_tables(tpl, k)
    n_subsets = 1 << k
    supp = {sz: [m for m in range(n_subsets) if bin(m).count("1") == sz]
            for sz in range(k + 1)}
    pos = {sz: {m: j for j, m in enumerate(cols)}
           for sz, cols in supp.items()}

    # per combine (post order): (child, p1, p2, pS, columns of the result)
    plan = []
    for i in reversed(range(len(tpl))):
        acc_size, steps = 1, []
        for c in ch[i]:
            triples = combos(acc_size, sizes[c])
            new_size = acc_size + sizes[c]

            def idx(sz, at):
                return torch.tensor([pos[sz][t[at]] for t in triples],
                                    dtype=torch.int64, device=dev)

            steps.append((c, idx(acc_size, 1), idx(sizes[c], 2),
                          idx(new_size, 0), len(supp[new_size])))
            acc_size = new_size
        plan.append((i, steps))

    def spmv_gather(full, nbr, msk, ovf):
        # Σ_{u∈N(v)} full[:, u, :]: the padded CSR, then the exact tail for
        # the entries past max_degree (none is dropped)
        chunk, _, S = full.shape
        n_loc, deg = nbr.shape
        g = full.index_select(1, nbr.reshape(-1)).view(chunk, n_loc, deg, S)
        out = (g * msk[None, :, :, None]).sum(2)
        if overflow_algo == "segment":
            o_nbr, o_row, o_msk = ovf
            og = full.index_select(1, o_nbr) * o_msk[None, :, None]
            return out.index_add_(1, o_row, og)
        t_nbr, t_loc, t_msk, t_lo = ovf
        live = t_loc < row_tile
        rows = torch.where(live, t_lo[:, None] + t_loc, 0).reshape(-1)
        og = (full.index_select(1, t_nbr.reshape(-1))
              * (t_msk * live).reshape(-1)[None, :, None])
        return out.index_add_(1, rows, og)

    def fn(nbr, msk, *rest):
        ovf, colors = rest[:-1], rest[-1]
        # a one-hot of the colors is the compact singleton table: supp[1]
        # is [1 << 0, 1 << 1, ...], so color c's column is c
        singleton = torch.nn.functional.one_hot(
            colors.long(), k).to(torch.float32)        # [chunk, n_loc, k]
        chunk, n_loc = colors.shape
        tables = [None] * len(tpl)
        for i, steps in plan:
            acc = singleton
            for c, p1, p2, pS, width in steps:
                # the child's table for every vertex: one allgather of the
                # compact table (worker-major along the vertex dim)
                child = tables[c]
                full = C.allgather(child, tiled=False).permute(
                    1, 0, 2, 3).reshape(chunk, -1, child.shape[2])
                nbr_counts = spmv_gather(full, nbr, msk, ovf)
                contrib = acc[:, :, p1] * nbr_counts[:, :, p2]
                acc = torch.zeros((chunk, n_loc, width), dtype=torch.float32,
                                  device=acc.device).index_add_(2, pS, contrib)
            tables[i] = acc
        # the root table's support is the size-s subsets (one column when
        # k == s): summing the compact table covers both cases
        return C.allreduce(tables[0].sum(-1).sum(-1))

    _FN_CACHE[cache_key] = fn
    return fn


@dataclasses.dataclass
class SubgraphConfig:
    template: str = "u5-tree"
    n_colors: int = 0        # 0 → template size (standard color coding)
    n_trials: int = 1        # averaged over colorings
    # trials a DP pass: the tables are [trial_chunk, n_loc, C(k, j)] f32
    trial_chunk: int = 8
    max_degree: int = 64     # padded-CSR width
    seed: int = 0
    # the exact tail past max_degree: "segment" (flattened row-sorted edge
    # list) or "onehot" (row-window tiles); both add by index_add_ here
    overflow_algo: str = "segment"
    overflow_row_tile: int = 512    # onehot: rows a tile window
    overflow_entry_tile: int = 2048  # onehot: most entries a tile

    def __post_init__(self):
        if self.overflow_algo not in ("segment", "onehot"):
            raise ValueError(f"overflow_algo must be 'segment' or "
                             f"'onehot', got {self.overflow_algo!r}")


def _colorful_probability(s: int, k: int) -> float:
    if k == s:
        return math.factorial(s) / (s ** s)
    return math.factorial(k) / (math.factorial(k - s) * k ** s)


def count_template(edges, n_vertices, cfg: SubgraphConfig,
                   mesh: WorkerMesh | None = None, device=None,
                   split: dict | None = None):
    """Estimate the number of (unrooted) embeddings of the template.

    Returns ``(estimate, per_trial_estimates, overflow_edges)``;
    ``overflow_edges`` counts the adjacency entries past ``cfg.max_degree``,
    which the tail adds exactly.  The estimate is the colorful rooted count
    over the colorfulness probability and |Aut(template)|.  With ``split``
    (a dict) the host prep's seconds (CSR, padding, the overflow partition,
    staging) and the DP's (to the readback) are written into it as
    ``prep_sec`` and ``dp_sec``."""
    t0 = time.perf_counter()
    tpl = (TEMPLATES[cfg.template] if isinstance(cfg.template, str)
           else cfg.template)
    s = template_size(tpl)
    k = cfg.n_colors or s
    if k < s:
        raise ValueError(
            f"n_colors={k} must be >= template size {s} for color-coding")
    mesh = resolve_mesh(mesh, device)
    _exact_f32(mesh.device)
    nw = mesh.num_workers
    n_pad = -(-n_vertices // nw) * nw

    nbr, msk, overflow = pad_csr(edges, n_vertices, cfg.max_degree)
    if n_pad > n_vertices:
        extra = n_pad - n_vertices
        nbr = np.concatenate([nbr, np.zeros((extra, cfg.max_degree),
                                            np.int32)])
        msk = np.concatenate([msk, np.zeros((extra, cfg.max_degree),
                                            np.float32)])
    if cfg.overflow_algo == "onehot":
        ovf = _partition_overflow_tiles(overflow, n_pad, nw,
                                        cfg.overflow_row_tile,
                                        cfg.overflow_entry_tile)
    else:
        ovf = _partition_overflow(overflow, n_pad, nw)
    if telemetry.enabled():
        # real adjacency entries per worker: where "one worker holds the
        # hub" shows
        skew.record_partition(
            "subgraph.partition",
            msk.reshape(nw, -1).sum(1), unit="edges",
            padded_total=msk.size)
    nbr_d = mesh.shard_array(nbr, 0).long()
    msk_d = mesh.shard_array(msk, 0)
    ovf_d = tuple(mesh.shard_array(a, 0).long() if a.dtype == np.int32
                  else mesh.shard_array(a, 0) for a in ovf)
    fn = flightrec.track(make_colorful_count_fn(tpl, k, mesh,
                                                cfg.overflow_algo,
                                                cfg.overflow_row_tile),
                         "subgraph.count")

    rng = np.random.default_rng(cfg.seed)
    chunk = max(1, min(cfg.n_trials, cfg.trial_chunk))
    t_pad = -(-cfg.n_trials // chunk) * chunk  # equal chunks
    colors = rng.integers(0, k, (t_pad, n_pad)).astype(np.int32)
    t1 = time.perf_counter()
    with telemetry.ledger.run("subgraph.count", steps=t_pad // chunk):
        outs = [fn(nbr_d, msk_d, *ovf_d,
                   mesh.shard_array(colors[lo:lo + chunk], 1))
                for lo in range(0, t_pad, chunk)]
    rooted = flightrec.readback(torch.cat(outs))[: cfg.n_trials]
    if split is not None:
        split["prep_sec"] = t1 - t0
        split["dp_sec"] = time.perf_counter() - t1
    p_colorful = _colorful_probability(s, k)
    n_auto = _count_automorphism_roots(tpl)
    estimates = [float(r) / p_colorful / n_auto for r in rooted]
    return float(np.mean(estimates)), estimates, len(overflow)


def benchmark(n_vertices=100_000, avg_degree=16, template="u5-tree",
              mesh=None, seed=0, max_degree=64, graph="uniform",
              overflow_algo="segment", device=None):
    """Vertices per second through one color-coding trial (graded config
    #5a), timed over ``count_template`` whole (the host prep included, as
    in the reference) after an untimed call; ``prep_sec`` and ``dp_sec``
    split the timed call.  ``graph="powerlaw"`` draws edge sources
    zipf-1.3, so the overflow tail carries real mass; ``overflow_share`` is
    the fraction of adjacency entries on it."""
    mesh = resolve_mesh(mesh, device)
    rng = np.random.default_rng(seed)
    n_edges = n_vertices * avg_degree // 2
    if graph == "powerlaw":
        src = (rng.zipf(1.3, n_edges).astype(np.int64) - 1) % n_vertices
        dst = rng.integers(0, n_vertices, n_edges)
        edges = np.stack([src, dst], 1)
    elif graph == "uniform":
        edges = np.stack([
            rng.integers(0, n_vertices, n_edges),
            rng.integers(0, n_vertices, n_edges),
        ], 1)
    else:
        raise ValueError(
            f"graph must be 'uniform' or 'powerlaw', got {graph!r}")
    cfg = SubgraphConfig(template=template, seed=seed, max_degree=max_degree,
                         overflow_algo=overflow_algo)
    count_template(edges, n_vertices, cfg, mesh)  # warmup
    split: dict = {}
    t0 = time.perf_counter()
    est, _, overflow = count_template(edges, n_vertices, cfg, mesh,
                                      split=split)
    dt = time.perf_counter() - t0
    return {
        "vertices_per_sec": n_vertices / dt,
        "estimate": est,
        "sec_per_trial": dt,
        "prep_sec": split["prep_sec"],
        "dp_sec": split["dp_sec"],
        "overflow_edges": overflow,
        "overflow_share": overflow / (2 * n_edges),
        "dropped_edges": 0,
        "template": template,
        "n_vertices": n_vertices,
        "graph": graph,
        "overflow_algo": overflow_algo,
        "num_workers": mesh.num_workers,
    }


def main(argv=None):
    import argparse

    from harp_tpu_torch.utils.metrics import benchmark_json

    p = argparse.ArgumentParser(
        description="harp-tpu subgraph counting on PyTorch "
                    "(edu.iu.subgraph parity)")
    p.add_argument("--vertices", type=int, default=100_000)
    p.add_argument("--avg-degree", type=int, default=16)
    p.add_argument("--template", default="u5-tree", choices=sorted(TEMPLATES))
    p.add_argument("--max-degree", type=int, default=64)
    p.add_argument("--graph", choices=["uniform", "powerlaw"],
                   default="uniform")
    p.add_argument("--overflow-algo", choices=["segment", "onehot"],
                   default="segment",
                   help="exact tail for adjacency past max-degree: the "
                        "row-sorted edge list or its row-window tiles "
                        "(same counts)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    mesh = WorkerMesh(args.device)
    print(benchmark_json("subgraph_cli", benchmark(
        args.vertices, args.avg_degree, args.template, mesh=mesh,
        max_degree=args.max_degree, graph=args.graph,
        overflow_algo=args.overflow_algo), mesh.device))
    return 0


if __name__ == "__main__":
    main()
