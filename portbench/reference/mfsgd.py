"""The plain reference of MF-SGD with model rotation on one worker: the
stated algorithm, in plain PyTorch, from the rating triples and the
initial global factors alone.

The algorithm, as configured (``configs/mfsgd-*.json``):

- the items split into ``rotate_chunks`` slices of ``ceil(n_items /
  rotate_chunks)`` ids; an epoch trains slice 0, then slice 1, ...;
- inside a slice the ratings fall into ``u_tile × i_tile`` tiles, taken
  user-tile-major; a tile's ratings, in their input order, are cut into
  entries of ``C`` ratings, ``C = min(entry_cap, 8·ceil(m / 8))`` (at
  least 8) with ``m`` the most ratings any tile holds;
- the entries run in that order; an entry is one minibatch: each of its
  ratings scores against the factors as they stood at the entry's start,
  ``e = v − w·h``, with the gathered rows rounded to the compute
  precision; the gradients ``e·h − λ·w`` and ``e·w − λ·h`` are rounded to
  it, summed a row in f32, and applied once: ``row += lr · sum``;
- the epoch's RMSE is over every rating's ``e``.

Entries that share neither a user tile nor an item tile commute, so the
reference runs, in order, the levels of the chain of entries (a level is
1 + the larger level of the previous entry on the same user tile and on
the same item tile), each level as one batch: the same result as the
entries one by one.

``precision``: ``"bf16"`` (the configuration's), ``"fp8"`` (float8 e4m3,
the control) or ``"f32"`` (no rounding).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROUND = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def _rounder(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision not in _ROUND:
        raise ValueError(f"unknown precision {precision!r}")
    dt = _ROUND[precision]
    return lambda x: x.to(dt).to(torch.float32)


def _levels(tu: np.ndarray, ti: np.ndarray) -> np.ndarray:
    """The level of each entry of one slice, entries in order."""
    level = np.empty(len(tu), np.int64)
    last_u: dict[int, int] = {}
    last_i: dict[int, int] = {}
    for e, (a, b) in enumerate(zip(tu.tolist(), ti.tolist())):
        lv = 1 + max(last_u.get(a, -1), last_i.get(b, -1))
        level[e] = last_u[a] = last_i[b] = lv
    return level


class Plan:
    """The batches of one epoch: for each slice, its levels in order, each
    the ratings of the level's entries with the distinct rows they touch."""

    def __init__(self, users, items, vals, config: dict):
        dev = users.device
        n_users, n_items = config["n_users"], config["n_items"]
        nc, ut, it = (config["rotate_chunks"], config["u_tile"],
                      config["i_tile"])
        i_own = -(-n_items // nc)
        ntu, nti = -(-n_users // ut), -(-i_own // it)
        users, items = users.long(), items.long()
        sl = items // i_own
        tile = (sl * ntu + users // ut) * nti + (items - sl * i_own) // it
        tile, order = torch.sort(tile, stable=True)
        counts = torch.bincount(tile, minlength=nc * ntu * nti)
        cap = int(min(config["entry_cap"],
                      max(8, 8 * math.ceil(int(counts.max()) / 8))))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(tile.numel(), device=dev) - starts[tile]
        per_tile = -(-counts // cap)
        first_entry = torch.cumsum(per_tile, 0) - per_tile
        entry = first_entry[tile] + pos // cap
        # each entry's tile, in entry order (entries are numbered in tile
        # order, so tile order is entry order)
        n_entries = int(per_tile.sum())
        e_tile = torch.repeat_interleave(
            torch.arange(nc * ntu * nti, device=dev), per_tile).cpu().numpy()
        e_slice = e_tile // (ntu * nti)
        level = np.empty(n_entries, np.int64)
        for s in range(nc):
            sel = np.flatnonzero(e_slice == s)
            level[sel] = _levels((e_tile[sel] // nti) % ntu,
                                 e_tile[sel] % nti)
        top = int(level.max()) + 1 if n_entries else 1
        key = torch.from_numpy(e_slice * top + level).to(dev)[entry]
        key, by = torch.sort(key, stable=True)
        perm = order[by]
        self.users, self.items = users[perm], items[perm]
        self.vals = vals.to(torch.float32)[perm]
        bounds = torch.cumsum(torch.bincount(key, minlength=nc * top),
                              0).cpu().tolist()
        self.batches = []
        lo = 0
        for hi in bounds:
            if hi > lo:
                u, i = self.users[lo:hi], self.items[lo:hi]
                self.batches.append(
                    (lo, hi, *torch.unique(u, return_inverse=True),
                     *torch.unique(i, return_inverse=True)))
            lo = hi
        self.entry_cap = cap
        self.n_levels = len(self.batches)


def sgd_epochs(plan: Plan, W0: torch.Tensor, H0: torch.Tensor, epochs: int,
               *, lr: float, reg: float, precision: str) -> list:
    """``epochs`` epochs from the global factors ``W0`` [n_users, rank] and
    ``H0`` [n_items, rank] → ``[(W, H, rmse)]`` after each epoch (f32
    tensors on the factors' device)."""
    rnd = _rounder(precision)
    W, H = W0.to(torch.float32).clone(), H0.to(torch.float32).clone()
    out = []
    for _ in range(epochs):
        se = torch.zeros((), dtype=torch.float64, device=W.device)
        for lo, hi, uu, inv_u, ui, inv_i in plan.batches:
            wu = rnd(W[plan.users[lo:hi]])
            hi_rows = rnd(H[plan.items[lo:hi]])
            err = plan.vals[lo:hi] - (wu * hi_rows).sum(-1)
            gw = rnd(err[:, None] * hi_rows - reg * wu)
            gh = rnd(err[:, None] * wu - reg * hi_rows)
            acc_w = torch.zeros((uu.numel(), W.shape[1]), device=W.device)
            acc_w.index_add_(0, inv_u, gw)
            acc_h = torch.zeros((ui.numel(), H.shape[1]), device=H.device)
            acc_h.index_add_(0, inv_i, gh)
            W[uu] += lr * acc_w
            H[ui] += lr * acc_h
            se += (err.double() ** 2).sum()
        out.append((W.clone(), H.clone(),
                    math.sqrt(float(se) / max(plan.users.numel(), 1))))
    return out
