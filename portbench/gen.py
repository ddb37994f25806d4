"""The benchmark's own inputs, made on the card from ``--seed``: the points
of a streaming KMeans epoch and the rating triples of an MF-SGD run, with
the initial state both sides start from.

One general generator a kind of entry, driven by the parameters of a
configuration file (``configs/``) and a traffic file (``traffic/``): a
new mix is a new data file.  Every draw comes from a ``torch.Generator``
on the device seeded by the run's seed and a fixed tag, so the same seed
gives the same inputs in every run and on both sides of a comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed64(*parts: int) -> int:
    """A 64-bit generator seed from the run's seed (any size) and tags."""
    return int(np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
               .generate_state(1, np.uint64)[0])


def _generator(device, *parts: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed64(*parts))
    return g


class MixtureChunks:
    """Chunks of a Gaussian mixture in ``d`` dimensions: ``components``
    means drawn N(0, mean_std²) per feature, equal weights, isotropic
    noise of standard deviation ``sigma``.  ``chunk(j)`` is the same for
    the same (seed, j), so an epoch revisits a fixed data set."""

    def __init__(self, config: dict, seed: int, device):
        mix = config["assumed"]["mixture"]
        self.rows, self.d = config["chunk_points"], config["d"]
        self.seed, self.device = seed, torch.device(device)
        self.components, self.sigma = mix["components"], mix["sigma"]
        g = _generator(self.device, seed, 0)
        self.means = torch.randn((self.components, self.d), generator=g,
                                 device=self.device) * mix["mean_std"]
        self._g = torch.Generator(device=self.device)

    def _draw(self, g: torch.Generator, rows: int) -> torch.Tensor:
        comp = torch.randint(0, self.components, (rows,), generator=g,
                             device=self.device)
        x = torch.randn((rows, self.d), generator=g, device=self.device)
        return x.mul_(self.sigma).add_(self.means.index_select(0, comp))

    def chunk(self, j: int) -> torch.Tensor:
        """Chunk ``j``: [chunk_points, d] f32 on the device."""
        self._g.manual_seed(seed64(self.seed, 1, j))
        return self._draw(self._g, self.rows)

    def initial_centroids(self, k: int) -> torch.Tensor:
        """k points of the mixture, Harp's initial centroids."""
        return self._draw(_generator(self.device, self.seed, 2), k)

    def col_scale(self) -> torch.Tensor:
        """The int8 feature scales: (max |mean| + 5 sigma) / 127 a feature,
        so that clipping touches only the far tail."""
        return (self.means.abs().amax(0) + 5.0 * self.sigma) / 127.0


def _zipf_draws(g, n_ranks: int, s: float, count: int, device):
    """``count`` ranks in [0, n_ranks) drawn with weight (r + 1)^-s, by
    inverting the cumulative weights (f64)."""
    w = torch.arange(1, n_ranks + 1, device=device,
                     dtype=torch.float64).pow_(-s)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((count,), generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_(max=n_ranks - 1)


def _zipf_pairs(config: dict, traffic: dict, dev):
    """The Zipf mix's (user, item) pairs, from ``structure_seed`` alone."""
    n_users, n_items, nnz = config["n_users"], config["n_items"], \
        config["nnz"]
    g = _generator(dev, traffic["structure_seed"], 11)
    floor = traffic["min_per_user"]
    order = torch.randperm(n_users, generator=g, device=dev)
    extra = order[_zipf_draws(g, n_users, traffic["user_zipf_s"],
                              nnz - floor * n_users, dev)]
    per_user = torch.bincount(extra, minlength=n_users) + floor
    users = torch.repeat_interleave(torch.arange(n_users, device=dev),
                                    per_user)
    key = torch.arange(n_items, device=dev, dtype=torch.float64) \
        + traffic["item_id_jitter"] * torch.rand(
            (n_items,), generator=g, device=dev, dtype=torch.float64)
    id_of_rank = torch.argsort(torch.argsort(key))
    items = id_of_rank[_zipf_draws(g, n_items, traffic["item_zipf_s"], nnz,
                                   dev)]
    return users, items


def _rename_within(group: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """A renaming of ids ``0..len(group)-1`` that keeps each id inside its
    group (``group`` non-decreasing in the id): ``new = out[old]``."""
    key = group.double() + torch.rand(group.shape, generator=g,
                                      device=group.device,
                                      dtype=torch.float64)
    return torch.argsort(key)


def ratings(config: dict, traffic: dict, seed: int, device):
    """The run's rating triples ``(users, items, values)`` on the device
    (int64, int64, f32), ``config["nnz"]`` of them.

    ``traffic["law"]``:

    - ``"zipf"``: every user rates ``min_per_user`` items and the rest
      fall to users by a Zipf law of exponent ``user_zipf_s`` over a random
      order of the users; items by a Zipf law of exponent ``item_zipf_s``,
      the rank-r item placed at the id order of ``r + item_id_jitter · U``
      (popular titles cluster at low ids, as in a catalogue grown over
      time).  These pairs are drawn once, from ``structure_seed``; the run's
      seed then renames users within each user tile and items within each
      item tile of the configuration (``u_tile``; ``i_tile`` inside each of
      the ``rotate_chunks`` item slices), so every seed gives the same
      ratings a tile, the same entries and the same dependent chains, in
      another order.  Triples come sorted by user, then item.
    - ``"uniform"``: users and items uniform, in draw order.

    Values are a rank-``true_rank`` product plus N(0, noise²)."""
    dev = torch.device(device)
    n_users, n_items, nnz = config["n_users"], config["n_items"], \
        config["nnz"]
    g = _generator(dev, seed, 10)
    if traffic["law"] == "zipf":
        users, items = _zipf_pairs(config, traffic, dev)
        users = _rename_within(
            torch.arange(n_users, device=dev) // config["u_tile"], g)[users]
        i_own = -(-n_items // config["rotate_chunks"])
        ids = torch.arange(n_items, device=dev)
        tile = (ids // i_own) * n_items + (ids % i_own) // config["i_tile"]
        items = _rename_within(tile, g)[items]
        by = torch.argsort(users * n_items + items, stable=True)
        users, items = users[by], items[by]
    elif traffic["law"] == "uniform":
        users = torch.randint(0, n_users, (nnz,), generator=g, device=dev)
        items = torch.randint(0, n_items, (nnz,), generator=g, device=dev)
    else:
        raise ValueError(f"unknown rating law {traffic['law']!r}")
    r = traffic["true_rank"]
    wt = torch.randn((n_users, r), generator=g, device=dev) / math.sqrt(r)
    ht = torch.randn((n_items, r), generator=g, device=dev) / math.sqrt(r)
    vals = (wt[users] * ht[items]).sum(-1) + traffic["noise"] * torch.randn(
        (nnz,), generator=g, device=dev)
    return users, items, vals


def factors(config: dict, seed: int, device):
    """The initial global factors ``(W [n_users, rank], H [n_items,
    rank])``, uniform in [0, 1/sqrt(rank)), f32 on the device."""
    dev = torch.device(device)
    g = _generator(dev, seed, 20)
    rank = config["rank"]
    scale = 1.0 / math.sqrt(rank)
    w = torch.rand((config["n_users"], rank), generator=g, device=dev)
    h = torch.rand((config["n_items"], rank), generator=g, device=dev)
    return w * scale, h * scale
