"""The LDA cell's token corpus, made on the card: documents drawn from a
true topic model whose words follow a Zipf law over a frequency-ranked
vocabulary.

The law, with every parameter in the configuration (``configs/``) and the
mix (``traffic/``):

- document lengths are lognormal of mean ``doc_len_mean`` and log-space
  standard deviation ``doc_len_sigma``, rounded, at least 1 and at most
  ``doc_len_cap`` (int16 doc-topic counts hold no more);
- word ranks follow a Zipf law of exponent ``word_zipf_s`` over the
  ``vocab_size`` ranks (a vocabulary cut to its top ``vocab_size`` words
  and numbered by rank);
- a document mixes ``true_topics`` topics with weights from a symmetric
  Dirichlet(``true_alpha``); a token draws its topic from its document's
  weights and its rank from the Zipf law, and the topic turns the rank
  inside its band (rank 0 alone, then ranks [2^(b-1), 2^b)) by an offset
  of its own: every topic keeps each band's Zipf mass, so the corpus
  keeps the law's mass in every band and in every 512-word tile.

All of that is drawn from ``structure_seed`` alone.  The run's seed then
renames documents within each ``d_tile`` group and words within each
``w_tile`` group of the configuration's rotation slices (as
``gen.ratings`` renames users and items), so every seed gives the same
tokens in each (doc tile, word tile) and the same entries, in another
order.  Tokens come sorted by document, then word.
"""

from __future__ import annotations

import math

import torch

from portbench.gen import _generator, _rename_within, _zipf_draws

#: documents drawn at once (a block's Dirichlet weights are [block, topics])
_DOC_BLOCK = 1 << 16


def doc_lengths(traffic: dict, n_docs: int, g, device) -> torch.Tensor:
    """Lognormal lengths (int64 [n_docs]) of the mix's mean and sigma."""
    sigma = traffic["doc_len_sigma"]
    mu = math.log(traffic["doc_len_mean"]) - 0.5 * sigma * sigma
    x = torch.randn((n_docs,), generator=g, device=device,
                    dtype=torch.float64)
    return torch.exp(mu + sigma * x).round_().clamp_(
        1, traffic["doc_len_cap"]).long()


def bands(vocab_size: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(lo, size)`` of each rank band: {0}, [1, 2), [2, 4), ... cut at
    ``vocab_size``."""
    lo, b = [0, 1], 1
    while lo[-1] < vocab_size:
        b *= 2
        lo.append(b)
    lo = torch.tensor(lo, device=device)
    lo[-1] = vocab_size
    return lo[:-1], lo[1:] - lo[:-1]


def band_of(rank: torch.Tensor) -> torch.Tensor:
    """The band index of each rank (0 for rank 0, else 1 + floor(log2))."""
    b = torch.floor(torch.log2(rank.clamp_min(1).double())).long() + 1
    return torch.where(rank == 0, 0, b)


def _ranks(config: dict, traffic: dict, device):
    """Every token's (document, word rank), from ``structure_seed``."""
    dev = torch.device(device)
    n_docs, V = config["n_docs"], config["vocab_size"]
    T = traffic["true_topics"]
    g = _generator(dev, traffic["structure_seed"], 30)
    lengths = doc_lengths(traffic, n_docs, g, dev)
    lo, size = bands(V, dev)
    offset = (torch.rand((T, lo.numel()), generator=g, device=dev,
                         dtype=torch.float64) * size).long()
    conc = torch.full((T,), float(traffic["true_alpha"]), device=dev)
    docs, ranks = [], []
    for d0 in range(0, n_docs, _DOC_BLOCK):
        L = lengths[d0:d0 + _DOC_BLOCK]
        B = L.numel()
        theta = torch._standard_gamma(conc.expand(B, T).contiguous(),
                                      generator=g).double()
        cdf = torch.cumsum(theta / theta.sum(1, keepdim=True), 1)
        # row r's cumulative weights lie in (r, r + 1]: one sorted key
        key = (cdf + torch.arange(B, device=dev, dtype=torch.float64)[:, None]
               ).reshape(-1)
        d = torch.repeat_interleave(torch.arange(B, device=dev), L)
        u = torch.rand((d.numel(),), generator=g, device=dev,
                       dtype=torch.float64)
        topic = (torch.searchsorted(key, d + u) - d * T).clamp_(0, T - 1)
        r = _zipf_draws(g, V, traffic["word_zipf_s"], d.numel(), dev)
        b = band_of(r)
        r = lo[b] + (r - lo[b] + offset[topic, b]) % size[b]
        docs.append(d + d0)
        ranks.append(r)
    return torch.cat(docs), torch.cat(ranks)


def corpus(config: dict, traffic: dict, seed: int, device):
    """The run's tokens ``(docs, words)``, int64 on the device, sorted by
    document, then word (module docstring)."""
    dev = torch.device(device)
    n_docs, V = config["n_docs"], config["vocab_size"]
    docs, ranks = _ranks(config, traffic, dev)
    g = _generator(dev, seed, 31)
    doc_name = _rename_within(
        torch.arange(n_docs, device=dev) // config["d_tile"], g)
    w_own = -(-V // config["rotate_chunks"])
    ids = torch.arange(V, device=dev)
    tile = (ids // w_own) * V + (ids % w_own) // config["w_tile"]
    word_name = _rename_within(tile, g)
    docs, words = doc_name[docs], word_name[ranks]
    key, _ = torch.sort(docs * V + words)
    return key // V, key % V
