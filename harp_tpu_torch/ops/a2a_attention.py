"""Ulysses-style all-to-all sequence parallelism for attention — the port
of ``harp_tpu.ops.a2a_attention``.

Instead of rotating K/V around the ring, one ``regroup`` (Harp's shuffle
verb, a tiled all-to-all) reshards Q, K and V from sequence-sharded to
head-sharded, every worker runs exact local attention over the WHOLE
sequence for its heads, and a second ``regroup`` restores sequence
sharding.  a2a moves each of Q, K, V and O once whatever the worker count;
ring never holds the whole sequence's K/V on a worker.  a2a needs
``heads % workers == 0`` and, under GQA, ``kv_heads % workers == 0`` too,
since the all-to-all reshards the KV head dim.  The local attention is the
online-softmax recurrence over ``block_k`` key blocks, so the scores are
[b, h, s, block_k], never [b, h, s, s]; ``block_k=None`` is one block.
"""

from __future__ import annotations

import torch

from harp_tpu_torch.ops.ring_attention import check_window, \
    online_softmax_block
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, num_workers


def _local_attention(q, k, v, scale, causal, block_k, window=None):
    """Exact attention with everything resident ([b, s, h, d] each, K/V
    with ``hk`` heads), blockwise over K/V by the online softmax."""
    b, s, h, d = q.shape
    bk = s if block_k is None else block_k
    if s % bk != 0:
        raise ValueError(f"block_k={bk} must divide the sequence length {s}")
    dev = q.device
    pos = torch.arange(s, device=dev)
    m = torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=dev)
    for t in range(s // bk):
        kt, vt = k[:, t * bk:(t + 1) * bk], v[:, t * bk:(t + 1) * bk]
        m, l, acc = online_softmax_block(
            q, kt, vt, m, l, acc, pos, t * bk + torch.arange(bk, device=dev),
            scale, causal, window)
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def a2a_attention(q, k, v, *, causal: bool = False,
                  scale: float | None = None, block_k: int | None = None,
                  window: int | None = None):
    """Exact multi-head attention, sequence sharded, via all-to-all, on this
    worker's shard.

    Args (this worker's shards; every worker calls it):
      q, k, v: [batch, seq_local, heads, head_dim]; heads (and, under GQA,
        kv_heads) must be divisible by the worker count.
      block_k: keys per block of the local attention (None: one block).
      causal, window, scale: as :func:`~harp_tpu_torch.ops.ring_attention.
        ring_attention`.
    Returns: [batch, seq_local, heads, head_dim] in q's dtype.
    """
    n = num_workers()
    b, nq, h, d = q.shape
    g = k.shape[2]
    check_window(window)
    if h % n != 0:
        raise ValueError(
            f"a2a attention needs heads ({h}) divisible by workers ({n}); "
            "use ring_attention for head counts that don't divide")
    if g != h and (h % g != 0 or g % n != 0):
        raise ValueError(
            f"a2a GQA needs KV heads ({g}) dividing query heads ({h}) AND "
            f"divisible by workers ({n}) — the all_to_all reshards the KV "
            "head dim too; use ring_attention otherwise")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)

    # sequence-sharded -> head-sharded ([b, s/n, h, d] -> [b, s, h/n, d]) is
    # one regroup; the inverse restores sequence sharding
    qh, kh, vh = C.regroup((q, k, v), split_dim=2, concat_dim=1)
    out = _local_attention(qh, kh, vh, scale, causal, block_k, window)
    return C.regroup(out, split_dim=1, concat_dim=2)


def make_a2a_attention_fn(mesh: WorkerMesh, causal: bool = False,
                          block_k: int | None = None,
                          window: int | None = None):
    """Host view: ``fn(q, k, v)`` takes the whole [batch, seq, heads,
    head_dim] arrays (every worker passes the same), attends over this
    worker's sequence shard, and returns the whole output on
    ``mesh.device``."""
    def fn(q, k, v):
        out = a2a_attention(*(mesh.shard_array(a, 1) for a in (q, k, v)),
                            causal=causal, block_k=block_k, window=window)
        return C.pull(out, concat_dim=1)

    return fn
