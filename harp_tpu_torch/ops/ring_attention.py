"""Ring attention: exact attention over a sequence-sharded ring — the port
of ``harp_tpu.ops.ring_attention``.

The sequence axis is sharded across workers; K/V blocks travel the ring
through ``rotate`` while each worker's resident Q block accumulates
online-softmax statistics (the flash-attention recurrence), so attention
over the whole sequence is exact and no worker holds the whole K/V: memory
per worker is O(seq / n).  The rotation is issued before the block compute
each step, as in the reference.  ``rotate`` carries autograd, so a loss
through :func:`ring_attention` differentiates through the ring.

The block products are plain large matrix products (``torch.einsum``), as
the reference leaves them to XLA; the single-card kernel is
:mod:`harp_tpu_torch.ops.flash_attention`.
"""

from __future__ import annotations

import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, num_workers, worker_id


def online_softmax_block(q, k, v, m, l, acc, q_pos, k_pos, scale, causal,
                         window=None):
    """One online-softmax update of (m, l, acc) with a K/V block.

    q: [B, nq, H, D]; k, v: [B, nk, G, D] with ``H % G == 0`` (G < H is
    grouped-query attention: K/V are stored, rotated and regrouped with G
    heads, and repeated to H only here, inside the block); m, l: [B, H, nq]
    f32; acc: [B, nq, H, D] f32.  Scores accumulate in f32 and are scaled
    after the dot; ``p`` is cast to V's dtype before the ``p·v`` product.
    Shared by both sequence-parallel schemes: ring attention runs it over
    rotating K/V blocks, a2a attention over resident ones.
    """
    h, g = q.shape[2], k.shape[2]
    if h != g:
        if h % g != 0:
            raise ValueError(
                f"query heads ({h}) must be a multiple of KV heads ({g}) "
                "for grouped-query attention")
        k = k.repeat_interleave(h // g, dim=2)
        v = v.repeat_interleave(h // g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    delta = q_pos[:, None] - k_pos[None, :]
    mask = None
    if causal:
        mask = delta >= 0
    if window is not None:
        # sliding window: the causal form attends to the last `window` keys
        # (itself included), the bidirectional one to |q_pos - k_pos| <
        # window
        near = (delta < window) if causal else (delta.abs() < window)
        mask = near if mask is None else (mask & near)
    if mask is not None:
        scores = torch.where(mask, scores, float("-inf"))
    m_blk = scores.amax(-1)                               # [B, H, nq]
    m_new = torch.maximum(m, m_blk)
    # guard: a fully masked row keeps m = -inf, and exp(-inf - -inf) is NaN
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new),
                        torch.zeros_like(m))
    p = torch.exp(torch.where(torch.isfinite(scores),
                              scores - m_new[..., None], float("-inf")))
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window} (window=0 would "
                         "mask every key and silently return zeros)")


def ring_attention(q, k, v, *, causal: bool = False,
                   scale: float | None = None, window: int | None = None):
    """Exact multi-head attention, sequence sharded, on this worker's shard.

    Args (this worker's shards; every worker calls it):
      q: [batch, seq_local, heads, head_dim]; k, v: the same with
        ``kv_heads`` dividing ``heads`` (GQA/MQA: K/V travel the ring with
        the smaller head count).
      causal: causal masking by GLOBAL positions
        (``worker_id() * seq_local + arange(seq_local)``).
      window: sliding window: each query attends to the last ``window``
        keys (itself included) when causal, or to keys within ``window -
        1`` positions either side when not.  A causal window reaches back
        only ``ceil((window - 1) / seq_local)`` shards, so the ring stops
        after that many steps (exact: later blocks are fully masked).
    Returns: [batch, seq_local, heads, head_dim] in q's dtype.
    """
    n, me = num_workers(), worker_id()
    b, nq, h, d = q.shape
    check_window(window)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    steps = n
    if window is not None and causal:
        steps = min(n, -(-(window - 1) // nq) + 1)

    dev = q.device
    q_pos = me * nq + torch.arange(nq, device=dev)
    m = torch.full((b, h, nq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, nq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nq, h, d), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for t in range(steps):
        # rotate first: the transfer does not depend on this step's compute
        k_nxt = C.rotate(k_cur)
        v_nxt = C.rotate(v_cur)
        src = (me - t) % n                      # whose block is resident
        k_pos = src * nq + torch.arange(k_cur.shape[1], device=dev)
        m, l, acc = online_softmax_block(q, k_cur, v_cur, m, l, acc, q_pos,
                                         k_pos, scale, causal, window)
        k_cur, v_cur = k_nxt, v_nxt
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def make_ring_attention_fn(mesh: WorkerMesh, causal: bool = False,
                           window: int | None = None):
    """Host view: ``fn(q, k, v)`` takes the whole [batch, seq, heads,
    head_dim] arrays (every worker passes the same), attends over this
    worker's sequence shard, and returns the whole output on
    ``mesh.device``."""
    def fn(q, k, v):
        out = ring_attention(*(mesh.shard_array(a, 1) for a in (q, k, v)),
                             causal=causal, window=window)
        return C.pull(out, concat_dim=1)

    return fn
