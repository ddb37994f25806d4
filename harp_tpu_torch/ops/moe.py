"""Expert parallelism: Switch-style top-1 MoE FFN, one expert per worker —
the port of ``harp_tpu.ops.moe``.

Tokens are routed to experts by a gating argmax, packed into
capacity-bounded buckets (:func:`~harp_tpu_torch.parallel.dispatch.
bucket_by_destination`), exchanged with ONE ``regroup`` (all-to-all) so
each worker receives every token routed to ITS expert, run through the
local expert FFN, and returned by the inverse ``regroup``; the gate
probability scales the combined output.  Tokens past a bucket's capacity
are dropped (their output is zero) and counted.
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.dispatch import bucket_by_destination
from harp_tpu_torch.parallel.mesh import num_workers


def moe_ffn(x, gate_w, w1, b1, w2, b2, *, capacity: int):
    """Top-1 MoE feed-forward on this worker's tokens.

    Args (per worker):
      x: [n_loc, d] local tokens.
      gate_w: [d, E] router weights, the same on every worker (E = the
        worker count).
      w1 [d, h], b1 [h], w2 [h, d], b2 [d]: THIS worker's expert.
      capacity: token slots this worker may send to EACH expert.
    Returns ``(y [n_loc, d], dropped)``: ``dropped`` is the GLOBAL
    (allreduced) int32 count of tokens that overflowed a bucket on any
    worker; their rows of ``y`` are zero.
    """
    e = num_workers()
    if gate_w.shape[-1] != e:
        raise ValueError(
            f"gate_w routes to {gate_w.shape[-1]} experts but the group has "
            f"{e} workers (one expert per worker) — shapes must match or "
            "tokens would silently clamp to wrong experts")

    logits = x @ gate_w                                   # [n_loc, E]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(logits, dim=-1)             # first max wins
    gate = probs.gather(1, expert_idx[:, None])[:, 0]

    (send,), keep, slot, dropped_local = bucket_by_destination(
        expert_idx, (x,), capacity, e)                    # [E, cap, d]
    dropped = C.allreduce(dropped_local)  # global drop count

    # the EP exchange: block e of `send` goes to worker e; received block s
    # holds worker s's tokens for MY expert
    recv = C.regroup(send, split_dim=0, concat_dim=0)
    h = torch.relu(recv @ w1 + b1)
    out = h @ w2 + b2                                     # [E, cap, d]
    # inverse exchange: block s returns to worker s
    back = C.regroup(out, split_dim=0, concat_dim=0)

    # un-dispatch: token t reads its expert's returned slot; dropped -> 0
    y = back[expert_idx, slot.clamp(0, capacity - 1)]
    return y * (gate * keep.to(gate.dtype))[:, None], dropped


def reference_moe(x, gate_w, w1_all, b1_all, w2_all, b2_all, capacity,
                  n_workers):
    """Host reference with the same routing and capacity rules, one token
    at a time in numpy.

    ``x`` is the GLOBAL [n, d] token array laid out worker-major (worker w
    owns rows ``w*n_loc:(w+1)*n_loc``); ``*_all`` stack every expert on
    dim 0."""
    x = np.asarray(x)
    n, d = x.shape
    n_loc = n // n_workers
    logits = x @ np.asarray(gate_w)
    probs = torch.softmax(torch.from_numpy(np.ascontiguousarray(logits)),
                          dim=-1).numpy()
    idx = logits.argmax(-1)
    y = np.zeros_like(x)
    # per (source worker, expert) capacity buckets, in token order
    counts = np.zeros((n_workers, len(b1_all)), np.int64)
    for t in range(n):
        w = t // n_loc
        ei = idx[t]
        if counts[w, ei] >= capacity:
            continue  # dropped
        counts[w, ei] += 1
        h = np.maximum(x[t] @ np.asarray(w1_all[ei])
                       + np.asarray(b1_all[ei]), 0)
        y[t] = (h @ np.asarray(w2_all[ei])
                + np.asarray(b2_all[ei])) * probs[t, ei]
    return y
