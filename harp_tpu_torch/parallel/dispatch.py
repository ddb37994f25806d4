"""Capacity-bounded destination bucketing, the all-to-all dispatch core —
the port of ``harp_tpu.parallel.dispatch``.

Items carry a destination id; each (source, destination) bucket holds a
fixed ``capacity`` of slots, so every worker sends the same number of
bytes to every other (the exchange is one ``regroup``).  Items past a
bucket's capacity go to a trash slot that is cut off before the exchange,
and are counted as dropped.  MoE dispatch (:mod:`harp_tpu_torch.ops.moe`)
routes its tokens through it.
"""

from __future__ import annotations

import torch


def bucket_by_destination(dest: torch.Tensor, payloads, capacity: int,
                          n_dest: int, valid: torch.Tensor | None = None):
    """Pack items into per-destination capacity buckets.

    Args:
      dest: [n] int, the destination id of each item (0 <= dest < n_dest
        for every valid item; an invalid item's id may be anything).
      payloads: tuple of tensors with leading dim n (any trailing shape).
      capacity: slots per destination bucket.
      n_dest: number of destinations.
      valid: optional [n] bool.  False items are skipped on purpose: they
        take no slot, send nothing and are NOT counted as dropped.
    Returns ``(bufs, keep, slot, dropped_local)``:
      bufs: tuple of [n_dest, capacity, ...] tensors, item i at
        ``(dest[i], slot[i])`` when kept, zeros elsewhere;
      keep: [n] bool, False for over-capacity (and invalid) items;
      slot: [n] int64, the position in the bucket (== capacity for a
        dropped item; pair it with ``keep`` when gathering back);
      dropped_local: int32 scalar, this worker's dropped VALID items.
    """
    n = dest.shape[0]
    dest = dest.to(torch.int64)
    # one_hot of an id out of [0, n_dest) is a zero row, as jax.nn.one_hot
    onehot = (dest[:, None] == torch.arange(n_dest, device=dest.device)
              ).to(torch.int32)                                  # [n, n_dest]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dest.device)
    else:
        onehot = onehot * valid[:, None].to(onehot.dtype)
    # slots count VALID items only: an invalid row is all zero in the
    # cumsum, so it never displaces a valid item
    cum = torch.cumsum(onehot, dim=0) - 1
    pos = cum.gather(1, dest.clamp(0, n_dest - 1)[:, None])[:, 0]
    keep = (pos < capacity) & valid
    slot = torch.where(keep, pos.to(torch.int64),
                       torch.full_like(dest, capacity))  # the trash slot

    # a skipped item may name no destination at all (an out-of-range row
    # id that its caller counts as a drop): it lands in bucket 0's trash
    # slot, as the reference's scatter drops an out-of-bounds write
    row = torch.where(keep, dest, torch.zeros_like(dest))
    bufs = []
    for p in payloads:
        buf = torch.zeros((n_dest, capacity + 1) + tuple(p.shape[1:]),
                          dtype=p.dtype, device=p.device)
        masked = p * keep.reshape((n,) + (1,) * (p.dim() - 1)).to(p.dtype)
        buf[row, slot] = masked
        bufs.append(buf[:, :capacity])
    dropped = (~keep & valid).sum().to(torch.int32)
    return tuple(bufs), keep, slot, dropped
