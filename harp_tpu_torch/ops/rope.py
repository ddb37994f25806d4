"""Rotary position embeddings for sequence-sharded tensors — the port of
``harp_tpu.ops.rope``.

RoPE needs each token's GLOBAL position, but under sequence parallelism a
worker holds only its shard: positions come from the worker id, as the
attention schemes derive their mask positions, so Q and K rotate
shard-locally with no gather of position tables.  The pairs are
interleaved, dimension ``2i`` with ``2i+1`` (the reference's convention,
not the halves that some model codebases rotate).
"""

from __future__ import annotations

import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh, worker_id


def rope_angles(positions: torch.Tensor, head_dim: int,
                base: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """[S] positions -> (cos [S, head_dim/2], sin [S, head_dim/2]), f32."""
    if head_dim % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {head_dim}")
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32,
                                            device=positions.device), exps)
    ang = positions[:, None].to(torch.float32) * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, *, base: float = 10000.0) -> torch.Tensor:
    """Rotate this worker's shard of a sequence-sharded [batch, seq_local,
    heads, head_dim] tensor by its tokens' global positions
    (``worker_id() * seq_local + arange(seq_local)``); call it before
    :func:`~harp_tpu_torch.ops.ring_attention.ring_attention` or
    :func:`~harp_tpu_torch.ops.a2a_attention.a2a_attention`."""
    b, nq, h, d = x.shape
    pos = worker_id() * nq + torch.arange(nq, device=x.device)
    cos, sin = rope_angles(pos, d, base)
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(b, nq, h, d).to(x.dtype)


def make_rope_fn(mesh: WorkerMesh, base: float = 10000.0):
    """Host view: ``fn(x)`` takes the whole [batch, seq, heads, head_dim]
    array (every worker passes the same), rotates this worker's sequence
    shard, and returns the whole result on ``mesh.device``."""
    def fn(x):
        out = apply_rope(mesh.shard_array(x, 1), base=base)
        return C.pull(out, concat_dim=1)

    return fn
