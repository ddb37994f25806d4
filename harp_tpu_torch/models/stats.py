"""Row sharding shared by the row-parallel apps — the part of
``harp_tpu.models.stats`` that SVM needs.

The statistics apps themselves (moments, covariance, naive Bayes, ...) are
not ported yet (ROADMAP.md, Queue 1, item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.parallel.mesh import WorkerMesh


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard_rows(mesh: WorkerMesh, *arrays):
    """Pad row-aligned arrays to a worker multiple and shard them.

    Returns ``(*this_workers_blocks, weights)``, the weights 1 for real rows
    and 0 for padding.  Floating arrays become float32, except bfloat16,
    which keeps its type (the reference's test is numpy's ``kind == 'f'``,
    which its bfloat16 does not pass); other types are kept."""
    arrays = [_as_tensor(a) for a in arrays]
    nw = mesh.num_workers
    n = arrays[0].shape[0]
    n_pad = -(-n // nw) * nw
    out = []
    for a in arrays:
        if a.is_floating_point() and a.dtype != torch.bfloat16:
            a = a.to(torch.float32)
        if n_pad > n:
            a = torch.cat([a, a.new_zeros((n_pad - n, *a.shape[1:]))])
        out.append(mesh.shard_array(a, 0))
    w = torch.zeros(n_pad, dtype=torch.float32)
    w[:n] = 1.0
    out.append(mesh.shard_array(w, 0))
    return tuple(out)
