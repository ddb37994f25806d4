"""Row movement over the reshard verb — the port of
``harp_tpu.elastic.move``.

A rebalance relabels external ids, so model rows must land on their
packs' new owners.  An arbitrary row permutation is not a move between two
:class:`~harp_tpu_torch.parallel.collective.ShardSpec` layouts, but it is
the verb's always-legal fallback split in two: ``reshard(blocked(0) →
replicated)`` (one all-gather on the wire) followed by a local gather of
each worker's new rows.  So the move rides the existing ``reshard``, is
recorded in the comm ledger like any verb call, and counts one dispatch
(``elastic.regather``) on the flight recorder.

Bit-exact: the exact wire moves rows untouched and the local gather is a
permutation, so :func:`regather_rows` equals the host ``np.take``
element for element.
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.parallel.collective import ShardSpec, reshard
from harp_tpu_torch.parallel.mesh import WorkerMesh, use_mesh


def _regather(x: torch.Tensor, mine: np.ndarray) -> torch.Tensor:
    full = reshard(x, ShardSpec.blocked(0), ShardSpec.replicated())
    idx = torch.as_tensor(np.clip(mine, 0, full.shape[0] - 1),
                          dtype=torch.int64, device=x.device)
    out = full.index_select(0, idx)
    keep = torch.as_tensor(mine >= 0, device=x.device).reshape(
        (-1,) + (1,) * (out.ndim - 1))
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def regather_rows(mesh: WorkerMesh, x: torch.Tensor, new_rows):
    """Move table rows into a new dim-0-blocked layout over the reshard
    verb.

    ``x``: this worker's dim-0 block of the table (every worker's block has
    the same rows).  ``new_rows``: host int array, one entry per output row
    of the new global layout (length a multiple of the workers): the global
    old row that lands there, or -1 for a pad slot (zero-filled).  Returns
    this worker's block of the new layout; its length may differ from the
    input's."""
    from harp_tpu_torch.utils import flightrec, telemetry

    nr = np.asarray(new_rows, np.int64)
    n = mesh.num_workers
    if nr.ndim != 1 or nr.shape[0] % n:
        raise ValueError(
            f"new_rows must be 1-D with length a multiple of {n} "
            f"workers, got shape {nr.shape}")
    mine = nr.reshape(n, -1)[mesh.rank]
    fn = flightrec.track(_regather, "elastic.regather")
    with use_mesh(mesh), \
            telemetry.span("elastic.regather", rows=int(nr.shape[0])), \
            telemetry.ledger.run("elastic.regather", steps=1):
        return fn(x, mine)
