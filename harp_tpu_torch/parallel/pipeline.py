"""Pipeline parallelism over the worker ring, GPipe-style microbatching —
the port of ``harp_tpu.parallel.pipeline``.

Worker ``w`` owns stage ``w``'s parameters; microbatches enter at stage 0,
activations hop worker to worker through
:func:`harp_tpu_torch.parallel.collective.rotate` each step, and after
``S + M - 1`` steps all ``M`` microbatches have flowed through all ``S``
stages.  The last stage's outputs are then broadcast to every worker.

Training comes from autograd: ``rotate``'s backward is the reverse hop and
``broadcast``'s is the cotangents summed onto the root, so each worker
receives exactly its own stage's gradients.  The port is SPMD by process,
and the backward collectives must meet in the same order on every worker:
so every worker builds the same graph, choosing between the injected
microbatch and the ring's activation (and whether the last stage records
an output) with ``torch.where`` on a flag rather than a Python branch.

Constraint, as in the reference: the activation that travels the ring is
one fixed-shape tensor, so every stage maps ``[mb, width] → [mb, width]``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import (WorkerMesh, num_workers,
                                          resolve_mesh, worker_id)
from harp_tpu_torch.utils.telemetry import span, tree_leaves


def _place(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dev)


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, microbatches, *,
                     mesh: WorkerMesh | None = None,
                     device=None) -> torch.Tensor:
    """Run ``microbatches`` ``[M, mb, width]`` (the same on every worker)
    through the S-stage pipeline; ``stage_params`` is this worker's stage
    and ``stage_fn(params, [mb, width]) → [mb, width]`` one stage.  Returns
    the final stage's ``[M, mb, width]`` outputs on every worker.  Runs on
    the mesh's device (this worker's card unless ``device`` says
    otherwise); the span ``pipeline_forward`` times it."""
    dev = resolve_mesh(mesh, device).device
    x = _place(microbatches, dev)
    params = C.tree_map(lambda p: _place(p, dev), stage_params)
    with span("pipeline_forward", microbatches=int(x.shape[0])):
        return _pipeline_forward(stage_fn, params, x)


def _pipeline_forward(stage_fn, stage_params, microbatches):
    s, me = num_workers(), worker_id()
    m, mb, width = microbatches.shape
    dev = microbatches.device

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(bool(b), device=dev)

    buf = torch.zeros((mb, width), dtype=microbatches.dtype, device=dev)
    outs = [torch.zeros_like(buf) for _ in range(m)]
    for t in range(s + m - 1):
        # stage 0 injects microbatch t while it exists; later stages take
        # what the ring delivered last step
        inject = microbatches[min(t, m - 1)]
        cur = torch.where(flag(me == 0 and t < m), inject, buf)
        y = stage_fn(stage_params, cur)
        # the final stage records microbatch t - (S-1) once it has flowed
        # through all S stages
        slot = t - (s - 1)
        at = min(max(slot, 0), m - 1)
        outs[at] = torch.where(flag(me == s - 1 and 0 <= slot < m), y,
                               outs[at])
        buf = C.rotate(y)
    # every worker gets the outputs (they are only valid on the last stage)
    return C.broadcast(torch.stack(outs), root=s - 1)


def pipeline_loss_and_grads(stage_fn, loss_fn, stage_params, microbatches,
                            targets, *, mesh: WorkerMesh | None = None,
                            device=None):
    """``(loss, grads)``: ``loss_fn(outputs [M, mb, width], targets)`` over
    all microbatches, and this worker's stage gradients (a nest shaped
    like ``stage_params``).

    The objective differentiated is ``loss / S``, as in the reference:
    every worker seeds a cotangent of 1 into the (replicated) loss and
    ``broadcast``'s backward sums them onto the last stage, so without the
    ``1/S`` each worker's gradients would be S times the true value.  The
    returned loss is the unscaled one."""
    dev = resolve_mesh(mesh, device).device
    s = num_workers()
    params = C.tree_map(
        lambda p: _place(p, dev).detach().requires_grad_(True), stage_params)
    outs = pipeline_forward(stage_fn, params, microbatches, device=dev)
    loss_scaled = loss_fn(outs, _place(targets, dev)) / s
    leaves = tree_leaves(params)
    got = torch.autograd.grad(loss_scaled, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, got)])
    grads = C.tree_map(lambda _: next(it), params)
    return loss_scaled.detach() * s, grads
