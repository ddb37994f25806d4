"""``serve`` — resident-model inference for the trained apps: the port of
``harp_tpu.serve``.

Harp has no serving path: every reference app is batch fit-and-exit.
This subsystem is a long-lived server that loads a trained model through
:class:`harp_tpu_torch.utils.checkpoint.CheckpointManager`, keeps the
model state on the worker group's devices across requests, and answers
inference queries for six apps (:mod:`harp_tpu_torch.serve.engines`).

The steady state is held to the reference's budgets:

- the micro-batcher (:mod:`harp_tpu_torch.serve.batcher`) coalesces
  queued requests into a small ladder of fixed padded shapes, so the
  steady state never sees a new shape and never captures
  (``flightrec.SteadyState(compiles=0)`` wraps every batch);
- every batch is one dispatch (one replay of the rung's CUDA graph,
  captured at startup by :mod:`harp_tpu_torch.serve.cache`) and one
  stacked readback;
- the continuous plane (:class:`~harp_tpu_torch.serve.server.
  ContinuousRunner` over :class:`~harp_tpu_torch.serve.batcher.
  ContinuousScheduler`, fronted by asyncio TCP in
  :mod:`harp_tpu_torch.serve.transport`) admits requests while batches
  are in flight and dispatches batch t+1 before batch t's readback, with
  the same budgets proven exact by ``SteadyState.verify_exact``;
- under faults it sheds, retries with a fresh staging, and isolates a
  failed batch to its own requests.
"""

from harp_tpu_torch.serve.batcher import (ContinuousScheduler, MicroBatcher,
                                          ShapeLadder)
from harp_tpu_torch.serve.cache import GraphCache, RungExecutable
from harp_tpu_torch.serve.server import ContinuousRunner, Server

__all__ = ["ContinuousScheduler", "ContinuousRunner", "MicroBatcher",
           "ShapeLadder", "GraphCache", "RungExecutable", "Server"]
