"""harp-tpu on PyTorch and CUDA — the port of ``harp_tpu`` to NVIDIA Hopper.

The same Harp collective-ML system as ``harp_tpu``, written with PyTorch's
idiom: plain functions on tensors, an explicit ``device`` and explicit
``torch.Generator``\\ s.  Workers are processes joined by
``torch.distributed`` (NCCL on cards, gloo in CPU tests); the TPU's Pallas
kernels become CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built at
first use by :mod:`harp_tpu_torch.ops.build`.

The public API is the reference's, name for name::

    from harp_tpu_torch import CollectiveApp, Combiner, run_app

- the worker group: :class:`~harp_tpu_torch.parallel.mesh.WorkerMesh`,
  ``current_mesh``, ``set_mesh``, ``init_distributed``;
- the verbs: :mod:`harp_tpu_torch.parallel.collective` (as ``collective``)
  and its :class:`~harp_tpu_torch.parallel.collective.Combiner`;
- the Table/KV layer of :mod:`harp_tpu_torch.table`;
- the ``CollectiveMapper`` residue of :mod:`harp_tpu_torch.mapper` and the
  schedulers of :mod:`harp_tpu_torch.schedule`.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a device and without a GPU they raise.  Importing the package
touches no device and starts no thread.  This package never imports JAX
or ``harp_tpu``.
"""

from harp_tpu_torch.parallel.mesh import (
    WorkerMesh,
    current_mesh,
    set_mesh,
    init_distributed,
)
from harp_tpu_torch.parallel import collective
from harp_tpu_torch.parallel.collective import Combiner
from harp_tpu_torch.table import (
    Int2DoubleKVTable,
    Int2FloatKVTable,
    Int2IntKVTable,
    Int2LongKVTable,
    KVTable,
    Long2DoubleKVTable,
    Long2IntKVTable,
    Partition,
    Table,
    combine_by_key,
    kv_allreduce,
    regroup_by_key,
)
from harp_tpu_torch.mapper import CollectiveApp, KeyValReader, run_app
from harp_tpu_torch.schedule import StaticScheduler, DynamicScheduler, Task

__version__ = "0.1.0"

__all__ = [
    "WorkerMesh",
    "current_mesh",
    "set_mesh",
    "init_distributed",
    "collective",
    "Combiner",
    "KVTable",
    "Int2IntKVTable",
    "Int2LongKVTable",
    "Int2FloatKVTable",
    "Int2DoubleKVTable",
    "Long2IntKVTable",
    "Long2DoubleKVTable",
    "kv_allreduce",
    "combine_by_key",
    "regroup_by_key",
    "Table",
    "Partition",
    "CollectiveApp",
    "KeyValReader",
    "run_app",
    "StaticScheduler",
    "DynamicScheduler",
    "Task",
    "__version__",
]
