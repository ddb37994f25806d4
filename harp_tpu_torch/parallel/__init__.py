"""Parallel substrate: the worker group, the Harp collective verbs over
``torch.distributed``, the rotation and GPipe pipelines.

The port of ``harp_tpu.parallel``, with the same exports: Harp's L0-L3
communication stack (membership, transport, the collective algorithms)
becomes process groups and NCCL (gloo on the CPU), and only the verbs and
their combiner semantics survive as API.
"""

from harp_tpu_torch.parallel.mesh import (
    WorkerMesh,
    current_mesh,
    init_distributed,
    mesh_2d,
    set_mesh,
)
from harp_tpu_torch.parallel.collective import (
    Combiner,
    ShardSpec,
    allreduce,
    allreduce_hier,
    allgather,
    broadcast,
    match_reshard_rules,
    reduce,
    regroup,
    regroup_quantized,
    reshard,
    reshard_reference,
    rotate,
    rotate_quantized,
    push,
    pull,
    barrier,
)
from harp_tpu_torch.parallel.pipeline import (pipeline_forward,
                                              pipeline_loss_and_grads)
# as in the reference, importing the rotate module after the verbs binds
# its name here: ``harp_tpu_torch.parallel.rotate`` is the module (the
# verb is ``collective.rotate``)
from harp_tpu_torch.parallel.rotate import (resident_chunk_index,
                                            rotate_pipeline)

__all__ = [
    "WorkerMesh",
    "current_mesh",
    "set_mesh",
    "init_distributed",
    "mesh_2d",
    "pipeline_forward",
    "pipeline_loss_and_grads",
    "Combiner",
    "ShardSpec",
    "allreduce",
    "allreduce_hier",
    "allgather",
    "match_reshard_rules",
    "reshard",
    "reshard_reference",
    "broadcast",
    "reduce",
    "regroup",
    "regroup_quantized",
    "rotate",
    "rotate_quantized",
    "push",
    "pull",
    "barrier",
    "resident_chunk_index",
    "rotate_pipeline",
]
