"""Worker membership: the port of ``harp_tpu.parallel.mesh``.

A Harp worker is one process with one device.  Membership is the
``torch.distributed`` default process group (NCCL between cards, gloo in
CPU tests); with no process group initialised the group is one worker on
one device.  The port is SPMD by process, so there is no ``shard_map``:
each worker runs the app's functions on its own shard, and the collective
verbs (:mod:`harp_tpu_torch.parallel.collective`) exchange data.

==================  =========================================
harp_tpu_torch      Harp (``edu.iu.harp.worker.Workers``)
==================  =========================================
``num_workers``     ``getNumWorkers()``
``rank``            ``getSelfID()``
``is_master``       ``isMaster()``
``device``          the worker's card (or the CPU, on request)
==================  =========================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The worker's device: ``device`` as given, else this worker's card.

    With no device given and no GPU present this raises: an entry point
    never carries on on the CPU unless the caller asked for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda", worker_id() % torch.cuda.device_count())


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 600.0) -> None:
    """Join a multi-process job; a no-op for one process or when a process
    group already exists.

    Harp's nodes-file handshake becomes ``init_process_group``: give it the
    rendezvous (``tcp://localhost:<port>`` or ``file://<path>``), the world
    size and this process's rank.  ``backend`` defaults to NCCL when CUDA
    is available, else gloo."""
    if dist.is_initialized() or world_size in (None, 1):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def worker_id() -> int:
    """This worker's rank — Harp's ``getSelfID()``."""
    return dist.get_rank() if dist.is_initialized() else 0


def num_workers() -> int:
    """Worker count — Harp's ``getNumWorkers()``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    """True on rank 0 — Harp's ``isMaster()``."""
    return worker_id() == 0


class WorkerMesh:
    """The worker group as seen by this process: its rank, the group's
    size and this worker's device."""

    def __init__(self, device: "torch.device | str | None" = None):
        self.device = resolve_device(device)

    @property
    def num_workers(self) -> int:
        return num_workers()

    @property
    def rank(self) -> int:
        return worker_id()

    def shard_array(self, x, dim: int = 0) -> torch.Tensor:
        """This worker's contiguous block of ``x`` along ``dim``, on
        ``device``.  Every worker passes the same global ``x``; ``dim`` must
        divide evenly over the workers, as the reference's sharding
        requires."""
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        nw, size = self.num_workers, x.shape[dim]
        if size % nw:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"divide over {nw} workers")
        block = size // nw
        return x.narrow(dim, self.rank * block, block).to(
            self.device).contiguous()

    def replicated(self, x) -> torch.Tensor:
        """``x`` whole on this worker's device (every worker holds it)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.device)

    def __repr__(self) -> str:
        return (f"WorkerMesh(num_workers={self.num_workers}, "
                f"rank={self.rank}, device={self.device})")


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This worker's place in a (data × model) grid of ranks.

    Rank ``r < n_data * n_model`` sits at ``(data_index, model_index) =
    divmod(r, n_model)``, the reference's ``reshape(n_data, n_model)`` of
    its devices.  ``data_group`` holds the ranks of this worker's column
    (same model index: gradients average over it); ``model_group`` those of
    its row (same data index: the tensor-parallel collectives).  With one
    process both groups are ``None``, and a group of one moves nothing.  A
    rank past the grid has no place (``data_index`` None)."""

    n_data: int
    n_model: int
    data_index: int | None
    model_index: int | None
    data_group: object
    model_group: object
    device: torch.device


#: the 2-D groups of the current world: {"world": the default group they
#: belong to, "grids": {(n_data, n_model): (data groups, model groups)}}
_GRIDS: dict = {"world": None, "grids": {}}


def mesh_2d(n_data: int, n_model: int, device=None) -> Mesh2D:
    """A 2-D (data × model) layout of the workers — the tensor-parallel
    extension beyond Harp's single worker axis.

    Every worker calls it with the same arguments: each data and model
    group is made once per world and shape with ``dist.new_group``, by
    every rank in the same order (a collective of the whole world)."""
    nw, me = num_workers(), worker_id()
    if n_data * n_model > nw:
        raise ValueError(
            f"mesh_2d({n_data}x{n_model}) needs {n_data * n_model} devices, "
            f"have {nw}")
    dev = resolve_device(device)
    size = n_data * n_model
    if nw == 1:
        return Mesh2D(n_data, n_model, 0, 0, None, None, dev)
    if _GRIDS["world"] is not dist.group.WORLD:
        _GRIDS["world"], _GRIDS["grids"] = dist.group.WORLD, {}
    key = (n_data, n_model)
    if key not in _GRIDS["grids"]:
        grid = np.arange(size).reshape(n_data, n_model)
        cols = [grid[:, j].tolist() for j in range(n_model)]
        rows = [grid[i].tolist() for i in range(n_data)]
        _GRIDS["grids"][key] = ([dist.new_group(r) for r in cols],
                                [dist.new_group(r) for r in rows])
    data_groups, model_groups = _GRIDS["grids"][key]
    if me >= size:
        return Mesh2D(n_data, n_model, None, None, None, None, dev)
    i, j = divmod(me, n_model)
    return Mesh2D(n_data, n_model, i, j, data_groups[j], model_groups[i], dev)


_CURRENT_MESH: WorkerMesh | None = None


def resolve_mesh(mesh: WorkerMesh | None, device) -> WorkerMesh:
    """An entry point's group: ``mesh`` if given (it must agree with
    ``device``), else one on ``device``, else the process-wide default."""
    if mesh is None:
        return WorkerMesh(device) if device is not None else current_mesh()
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} disagrees with the mesh's "
                         f"{mesh.device}")
    return mesh


def current_mesh() -> WorkerMesh:
    """The process-wide default group (made on first use, on this worker's
    card — which raises where there is none)."""
    global _CURRENT_MESH
    if _CURRENT_MESH is None:
        _CURRENT_MESH = WorkerMesh()
    return _CURRENT_MESH


def set_mesh(mesh: WorkerMesh | None) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


@contextlib.contextmanager
def use_mesh(mesh: WorkerMesh):
    global _CURRENT_MESH
    prev, _CURRENT_MESH = _CURRENT_MESH, mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev
