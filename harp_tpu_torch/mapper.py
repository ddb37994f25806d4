"""CollectiveApp — the ``CollectiveMapper`` residue (Harp L4), the port of
``harp_tpu.mapper``.

Harp apps subclass ``edu.iu.harp.mapcollective.CollectiveMapper``, whose
``run()`` bootstraps the worker (peer discovery, membership barrier),
calls the user's ``mapCollective(reader, context)`` once with the whole
iterative program inside, then tears down and writes outputs.  The mapper
gives app code ``getSelfID``/``getNumWorkers``/``isMaster`` and the
collectives.

Here a worker is a process: the bootstrap is
:func:`harp_tpu_torch.parallel.mesh.init_distributed` (a no-op for one
process), the input files are dealt over the processes by
:func:`harp_tpu_torch.fileformat.multi_file_splits`, and the master is
rank 0.  Teardown closes the :class:`~harp_tpu_torch.utils.metrics.
MetricsLogger`, checks the app's flight-recorder budget (warn mode) and,
with telemetry on, stamps this process's wall seconds on the skew ledger
(``skew.record_host``).  Apps may equally call the model classes in
:mod:`harp_tpu_torch.models` directly; this class keeps Harp's shape for
ported app code.
"""

from __future__ import annotations

import logging
import time
from typing import Any

from harp_tpu_torch.parallel.mesh import (WorkerMesh, current_mesh,
                                          init_distributed, is_master,
                                          num_workers, use_mesh, worker_id)
from harp_tpu_torch.utils import flightrec, telemetry
from harp_tpu_torch.utils.metrics import MetricsLogger
from harp_tpu_torch.utils.telemetry import span

log = logging.getLogger("harp_tpu_torch")


class KeyValReader:
    """This worker's input splits — Harp's ``KeyValReader`` handed to
    ``mapCollective`` (key = file path, value = the loader's result).

    Harp's map-collective jobs use ``MultiFileInputFormat``, so each mapper
    receives whole files.  ``value`` is produced lazily by ``loader``
    (default: the native CSV loader,
    :func:`harp_tpu_torch.native.datasource.load_csv`)."""

    def __init__(self, paths: list[str], loader=None):
        if loader is None:
            from harp_tpu_torch.native.datasource import load_csv as loader
        self._paths = list(paths)
        self._loader = loader
        self._pos = 0
        self._value = None  # loaded lazily, cached per position

    def __iter__(self):
        for p in self._paths:
            yield p, self._loader(p)

    # Harp's imperative reader API (nextKeyValue/getCurrentKey/getCurrentValue)
    def next_key_value(self) -> bool:
        if self._pos >= len(self._paths):
            return False
        self._pos += 1
        self._value = None
        return True

    def current_key(self) -> str:
        if self._pos == 0:
            raise RuntimeError("call next_key_value() before current_key()")
        return self._paths[self._pos - 1]

    def current_value(self):
        if self._pos == 0:
            raise RuntimeError("call next_key_value() before current_value()")
        if self._value is None:
            self._value = self._loader(self._paths[self._pos - 1])
        return self._value

    @property
    def paths(self) -> list[str]:
        return list(self._paths)


class CollectiveApp:
    """Base class for Harp-style applications.

    Subclass and override :meth:`map_collective`.  Inside it, use
    ``self.mesh`` (the worker group and this worker's device), the verbs of
    :mod:`harp_tpu_torch.parallel.collective`, and ``self.metrics`` for
    per-iteration logging.  ``budget``: ``flightrec.budget`` limits for the
    whole ``map_collective`` block (e.g. ``{"readbacks": 1}``), checked in
    warn mode while telemetry is on.  Without a ``mesh`` the app runs on
    this worker's card, and raises where there is none."""

    def __init__(self, config: Any = None, mesh: WorkerMesh | None = None,
                 metrics_path: str | None = None,
                 input_paths: list[str] | None = None, loader=None,
                 budget: dict | None = None):
        self.config = config
        self.budget = budget
        init_distributed()  # a no-op for one process (Harp's bootstrap)
        self.mesh = mesh or current_mesh()
        self.metrics = MetricsLogger(metrics_path)
        # this process's input splits (MultiFileInputFormat semantics)
        self.reader = None
        if input_paths is not None:
            from harp_tpu_torch.fileformat import multi_file_splits

            splits = multi_file_splits(input_paths, num_workers())
            self.reader = KeyValReader(splits[worker_id()], loader)

    # -- Harp mapper API ----------------------------------------------------
    @property
    def num_workers(self) -> int:
        """``getNumWorkers()``."""
        return self.mesh.num_workers

    @property
    def worker_id(self) -> int:
        """``getSelfID()``."""
        return self.mesh.rank

    def is_master(self) -> bool:
        """``isMaster()``: rank 0 of the job."""
        return is_master()

    # -- lifecycle ----------------------------------------------------------
    def map_collective(self) -> Any:
        """The whole iterative program — override it (Harp's mapCollective)."""
        raise NotImplementedError

    def run(self) -> Any:
        """``CollectiveMapper.run()``: setup → mapCollective → cleanup."""
        t0 = time.perf_counter()
        log.info("harp-tpu app starting: %d workers, config=%s",
                 self.num_workers, self.config)
        try:
            with self.metrics, use_mesh(self.mesh), \
                    span("map_collective", app=type(self).__name__), \
                    flightrec.budget(**(self.budget or {}), action="warn",
                                     tag=type(self).__name__):
                result = self.map_collective()
        finally:
            self.metrics.close()
        if telemetry.enabled():
            from harp_tpu_torch.utils import skew

            # this process's wall seconds for the superstep, so a merged
            # report can name a straggling process
            skew.record_host("map_collective", self.mesh.rank,
                             time.perf_counter() - t0,
                             n_workers=self.num_workers)
            fs = flightrec.snapshot()
            log.info("flight record: %d compile(s) %.3fs, H2D %d B, "
                     "%d dispatch(es), %d readback(s)",
                     fs["compiles"], fs["compile_s"], fs["h2d_bytes"],
                     fs["dispatches"], fs["readbacks"])
        log.info("harp-tpu app finished in %.2fs", time.perf_counter() - t0)
        return result


def run_app(app_cls, config=None, **kw):
    """Launcher: ``app_cls(config, **kw).run()`` (Harp's ``hadoop jar``)."""
    return app_cls(config, **kw).run()
