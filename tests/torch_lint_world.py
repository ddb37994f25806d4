"""Spawned gloo worlds for the lint layers' tests: every registered driver
and protocol under the wire audit, and the threadguard's runs, on four
workers.  Like :mod:`torch_world` (whose ``run_world`` spawns them), the
children import torch and harp_tpu_torch, never JAX."""

from __future__ import annotations

from torch_world import WORLD, run_world, time_limit  # noqa: F401


def _fixture_drivers() -> dict:
    """Wire fixtures: a raw call no ledger sees (HL301), a verb whose
    ledger under-counts its wire (HL302), a quantized record (exempt) and
    an honest one.  Each records and calls on one line, so the two share
    a site."""
    import torch
    import torch.distributed as dist

    from harp_tpu_torch.utils import telemetry as T

    def raw(x):
        dist.all_reduce(x.clone())

    def lying(x):
        T.record_comm("allreduce", x[:2]); dist.all_reduce(x.clone())  # noqa: E702

    def quantized(x):
        T.record_comm("allreduce_quantized", x, wire_dtype=torch.int8); dist.all_reduce(x.clone())  # noqa: E501,E702

    def honest(x):
        T.record_comm("allreduce", x); dist.all_reduce(x.clone())  # noqa: E702

    return {name: (lambda device, f=f: (f, (torch.ones(8),)))
            for name, f in (("raw", raw), ("lying", lying),
                            ("quantized", quantized), ("honest", honest))}


def run_wire_audit(rank: int, world: int) -> dict:
    """Every registered driver under the wire tap (HL301/HL302 findings,
    byte sheets), every protocol under the staging audit, and the wire
    fixtures."""
    from harp_tpu_torch.analysis import cli
    from harp_tpu_torch.analysis.drivers import DRIVERS, PROTOCOLS

    vs, sheets = cli.run_wire_layer(DRIVERS, "cpu")
    ps = cli.run_protocol_layer(PROTOCOLS, "cpu")
    fixtures = {}
    for name, build in _fixture_drivers().items():
        fvs, sheet = cli.run_wire_layer({name: build}, "cpu")
        fixtures[name] = {"rules": sorted(v.rule for v in fvs),
                          "sheet": sheet[name]}
    return {"violations": [v.format() for v in vs],
            "protocol_violations": [v.format() for v in ps],
            "sheets": sheets, "fixtures": fixtures}


def guarded_fit(mesh, pts, armed: bool) -> dict:
    """One int8 KMeans fit, with the thread guard armed or not: its
    centroids, inertia, K1 launches, dispatches and readbacks."""
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.utils import flightrec, telemetry, threadguard

    KK.reset_launches()
    with telemetry.scope(True):
        if armed:
            with threadguard.armed() as g:
                c, inertia = KM.fit(pts, k=8, iters=3, mesh=mesh, seed=0,
                                    quantize="int8")
            checks, violations = g.checks, list(g.violations)
        else:
            c, inertia = KM.fit(pts, k=8, iters=3, mesh=mesh, seed=0,
                                quantize="int8")
            checks, violations = 0, []
        tr = flightrec.transfers.summary()
    return {"c": c, "inertia": inertia, "launches": dict(KK.LAUNCHES),
            "dispatches": tr["dispatches"], "readbacks": tr["readbacks"],
            "checks": checks, "violations": violations}


def run_guarded_fits(rank: int, world: int, pts) -> dict:
    """The int8 KMeans fit on the four-worker group, disarmed then armed
    then disarmed again."""
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    mesh = WorkerMesh("cpu")
    return {f"{i}-{armed}": guarded_fit(mesh, pts, armed)
            for i, armed in enumerate((False, True, False))}
