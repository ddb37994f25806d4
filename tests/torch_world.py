"""Spawned gloo worlds for the port's CPU tests, and the work they run.

The children import this module (and through it torch and harp_tpu_torch)
but never JAX: the functions here stay free of ``harp_tpu`` and ``jax``.
One world per test module: a module-scoped fixture runs every case of the
module in one spawn and the tests read its results.  The rendezvous is a
``file://`` under the test's tmp directory, so parallel test workers never
share a port, and every wait has a timeout.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import time
import traceback

import numpy as np

WORLD = 4


def _child(rank, world, init_file, target, args, out):
    try:
        import torch
        import torch.distributed as dist

        from harp_tpu_torch.parallel.mesh import init_distributed

        torch.set_num_threads(1)
        init_distributed(f"file://{init_file}", world, rank, backend="gloo",
                         timeout_s=60)
        try:
            result = target(rank, world, *args)
            result["_jax_imported"] = "jax" in sys.modules
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:  # reported to the parent, which raises
        out.put((rank, "error", traceback.format_exc()))


def run_world(target, tmp_path, *args, world: int = WORLD,
              timeout: float = 120.0) -> list[dict]:
    """Run ``target(rank, world, *args)`` in ``world`` spawned gloo
    processes; return each rank's result dict, in rank order."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_file = os.path.join(str(tmp_path), "rendezvous")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, init_file, target, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, dict] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, status, payload = out.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(
                    f"gloo world gave {len(results)} of {world} results "
                    f"within {timeout} s") from None
            if status != "ok":
                raise RuntimeError(f"worker {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---- collective verbs ---------------------------------------------------

OPS = ("add", "max", "min", "avg", "multiply")
DTYPES = ("float32", "int32", "bool")


def collective_cases() -> list[tuple[str, str, dict, str | None, tuple]]:
    """(case id, verb, kwargs, input kind, per-worker shape)."""
    cases = []
    for op in OPS:
        for dt in DTYPES:
            cases.append((f"allreduce-{op}-{dt}", "allreduce", {"op": op},
                          dt, (3, 5)))
            cases.append((f"reduce-{op}-{dt}", "reduce",
                          {"op": op, "root": 1}, dt, (2, 3)))
    for dt in DTYPES:
        cases.append((f"allgather-{dt}", "allgather", {}, dt, (2, 3)))
        for root in (0, 2):
            cases.append((f"broadcast-root{root}-{dt}", "broadcast",
                          {"root": root}, dt, (4,)))
    cases.append(("allgather-untiled", "allgather", {"tiled": False},
                  "float32", (2, 3)))
    # root holds subnormals and -0.0; the others hold NaNs, to be discarded
    cases.append(("broadcast-bits", "broadcast", {"root": 1}, "bits", (6,)))
    for op in ("add", "avg", "max", "min"):
        for dt in ("float32", "int32"):
            cases.append((f"push-{op}-{dt}", "push", {"op": op}, dt, (8, 3)))
        cases.append((f"push-{op}-dim1", "push",
                      {"op": op, "scatter_dim": 1}, "float32", (3, 8)))
    cases.append(("pull-dim0", "pull", {}, "float32", (2, 3)))
    cases.append(("pull-dim1-int32", "pull", {"concat_dim": 1}, "int32",
                  (2, 3)))
    cases.append(("barrier", "barrier", {}, None, ()))
    return cases


def case_inputs(idx: int, kind: str | None, shape: tuple,
                world: int = WORLD) -> np.ndarray:
    """Every worker's input for case ``idx``: [world, *shape]."""
    rng = np.random.default_rng(100 + idx)
    full = (world, *shape)
    if kind == "float32":
        return rng.normal(size=full).astype(np.float32)
    if kind == "int32":
        return rng.integers(-5, 6, size=full).astype(np.int32)
    if kind == "bool":
        return rng.random(full) < 0.5
    if kind == "bits":
        x = np.full(full, np.nan, np.float32)
        x[1] = (rng.normal(size=shape) * 1e-39).astype(np.float32)
        x[1, 0] = -0.0
        return x
    return np.zeros((world,), np.int32)  # barrier takes no input


def run_collective_cases(rank: int, world: int) -> dict:
    import torch

    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils import telemetry

    out = {}
    for idx, (cid, verb, kw, kind, shape) in enumerate(collective_cases()):
        if verb == "barrier":
            out[cid] = C.barrier().numpy()
            continue
        x = torch.from_numpy(case_inputs(idx, kind, shape, world)[rank].copy())
        before = x.clone()
        out[cid] = getattr(C, verb)(x, **kw).numpy()
        assert torch.equal(x, before) or kind == "bits", "verb mutated input"
    try:
        C.push(torch.zeros(6, 3))
        out["push-indivisible"] = "no error"
    except ValueError as e:
        out["push-indivisible"] = str(e)
    # one call of each verb on a (tuple, dict) tree, with the ledger on
    with telemetry.scope():
        tree = (torch.ones(4, 2), {"n": torch.ones(3, dtype=torch.int32)})
        with telemetry.ledger.run("verbs", steps=1):
            out["tree-allreduce"] = C.allreduce(tree)
            C.push(torch.ones(8, 2))
            C.pull(torch.ones(2, 2))
        out["ledger"] = telemetry.ledger.summary()["verbs"]
    out["tree-allreduce"] = [out["tree-allreduce"][0].numpy(),
                             out["tree-allreduce"][1]["n"].numpy()]
    return out


# ---- KMeans ----------------------------------------------------------------

#: (case id, fit kwargs) run on every worker of the KMeans world
KMEANS_CASES = [
    ("allreduce", {"k": 8}),
    ("regroupallgather", {"k": 8, "variant": "regroupallgather"}),
    ("allreduce-k3", {"k": 3}),
    ("regroupallgather-k3", {"k": 3, "variant": "regroupallgather"}),
    ("int8-allreduce", {"k": 8, "quantize": "int8"}),
    ("int8-regroupallgather", {"k": 8, "quantize": "int8",
                               "variant": "regroupallgather"}),
    ("pallas-regroupallgather", {"k": 8, "use_pallas": True,
                                 "variant": "regroupallgather"}),
]


def run_kmeans_cases(rank: int, world: int, pts: np.ndarray,
                     iters: int) -> dict:
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.parallel.mesh import WorkerMesh, is_master
    from harp_tpu_torch.utils import telemetry

    mesh = WorkerMesh("cpu")
    out = {}
    for cid, kw in KMEANS_CASES:
        with telemetry.scope():
            c, inertia = KM.fit(pts, iters=iters, mesh=mesh, seed=None, **kw)
            out[cid] = {"centroids": c, "inertia": inertia,
                        "ledger": telemetry.ledger.summary()["kmeans.fit"]}
    out["rank"] = mesh.rank
    out["num_workers"] = mesh.num_workers
    out["is_master"] = is_master()
    return out
