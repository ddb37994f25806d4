"""Spawned gloo worlds for the public API's and the runnable apps' tests.
Like :mod:`torch_world` (whose ``run_world`` spawns them), the children
import torch and harp_tpu_torch, never JAX: every import of the port here
goes through the public names a user's app starts with."""

from __future__ import annotations

import numpy as np

from torch_world import WORLD, run_world, time_limit  # noqa: F401

#: the apps' arguments in the CPU tests (the reference's flags)
APP_ARGS = {
    "kmeans_app": ["--n", "1024", "--d", "8", "--k", "4", "--iters", "5"],
    "mfsgd_app": ["--users", "128", "--items", "96", "--nnz", "2000",
                  "--rank", "4", "--epochs", "4"],
    "pipeline_moe_app": ["--steps", "8"],
    "streaming_kmeans_app": ["--n", "3000", "--d", "16", "--k", "8",
                             "--iters", "4", "--chunk", "512"],
}


def mfsgd_app_kwargs() -> dict:
    """``mfsgd_app.run``'s arguments for ``APP_ARGS["mfsgd_app"]``."""
    a = APP_ARGS["mfsgd_app"]
    return {k.lstrip("-"): int(v) for k, v in zip(a[::2], a[1::2])}


def run_app_cases(rank: int, world: int, mf_state: dict,
                  workdir: str) -> dict:
    """Each app on this worker, on the CPU, through its ``main`` (MF-SGD
    through ``run`` from the reference's initial factors ``mf_state``);
    the streaming app once in a temporary directory of worker 0's, once
    in ``workdir``."""
    from harp_tpu_torch import WorkerMesh
    from harp_tpu_torch.convert import mfsgd_state_from_numpy
    from harp_tpu_torch.examples import (kmeans_app, mfsgd_app,
                                         pipeline_moe_app,
                                         streaming_kmeans_app)

    cpu = ["--device", "cpu"]
    out = {"kmeans_app": kmeans_app.main(APP_ARGS["kmeans_app"] + cpu),
           "mfsgd_app": mfsgd_app.run(
               **mfsgd_app_kwargs(), mesh=WorkerMesh("cpu"),
               state=mfsgd_state_from_numpy(mf_state, "cpu")),
           "pipeline_moe_app": pipeline_moe_app.main(
               APP_ARGS["pipeline_moe_app"] + cpu)}
    args = APP_ARGS["streaming_kmeans_app"] + cpu
    out["streaming_kmeans_app"] = streaming_kmeans_app.main(args)
    out["streaming_workdir"] = streaming_kmeans_app.main(
        args + ["--workdir", workdir])
    return out


def run_api_cases(rank: int, world: int) -> dict:
    """A Harp-style app written against the package's public names only:
    the verbs under each combiner, the KV layer, the schedulers, the
    timer."""
    import torch

    from harp_tpu_torch import (CollectiveApp, Combiner, DynamicScheduler,
                                Int2DoubleKVTable, StaticScheduler, Task,
                                WorkerMesh, collective, combine_by_key,
                                current_mesh, kv_allreduce, regroup_by_key,
                                run_app, set_mesh)
    from harp_tpu_torch.parallel import (allgather, broadcast,
                                         rotate_pipeline)
    rotate = collective.rotate  # parallel.rotate is the rotate module
    from harp_tpu_torch.utils import Timer, device_sync

    class Square(Task):
        def run(self, item):
            return item * item

    class ApiApp(CollectiveApp):
        def map_collective(self):
            me, n = self.worker_id, self.num_workers
            x = torch.arange(4, dtype=torch.float32) + me
            res = {f"allreduce-{c.name}": collective.allreduce(x, c).numpy()
                   for c in (Combiner.ADD, Combiner.MAX, Combiner.MIN)}
            res["allgather"] = allgather(x[None]).numpy()
            res["broadcast"] = broadcast(x, root=n - 1).numpy()
            res["rotate"] = rotate(x).numpy()
            res["rotate_pipeline"] = rotate_pipeline(
                lambda acc, c, t: (acc + c.sum(), c), torch.zeros(()),
                x.clone(), n_chunks=2)[0].item()
            table = Int2DoubleKVTable(Combiner.ADD)
            for k in range(3):
                table.add(k + me, float(me + 1))
            res["kv"] = kv_allreduce(table).to_arrays()
            keys = torch.tensor([me, me + 1, 2 * me], dtype=torch.int64)
            vals = torch.ones(3) * (me + 1)
            kk, vv, mask, dropped = regroup_by_key(keys, vals, capacity=3)
            res["kv_regroup"] = (combine_by_key(kk, vv, 2 * n + 1).numpy(),
                                 int(dropped))
            res["is_master"] = self.is_master()
            return res

    out = {"app": run_app(ApiApp, mesh=WorkerMesh("cpu"))}
    set_mesh(WorkerMesh("cpu"))
    out["current_mesh"] = (current_mesh().rank, current_mesh().num_workers)
    set_mesh(None)
    items = list(range(10))
    out["static"] = StaticScheduler([Square(), Square()],
                                    device="cpu").schedule(items)
    out["dynamic"] = sorted(DynamicScheduler([Square(), Square()],
                                             device="cpu").schedule(items))
    timer = Timer()
    out["timer"] = (timer.time("sync", lambda: torch.ones(3)).tolist(),
                    timer.summary()["sync"]["n"],
                    device_sync({"a": torch.full((2,), 7.0)}))
    return out


def api_expected(rank: int, world: int) -> dict:
    """What :func:`run_api_cases` must give, from numpy."""
    xs = [np.arange(4, dtype=np.float32) + r for r in range(world)]
    kv: dict[int, float] = {}
    for r in range(world):
        for k in range(3):
            kv[k + r] = kv.get(k + r, 0.0) + r + 1
    owned = np.zeros(2 * world + 1, np.float32)
    for r in range(world):
        for key in (r, r + 1, 2 * r):
            if key % world == rank:
                owned[key] += r + 1
    half = [np.split(x, 2) for x in xs]
    return {"allreduce-ADD": sum(xs), "allreduce-MAX": xs[-1],
            "allreduce-MIN": xs[0], "allgather": np.stack(xs),
            "broadcast": xs[-1], "rotate": xs[(rank - 1) % world],
            "rotate_pipeline": float(sum(h.sum() for hs in half
                                         for h in hs)),
            "kv": (np.array(sorted(kv), np.int64),
                   np.array([kv[k] for k in sorted(kv)]),
                   np.array([sum(1 for r in range(world) if 0 <= k - r < 3)
                             for k in sorted(kv)], np.int64)),
            "kv_regroup": (owned, 0), "is_master": rank == 0,
            "timer": ([1.0, 1.0, 1.0], 1, 7.0)}
