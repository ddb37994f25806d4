"""Collective micro-benchmarks — the port of ``harp_tpu.benchmark``
(Harp's ``edu.iu.benchmark``).

    python -m harp_tpu_torch bench                  # every verb, 64 KB-64 MB
    python -m harp_tpu_torch bench --max-mb 256 --verbs allreduce rotate
    python -m harp_tpu_torch bench --sparse-capacity-sweep
    python -m harp_tpu_torch bench --device cpu     # the CPU, on request

Each verb runs through :func:`~harp_tpu_torch.parallel.collective.host_op`
on this worker's block at message sizes that grow by 4x; one JSON line per
(verb, size) gives the achieved GB/s and the seconds a call, beside the
device's name (a card's with its power limit).  Card times come from CUDA
events around ``reps`` calls after one untimed call.  With one worker no
byte crosses a link (a one-worker verb is a local copy or a no-op), so the
rows time the local path only, and say so (``"note"``): they are not
fabric numbers.  Every worker of a multi-process group runs the same
command, and each prints its own rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from harp_tpu_torch import table as T
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.parallel.mesh import WorkerMesh
from harp_tpu_torch.utils import telemetry
from harp_tpu_torch.utils.timing import cuda_ms, device_sync

#: name: (verb, kwargs, bytes on the wire per payload byte, by worker count)
VERBS = {
    "allreduce": (C.allreduce, {}, lambda nw: 2.0),
    "allgather": (C.allgather, {}, lambda nw: 1.0),
    "broadcast": (C.broadcast, {}, lambda nw: 1.0),
    "reduce": (C.reduce, {}, lambda nw: 1.0),
    "regroup": (C.regroup, {}, lambda nw: 1.0),
    "rotate": (C.rotate, {}, lambda nw: 1.0),
    "push": (C.push, {}, lambda nw: 1.0),
    "pull": (C.pull, {}, lambda nw: 1.0),
    # the quantized wires move half or a quarter of the f32 wire's bytes
    "allreduce_bf16": (C.allreduce_quantized,
                       {"wire_dtype": torch.bfloat16}, lambda nw: 1.0),
    "allreduce_int8": (C.allreduce_quantized, {"wire_dtype": torch.int8},
                       lambda nw: 0.5),
    "rotate_bf16": (C.rotate_quantized, {"wire_dtype": torch.bfloat16},
                    lambda nw: 0.5),
    "rotate_int8": (C.rotate_quantized, {"wire_dtype": torch.int8},
                    lambda nw: 0.25),
    "regroup_bf16": (C.regroup_quantized, {"wire_dtype": torch.bfloat16},
                     lambda nw: 0.5),
    "regroup_int8": (C.regroup_quantized, {"wire_dtype": torch.int8},
                     lambda nw: 0.25),
}

SPARSE_VERBS = ("pull_sparse", "push_sparse")

_ONE_WORKER = ("one worker: no byte crosses a link; these rows time the "
               "local path, not a fabric")


def device_label(device: torch.device) -> str:
    """The device a row was measured on: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"
    return out.splitlines()[0]


def _seconds_a_call(run, reps: int, device: torch.device) -> float:
    """Seconds a call of ``run`` after one untimed call: CUDA events on a
    card, the host clock (ending in a sync) elsewhere."""
    if device.type == "cuda":
        return cuda_ms(run, reps=reps, warmup=1) / 1e3
    device_sync(run())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    device_sync(out)
    return (time.perf_counter() - t0) / reps


def _row(mesh: WorkerMesh, label: str, **fields) -> dict:
    row = {**fields, "num_workers": mesh.num_workers, "device": label}
    if mesh.num_workers == 1:
        row["note"] = _ONE_WORKER
    return row


def _normal(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Standard normal data made on ``device`` (the timed values do not
    matter; the host would take seconds for the largest sizes)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def bench_verb(name: str, mesh: WorkerMesh, size_bytes: int, reps: int = 20,
               label: str | None = None) -> dict:
    """One verb at one size: ``size_bytes`` is the global [rows, 128] f32
    payload, this worker holding its block of the rows."""
    fn, kwargs, wire = VERBS[name]
    nw = mesh.num_workers
    # regroup and push split each worker's block again by nw
    mult = nw * nw if name.startswith(("regroup", "push")) else nw
    n_rows = max(mult, size_bytes // (4 * 128) // mult * mult)
    x = _normal((n_rows // nw, 128), mesh.rank, mesh.device)
    op = C.host_op(mesh, fn, **kwargs)
    with telemetry.ledger.run(f"bench.{name}", steps=reps + 1):
        dt = _seconds_a_call(lambda: op(x), reps, mesh.device)
    nbytes = n_rows * 128 * 4
    return _row(mesh, label or device_label(mesh.device), verb=name,
                bytes=nbytes, sec=dt, gb_per_sec=nbytes * wire(nw) / dt / 1e9)


def bench_sparse(name: str, mesh: WorkerMesh, size_bytes: int,
                 reps: int = 20, label: str | None = None) -> dict:
    """The request/serve row exchange (``table.pull_rows_sparse`` /
    ``push_rows_sparse``): ``size_bytes`` is the global requested-row
    payload, the table 4x past it (which must not change the time: that is
    the verbs' point).  Every worker requests ``m / nw`` rows of every
    owner, so ``capacity = m / nw`` and every wire slot carries a row."""
    nw = mesh.num_workers
    d = 128
    m = max(nw, size_bytes // (4 * d * nw) // nw * nw)  # rows per worker
    cap = m // nw
    rows_local = max(4 * m, 128)
    table = _normal((rows_local, d), mesh.rank, mesh.device)
    ids = torch.cat([o * rows_local + torch.arange(cap, dtype=torch.int32)
                     for o in range(nw)]).to(mesh.device)
    if name == "pull_sparse":
        def run():
            return T.pull_rows_sparse(table, ids, capacity=cap)[0]
    else:
        deltas = _normal((m, d), 1000 + mesh.rank, mesh.device)

        def run():
            return T.push_rows_sparse(table, ids, deltas, capacity=cap)[0]
    dt = _seconds_a_call(run, reps, mesh.device)
    payload = nw * m * d * 4
    return _row(mesh, label or device_label(mesh.device), verb=name,
                bytes=payload, sec=dt, gb_per_sec=payload / dt / 1e9,
                table_rows=nw * rows_local, requested_rows_per_worker=m)


def sweep_sparse_capacity(mesh: WorkerMesh, m: int = 4096, d: int = 128,
                          reps: int = 5, zipf_a: float = 1.1,
                          caps=(1 / 64, 1 / 16, 1 / 4, 1 / 2, 1.0),
                          label: str | None = None):
    """Capacity against (drops, wire, time) for ``pull_rows_sparse`` under
    three request distributions, for sizing ``pull_cap``; ``caps`` are
    fractions of the ``m`` requests a worker sends (cap = m never drops):

    - ``even``: owners round-robin, the even bench's best case;
    - ``zipf``: ids ~ Zipf(``zipf_a``) over the table, row 0 hottest;
    - ``zipf_dedup``: the same ids with each duplicate masked out of the
      wire (``valid``), one slot per distinct row (LDA's ``dedup_pulls``).

    Every worker sends the same ids.  Yields one record per (dist,
    capacity): ``drop_rate`` = dropped / sent requests over all workers,
    ``wire_mb`` = the all-to-all buffers both ways (rows and ids)."""
    nw = mesh.num_workers
    label = label or device_label(mesh.device)
    rows_local = max(128, 2 * m)
    # one numpy generator, drawn in the reference's order (the table, then
    # the ids), so both sweeps request the same rows
    rng = np.random.default_rng(0)
    table_d = mesh.shard_array(
        rng.normal(size=(nw * rows_local, d)).astype(np.float32), 0)
    zipf_ids = (rng.zipf(zipf_a, size=m).astype(np.int64) - 1) \
        % (nw * rows_local)

    def ids_for(dist):
        if dist == "even":
            per = np.arange(m, dtype=np.int64)
            return (per % nw) * rows_local + (per // nw) % rows_local, \
                np.ones(m, bool)
        valid = np.ones(m, bool)
        if dist == "zipf_dedup":
            order = np.argsort(zipf_ids, kind="stable")
            valid[order[1:]] = zipf_ids[order[1:]] != zipf_ids[order[:-1]]
        return zipf_ids, valid

    for dist in ("even", "zipf", "zipf_dedup"):
        ids, valid = ids_for(dist)
        sent = int(valid.sum())  # per worker
        ids_d = torch.from_numpy(ids.astype(np.int32)).to(mesh.device)
        valid_d = torch.from_numpy(valid).to(mesh.device)
        for frac in caps:
            cap = max(1, int(m * frac))

            def run():
                return T.pull_rows_sparse(table_d, ids_d, capacity=cap,
                                          valid=valid_d)

            dt = _seconds_a_call(run, reps, mesh.device)
            dropped = int(run()[2])
            wire = nw * (nw * cap) * (d * 4 + 4) * 2
            yield _row(mesh, label, verb="pull_sparse_sweep", dist=dist,
                       capacity=cap, cap_frac=frac,
                       requests_per_worker=sent,
                       drop_rate=dropped / max(1, sent * nw),
                       dropped=dropped, wire_mb=wire / 1e6, sec=dt,
                       zipf_a=zipf_a)


def sizes(min_kb: int, max_mb: int) -> list[int]:
    """Message sizes from ``min_kb`` KB up to ``max_mb`` MB, by 4x."""
    out, size = [], min_kb * 1024
    while size <= max_mb * 1024 * 1024:
        out.append(size)
        size *= 4
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="harp-tpu collective micro-benchmarks on PyTorch")
    p.add_argument("--verbs", nargs="*",
                   default=sorted(VERBS) + list(SPARSE_VERBS))
    p.add_argument("--min-kb", type=int, default=64)
    p.add_argument("--max-mb", type=int, default=64)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--sparse-capacity-sweep", action="store_true",
                   help="instead of the size sweep: capacity against (drop "
                        "rate, wire, time) for pull_rows_sparse under even, "
                        "Zipf-1.1 and deduplicated Zipf requests")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card; 'cpu' "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.verbs) - set(VERBS) - set(SPARSE_VERBS))
    if unknown:
        p.error(f"unknown verbs {unknown}")
    mesh = WorkerMesh(args.device)
    label = device_label(mesh.device)
    if args.sparse_capacity_sweep:
        for rec in sweep_sparse_capacity(mesh, reps=args.reps, label=label):
            print(json.dumps(rec))
        return 0
    for verb in args.verbs:
        bench = bench_sparse if verb in SPARSE_VERBS else bench_verb
        for s in sizes(args.min_kb, args.max_mb):
            print(json.dumps(bench(verb, mesh, s, args.reps, label)),
                  flush=True)
    from harp_tpu_torch.report import maybe_emit

    maybe_emit("bench")
    return 0


if __name__ == "__main__":
    main()
