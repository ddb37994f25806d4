"""The port's own evidence collector: every row the cost model is graded
against, measured on the card.

    python -m harp_tpu_torch.perfmodel.measure --out H100_EVIDENCE.jsonl
    python -m harp_tpu_torch.perfmodel.measure --only kmeans_int8 --out x.jsonl
    python -m harp_tpu_torch.perfmodel.measure --overheads --out x.jsonl

Runs on the card (the default device; it raises without one, like every
entry point) and writes one JSON line a row:

- one bench row a config of :data:`~harp_tpu_torch.perfmodel.model.
  CONFIG_MODELS` that :data:`RUNS` knows, and one a config the grader's
  pairs need (:data:`~harp_tpu_torch.perfmodel.grade.FAMILY_PAIRS`),
  through the app's own ``benchmark`` at the graded full shape
  (:data:`~harp_tpu_torch.perfmodel.model.FULL_SHAPES`): the call's
  keyword arguments, then its result;
- ``kind: "sweep"`` rows: K3's ``u_tile``/``i_tile`` and K4's
  ``d_tile``/``w_tile`` (``--sweeps``);
- one ``kind: "overhead"`` row, the probe behind
  ``flightrec.CALIBRATED_OVERHEADS`` (``--overheads``);
- the ``kind: "profile"`` rows of ``profile --all`` (``--profile``), the
  baseline ``health`` grades fresh profiles against, and one ``kind:
  "plan"`` row a driver program on ``single_card`` (the sheets ``predict``
  prices);

with no section flag, all of them.  Every row carries the card's name
and power limit (``metrics.provenance``), the commit (``--commit``, else
``git``) and the date.  A config whose full-shape run would not fit the
time is cut in depth (epochs, iterations), never in width, and says so in
``reduced``; none is cut today.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

#: config -> (module, benchmark function, keyword arguments): each at the
#: benchmark's own defaults (the graded full shapes) but for the knobs
#: that pick the arm
RUNS = {
    "kmeans": ("models.kmeans", "benchmark", {}),
    "kmeans_int8": ("models.kmeans", "benchmark", {"quantize": "int8"}),
    "kmeans_pallas": ("models.kmeans", "benchmark", {"use_pallas": True}),
    "kmeans_stream": ("models.kmeans_stream", "benchmark_streaming",
                      {"n": 100_000_000, "k": 1000, "iters": 2}),
    "kmeans_stream_int8": ("models.kmeans_stream", "benchmark_streaming",
                           {"n": 100_000_000, "k": 1000, "iters": 2,
                            "quantize": "int8"}),
    "mfsgd": ("models.mfsgd", "benchmark", {"algo": "dense"}),
    "mfsgd_pallas": ("models.mfsgd", "benchmark", {"algo": "pallas"}),
    "lda": ("models.lda", "benchmark", {"algo": "dense"}),
    "lda_pallas": ("models.lda", "benchmark", {"algo": "pallas"}),
    "svm": ("models.svm", "benchmark", {"algo": "xla"}),
    "svm_kernel_pallas": ("models.svm", "benchmark", {"algo": "pallas"}),
    "wdamds": ("models.wdamds", "benchmark", {"algo": "xla"}),
    "wdamds_dist_pallas": ("models.wdamds", "benchmark", {"algo": "pallas"}),
    "rf_dense_hist": ("models.rf", "benchmark", {"hist_algo": "dense"}),
    "rf_hist_pallas": ("models.rf", "benchmark", {"hist_algo": "pallas"}),
}

#: sweep name -> (config, [keyword arguments a point]): square tiles, the
#: default in the middle
SWEEP_POINTS = {
    "mfsgd_pallas_tile": ("mfsgd_pallas", [
        {"u_tile": t, "i_tile": t} for t in (128, 256, 512)]),
    "lda_pallas_tile": ("lda_pallas", [
        {"d_tile": t, "w_tile": t} for t in (128, 256, 512)]),
}


def _bench(cfg: str, extra: dict, dev) -> tuple[dict, dict]:
    """(keyword arguments, result) of one config's benchmark on ``dev``."""
    import importlib

    mod, fn, kw = RUNS[cfg]
    kw = {**kw, **extra}
    bench = getattr(importlib.import_module(f"harp_tpu_torch.{mod}"), fn)
    return kw, bench(device=dev, **kw)


def probe_overheads(dev, reps: int = 5) -> dict:
    """The card's fixed costs (``flightrec.CALIBRATED_OVERHEADS``' keys),
    each the median of ``reps`` samples:

    - ``dispatch_s``: 2,000 one-element adds back to back, no synchronize
      in the window, over the host's clock;
    - ``readback_s``: a scalar ``.item()`` once the card is idle;
    - ``compile_s``: one CUDA-graph capture of a ten-op step
      (``timing.capture_graph``);
    - ``h2d_gbs``: a 256 MiB copy from pinned host memory.

    On the CPU (a rehearsal) there is no graph to capture and no pinned
    copy: ``compile_s`` and ``h2d_gbs`` are None."""
    import torch

    from harp_tpu_torch.utils import timing

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    x = torch.zeros(1, device=dev)
    y = torch.empty_like(x)
    disp, rb, comp, h2d = [], [], [], []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        for _ in range(2000):
            torch.add(x, 1.0, out=y)
        disp.append((time.perf_counter() - t0) / 2000)
        sync()
    s = x.sum()
    for _ in range(10 * reps):
        sync()
        t0 = time.perf_counter()
        s.item()
        rb.append(time.perf_counter() - t0)
    if cuda:
        z = torch.zeros(4096, device=dev)

        def step():
            out = z
            for i in range(10):
                out = out * 1.0001 + i
            return out

        for _ in range(reps):
            t0 = time.perf_counter()
            timing.capture_graph(step, label="perfmodel.probe")
            sync()
            comp.append(time.perf_counter() - t0)
        host = torch.empty(256 << 20, dtype=torch.uint8).pin_memory()
        dst = torch.empty(host.shape, dtype=torch.uint8, device=dev)
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            dst.copy_(host, non_blocking=True)
            sync()
            h2d.append(host.numel() / (time.perf_counter() - t0))
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    return {"dispatch_s": med(disp), "readback_s": med(rb),
            "compile_s": med(comp), "h2d_gbs": med(h2d),
            "samples": {"dispatch_s": disp, "readback_s": rb,
                        "compile_s": comp, "h2d_gbs": h2d}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m harp_tpu_torch.perfmodel.measure",
        description="collect the port's card evidence for the cost model")
    p.add_argument("--only", nargs="+", metavar="CFG", default=None,
                   help=f"bench rows only for these configs ({sorted(RUNS)})")
    p.add_argument("--sweeps", action="store_true", help="the tile sweeps")
    p.add_argument("--overheads", action="store_true",
                   help="the overhead probe")
    p.add_argument("--profile", action="store_true",
                   help="profile --all's rows and the drivers' plan rows")
    p.add_argument("--out", required=True, help="JSONL file to append to")
    p.add_argument("--commit", default=None,
                   help="the commit to stamp (default: git's HEAD)")
    p.add_argument("--device", default=None,
                   help="torch device (default: this worker's card)")
    args = p.parse_args(argv)
    unknown = sorted(set(args.only or ()) - set(RUNS))
    if unknown:
        print(f"unknown config(s) {unknown}; known: {sorted(RUNS)}",
              file=sys.stderr)
        return 2

    import torch

    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.utils.metrics import _plain, provenance

    dev = WorkerMesh(args.device).device   # no card and no --device: raise
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from harp_tpu_torch.ops import build

        build.build()
    every = not (args.only or args.sweeps or args.overheads or args.profile)
    stamp = provenance(dev)
    if args.commit:
        stamp["commit"] = args.commit
    t_all = time.perf_counter()

    with open(args.out, "a") as fh:
        def emit(row: dict) -> None:
            line = json.dumps({k: _plain(v) for k, v in row.items()})
            fh.write(line + "\n")
            fh.flush()
            print(line, flush=True)

        if every or args.only:
            for cfg in args.only or list(RUNS):
                t0 = time.perf_counter()
                kw, out = _bench(cfg, {}, dev)
                emit({"config": cfg, **stamp, **kw, **out,
                      "collector_sec": round(time.perf_counter() - t0, 3)})
        if every or args.sweeps:
            for name, (cfg, points) in SWEEP_POINTS.items():
                for extra in points:
                    t0 = time.perf_counter()
                    kw, out = _bench(cfg, extra, dev)
                    emit({"kind": "sweep", "sweep": name, "config": cfg,
                          **stamp, **kw, **out, "collector_sec": round(
                              time.perf_counter() - t0, 3)})
        if every or args.overheads:
            emit({"kind": "overhead", **stamp, **probe_overheads(dev)})
        if every or args.profile:
            from harp_tpu_torch.plan.planner import plan_all
            from harp_tpu_torch.plan.topology import single_card
            from harp_tpu_torch.profile import attribution

            for row in attribution.capture_all(device=dev):
                emit({**row, **stamp})
            for plan in plan_all(single_card(), dev).values():
                emit({**plan.row(), **stamp})
    print(f"measure: {time.perf_counter() - t_all:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
