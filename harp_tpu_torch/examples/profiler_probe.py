"""How many of the kernels launched inside a torch.profiler session its
trace holds, session after session in one process, on one CUDA card.

    python -m harp_tpu_torch.examples.profiler_probe [--sessions 6] [--pad S]

Each round runs three sessions, each between two synchronizes, and counts
the device events of each kernel that the trace holds against the
launches made:

- ``mix``: one small K4 step (a single cooperative launch from the
  port's ctypes library), 30 K6 launches (the library's ordinary
  launches), each followed by a readback, and 200 PyTorch elementwise
  kernels;
- ``lda``: one ``LDA.sample_epoch`` at the LDA benchmark width (100k docs
  x 50k words, 1000 topics: two K4 launches; ``PERF.md`` §6 has their
  time on the card);
- ``mds``: one ``wdamds.mds`` at n = 4096 (30 K6 launches).

``--pad S`` sleeps S seconds inside each window after the work.  Host
microseconds a launch are timed before the first round and after the
last.  Run it once as it is and once with ``TEARDOWN_CUPTI=0`` in the
environment (the profiler then keeps CUPTI attached between sessions).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _mix(dev):
    """A small K4 step (8 entries x 2048 slots, 1000 topics), a K6 block
    (n = 4096, dim 3) and a 1M-float tensor."""
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.ops import wdamds_kernel as K6

    rng = np.random.default_rng(0)
    K, NE, C, R = 1000, 8, 2048, 32
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    Ndk = t(rng.integers(0, 40, (3 * R, K)).astype(np.float32))
    Nwk = t(rng.integers(0, 40, (2 * R, K)).astype(np.float32))
    nk = Nwk.sum(0) + 100
    cd, cw, z = (t(rng.integers(0, hi, (NE, C)).astype(np.int32))
                 for hi in (R, R, K))
    od = t(rng.integers(0, 3, NE).astype(np.int32) * R)
    ow = t(rng.integers(0, 2, NE).astype(np.int32) * R)
    seeds = t(rng.integers(-2 ** 31, 2 ** 31 - 1, (NE, 2)).astype(np.int32))
    plan = K4.EntryPlan.build(cd, cw, od, ow, R, R, Ndk.shape[0],
                              Nwk.shape[0], 128)
    n = 4096
    g = torch.Generator(dev).manual_seed(0)
    delta = torch.rand((n, n), device=dev, generator=g)
    X = torch.rand((n, 3), device=dev, generator=g)
    mask = torch.ones(n, device=dev)
    x = torch.zeros(1 << 20, device=dev)

    def run():
        K4.cgs_step(Ndk, Nwk, nk, z, cd, cw, od, ow, alpha=0.1, beta=0.01,
                    vbeta=0.5, d_tile=R, w_tile=R, cc=128, seeds=seeds,
                    plan=plan)
        for _ in range(30):
            float(K6.smacof_bx(delta, mask, X, X, float(n), eps=1e-9)[0, 0])
        for _ in range(200):
            x.add_(1.0)

    return run


def _us_a_launch(fn, n: int = 2000) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main(argv: list[str] | None = None) -> int:
    from torch.profiler import ProfilerActivity, profile

    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.models import wdamds as WD
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.ops import wdamds_kernel as K6

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=6)
    ap.add_argument("--pad", type=float, default=0.0)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    lda = LD.LDA(100_000, 50_000, LD.LDAConfig(n_topics=1000, algo="pallas"),
                 seed=1)
    lda.set_tokens(*LD.benchmark_corpus(100_000, 50_000, 100, 0))
    delta = WD.benchmark_delta(4096, 0)
    cfg = WD.MDSConfig(dim=3, iters=30, algo="pallas")
    runs = {"mix": _mix(dev), "lda": lda.sample_epoch,
            "mds": lambda: WD.mds(delta, cfg)}
    # kernel name, its wrapper's count, launches (None: read the count)
    kinds = {"mix": [("step_kernel", None), ("bx_kernel", None),
                     ("elementwise", 200)],
             "lda": [("step_kernel", None)], "mds": [("bx_kernel", None)]}
    for run in runs.values():  # build, plan and warm up outside any session
        run()
    tiny = torch.zeros(1, device=dev)
    host = {"before": _us_a_launch(lambda: tiny.add_(1.0))}
    for s in range(args.sessions):
        for what, run in runs.items():
            counts = (K4.LAUNCHES["cgs_entry_update"],
                      K6.LAUNCHES["smacof_bx"])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e6
                time.sleep(args.pad)
            made = {"step_kernel": K4.LAUNCHES["cgs_entry_update"] - counts[0],
                    "bx_kernel": K6.LAUNCHES["smacof_bx"] - counts[1]}
            dev_ev = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            row = {"session": s, "run": what, "wall_us": round(wall, 1),
                   "pad_s": args.pad,
                   "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI")}
            for name, launched in kinds[what]:
                ev = [e for e in dev_ev if name in e.name]
                row[name] = {
                    "seen": len(ev),
                    "launched": made.get(name, launched),
                    "first_start_us": round(min(
                        (e.time_range.start for e in ev), default=-1), 1),
                    "last_end_us": round(max(
                        (e.time_range.end for e in ev), default=-1), 1)}
            print(json.dumps(row), flush=True)
    host["after"] = _us_a_launch(lambda: tiny.add_(1.0))
    print(json.dumps({"host_us_a_launch": host,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
