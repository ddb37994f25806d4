"""The readings that the limits of ``correct`` are set from, on the card, at
a cell's own size.  Training cells need no measured window, so one
process reads, for each seed, the program's numbers against the reference
(its first steps as set-up drives them) and, for the seeds named, those of
the control (the reference in the nearest lower precision, put in the
program's place) and of the half-batch fault (half of the data left out,
the mean taken over the rest, planted in the program).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1,2] [--out FILE]

One JSON line a reading on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"int8": "int4", "f32": "tf32", "bf16": "fp8"}


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _half_batch(driver_name: str):
    """A context that plants the half-batch fault in the program."""
    import contextlib

    @contextlib.contextmanager
    def planted():
        if driver_name == "kmeans_stream":
            from harp_tpu_torch.models import kmeans_stream as KS

            real = KS._synthetic_run

            def half(c, n_iters, gen, n_chunks, cfg, col_scale):
                c, inertia = real(c, n_iters, gen, n_chunks // 2, cfg,
                                  col_scale)
                return c, inertia * (n_chunks / (n_chunks // 2))

            KS._synthetic_run = half
            try:
                yield
            finally:
                KS._synthetic_run = real
        else:
            from harp_tpu_torch.models import mfsgd as MF

            real = MF.MFSGD.set_ratings
            MF.MFSGD.set_ratings = (
                lambda self, u, i, v: real(self, u[::2], i[::2], v[::2]))
            try:
                yield
            finally:
                MF.MFSGD.set_ratings = real

    return planted


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda:0",
                   help="cpu rehearses the script with the plain versions")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import compare, harness

    if args.device != "cpu" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    m = harness.load_manifest(ROOT)
    cell, config, traffic = harness.resolve(m, ROOT, args.workload)
    Driver = harness.load_driver(config["driver"])
    n, prec = traffic["checked_steps"], traffic["precision"]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, planted=None):
        ctx = harness.Context(cell, config, traffic, seed,
                              torch.device(args.device), time.perf_counter())
        drv = Driver(ctx)
        if planted is None:
            drv.setup()
            prog = drv.steps(n)
        else:
            with planted():
                drv.setup()
                prog = drv.steps(n)
        setup = time.perf_counter() - ctx.t_start
        drv.release()
        return drv, prog, setup

    for seed in args.seeds:
        drv, prog, setup = program(seed)
        t0 = time.perf_counter()
        ref = drv.reference(n, prec)
        ref_s = time.perf_counter() - t0
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              **compare.numbers(drv.initial(), prog, ref),
              "losses": [x for _, x in prog],
              "ref_losses": [x for _, x in ref],
              "setup_s": setup, "reference_s": ref_s})
        if seed in args.control_seeds:
            ctrl = drv.reference(n, CONTROL[prec])
            emit({"workload": args.workload, "seed": seed, "kind": "control",
                  "precision": CONTROL[prec],
                  **compare.numbers(drv.initial(), ctrl, ref)})
        if seed in args.fault_seeds:
            fdrv, fprog, _ = program(seed, _half_batch(config["driver"]))
            emit({"workload": args.workload, "seed": seed,
                  "kind": "fault_half_batch",
                  **compare.numbers(drv.initial(), fprog, ref)})
            del fdrv
        del drv
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
