"""The readings that the limits of ``correct`` are set from, on the card, at
a cell's own size.  Training cells need no measured window, so one
process reads, for each seed, the program's numbers against the reference
(its first steps as set-up drives them) and, for the seeds named, those of
the control (the reference in the nearest lower precision, put in the
program's place; where the program has such a path of its own, the
program with it switched on: ``PROGRAM_CONTROL``) and of the half-batch
fault (half of the data left out, the mean taken over the rest, planted in
the program; for LDA, a sweep that skips half the entries).  For LDA,
``--chain-seeds`` also replays the checked sweeps whole with the
reference's own chain (``drivers/lda.py`` ``Driver.chain``): its
likelihood after each sweep sets ``ll_center``, and it reads the tokens
whose topic differs from the program's over the whole of both rotation
steps.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--fault-seeds 1,2] [--chain-seeds 1,2] \\
        [--out FILE]

One JSON line a reading on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"int8": "int4", "f32": "tf32", "bf16": "fp8"}
#: drivers whose program has a lower-precision path of its own: the
#: configuration keys that switch it on (K4's count gathers in bf16)
PROGRAM_CONTROL = {"lda": {"pallas_exact_gathers": False}}


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
        elif driver_name == "lda":
            from harp_tpu_torch.ops import lda_kernel as K4

            real = K4.cgs_step

            def half(Ndk, Nwk, nk, z, cd, cw, od, ow, *, plan=None, **kw):
                cd = cd.clone()
                cd[1::2] = kw["d_tile"]  # odd entries: every slot a pad
                if plan is not None:
                    n = plan.n_chunks.copy()
                    n[1::2] = 0
                    plan = K4.EntryPlan(n, plan.cc, plan.d_rows, plan.w_rows)
                return real(Ndk, Nwk, nk, z, cd, cw, od, ow, plan=plan,
                            **kw)

            K4.cgs_step = half
            try:
                yield
            finally:
                K4.cgs_step = real
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
    p.add_argument("--chain-seeds", type=_ints, default=[])
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

    def program(seed, planted=None, switched=None):
        ctx = harness.Context(cell, {**config, **(switched or {})}, traffic,
                              seed, torch.device(args.device),
                              time.perf_counter())
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

    def numbers(drv, prog, ref):
        return getattr(drv, "numbers", compare.numbers)(drv.initial(), prog,
                                                       ref)

    own = hasattr(Driver, "numbers")
    # a switched control and a fault are judged against the sound run's
    # reference of the same seed
    switch = PROGRAM_CONTROL.get(config["driver"])
    for seed in args.seeds:
        drv, prog, setup = program(seed)
        t0 = time.perf_counter()
        ref = drv.reference(n, prec)
        ref_s = time.perf_counter() - t0
        row = {"workload": args.workload, "seed": seed, "kind": "program",
               **numbers(drv, prog, ref), "setup_s": setup,
               "reference_s": ref_s}
        if not own:
            row.update(losses=[x for _, x in prog],
                       ref_losses=[x for _, x in ref])
        emit(row)
        if seed in args.chain_seeds and hasattr(drv, "chain"):
            for r in drv.chain(n, ref):
                emit({"workload": args.workload, "seed": seed,
                      "kind": "chain", **r})
        if seed in args.control_seeds and switch is not None:
            cdrv, cprog, _ = program(seed, switched=switch)
            emit({"workload": args.workload, "seed": seed, "kind": "control",
                  "switched": switch, **numbers(cdrv, cprog, ref)})
            del cdrv, cprog
            gc.collect()
        elif seed in args.control_seeds:
            ctrl = drv.reference(n, CONTROL[prec])
            emit({"workload": args.workload, "seed": seed, "kind": "control",
                  "precision": CONTROL[prec],
                  **compare.numbers(drv.initial(), ctrl, ref)})
        if seed in args.fault_seeds:
            fdrv, fprog, _ = program(seed, _half_batch(config["driver"]))
            emit({"workload": args.workload, "seed": seed,
                  "kind": "fault_half_batch", **numbers(fdrv, fprog, ref)})
            del fdrv, fprog
            gc.collect()
        # the next seed's program starts with nothing of this one's held
        del drv, prog, ref
        gc.collect()
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
