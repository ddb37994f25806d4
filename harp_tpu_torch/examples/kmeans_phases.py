"""Where K1 (kmeans_partials_int8) and K2 (kmeans_partials) spend their
time on one CUDA card, phase by phase.

    python -m harp_tpu_torch.examples.kmeans_phases [--n 1000000] [--d 300]
        [--k 100,1000]

For each k, on separated blobs drawn on the card from a seed:

- each wrapper timed with CUDA events (ms a call), with its launch plan
  (``kmeans_kernel.plan``: fused or two-pass, tile rows);
- one run of each kernel built with ``-DKM_PHASES`` (a copy in
  ``_build/``): thread 0 of every block sums ``clock64()`` cycles by
  phase (``csrc/kmeans_tiles.cuh``), averaged over the blocks and given
  per tile: the wait for the tile's bulk copy, the re-stride of the staged
  bytes into the tile, the scores (MMA and argmin), the cross-warp merge,
  the one-hot sums, and the whole tile loop; for the two-pass path the
  range kernel's cycles per block selecting each round's rows, gathering
  them (bulk copies and re-stride), and summing.  Cycles are SM clocks
  (``clocks.max.sm`` is printed beside them); the instrumented kernels run
  within a few percent of the plain ones (``ms_phases`` against ``ms``).

First it prints, for each kernel's built library, the count of each
tensor-core, ldmatrix and bulk-copy instruction in every kernel function
of ``cuobjdump -sass`` (the toolkit's), which shows where the products
run.  Then one JSON line per (kernel, k), with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from harp_tpu_torch.models import kmeans as KM
from harp_tpu_torch.ops import build
from harp_tpu_torch.ops import kmeans_kernel as KK
from harp_tpu_torch.parallel import collective as C
from harp_tpu_torch.utils.timing import cuda_ms

MAIN = ["store", "score", "merge", "sums", "loop", "wait", "wait+restride"]
RANGE = ["select", "gather", "sums"]


def phase_libs() -> dict:
    """Both kernels built with -DKM_PHASES into _build/, bound like the
    plain ones plus their kmeans_phases entry point."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KK._SIGNATURES:
        out = build.BUILD_DIR / f"{build.library_path(name).stem}-phases.so"
        if not out.exists():
            procs[name] = (out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-DKM_PHASES", "-o",
                 str(out), str(build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        else:
            procs[name] = (out, None)
    libs = {}
    for name, (out, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc -DKM_PHASES failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in KK._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kmeans_phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.kmeans_phases.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_census(name: str) -> dict:
    """{kernel function: {instruction: count}} of the MMA (HMMA, IMMA,
    HGMMA, IGMMA), LDSM and bulk-copy (UBLKCP) instructions in the built
    library of ``csrc/<name>.cu``."""
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    census = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = collections.Counter(re.findall(
            r"\b((?:HMMA|IMMA|HGMMA|IGMMA|LDSM|UBLKCP)\.[\w.]+)", fn))
        if ops:
            census[fn.splitlines()[0].strip()] = dict(sorted(ops.items()))
    return census


def measure(name: str, call, lib, p: KK.Plan, n: int) -> dict:
    ms = cuda_ms(call, reps=20)
    # a plan belongs to the library that made it: the instrumented library
    # makes its own while it is bound
    plain, plans = KK._BOUND[name], dict(KK._PLANS)
    KK._BOUND[name] = lib
    KK._PLANS.clear()
    try:
        ms_phases = cuda_ms(call, reps=5)
        call()
        torch.cuda.synchronize()
    finally:
        KK._BOUND[name] = plain
        KK._PLANS.clear()
        KK._PLANS.update(plans)
    main = np.zeros((1024, len(MAIN)), np.uint64)
    rng = np.zeros((1024, len(RANGE)), np.uint64)
    build.check(lib.kmeans_phases(main.ctypes.data, rng.ctypes.data),
                "kmeans_phases")
    per_block = main[:p.grid].astype(float).mean(0)
    tiles = -(-n // p.tile_rows) / p.grid
    row = {"ms": ms, "ms_phases": ms_phases,
           "plan": {f: v for f, v in p._asdict().items() if f != "handle"},
           "cycles_per_tile": {k: round(v / tiles) for k, v in
                               zip(MAIN, per_block)}}
    if not p.fused:
        r = rng[:p.ranges * p.stripes].astype(float).mean(0)
        row["range_cycles_per_block"] = {k: round(v) for k, v in
                                         zip(RANGE, r)}
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--k", default="100,1000")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kmeans_phases needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build(list(KK._SIGNATURES))
    for name in KK._SIGNATURES:
        for fn, ops in sass_census(name).items():
            print(json.dumps({"library": name, "function": fn, "sass": ops}))
    libs = phase_libs()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, d = args.n, args.d
    for k in (int(x) for x in args.k.split(",")):
        centers = torch.randn((k, d), generator=gen, device=dev) * 8.0
        a = torch.randint(0, k, (n,), generator=gen, device=dev)
        x = centers[a] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
        q, scale = C.quantize_to_int8(x, x.abs().amax(0))
        k1 = (q, *KM._quantize_centroids(centers, scale), scale)
        for name, call in (
                ("kmeans_partials_int8", lambda: KK.kmeans_partials_int8(*k1)),
                ("kmeans_partials", lambda: KK.kmeans_partials(x, centers))):
            p = KK.plan(name, dev, n, d, k)
            row = measure(name, call, libs[name], p, n)
            print(json.dumps({"kernel": name, "n": n, "d": d, "k": k, **row,
                              "card": card}), flush=True)
        del x, q, k1


if __name__ == "__main__":
    main()
