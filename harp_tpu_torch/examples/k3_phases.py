"""Where one K3 rotation step spends its time on one CUDA card, phase by
phase, at each cluster size.

    python -m harp_tpu_torch.examples.k3_phases [--clusters 2,4,8]

At MovieLens-20M width (138,493 x 26,744, 20M ratings, rank 64, 256 x 256
tiles, one worker, two H chunks: a rotation step is 28,673 entries on a
critical path of 593), bf16 compute, for each cluster size
(``mfsgd_kernel.CLUSTER``):

- ``sgd_tile_update`` timed with CUDA events (ms a step, and a step over
  the critical path: microseconds a critical-path entry);
- one run of a copy of ``csrc/mfsgd_tile_update.cu`` that stamps the
  global timer at the phase boundaries of every entry (thread 0 of the
  cluster's first block; the copy is built into ``_build/``): the median
  microseconds an entry spends loading its ratings, waiting for its
  predecessors, in the W pass, at the barrier and in the H pass, at the
  last barrier, in the apply and in the publish, the time from ready to
  published, and the handoff from the later predecessor's publish to the
  entry being ready.  The stamps cost a
  few percent of the step (``span_ms`` against ``ms``).

Prints one JSON line per cluster size, with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from harp_tpu_torch.models import mfsgd as MF
from harp_tpu_torch.ops import build
from harp_tpu_torch.ops import mfsgd_kernel as K3
from harp_tpu_torch.utils.timing import cuda_ms

USERS, ITEMS, NNZ, RANK, TILE = 138_493, 26_744, 20_000_000, 64, 256

_STAMP = "if (rank == 0 && t == 0) prof[(long)pos * 8 + {k}] = gtime();"
_PUBLISH = ("    __syncthreads();\n    if (t == 0) {\n      __threadfence();\n"
            "      atomicAdd(done + pos, 1);  // this block has applied\n"
            "    }")
#: (text of the kernel, what replaces it): the stamps 0-7 and the extra
#: argument that receives them
_PATCHES = [
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\n__device__ __forceinline__ "
     "unsigned long long gtime() { unsigned long long v; asm volatile("
     "\"mov.u64 %0, %globaltimer;\" : \"=l\"(v)); return v; }"),
    ("float* __restrict__ cnt_part) {",
     "float* __restrict__ cnt_part, unsigned long long* __restrict__ prof) {"),
    ("    const int n = __ldg(n_real + pos);\n",
     "    const int n = __ldg(n_real + pos);\n" + _STAMP.format(k=0) + "\n"),
    ("    if (t == 0) {\n      wait_done(done, pu, CL);",
     "    __syncthreads();\n    " + _STAMP.format(k=1)
     + "\n    if (t == 0) {\n      wait_done(done, pu, CL);"),
    ("    __syncthreads();  // loaded, and the predecessors have applied\n",
     "    __syncthreads();  // loaded, and the predecessors have applied\n"
     + _STAMP.format(k=2) + "\n"),
    ("      if (side == 0)\n        cluster.sync();",
     "      if (side == 0) {\n        __syncthreads();\n        "
     + _STAMP.format(k=3) + "\n        cluster.sync();\n      }"),
    ("    cluster.sync();  // every final value of the entry has landed\n",
     "    __syncthreads();\n" + _STAMP.format(k=4)
     + "\n    cluster.sync();  // every final value of the entry has landed\n"
     + _STAMP.format(k=5) + "\n"),
    (_PUBLISH, "    __syncthreads();\n" + _STAMP.format(k=6)
     + _PUBLISH[len("    __syncthreads();"):] + "\n" + _STAMP.format(k=7)),
    ("int, int, float, float, int*, float*, float*);",
     "int, int, float, float, int*, float*, float*, unsigned long long*);"),
    ("                    void* se, void* cnt, void* stream) {",
     "                    void* se, void* cnt, void* stream, void* prof) {"),
    ("(int*)work, (float*)se, (float*)cnt);",
     "(int*)work, (float*)se, (float*)cnt, (unsigned long long*)prof);"),
]
_PHASES = ["load", "wait", "w_pass", "sync_h_pass", "barrier", "apply",
           "publish"]


def stamped_library() -> ctypes.CDLL:
    """The stamped copy of K3, built with the port's nvcc flags."""
    src = (build.CSRC / "mfsgd_tile_update.cu").read_text()
    for old, new in _PATCHES:
        if old not in src:
            raise RuntimeError(f"k3_phases: the kernel no longer holds "
                               f"{old[:60]!r}; update the patches")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "k3_phases.cu"
    so = build.BUILD_DIR / "libk3_phases.so"
    cu.write_text(src)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"k3_phases: nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in K3._SIGNATURES.items():
        extra = [ctypes.c_void_p] if fn == "sgd_tile_update" else []
        getattr(lib, fn).argtypes = argtypes + extra
        getattr(lib, fn).restype = ctypes.c_int
    limit, static = ctypes.c_int(), ctypes.c_int()
    build.check(lib.sgd_tile_update_init(ctypes.byref(limit),
                                         ctypes.byref(static)),
                "k3_phases init")
    return lib


def stamped_step(lib, cl, W, H, ent, sched, C) -> np.ndarray:
    """One step of the stamped copy → stamps [n_sched, 8] in ns."""
    n = sched.order.numel()
    smem = K3.block_bytes(TILE, TILE, RANK, C, cl)
    clusters = ctypes.c_int()
    build.check(lib.sgd_tile_update_plan(cl, smem, 1, ctypes.byref(clusters)),
                "k3_phases plan")
    W2, H2 = W.clone(), H.clone()
    work = torch.zeros(1 + n, dtype=torch.int32, device=W.device)
    se = torch.empty(n * cl, device=W.device)
    cnt = torch.empty_like(se)
    prof = torch.zeros((n, 8), dtype=torch.int64, device=W.device)
    build.check(lib.sgd_tile_update(
        W2.data_ptr(), H2.data_ptr(), *(t.data_ptr() for t in ent),
        sched.order.data_ptr(), sched.pred.data_ptr(), sched.sort.data_ptr(),
        sched.n_real.data_ptr(), n, C, RANK, TILE, TILE, 0.01, 0.05, 1, cl,
        min(clusters.value, n), smem, work.data_ptr(), se.data_ptr(),
        cnt.data_ptr(), torch.cuda.current_stream().cuda_stream,
        prof.data_ptr()), "k3_phases launch")
    torch.cuda.synchronize()
    return prof.cpu().numpy().astype(np.float64)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", default="2,4,8")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    u, i, v = MF.synthetic_ratings(USERS, ITEMS, NNZ, seed=0)
    eu, ei, ev, ou, oi, _, _, ub, ibc = MF.partition_ratings_tiles(
        u, i, v, USERS, ITEMS, 1, TILE, TILE, 2048, n_slices=2)
    sched = K3.LevelSchedule.build(eu[0], ei[0], ou[0], oi[0], TILE, TILE,
                                   ub, ibc, dev)
    ent = [torch.from_numpy(a[0].copy()).to(dev) for a in (eu, ei, ev, ou, oi)]
    C = eu.shape[2]
    del u, i, v, eu, ei, ev, ou, oi
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    W = torch.rand((ub, RANK), generator=gen, device=dev) / RANK ** 0.5
    H = torch.rand((ibc, RANK), generator=gen, device=dev) / RANK ** 0.5
    kw = dict(lr=0.01, reg=0.05, u_tile=TILE, i_tile=TILE,
              compute_dtype=torch.bfloat16, schedule=sched)
    lib = stamped_library()
    pred = sched.pred.cpu().numpy()
    has_pred = (pred >= 0).any(axis=1)
    default = K3.CLUSTER
    try:
        for cl in (int(c) for c in args.clusters.split(",")):
            K3.CLUSTER = cl
            ms = cuda_ms(lambda: K3.sgd_tile_update(W, H, *ent, **kw),
                         reps=10, warmup=1)
            P = stamped_step(lib, cl, W, H, ent, sched, C)
            P -= P[:, 0].min()
            d = np.diff(P, axis=1) / 1e3
            later = np.max(np.where(pred >= 0, P[np.maximum(pred, 0), 7],
                                    -np.inf), axis=1)
            row = {"cluster": cl, "ms": ms, "entries": int(len(P)),
                   "critical_path": sched.n_levels,
                   "us_per_critical_entry": ms * 1e3 / sched.n_levels,
                   "span_ms": float(P[:, 7].max() / 1e6),
                   "median_us": {k: float(np.median(d[:, j]))
                                 for j, k in enumerate(_PHASES)},
                   "handoff_median_us": float(np.median(
                       (P[has_pred, 2] - later[has_pred]) / 1e3)),
                   "ready_to_publish_median_us": float(np.median(
                       (P[:, 7] - P[:, 2]) / 1e3)),
                   "device": card}
            print(json.dumps(row), flush=True)
    finally:
        K3.CLUSTER = default


if __name__ == "__main__":
    main()
