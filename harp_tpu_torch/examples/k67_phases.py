"""Where K7 (hist_bins) and K6 (smacof_bx) spend their time on one CUDA
card, by ablation, and how K7's launch plans compare.  Times are CUDA
events around a CUDA graph of several calls (``utils.timing.graph_ms``),
so the host's launch cost is left out.

    python -m harp_tpu_torch.examples.k67_phases [--sweep]

At the main paths' shapes (K7: every level 0-5 of the real 32-tree
200k x 64 fit with 32 uint8 bins, as ``chip_smoke.k7_phase`` builds them;
K6: n_loc = N = 4096, dim 3, f32 and bf16 delta), it times with CUDA
events each kernel and copies of it built into ``_build/`` with one part
of the work taken out (text patches that name the source lines they
replace, and fail loudly when a line is not there):

- K7: "no increments" keeps every load and the bin-id reads but skips the
  shared-memory atomics (their condition can never hold, yet the compiler
  cannot know it); "no items" also drops the loop over the queued items;
  "no stream" loads only the first four super-tiles of each block and
  counts them over and over.
- K6: "no delta" takes 1 in place of each delta (the loads go), "no
  distance" takes D = 1 (the distance arithmetic goes).

K7 is also timed as built with 3 ring slots in place of 4, with 8
queued items a batch in place of 4, and without the masks that tell the
compiler its shared-memory offsets are multiples of 16 (design options).

``--sweep`` times K7 at every plan that fits (slice widths 64 / 32 / 16
/ 8, 1-16 trees a block, the planner's sample chunks; and the planner's
slice and trees at 2-64 sub-tiles a ring slot) beside the planner's
choice.
Prints one JSON line a kernel, with the card's name and power limit; K7's
result is checked bit for bit against the plain version at every level.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from harp_tpu_torch.models import rf as RF
from harp_tpu_torch.models import wdamds as WD
from harp_tpu_torch.ops import build
from harp_tpu_torch.ops import rf_kernel as K7
from harp_tpu_torch.ops import wdamds_kernel as K6
from harp_tpu_torch.utils.timing import graph_ms

RF_N, RF_F, RF_TREES, RF_DEPTH = 200_000, 64, 32, 6
MDS_N, MDS_DIM = 4096, 3

_I = ctypes.c_int
#: {variant: [(source text, what replaces it)]}
K7_ABLATIONS = {
    "no increments": [("if (it[q].y == 0) continue;",
                       "if (it[q].y == 0 || b0[q] + b1[q] != -1000 - it[q].y) "
                       "continue;")],
    "no items": [("const int cnt = *count;", "const int cnt = 0;")],
    "no stream": [("if (tile + kStages - 1 < tiles)",
                   "if (tile + kStages - 1 < kStages)")],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "batch 8": [("constexpr int kBatch = 4;", "constexpr int kBatch = 8;")],
    "no alignment hints": [
        ("smem + (p.counts_at & ~15L)", "smem + p.counts_at"),
        ("smem + (p.queue_at & ~15L)", "smem + p.queue_at"),
        ("smem + (p.ring_at & ~15L)", "smem + p.ring_at"),
        ("sb = p.slot & ~15L, bb = p.rcw_at & ~15L;",
         "sb = p.slot, bb = p.rcw_at;")],
}
K6_ABLATIONS = {
    "no delta": [("cur[q].get(e) * rsqrtf(d2)", "rsqrtf(d2)")],
    "no distance": [("const float d2 = fmaxf(x2[q] - 2.f * cross + y[DIM], 0.f);",
                     "const float d2 = 1.f;")],
}


def build_variants(todo: dict) -> dict:
    """{tag: (source path, patches, signatures)} → {tag: bound library},
    each patched copy compiled by nvcc into ``_build/``, all at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (src, patches, _) in todo.items():
        text = Path(src).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: {old!r} is not in {src} once")
            text = text.replace(old, new)
        key = hashlib.sha256(text.encode() + " ".join(
            build.NVCC_FLAGS).encode()).hexdigest()[:16]
        cu = build.BUILD_DIR / f"ablation-{key}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(text)
        proc = None
        if not so.exists():
            proc = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(Path(src).parent),
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        procs[tag] = (so, proc)
    libs = {}
    for tag, (so, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {tag}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in todo[tag][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[tag] = lib
    return libs


def rf_levels(dev):
    """The uint8 bins, int32 weights and each level's row codes of the
    real fit (``RF.RFConfig`` defaults, seed 0), grown on the card."""
    cfg = RF.RFConfig(n_trees=RF_TREES, max_depth=RF_DEPTH,
                      hist_algo="pallas")
    x, yh = RF.synthetic_classification(RF_N, RF_F, seed=0)
    edges = RF.quantile_bins(x, cfg.n_bins)
    bins = torch.from_numpy(RF.binize_chunked(x, edges).astype(np.uint8)).to(
        dev)
    y = torch.from_numpy(yh.astype(np.int64)).to(dev)
    weights, feat_mask = RF.tree_draws(cfg, RF_N, RF_F, range(RF_TREES), dev)
    w_i32 = weights.clamp(0, 127).to(torch.int32)
    node = torch.zeros((RF_TREES, RF_N), dtype=torch.int64, device=dev)
    levels = []
    for level in range(RF_DEPTH):
        levels.append((node * cfg.n_classes + y[None, :]).to(torch.int32))
        if level + 1 < RF_DEPTH:
            node = RF._grow_level(bins, y, weights, node, level, feat_mask,
                                  cfg)[2]
    return bins, w_i32, levels, cfg.n_classes, cfg.n_bins


def k6_call(lib, args):
    grid, ch = _I(), _I()
    delta, _, Xl, _, _ = args
    build.check(lib.wdamds_smacof_bx_plan(delta.shape[0], delta.shape[1],
                                          Xl.shape[1], ctypes.byref(grid),
                                          ctypes.byref(ch)), "K6 plan")
    return lambda: K6.launch(lib, grid.value, ch.value, *args, 1e-9)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="time K7 at every plan that fits")
    a = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = card_line()
    csrc = build.CSRC
    todo = {("K7", "full"): (csrc / "rf_hist_bins.cu", [], K7._SIGNATURES),
            ("K6", "full"): (csrc / "wdamds_smacof_bx.cu", [], K6._SIGNATURES)}
    for v, p in K7_ABLATIONS.items():
        todo[("K7", v)] = (csrc / "rf_hist_bins.cu", p, K7._SIGNATURES)
    for v, p in K6_ABLATIONS.items():
        todo[("K6", v)] = (csrc / "wdamds_smacof_bx.cu", p, K6._SIGNATURES)
    libs = build_variants(todo)

    # -- K7 -----------------------------------------------------------------
    bins, w, levels, C_, B = rf_levels(dev)
    optin, sms = _I(), _I()
    for (kern, _), lib in libs.items():  # each copy takes the opt-in memory
        if kern == "K7":
            build.check(lib.rf_hist_bins_setup(ctypes.byref(optin),
                                               ctypes.byref(sms)), "setup")
    optin, sms = optin.value, sms.value
    rec = {"kernel": "hist_bins", "card": card, "levels": []}
    for level, rc in enumerate(levels):
        R = 2 ** level * C_
        p = K7.plan(RF_TREES, RF_N, RF_F, B, R, 1, optin, sms)
        ref = K7.hist_bins_plain(bins, rc, w, R, B)
        row = {"level": level, "R": R, "plan": p.__dict__, "ms": {}}
        for (kern, var), lib in libs.items():
            if kern != "K7":
                continue
            call = (lambda lib=lib: K7.launch(lib, p, bins, rc, w, R, B))
            if var == "full" and not torch.equal(call(), ref):
                raise SystemExit(f"{kern} level {level}: differs from plain")
            row["ms"][f"{kern}: {var}"] = graph_ms(call, reps=5, replays=2)
        if a.sweep:
            lib, sweep = libs[("K7", "full")], []
            pins = [(fs, tg, None) for fs in (64, 32, 16, 8)
                    for tg in (1, 2, 3, 4, 6, 8, 12, 16)]
            pins += [(p.fs, p.tg, ns) for ns in (2, 4, 8, 16, 32, 64)]
            for fs, tg, ns in pins:
                q = K7.plan(RF_TREES, RF_N, RF_F, B, R, 1, optin, sms, fs=fs,
                            tg=tg, ns=ns)
                if q is None or q.smem > optin:
                    continue
                ms = graph_ms(lambda: K7.launch(lib, q, bins, rc, w, R, B),
                              reps=3, replays=1, warmup=1)
                sweep.append([fs, tg, q.ns, q.nchunks, round(ms, 4)])
            row["sweep"] = sorted(sweep, key=lambda s: s[-1])
        rec["levels"].append(row)
        print(f"K7 level {level} R={R} plan {p}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row["ms"].items()) + f" [{card}]",
              flush=True)
        if a.sweep:
            print(f"  fastest plans (fs, tg, ns, chunks, ms): "
                  f"{row['sweep'][:8]}", flush=True)
    print(json.dumps(rec), flush=True)
    del bins, w, levels

    # -- K6 -----------------------------------------------------------------
    rec = {"kernel": "smacof_bx", "card": card, "arms": []}
    for ddt in (torch.float32, torch.bfloat16):
        delta = torch.from_numpy(WD.benchmark_delta(MDS_N, 0)).to(dev, ddt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(MDS_N)
        X = torch.randn((MDS_N, MDS_DIM), generator=gen, device=dev)
        args = (delta, torch.ones(MDS_N, device=dev), X, X, float(MDS_N))
        row = {"delta": str(ddt).removeprefix("torch."), "ms": {}}
        for (kern, var), lib in libs.items():
            if kern == "K6":
                row["ms"][f"{kern}: {var}"] = graph_ms(k6_call(lib, args),
                                                       reps=20)
        rec["arms"].append(row)
        print(f"K6 N={MDS_N} {row['delta']}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row["ms"].items()) + f" [{card}]",
              flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
