#!/usr/bin/env python3
"""Smoke run of harp_tpu_torch on one NVIDIA card: the quickest proof that
the port builds, agrees with itself and runs its main path on the GPU.

    python3 chip_smoke.py

From the repo root, on a machine with one CUDA card and nvcc.  Phases, each
fatal when it fails (exit code != 0 and no result line):

1. card, versions, and the build of every kernel under harp_tpu_torch/csrc
   (one nvcc per source, all started together);
2. K1 (kmeans_partials_int8) against its plain PyTorch version at
   1M x 300 k=100, at a ragged n and at k=1000: sums and counts equal,
   best_sum within rtol 1e-5 (f32 summation order);
3. K2 (kmeans_partials) against its plain version at the same shapes on
   separated blobs: counts equal, sums within 1e-5 * max|x| * max count and
   inertia within 1e-5 * sum|x|^2 (f32 summation order), reruns bit-equal;
4. models.kmeans.fit at 1M x 300 k=100, 10 iterations, for int8 (K1 runs
   once per iteration), f32 + use_pallas (K2 likewise) and the default f32
   matmul path (neither kernel): launch counts, finite inertia no worse
   than after one iteration, and agreement with the CPU run on a small
   input;
5. models.kmeans.benchmark at 1M x 300 k=100 for the three paths, and the
   CLI (python -m harp_tpu_torch kmeans --bench --quantize int8);
6. K3 (sgd_tile_update) against its plain version for one rotation step at
   MovieLens-20M width (138,493 x 26,744, 20M ratings, rank 64, one worker,
   two H chunks, 256 x 256 tiles), compute dtype bf16 and f32: W and H
   within rtol 1e-4 / atol 1e-5 and se within rtol 1e-5 (the gradient sums
   are added in another f32 order), cnt equal;
7. models.mfsgd.MFSGD at that width with algo="pallas": train_epoch, then
   train_epochs(3), K3 launched once per rotation step (2 per epoch),
   finite RMSEs falling below the first epoch's, and the card agreeing with
   the CPU on a small input for all three algos;
8. models.mfsgd.benchmark at that width for pallas, and the CLI
   (python -m harp_tpu_torch mfsgd --algo pallas --epochs 3);
9. one JSON line of the kernels, the card's name and power limit, and
   the result line {"ok": true, "device": {...}}.

Times are CUDA-event times on this card (its power limit is printed beside
them); bounds use the H100 SXM data-sheet rates below.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, tensor-core op/s and
# f32 op/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}

N, D, K, ITERS = 1_000_000, 300, 100, 10
SHAPES = [(N, D, K), (N + 3, D, K), (N, D, 1000)]

# MovieLens-20M width (the reference's graded MF-SGD config)
ML_USERS, ML_ITEMS, ML_NNZ, ML_RANK, EPOCHS = 138_493, 26_744, 20_000_000, 64, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def blobs(n, d, k, gen, dev, spread=8.0, noise=0.5):
    """Separated clusters drawn on the card from ``gen``."""
    import torch

    centers = torch.randn((k, d), generator=gen, device=dev) * spread
    assign = torch.randint(0, k, (n,), generator=gen, device=dev)
    pts = centers[assign] + noise * torch.randn((n, d), generator=gen,
                                                device=dev)
    return pts, centers


def distinct_rows(ids, real, tile) -> int:
    """Sum over entries (rows of ``ids`` [NE, C]) of the distinct tile rows
    that the entry's real slots touch."""
    import numpy as np

    s = np.sort(np.where(real, ids, tile), axis=-1)
    new = np.ones(s.shape, bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return int((new & (s < tile)).sum())


def k3_work(eu, ei, u_tile, i_tile) -> dict:
    """What one rotation step's entries ask of K3, counted from the data:
    slots, real ratings, and the distinct W and H tile rows of each entry
    summed over the entries (rows no rating of an entry touches keep a zero
    gradient and need no apply)."""
    real = eu < u_tile
    return {"entries": eu.shape[0], "slots": eu.size,
            "ratings": int(real.sum()),
            "rows": distinct_rows(eu, real, u_tile)
            + distinct_rows(ei, real, i_tile)}


def k3_bound_ms(work, u_bound, h_rows, rank) -> tuple[float, str]:
    """K3's least time for one rotation step: bytes are eu for every slot
    (4 bytes: it marks the pads), ei and ev for the real ratings (8 bytes),
    ou and oi once, and W and H read and written once; operations are 10
    f32 flops a rating and rank element (dot 2, the two gradients 3 each,
    their two sums 2) plus the apply, 2 a rank element of each distinct row
    an entry touches, on the CUDA cores (67 TFLOP/s f32)."""
    nbytes = (4 * work["slots"] + 8 * work["ratings"] + 8 * work["entries"]
              + 2 * 4 * (u_bound + h_rows) * rank)
    ops = 10.0 * work["ratings"] * rank + 2.0 * work["rows"] * rank
    return bound_ms(nbytes, ops, "f32")


def mfsgd_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 6-8; returns K3's row of the kernels line and its launches on
    the MF-SGD main path."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.utils.timing import cuda_ms

    # -- 6. K3 against its plain version, one rotation step ------------------
    t0 = time.perf_counter()
    u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, ML_NNZ, seed=0)
    ut = it = 256
    eu, ei, ev, ou, oi, _, _, ub, ibc = MF.partition_ratings_tiles(
        u, i, v, ML_USERS, ML_ITEMS, 1, ut, it, 2048, n_slices=2)
    sched = K3.LevelSchedule.build(eu[0], ei[0], ou[0], oi[0], ut, it, ub,
                                   ibc, dev)
    ent = [torch.from_numpy(a[0].copy()).to(dev) for a in (eu, ei, ev, ou, oi)]
    work = k3_work(eu[0], ei[0], ut, it)
    ne, c = eu.shape[1:]
    print(f"K3 prep: {time.perf_counter() - t0:.1f} s; one step: {ne} "
          f"entries x {c} slots, {work['ratings']} ratings, {work['rows']} "
          f"distinct tile rows over the entries, W [{ub}, {ML_RANK}], H "
          f"chunk [{ibc}, {ML_RANK}], {sched.n_levels} levels, at most "
          f"{sched.max_width} entries wide")
    del u, i, v, eu, ei, ev, ou, oi
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scale = 1.0 / ML_RANK ** 0.5
    W = torch.rand((ub, ML_RANK), generator=gen, device=dev) * scale
    H = torch.rand((ibc, ML_RANK), generator=gen, device=dev) * scale
    row = None
    for cd in (torch.bfloat16, torch.float32):
        kw = dict(lr=0.01, reg=0.05, u_tile=ut, i_tile=it, compute_dtype=cd,
                  schedule=sched)
        W1, H1, se1, c1 = K3.sgd_tile_update(W, H, *ent, **kw)
        W2, H2, se2, c2 = K3.sgd_tile_update_plain(W, H, *ent, **kw)
        torch.cuda.synchronize()
        werr = float((W1 - W2).abs().max())
        herr = float((H1 - H2).abs().max())
        serr = abs(float(se1) - float(se2)) / float(se2)
        ok_w = bool(((W1 - W2).abs() <= 1e-5 + 1e-4 * W2.abs()).all())
        ok_h = bool(((H1 - H2).abs() <= 1e-5 + 1e-4 * H2.abs()).all())
        if not (ok_w and ok_h and serr <= 1e-5
                and float(c1) == float(c2) == work["ratings"]):
            fail(f"K3 {cd} disagrees with its plain version: W err {werr}, "
                 f"H err {herr}, se rel err {serr}, cnt {float(c1)} vs "
                 f"{float(c2)}")
        if torch.equal(W1, W):
            fail("K3 left W unchanged")
        ms = cuda_ms(lambda: K3.sgd_tile_update(W, H, *ent, **kw), reps=10,
                     warmup=1)
        plain = cuda_ms(lambda: K3.sgd_tile_update_plain(W, H, *ent, **kw),
                        reps=2, warmup=1)
        b_ms, b_by = k3_bound_ms(work, ub, ibc, ML_RANK)
        print(f"K3 {str(cd).removeprefix('torch.')}: W err {werr:.3e}, H err "
              f"{herr:.3e}, se rel err {serr:.2e}, cnt {int(c1)} equal; "
              f"kernel {ms:.4f} ms/call ({sched.n_levels} CUDA launches a "
              f"call), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
              f"[{card}]")
        if cd == torch.bfloat16:  # the main path's compute dtype
            row = {"max_abs_err": max(werr, herr), "ms": ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        del W1, H1, W2, H2
    del ent, W, H

    # -- 7. MF-SGD through the public entry -----------------------------------
    cfg = MF.MFSGDConfig(rank=ML_RANK, algo="pallas")
    model = MF.MFSGD(ML_USERS, ML_ITEMS, cfg, seed=0)
    u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, ML_NNZ, seed=0)
    t0 = time.perf_counter()
    model.set_ratings(u, i, v)
    prep = time.perf_counter() - t0
    del u, i, v
    K3.reset_launches()  # the MF-SGD main path's run starts here
    t0 = time.perf_counter()
    first = model.train_epoch()
    after_one = K3.LAUNCHES["sgd_tile_update"]
    t1 = time.perf_counter()
    rmses = model.train_epochs(EPOCHS)
    t2 = time.perf_counter()
    launches = K3.LAUNCHES["sgd_tile_update"]  # ... and ends here
    if (after_one, launches) != (2, 2 * (1 + EPOCHS)):
        fail(f"MF-SGD pallas: K3 launches {after_one} after one epoch and "
             f"{launches} after {1 + EPOCHS}; expected 2 per epoch")
    if not (np.isfinite([first, *rmses]).all() and rmses[-1] < first):
        fail(f"MF-SGD pallas: RMSEs {first}, {rmses} not finite and falling")
    print(f"MFSGD pallas at {ML_USERS} x {ML_ITEMS}, {ML_NNZ} ratings, rank "
          f"{ML_RANK}: set_ratings {prep:.1f} s; train_epoch rmse {first:.6f} "
          f"({t1 - t0:.3f} s); train_epochs({EPOCHS}) rmse "
          f"{[round(r, 6) for r in rmses]} ({(t2 - t1) / EPOCHS:.4f} s/epoch);"
          f" K3 launches {launches} [{card}]")
    profile_epoch(model, card)
    del model
    small = MF.synthetic_ratings(300, 200, 6000, rank=4, noise=0.05, seed=1)
    for algo in ("pallas", "dense", "scatter"):
        kw = ({"chunk": 512} if algo == "scatter" else
              {"u_tile": 16, "i_tile": 16, "entry_cap": 64})
        cfg = MF.MFSGDConfig(rank=16, algo=algo, lr=0.05, **kw)
        out = {}
        for where in ("cpu", "cuda"):  # the card starts from the CPU's init
            m = MF.MFSGD(300, 200, cfg, seed=2, device=where,
                         state=None if where == "cpu" else state)
            state = {"W": m.W, "H": m.H}
            m.set_ratings(*small)
            out[where] = (m.train_epochs(3), *m.factors())
        r_g, W_g, H_g = out["cuda"]
        r_c, W_c, H_c = out["cpu"]
        if not (np.allclose(r_g, r_c, rtol=1e-5, atol=0)
                and np.allclose(W_g, W_c, rtol=1e-4, atol=1e-5)
                and np.allclose(H_g, H_c, rtol=1e-4, atol=1e-5)):
            fail(f"MFSGD {algo}: the card and the CPU disagree on a small "
                 f"input (rmse {r_g} vs {r_c})")
    print("MFSGD: card and CPU agree on 300 x 200, 6000 ratings, rank 16, "
          "3 epochs from the same init, for pallas, dense and scatter "
          "(factors rtol 1e-4 / atol 1e-5, RMSEs rtol 1e-5)")

    # -- 8. benchmark and CLI ----------------------------------------------------
    out = MF.benchmark(ML_USERS, ML_ITEMS, ML_NNZ, ML_RANK, EPOCHS,
                       algo="pallas")
    if not (np.isfinite(out["rmse_final"])
            and out["rmse_final"] < out["rmse_first_epoch"]):
        fail(f"MF-SGD benchmark: RMSE not finite and falling: {out}")
    print(f"MFSGD benchmark pallas: {out['updates_per_sec_per_chip']:.6e} "
          f"updates/s per card, {out['sec_per_epoch']:.6f} s/epoch, rmse "
          f"{out['rmse_first_epoch']:.6f} -> {out['rmse_final']:.6f}, prep "
          f"{out['prep_sec']:.1f} s; K3 {row['ms']:.4f} ms/call x 2 calls "
          f"an epoch [{card}]")
    cli = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "mfsgd", "--algo", "pallas",
         "--epochs", str(EPOCHS)], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    if cli.returncode:
        fail(f"MF-SGD CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
    crow = json.loads(cli.stdout.strip().splitlines()[-1])
    if crow.get("backend") != "cuda" or not np.isfinite(crow["rmse_final"]):
        fail(f"MF-SGD CLI row is not a finite cuda result: {crow}")
    print(f"CLI: {json.dumps(crow)}")
    return row, launches


def profile_epoch(model, card: str) -> None:
    """Device busy share of one train_epoch, from torch.profiler's CUDA
    kernel times over the epoch's wall (the epoch ends in a readback)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epoch()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        print("MFSGD profile: the profiler saw no device time; idle share "
              "not measured")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f"MFSGD profile of one train_epoch: wall {wall:.4f} s, device "
          f"busy {busy:.4f} s, idle share {1 - busy / wall:.3f}; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in top) + f" [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import build
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils.timing import cuda_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{build.sources()} (parallel nvcc)")
    for name, rec in build.BUILD_LOG.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: {rec['seconds']:.1f} s; " + " | ".join(regs))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows: dict[str, dict] = {}

    # -- 2. K1 against its plain version ------------------------------------
    for n, d, k in SHAPES:
        x, centers = blobs(n, d, k, gen, dev)
        q, scale = C.quantize_to_int8(x, x.abs().amax(0))
        args = (q, *KM._quantize_centroids(centers, scale), scale)
        s1, n1, b1 = KK.kmeans_partials_int8(*args)
        s2, n2, b2 = KK.kmeans_partials_int8_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
            fail(f"K1 sums/counts differ from the plain version at "
                 f"n={n} d={d} k={k}")
        rel = abs(float(b1) - float(b2)) / max(abs(float(b2)), 1e-30)
        if rel > 1e-5:
            fail(f"K1 best_sum rel err {rel} > 1e-5 at n={n} d={d} k={k}")
        err = float((s1 - s2).abs().max())
        ms = cuda_ms(lambda: KK.kmeans_partials_int8(*args), reps=20)
        plain = cuda_ms(lambda: KK.kmeans_partials_int8_plain(*args),
                        reps=3, warmup=1)
        nbytes = n * d + k * d + 4 * (2 * k + d) + 4 * (k * d + k + 1)
        b_ms, b_by = bound_ms(nbytes, 2.0 * n * k * d, "int8")
        print(f"K1 n={n} d={d} k={k}: equal sums/counts, best_sum rel err "
              f"{rel:.2e}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) [{card}]")
        if (n, d, k) == (N, D, K):
            rows["kmeans_partials_int8"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by}
        del x, q, args, s1, s2

    # -- 3. K2 against its plain version ------------------------------------
    for n, d, k in SHAPES:
        x, centers = blobs(n, d, k, gen, dev)
        s1, n1, i1 = KK.kmeans_partials(x, centers)
        s2, n2, i2 = KK.kmeans_partials_plain(x, centers)
        s3, _, i3 = KK.kmeans_partials(x, centers)
        torch.cuda.synchronize()
        if not torch.equal(n1, n2):
            fail(f"K2 counts differ at n={n} d={d} k={k}")
        err = float((s1 - s2).abs().max())
        tol = 1e-5 * float(x.abs().max()) * float(n1.max())
        x2 = float((x.double() ** 2).sum())
        ierr = abs(float(i1) - float(i2))
        if err > tol or ierr > 1e-5 * x2:
            fail(f"K2 sums err {err} (tol {tol}) or inertia err {ierr} "
                 f"(tol {1e-5 * x2}) at n={n} d={d} k={k}")
        if not (torch.equal(s1, s3) and torch.equal(i1, i3)):
            fail(f"K2 reruns differ at n={n} d={d} k={k}")
        ms = cuda_ms(lambda: KK.kmeans_partials(x, centers), reps=20)
        plain = cuda_ms(lambda: KK.kmeans_partials_plain(x, centers),
                        reps=3, warmup=1)
        nbytes = 4 * n * d + 4 * k * d + 4 * (k * d + k + 1)
        b_ms, b_by = bound_ms(nbytes, 2.0 * n * k * d, "bf16")
        print(f"K2 n={n} d={d} k={k}: equal counts, sums max err {err:.3e} "
              f"(tol {tol:.3e}), inertia err {ierr:.3e} (tol "
              f"{1e-5 * x2:.3e}), reruns bit-equal; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if (n, d, k) == (N, D, K):
            rows["kmeans_partials"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by}
            c2 = (centers ** 2).sum(-1)
            yard = cuda_ms(lambda: KM._partials_block(x, centers, c2),
                           reps=5, warmup=1)
            print(f"yardstick: the port's default f32 path _partials_block "
                  f"(torch.matmul; not one library call) at n={n} d={d} "
                  f"k={k}: {yard:.4f} ms [{card}]")
        del x, s1, s2, s3

    # -- 4. fit through the public entry ------------------------------------
    import numpy as np

    rng = np.random.default_rng(0)
    centers_h = rng.normal(size=(K, D)).astype(np.float32) * 8.0
    pts_h = centers_h[rng.integers(0, K, N)]
    pts_h += rng.normal(size=(N, D)).astype(np.float32)
    paths = {"int8 (K1)": {"quantize": "int8"},
             "f32 use_pallas (K2)": {"use_pallas": True},
             "f32 default (matmul)": {}}
    # k-means++ seeding puts one centroid in (nearly) every blob, so the
    # three paths settle in the same Lloyd basin and their inertias compare
    one_iter = {p: KM.fit(pts_h, k=K, iters=1, seed=0, init="kmeans++",
                          **kw)[1] for p, kw in paths.items()}
    KK.reset_launches()  # the main path's run starts here
    fits = {}
    for p, kw in paths.items():
        before = dict(KK.LAUNCHES)
        t0 = time.perf_counter()
        c, inertia = KM.fit(pts_h, k=K, iters=ITERS, seed=0,
                            init="kmeans++", **kw)
        wall = time.perf_counter() - t0
        delta = {name: KK.LAUNCHES[name] - before[name] for name in before}
        want = {"kmeans_partials_int8": ITERS if "K1" in p else 0,
                "kmeans_partials": ITERS if "K2" in p else 0}
        if delta != want:
            fail(f"fit {p}: kernel launches {delta}, expected {want}")
        if not (np.isfinite(inertia) and np.isfinite(c).all()
                and c.shape == (K, D)):
            fail(f"fit {p}: non-finite or misshapen result")
        if inertia > one_iter[p] * (1 + 1e-6):
            fail(f"fit {p}: inertia {inertia} worse than after one "
                 f"iteration ({one_iter[p]})")
        fits[p] = (c, inertia)
        print(f"fit {p}: {ITERS} iterations, inertia {inertia:.6e} (after "
              f"one: {one_iter[p]:.6e}), launches {delta}, wall "
              f"{wall:.3f} s incl. host data prep [{card}]")
    launches = dict(KK.LAUNCHES)  # the main path's run ends here
    # bf16 scoring (K2) moves only near-ties; int8 points add quantization
    # noise of about scale^2/12 per coordinate (~1% of the inertia here)
    f32 = fits["f32 default (matmul)"][1]
    for p, tol in (("f32 use_pallas (K2)", 1e-3), ("int8 (K1)", 2e-2)):
        if abs(fits[p][1] - f32) > tol * abs(f32):
            fail(f"fit {p}: inertia {fits[p][1]} differs from the f32 "
                 f"path's {f32} by more than {tol}")
    small = pts_h[:4096, :32]
    for p, kw in paths.items():
        cg, ig = KM.fit(small, k=8, iters=5, seed=None, **kw)
        cc, ic = KM.fit(small, k=8, iters=5, seed=None, device="cpu", **kw)
        if not (np.allclose(cg, cc, rtol=1e-4, atol=1e-4)
                and abs(ig - ic) <= 1e-4 * abs(ic)):
            fail(f"fit {p}: the card and the CPU disagree on a small input")
    print("fit: card and CPU agree on 4096 x 32, k=8 for all three paths "
          "(rtol 1e-4)")
    del pts_h

    # -- 5. benchmark --------------------------------------------------------
    kernel_of = {"int8 (K1)": "kmeans_partials_int8",
                 "f32 use_pallas (K2)": "kmeans_partials"}
    for p, kw in paths.items():
        out = KM.benchmark(n=N, d=D, k=K, iters=ITERS, **kw)
        if not np.isfinite(out["inertia"]):
            fail(f"benchmark {p}: non-finite inertia")
        line = (f"benchmark {p}: {out['iters_per_sec']:.2f} iter/s, "
                f"{out['sec_per_iter'] * 1e3:.4f} ms/iter")
        if p in kernel_of:
            r = rows[kernel_of[p]]
            line += (f"; kernel {r['ms']:.4f} ms/launch, bound "
                     f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        print(line + f" [{card}]")
    cli = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "kmeans", "--bench",
         "--quantize", "int8"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    if cli.returncode:
        fail(f"CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
    row = json.loads(cli.stdout.strip().splitlines()[-1])
    if row.get("backend") != "cuda" or not np.isfinite(row["inertia"]):
        fail(f"CLI row is not a finite cuda result: {row}")
    print(f"CLI: {json.dumps(row)}")

    # -- 6-8. MF-SGD -----------------------------------------------------------
    rows["sgd_tile_update"], launches["sgd_tile_update"] = mfsgd_phases(
        dev, card)

    # -- 9. result -----------------------------------------------------------
    src = {"kmeans_partials_int8": ("harp_tpu_torch/csrc/kmeans_partials_int8.cu",
                                    "harp_tpu/ops/kmeans_kernel.py:249"),
           "kmeans_partials": ("harp_tpu_torch/csrc/kmeans_partials.cu",
                               "harp_tpu/ops/kmeans_kernel.py:110"),
           "sgd_tile_update": ("harp_tpu_torch/csrc/mfsgd_tile_update.cu",
                               "harp_tpu/ops/mfsgd_kernel.py:133")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                **rows[name], "library_ms": None} for name in src]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
