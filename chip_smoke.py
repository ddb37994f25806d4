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
9. K4 (cgs_entry_update, through its step entry point cgs_step) against
   its plain version at the LDA benchmark width (100k docs x 50k words,
   1000 topics, 100 tokens a doc; 512 x 512 tiles, C = 768, cc from
   chunk_width): the first 256 entries of one rotation step with injected
   uniforms for f32 and int16 Ndk, then the whole step on the Philox arm;
   tables, topics and dNk bit-equal;
10. K4's Philox arm on a flat tile: topic frequencies match the posterior;
11. models.lda.LDA on synthetic_corpus(96, 64, 4, 50) for pallas and dense,
   four seeds, twelve sweeps: chain invariants, rising likelihood, and the
   two algos' mean log-likelihoods within 0.05;
12. models.lda.benchmark(algo="pallas") at the benchmark width (K4 launched
   once per rotation step: 2 an epoch), and the CLI (python -m
   harp_tpu_torch lda --algo pallas);
13. torch.profiler over one sample_epoch at that width: device busy and
   idle share, top kernels;
14. one sample_epoch at the graded enwiki-1M size (1M docs, 100M tokens,
   int16 Ndk) when phase 12's epoch is under 3 s: prep, epoch time, peak
   device memory and the chain invariants;
15. one JSON line of the kernels, the card's name and power limit, and
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

# LDA benchmark width (the reference's benchmark() defaults, graded config
# #3 scaled to one card) and the graded enwiki-1M doc count
LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_TPD, LDA_EPOCHS = 100_000, 50_000, 1000, 100, 2
ENWIKI_DOCS = 1_000_000
# H100 SXM special-function (MUFU) rate: 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost clock
SFU_OPS_S = 16 * 132 * 1.98e9


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

    # -- 8. benchmark and CLI -------------------------------------------------
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


def k4_work(ed, d_tile) -> dict:
    """What one rotation step's entries ask of K4, counted from the data."""
    real = ed < d_tile
    return {"entries": ed.shape[0], "slots": ed.size,
            "tokens": int(real.sum())}


def k4_bound_ms(work, ndk_bytes, nwk_bytes, K) -> tuple[float, str]:
    """K4's least time for one rotation step.  Bytes: cd for every slot (4
    B: it marks the pads), cw and z read and z written for the real tokens
    (12 B), od/ow and the two seed words per entry (16 B), nk read and
    written, and Ndk and the word chunk read and written once.  Operations:
    ~10 f32 operations per real token and topic (three gathers less the own
    assignment, three prior adds and clamps, the ratio's two products and
    one division, the compare) on the CUDA cores at 67 TFLOP/s, and one log
    each on the special-function units (SFU_OPS_S); the two run side by
    side, so the slower one bounds."""
    nbytes = (4 * work["slots"] + 12 * work["tokens"] + 16 * work["entries"]
              + 8 * K + 2 * (ndk_bytes + nwk_bytes))
    el = work["tokens"] * K
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(10.0 * el / PEAK_OPS["f32"], el / SFU_OPS_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lda_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 9-14; returns K4's row of the kernels line and its launches
    on the LDA main path (phase 12's benchmark)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.utils.timing import cuda_ms

    # -- 9. K4 against its plain version, one rotation step ------------------
    t0 = time.perf_counter()
    cfg = LD.LDAConfig(n_topics=LDA_TOPICS, algo="pallas")
    model = LD.LDA(LDA_DOCS, LDA_VOCAB, cfg, seed=0)
    model.set_tokens(*LD.benchmark_corpus(LDA_DOCS, LDA_VOCAB, LDA_TPD, 0))
    s = 0
    ed, ew, od, ow = (a[s] for a in model._tokens)
    z0, plan, cc = model.z_grid[s].clone(), model._plans[s], model.cc
    ne, c = ed.shape
    wrows = model.Nwk.shape[0] // 2
    Ndk, Nwk, Nk = model.Ndk.clone(), model.Nwk[:wrows].clone(), model.Nk
    work = k4_work(ed.cpu().numpy(), cfg.d_tile)
    print(f"K4 prep: {time.perf_counter() - t0:.1f} s; one step: {ne} "
          f"entries x {c} slots, {work['tokens']} tokens, cc {cc} (count "
          f"bounds {model._count_bounds}), {plan.launches} CUDA launches a "
          f"step, Ndk {tuple(Ndk.shape)}, word chunk {tuple(Nwk.shape)}")
    del model
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, vbeta=LDA_VOCAB * cfg.beta,
              d_tile=cfg.d_tile, w_tile=cfg.w_tile, cc=cc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_sub = min(256, ne)
    sub = [a[:n_sub] for a in (ed, ew, od, ow)]
    u = torch.rand((n_sub, c, LDA_TOPICS), generator=gen,
                   device=dev).clamp_min_(2.0 ** -25)
    sub_plan = K4.EntryPlan(plan.n_chunks[:n_sub].copy(), cc, plan.d_rows,
                            plan.w_rows)
    err = 0.0
    for dt in (torch.float32, torch.int16):
        outs = []
        for fn in (K4.cgs_step, K4.cgs_step_plain):
            st = [Ndk.to(dt, copy=True), Nwk.clone(), z0[:n_sub].clone()]
            extra = {"plan": sub_plan} if fn is K4.cgs_step else {}
            d = fn(st[0], st[1], Nk, st[2], *sub, u=u, **kw, **extra)
            outs.append(st + [d])
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a, b):
                fail(f"K4 ({dt}, injected uniforms) differs from its plain "
                     f"version on the first {n_sub} entries")
        moved = int((outs[0][2] != z0[:n_sub]).sum())
        print(f"K4 {str(dt).removeprefix('torch.')} Ndk, injected uniforms, "
              f"first {n_sub} entries: tables, topics and dNk bit-equal to "
              f"the plain version; {moved} topics moved")
    st = [Ndk.clone(), Nwk.clone(), z0[:n_sub].clone()]
    ms_sub = cuda_ms(lambda: K4.cgs_step(st[0], st[1], Nk, st[2], *sub, u=u,
                                         plan=sub_plan, **kw),
                     reps=3, warmup=1)
    plain_sub = cuda_ms(lambda: K4.cgs_step_plain(st[0], st[1], Nk, st[2],
                                                  *sub, u=u, **kw),
                        reps=1, warmup=0)
    del st
    del u
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (ne, 2), dtype=torch.int32,
                          generator=gen, device=dev)
    full = (ed, ew, od, ow)
    ka = [Ndk.clone(), Nwk.clone(), z0.clone()]
    pa = [Ndk.clone(), Nwk.clone(), z0.clone()]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    d1 = K4.cgs_step(ka[0], ka[1], Nk, ka[2], *full, seeds=seeds, plan=plan,
                     **kw)
    start.record()
    d2 = K4.cgs_step_plain(pa[0], pa[1], Nk, pa[2], *full, seeds=seeds, **kw)
    end.record()
    end.synchronize()
    plain = start.elapsed_time(end)
    for a, b in zip(ka + [d1], pa + [d2]):
        err = max(err, float((a.float() - b.float()).abs().max()))
        if not torch.equal(a, b):
            fail("K4 (Philox arm) differs from its plain version on a whole "
                 "rotation step")
    del pa
    ms = cuda_ms(lambda: K4.cgs_step(ka[0], ka[1], Nk, ka[2], *full,
                                     seeds=seeds, plan=plan, **kw),
                 reps=3, warmup=1)
    b_ms, b_by = k4_bound_ms(work, Ndk.numel() * 4, Nwk.numel() * 4,
                             LDA_TOPICS)
    print(f"K4 whole step, Philox arm: bit-equal to the plain version; "
          f"kernel {ms:.4f} ms/step ({plan.launches} CUDA launches, "
          f"{ms * 1e3 / plan.launches:.3f} us a launch), plain {plain:.4f} "
          f"ms/step, bound {b_ms:.4f} ms ({b_by}); first {n_sub} entries "
          f"with injected uniforms: kernel {ms_sub:.4f} ms, plain "
          f"{plain_sub:.4f} ms [{card}]")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
           "bound_by": b_by}
    del ka, Ndk, Nwk, full, seeds

    # -- 10. the Philox arm draws from the posterior --------------------------
    Kf, C_ = 8, 256
    av = torch.tensor([1.0, 2, 3, 4, 1, 1, 1, 3], device=dev) * 10_000
    bv = torch.tensor([4.0, 1, 2, 1, 1, 2, 1, 1], device=dev) * 10_000
    Db = torch.zeros((8, Kf), device=dev)
    Wb = torch.zeros((8, Kf), device=dev)
    Db[0], Wb[0] = av, bv
    zeros = torch.zeros(C_, dtype=torch.int32, device=dev)
    a_, b_, c_ = av.cpu().numpy(), bv.cpu().numpy(), np.full(Kf, 1e6)
    a_[0] -= 1
    b_[0] -= 1
    c_[0] -= 1
    p = a_ * b_ / c_
    p /= p.sum()
    counts = np.zeros(Kf)
    reps = 64
    for r in range(reps):
        zn = K4.cgs_entry_update(
            Db, Wb, torch.full((Kf,), 1e6, device=dev), zeros, zeros, zeros,
            alpha=0.0, beta=0.0, vbeta=0.0, cc=C_,
            seed2=torch.tensor([3, 100 + r], dtype=torch.int32,
                               device=dev))[2]
        counts += np.bincount(zn.cpu().numpy(), minlength=Kf)
    freq = counts / (reps * C_)
    se = np.sqrt(p * (1 - p) / (reps * C_)).max()
    if np.abs(freq - p).max() > 5 * se + 0.005:
        fail(f"K4 Philox draws {freq} do not match the posterior {p}")
    print(f"K4 Philox arm on a flat tile: frequencies {np.round(freq, 4)} vs "
          f"posterior {np.round(p, 4)}, max gap {np.abs(freq - p).max():.4f}"
          f" (limit {5 * se + 0.005:.4f})")

    # -- 11. small corpus on the card: invariants, pallas vs dense -----------
    d, w = LD.synthetic_corpus(96, 64, 4, 50)
    lls = {}
    for algo in ("pallas", "dense"):
        lls[algo] = []
        for seed in range(4):
            m = LD.LDA(96, 64, LD.LDAConfig(
                n_topics=8, algo=algo, sampler="exprace", d_tile=16,
                w_tile=16, entry_cap=64), seed=10 + seed)
            m.set_tokens(d, w)
            ll0 = m.log_likelihood()
            m.sample_epochs(12)
            Ndk_, Nwk_ = m.doc_topic_table(), m.word_topic_table()
            Nk_ = m.Nk.cpu().numpy()
            if not (Ndk_.sum() == Nwk_.sum() == m.n_tokens
                    and np.array_equal(Nwk_.sum(0), Nk_)
                    and np.array_equal(Nwk_, np.round(Nwk_))
                    and (Ndk_ >= 0).all() and (Nwk_ >= 0).all()):
                fail(f"LDA {algo} seed {seed}: chain invariants broken")
            lls[algo].append(m.log_likelihood())
            if not lls[algo][-1] > ll0:
                fail(f"LDA {algo}: log-likelihood {lls[algo][-1]} did not "
                     f"rise from {ll0}")
    gap = abs(np.mean(lls["pallas"]) - np.mean(lls["dense"]))
    if gap >= 0.05:
        fail(f"LDA pallas vs dense mean log-likelihood gap {gap} >= 0.05: "
             f"{lls}")
    print(f"LDA 96 docs x 64 words, 8 topics, 4 seeds x 12 sweeps: "
          f"invariants hold; mean log-likelihood pallas "
          f"{np.mean(lls['pallas']):.4f}, dense {np.mean(lls['dense']):.4f}, "
          f"gap {gap:.4f} (gate 0.05)")

    # -- 12. benchmark and CLI (the LDA main path) ----------------------------
    K4.reset_launches()  # the LDA main path's run starts here
    out = LD.benchmark(LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_TPD, LDA_EPOCHS,
                       algo="pallas")
    launches = K4.LAUNCHES["cgs_entry_update"]  # ... and ends here
    if launches != 2 * (1 + LDA_EPOCHS):
        fail(f"LDA benchmark: K4 launches {launches}, expected 2 per epoch")
    if not np.isfinite(out["log_likelihood"]):
        fail(f"LDA benchmark: non-finite log-likelihood: {out}")
    print(f"LDA benchmark pallas: {out['tokens_per_sec_per_chip']:.6e} "
          f"tokens/s per card, {out['sec_per_epoch']:.6f} s/epoch, "
          f"log-likelihood {out['log_likelihood']:.6f}, prep "
          f"{out['prep_sec']:.1f} s; K4 {ms:.4f} ms/step x 2 steps an epoch, "
          f"{launches} calls [{card}]")
    cli = subprocess.run(
        [sys.executable, "-m", "harp_tpu_torch", "lda", "--algo", "pallas"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if cli.returncode:
        fail(f"LDA CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
    crow = json.loads(cli.stdout.strip().splitlines()[-1])
    if crow.get("backend") != "cuda" or not np.isfinite(
            crow["log_likelihood"]):
        fail(f"LDA CLI row is not a finite cuda result: {crow}")
    print(f"CLI: {json.dumps(crow)}")

    # -- 13. profile one sweep ------------------------------------------------
    model = LD.LDA(LDA_DOCS, LDA_VOCAB, cfg, seed=1)
    model.set_tokens(*LD.benchmark_corpus(LDA_DOCS, LDA_VOCAB, LDA_TPD, 0))
    model.sample_epoch()
    t0 = time.perf_counter()
    model.sample_epoch()
    bare = time.perf_counter() - t0
    profile_epoch(model, card, "LDA", "sample_epoch", bare)
    del model

    # -- 14. enwiki-1M on this card -------------------------------------------
    if out["sec_per_epoch"] >= 3.0:
        print(f"LDA enwiki-1M skipped: the benchmark epoch took "
              f"{out['sec_per_epoch']:.3f} s (>= 3 s)")
        return row, launches
    torch.cuda.reset_peak_memory_stats()
    big = LD.LDA(ENWIKI_DOCS, LDA_VOCAB, LD.LDAConfig(
        n_topics=LDA_TOPICS, algo="pallas", ndk_dtype="int16"), seed=0)
    corpus = LD.benchmark_corpus(ENWIKI_DOCS, LDA_VOCAB, LDA_TPD, 0)
    t0 = time.perf_counter()
    big.set_tokens(*corpus)
    prep = time.perf_counter() - t0
    del corpus
    t0 = time.perf_counter()
    big.sample_epoch()
    sweep = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_tok = ENWIKI_DOCS * LDA_TPD
    # exact sums in row blocks: a whole-table int64 copy would be 8 GB
    ndk_sum = sum(int(b.sum(dtype=torch.int64))
                  for b in big.Ndk.split(1 << 16))
    nwk_sum = int(big.Nwk.sum(dtype=torch.float64))
    ok = (ndk_sum == nwk_sum == big.n_tokens == n_tok
          and torch.equal(big.Nwk.sum(0), big.Nk)
          and int(big.Ndk.min()) >= 0 and float(big.Nwk.min()) >= 0)
    if not ok:
        fail(f"LDA enwiki-1M: invariants broken (Ndk sum {ndk_sum}, Nwk sum "
             f"{nwk_sum}, tokens {n_tok})")
    print(f"LDA enwiki-1M ({ENWIKI_DOCS} docs x {LDA_VOCAB} words, "
          f"{LDA_TOPICS} topics, "
          f"{n_tok} tokens, int16 Ndk {tuple(big.Ndk.shape)}): prep "
          f"{prep:.1f} s, one sample_epoch {sweep:.3f} s "
          f"({n_tok / sweep:.6e} tokens/s), cc {big.cc}, peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (set_tokens and the sweep), "
          f"invariants hold [{card}]")
    return row, launches


def profile_epoch(model, card: str, app: str = "MFSGD",
                  what: str = "train_epoch", bare: float | None = None
                  ) -> None:
    """Device busy share of one epoch (``what``: its method), from
    torch.profiler's CUDA kernel times over the epoch's wall (the epoch ends
    in a readback); ``bare``, the wall of an unprofiled epoch, gives a
    second idle share free of the profiler's own host cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        getattr(model, what)()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    if busy <= 0:
        print(f"{app} profile: the profiler saw no device time; idle share "
              "not measured")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    unprofiled = ("" if bare is None else f" (unprofiled wall {bare:.4f} s, "
                  f"idle share {max(1 - busy / bare, 0.0):.3f})")
    print(f"{app} profile of one {what}: wall {wall:.4f} s, device "
          f"busy {busy:.4f} s, idle share {1 - busy / wall:.3f}"
          f"{unprofiled}; top: "
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

    # -- 6-8. MF-SGD ----------------------------------------------------------
    rows["sgd_tile_update"], launches["sgd_tile_update"] = mfsgd_phases(
        dev, card)

    # -- 9-14. LDA ------------------------------------------------------------
    rows["cgs_entry_update"], launches["cgs_entry_update"] = lda_phases(
        dev, card)

    # -- 15. result ----------------------------------------------------------
    src = {"kmeans_partials_int8": ("harp_tpu_torch/csrc/kmeans_partials_int8.cu",
                                    "harp_tpu/ops/kmeans_kernel.py:249"),
           "kmeans_partials": ("harp_tpu_torch/csrc/kmeans_partials.cu",
                               "harp_tpu/ops/kmeans_kernel.py:110"),
           "sgd_tile_update": ("harp_tpu_torch/csrc/mfsgd_tile_update.cu",
                               "harp_tpu/ops/mfsgd_kernel.py:133"),
           "cgs_entry_update": ("harp_tpu_torch/csrc/lda_cgs_entry.cu",
                                "harp_tpu/ops/lda_kernel.py:190")}
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
