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
6. one JSON line of the kernels, the card's name and power limit, and
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

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s and tensor-core op/s
HBM_BYTES_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}

N, D, K, ITERS = 1_000_000, 300, 100, 10
SHAPES = [(N, D, K), (N + 3, D, K), (N, D, 1000)]


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

    # -- 6. result -----------------------------------------------------------
    src = {"kmeans_partials_int8": ("harp_tpu_torch/csrc/kmeans_partials_int8.cu",
                                    "harp_tpu/ops/kmeans_kernel.py:249"),
           "kmeans_partials": ("harp_tpu_torch/csrc/kmeans_partials.cu",
                               "harp_tpu/ops/kmeans_kernel.py:110")}
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
