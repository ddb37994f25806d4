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
   best_sum within rtol 1e-5 (f32 summation order), reruns bit-equal, and
   the CUDA launches of one call (counted in a captured CUDA graph)
   (k1_phase);
3. K2 (kmeans_partials) against its plain version at the same shapes on
   separated blobs: counts equal, sums within 1e-5 * max|x| * max count and
   inertia within 1e-5 * sum|x|^2 (f32 summation order), reruns bit-equal,
   CUDA launches a call, and the port's default f32 path _partials_block
   timed beside it at k=100 and k=1000 (k2_phase);
4. models.kmeans.fit at 1M x 300 k=100, 10 iterations, for int8 (K1 runs
   once per iteration), f32 + use_pallas (K2 likewise) and the default f32
   matmul path (neither kernel): launch counts, finite inertia (no worse
   after 10 iterations than after one on the first 100k points), and
   agreement with the CPU run on a small input;
5. models.kmeans.benchmark at 1M x 300 k=100 for the three paths and at
   k=1000 for int8 and f32 + use_pallas, torch.profiler over the int8
   benchmark's window (device busy and idle share, top kernels), and the
   CLI (python -m harp_tpu_torch kmeans --bench --quantize int8);
6. K3 (sgd_tile_update) against its plain version for one rotation step at
   MovieLens-20M width (138,493 x 26,744, 20M ratings, rank 64, one worker,
   two H chunks, 256 x 256 tiles), compute dtype bf16 and f32: W and H
   within rtol 1e-4 / atol 1e-5 and se within rtol 1e-5 (the gradient sums
   are added in another f32 order), cnt equal; the CUDA launches of one
   call (counted in a captured CUDA graph), the entry count, the critical
   path and the microseconds a critical-path entry; then a deep chain (593
   entries on one tile pair) and a wide step (two levels of 2000 entries)
   against the plain version, with microseconds an entry (k3_phase);
7. models.mfsgd.MFSGD at that width with algo="pallas": train_epoch, then
   train_epochs(3), K3 launched once per rotation step (2 per epoch),
   finite RMSEs falling below the first epoch's, and the card agreeing with
   the CPU on a small input for all three algos;
8. models.mfsgd.benchmark at that width for pallas, and the CLI at 2M
   ratings (python -m harp_tpu_torch mfsgd --algo pallas --epochs 3 --nnz
   2000000);
9. K4 (cgs_entry_update, through its step entry point cgs_step) against
   its plain version at the LDA benchmark width (100k docs x 50k words,
   1000 topics, 100 tokens a doc; 512 x 512 tiles, C = 768, cc from
   chunk_width): the first 256 entries of one rotation step with injected
   uniforms for f32 and int16 Ndk, then the step's first entries that
   span K4_PLAIN_CHUNKS chunks on the Philox arm for f32 and int16 Ndk;
   tables, topics and dNk bit-equal; the whole step timed, launches a
   step (one), microseconds a chunk, and torch.profiler's split of the
   step into kernel time and the gaps between launches;
10. K4's Philox arm on a flat tile: topic frequencies match the posterior;
11. models.lda.LDA on synthetic_corpus(96, 64, 4, 50) for pallas and dense,
   four seeds, twelve sweeps: chain invariants, rising likelihood, and the
   two algos' mean log-likelihoods within 0.05;
12. models.lda.benchmark(algo="pallas") at the benchmark width (K4 launched
   once per rotation step: 2 an epoch), and the CLI (python -m
   harp_tpu_torch lda --algo pallas);
13. torch.profiler over one sample_epoch at that width: device busy and
   idle share, top kernels;
14. one sample_epoch at the graded enwiki-1M width (its 50k words and
   1000 topics, a quarter of its 1M docs: 25M tokens, int16 Ndk) when
   phase 12's epoch is under 3 s: prep, epoch time, peak device memory and
   the chain invariants;
15. K5 (pegasos_grad) against its plain version at 500,256 x 128 (500k
   rows + 256 support-vector rows), f32 and bf16 x: gs equal (0/1 weights,
   +-1 labels: small integers), gw within 1e-5 * sum_i sw_i |x_i| (f32
   summation order), reruns bit-equal, and the CUDA launches of one call
   (counted in a captured CUDA graph) (k5_phase);
16. models.svm at 500k x 128 with algo="pallas": SVM.fit with K5 launched
   1000 times (200 steps x 5 rounds), train_acc on the first 50k rows above
   SVM_ACC_FLOOR, the card and the CPU agreeing on a small input for both
   algos and all three sv_wires, benchmark and the CLI (python -m
   harp_tpu_torch svm --algo pallas), and torch.profiler over one fit;
17. K6 (smacof_bx) against its plain version at n = 4096, dim 3, f32 and
   bf16 delta, and at a ragged n = 4099: within rtol 1e-4 / atol 1e-5 (f32
   summation order), reruns bit-equal; the time of back-to-back wrapper
   calls (the kernels line's ms) and of the kernel from a CUDA graph of 20
   calls (graph_ms) (k6_phase);
18. models.wdamds.mds at n = 4096, dim 3, 30 iterations, algo="pallas": K6
   launched 30 times, a finite stress below the one-iteration stress, the
   card and the CPU agreeing on a small input for both algos (stress rtol
   1e-3), benchmark and the CLI, and torch.profiler over one mds;
19. K7 (hist_bins) against its plain version at 200k x 64 features x 32
   bins, 32 trees, on the row codes and weights of every level 0-5 of a
   real fit: bit-equal int32 counts for uint8 and int32 bins, reruns
   bit-equal, the time of back-to-back wrapper calls (ms) and of the
   kernel from a CUDA graph of 5 calls (graph_ms); torch.bincount of the same weighted cells timed beside it (library_ms)
   (k7_phase);
20. models.rf at 200k x 64, 32 trees, depth 6, hist_algo="pallas": K7
   launched once per level, the forest bit-equal to the dense arm's on the
   card under the same seed, train_acc on 20k rows above RF_ACC_FLOOR,
   benchmark and the CLI (python -m harp_tpu_torch rf --hist-algo pallas),
   and torch.profiler over one fit;
21. K8 (flash_attention) against its plain version at Mistral-7B width,
   [32, 8192, 128] with K/V made by repeating 8 KV heads x4: bf16 causal,
   bf16 causal + window 4096, f32 causal and f32 causal + window 4096 (the
   main path's call), plus f32 non-causal window 512 at N = 2048 and bf16
   causal at [64, 4096, 64]: f32 within rtol 2e-4 / atol 2e-5; bf16 within
   2^-6 of each entry's size or its row's RMS (flash_attention.
   row_scaled_error), and the plain version with a planted fault (a key
   tile's p.v dropped; the window a tile short) must fail that test;
   reruns bit-equal; the path each arm ran (wgmma or simt);
   scaled_dot_product_attention on the same tensors timed beside it
   (library_ms);
22. the attention schemes at Mistral width on one card, f32, seq 8192 (the
   K8 main path): ring_attention after apply_rope with window 4096 and GQA
   32q/8kv, a2a_attention with block_k 512, and K8 on the folded heads,
   agreeing within rtol 2e-4 / atol 2e-5; K8 launched, peak device memory;
23. the long-context layer (harp_tpu_torch.examples.longctx_layer) at
   Mistral width: forwards at seq 8192 (a warm-up, then the median and
   spread of five) and training steps at seq 4096 (finite loss and update,
   tokens/s, peak memory), and the card against
   the CPU at the example's defaults (loss sequence rtol 1e-3);
24. MoE (moe_ffn on one card: one expert) against the CPU and the host
   reference on a small input, zero drops at capacity = tokens;
25. K1 at the streaming chunk shape, [262,144, 300] with k = 1000, against
   its plain version (sums and counts equal, best_sum rtol 1e-5, reruns
   bit-equal; ms, graph_ms, bound), models.kmeans._partials_block_int8
   timed beside it, the fused quantize pass that makes K1's streamed
   chunk (int8 chunk bit-equal, x2 rtol 1e-6; ms, graph_ms, plain, bound),
   and K2 beside _partials_block (the f32 chunk route) at the same shape
   (stream_chunk_phase);
26. models.kmeans_stream.fit_streaming on a seeded 1M x 300 host array, k =
   1000, explicit init, f32 and int8, at prefetch 0, 1, 2 and 4: every
   depth bit-identical, the int8 stream launching K1 once a chunk an epoch
   (counts set to 0 just before the int8 prefetch-2 fit, read just after),
   f32 and int8 inertias within 2e-2, each fit's pipeline account and peak
   device memory, the H2D rate of one chunk from pinned and from pageable
   memory, and the card against the CPU on a small input (rtol 1e-4)
   (stream_fit_phase);
27. models.kmeans_stream.benchmark_ingest on a .npy memmap of the first 1M
   rows, f32 at prefetch 0, 1, 2 and 4 and f16 at 2 (the f16 wire
   bit-identical to the host cast), and fit_streaming_files over a
   directory of CSV splits read by the port's native loader, against the
   single-source fit of the same rows (stream_ingest_phase);
28. models.kmeans_stream.benchmark_streaming at the north star (n = 1e9, d
   = 300, k = 1000, int8; K1 once a chunk an epoch) and f32 at n = 1e8:
   iters/s, points/s, s/iter and peak device memory; torch.profiler over
   one int8 epoch of 128 chunks; and the CLI (python -m harp_tpu_torch
   kmeans-stream --quantize int8) (stream_benchmark_phase);
29. the collective surface on the card's one-rank NCCL group: every
   quantized verb, every reshard pair of five layouts on the three wires
   and allreduce_hier against numpy, then the bench app (python -m
   harp_tpu_torch bench --max-mb 256: GB/s and microseconds a call per
   verb and size; one worker, so the local path) (verbs_phase);
30. the sparse row verbs (pull/push_rows_sparse and their _dedup forms) on
   a [50,000, 1000] f32 table with 8192 Zipf ids against numpy gathers and
   np.add.at, drops at a small capacity, and the time a call
   (tables_phase);
31. LDA push/pull (this slice's main path; no kernel): a small corpus on
   the card against the CPU, bit-equal under injected draws; benchmark(
   algo="pushpull") at the benchmark width (tokens/s, s/epoch, prep,
   log-likelihood, dropped_tokens 0, peak memory); then on a tenth of the
   docs at the same width: suggest_pull_cap and a sweep at it (0 dropped,
   Nwk.sum(0) == Nk, sum Ndk == tokens); the split of a chunk into pull,
   sample and push from CUDA events; torch.profiler over a sweep (device
   busy and idle share, top kernels); and the CLI
   (python -m harp_tpu_torch lda --algo pushpull --docs 10000)
   (lda_pushpull_phases);
32. models.kmeans.fit at 1M x 300, k = 100, int8 with psum_schedule="hier"
   (K1 once an iteration), bit-equal to one_shot on one card
   (kmeans_hier_phase);
33. subgraph counting (no kernel of ours): the card against the CPU bit
   for bit on a 64-vertex hub graph (u5 and u7 trees, both overflow
   algos, which agree), u7-tree on K7 exactly 7!, benchmark at the graded
   1M-vertex power-law shape (u5-tree, average degree 8, max_degree 16)
   for both algos (vertices/s, host prep and device DP seconds, the algos
   within rtol 1e-5), the CLI, u7-tree at 50k vertices, and
   torch.profiler over one trial (subgraph_phase);
34. the MLP trainers (no kernel of ours): the card against the CPU on a
   small input (the three gradient wires, ZeRO-1 adam, momentum; rtol
   1e-4), benchmark at MNIST width (784, 512, 256, 10), 60,000 samples,
   batch 8192, for the f32, bf16 and int8 wires and ZeRO-1 adam
   (samples/s), TPMLPTrainer on a 1 x 1 mesh_2d against MLPTrainer with a
   falling loss, fit for 2 epochs through the CLI (python -m
   harp_tpu_torch mlp --train), and torch.profiler over ten steps
   (mlp_phase);
35. CCD++ (no kernel of ours): the card against the CPU on a small input
   (rtol 1e-4), benchmark at MovieLens-20M width, rank 32, 2 epochs
   (seconds an epoch, a falling RMSE), and the CLI at its defaults
   (ccd_phase);
36. the stats suite (no kernel of ours) on 10M x 64 f32 rows drawn on the
   card: moments, covariance, PCA, linreg, ridge, TSQR, SVD and naive
   Bayes (seconds, rows/s, peak memory), TSQR's residual below 1e-5, the
   card against the CPU on 20,000 rows at the stats tolerances, the
   covariance within 1e-5 of an f64 host Gram (TF32 off), and ALS at
   MovieLens-1M's counts, rank 8, 3 iterations (seconds an iteration, a
   falling RMSE, peak memory beside the reckoned one) (stats_phase);
37. weighted WDA-MDS at n = 4096, dim 3, 30 iterations of 10 CG steps,
   with a seeded 10 % of the pairs weighted 0 and their δ corrupted x5
   (iters/s, weighted stress), unit weights against the unweighted stress
   (rtol 1e-3), the card against the CPU at n = 256 (wmds_phase);
38. SVM's sparse path on a seeded 500k x 128 libsvm file at 10 % density:
   the native parser against the Python one on the file's first 50,000
   rows (equal arrays), fit_sparse and the --libsvm CLI on the card
   (samples/s, train_acc), the card against the CPU on 2,000 rows (rtol
   1e-3) (svm_sparse_phase);
39. durable runs on the kernels, each recovered run bit-equal to an
   uninterrupted one after an injected ckpt_write fault (one step
   replayed) and a worker failure: KMeans 1M x 300, k = 100, 10 iterations,
   ckpt_every 2, int8 on K1 and f32 use_pallas on K2 (launch counts show
   the replay); MF-SGD on K3, LDA on K4 and CCD++, 4 epochs (a second
   uninterrupted CCD++ run bit-equal too), and the MLP's fit_ckpt
   (rtol 1e-5); streaming int8 at 500k x 300, k = 1000, three epochs,
   killed after two epochs and resumed by the CLI's --resume; the seconds
   and bytes a checkpoint costs; a lone ckpt_write fault leaves its tmp.*
   and no damage (durable_phase);
40. the serving plane (no kernel of ours; TF32 off) at full width, each
   engine from a cold graph cache: KMeans k = 1000 x d = 300, MF-SGD
   top-10 served from phase 39's durable MF-SGD checkpoint (138,493 x
   26,744, rank 64; its factors exported through MFSGD.factors()), LDA
   50,000 words x 1000 topics with 16 EM steps, the MLP at MNIST width
   (784, 512, 256, 10), RF 32 trees of depth 6 on 64 features, SVM
   d = 128: the burst benchmark row over a timed window of at least
   1 s of single-row requests in bursts that land on every rung (qps,
   p50/p95/p99 ms over every request of the window, padding_frac,
   startup seconds, captures, cache hits and misses, steady_compiles 0,
   one dispatch and one readback a batch), and the card's raw step
   outputs against the CPU's, batch by batch, on the same requests
   answered by Server.process and by a depth-2 ContinuousRunner, with
   batches of several rungs (the same rung too) in flight back to back
   (ids and classes equal; MF-SGD scores rtol 1e-5, MLP logits and SVM
   scores rtol 1e-5 with an atol of 1e-5 of the batch's largest |value|,
   LDA's θ rtol 1e-4 / atol 1e-6); then KMeans' sustained A/B over
   40,000 requests with a 5 % dispatch fault rate (every request served,
   every fault retried), and a warm restart from the same cache
   directory (no kernel build, a hit and a capture a rung); K1-K8 launch
   nothing (serve_phase);
41. the pipeline on the card at S = 1: forward and stage gradients
   against the CPU (rtol 1e-4 / atol 1e-5) (pipeline_phase);
42. the training plane under telemetry: KMeans fit at graded config #1
   (1M x 300, k = 100, int8 on K1, 10 iterations) with telemetry off and
   on: centroids and inertia bit-equal, the same K1 launches and the same
   dispatches and readbacks (counted by flight-recorder observers, which
   see both runs); the export holds one superstep-timeline run, a skew
   execution row whose per-worker points sum to n and, through the
   report CLI, a report row; the report, timeline and health CLIs exit 0
   on it, and the serve CLI's burst bench with HARP_TELEMETRY=1 ends in
   its run report (the four subprocesses run together)
   (telemetry_phase);
43. elastic training on one card: MF-SGD at graded config #2's width
   (138,493 x 26,744, 2M ratings, rank 64, bf16, K3) for 3 epochs and
   LDA at graded config #3's width (100k docs x 50k words x 1000 topics,
   K4) for 2 sweeps, each through elastic_fit: the home layout bit-equal
   to the plain loop from the same initial state, and a transient
   dispatch fault at epoch 1 resumed from its checkpoint bit-equal to the
   uninterrupted elastic run, its elastic "resume" row in the export;
   streaming KMeans through kmeans_stream_elastic_fit at 1M x 300,
   k = 1000, f32, bit-equal to fit_streaming; a worker loss on one worker
   (--max-worker-loss 1) fails loudly; the seconds of each part and the
   host prep (elastic_phase);
44. the measurement layer (measurement_phase): the schedulers' stream
   order on the card (a Dynamic and a Static scheduler: items written on
   the caller's stream after start, large results read straight after
   hand-out); every kernel of ops/kernel_registry.py at its registered
   shape, one launch each (LAUNCHES grows by the registered count, the
   plain version agrees within the kernel's class, shared memory within
   the card's opt-in limit); the KMeans int8 fit at graded config #1
   under utils.profiling.trace, attributed to the mechanism buckets (K1's
   share, the idle share; "not measured" when the trace is short of K1's
   launches); the benchmark rows of phases 5, 8, 12 and 34 on the card's
   roofline, none over 100 %; python -m harp_tpu_torch profile --all
   --json, every row reconciled or naming its dropped records; and
   checked_jit on the card;
45. the cost model and the fit gates (costmodel_phase): the overhead
   probe beside the committed CALIBRATED_OVERHEADS; the shared-memory gate
   at K1's and K2's plans (registry shape and the north-star chunk shape);
   a K3 config past the card's opt-in refused with MemoryError and no
   launch; an HBM request past the free memory refused before any
   allocation; perfmodel.presize for K1, K2, K3 and K7; plan_all on
   single_card over the eleven drivers; predict --grade and the model gate
   on the committed H100_EVIDENCE.jsonl; grade_bench_row over phases 5 and
   8's KMeans int8 and MF-SGD rows;
46. the lint layers and the thread guard (analysis_phase): python -m
   harp_tpu_torch lint --json in a subprocess, clean (every driver and
   protocol under the wire audit on the card, K1's and K2's shared memory
   held to the card's plans); the thirteen lint drivers on the card
   against the CPU (ring attention's local block on the card); the
   KMeans engine over TCP with threadguard armed (checks, no violation);
   the int8 fit on K1 armed and disarmed, bit-equal with the same
   counts; a launch on a forbidden thread name refused; and the registry's
   smem_bytes against the shared memory K1, K2, K3 and K7 take at launch;
47. the reference's surface (surface_phase): the public API's import
   line; models.lda.benchmark(algo="pallas", pack_cache=DIR) at graded
   config #3 (K4) cold, then warm: the same log-likelihood bit for bit,
   K4 launched 2 x (1 + LDA_EPOCHS) each time, one .npz and no tmp file
   in DIR, both prep_sec; MF-SGD algo="dense" at graded config #2's
   widths on 2M ratings with carry_w on and off, one epoch each, W, H and
   RMSE bit-equal; and the four apps through their main on the card:
   kmeans_app at d = 300, k = 100 on a quarter of graded config #1's
   points (its centroids within rtol 1e-4 / atol 1e-6 of a CPU run of the
   app at APP_KM_CHECK_N points), mfsgd_app and pipeline_moe_app at
   their defaults (one stage, one expert), streaming_kmeans_app at the
   north star's d = 300 on the app's 20,000 rows with k = 8 (APP_STREAM_K
   says why not 1000);
48. one JSON line of the kernels, the card's name and power limit, and
   the result line {"ok": true, "device": {...}}.

Times are CUDA-event times on this card (its power limit is printed beside
them); bounds and rates come from harp_tpu_torch/ops/kernel_registry.py and
harp_tpu_torch/utils/roofline.py (the H100 SXM data sheet).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))

# the kernels' bounds and the card's rates (NVIDIA H100 SXM data sheet):
# harp_tpu_torch/ops/kernel_registry.py and harp_tpu_torch/utils/roofline.py
from harp_tpu_torch.ops.kernel_registry import (  # noqa: E402
    k3_bound_ms, k3_work, k4_bound_ms, k4_work, k5_bound_ms, k6_bound_ms,
    k7_bound_ms, k8_bound_ms, k8_pairs, k12_bound_ms)


N, D, K, ITERS = 1_000_000, 300, 100, 10
SHAPES = [(N, D, K), (N + 3, D, K), (N, D, 1000)]

# MovieLens-20M width (the reference's graded MF-SGD config)
ML_USERS, ML_ITEMS, ML_NNZ, ML_RANK, EPOCHS = 138_493, 26_744, 20_000_000, 64, 3

# LDA benchmark width (the reference's benchmark() defaults, graded config
# #3 scaled to one card) and the graded enwiki-1M doc count
LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_TPD, LDA_EPOCHS = 100_000, 50_000, 1000, 100, 2
ENWIKI_DOCS = 1_000_000
# the int16-Ndk sweep of phase 14 runs a quarter of enwiki-1M's docs at its
# vocabulary width (depth, not width: the 1M-doc prep alone took 36 s)
ENWIKI_SWEEP_DOCS = ENWIKI_DOCS // 4
# K4 against its plain version on the first entries of a rotation step that
# span this many of its ~44,800 chunks (the plain whole step took 105-155 s)
K4_PLAIN_CHUNKS = 4096

# SVM, WDA-MDS and RF at the reference's benchmark() defaults
SVM_N, SVM_D, SVM_K = 500_000, 128, 256
MDS_N, MDS_DIM, MDS_ITERS = 4096, 3, 30
RF_N, RF_F, RF_TREES, RF_DEPTH = 200_000, 64, 32, 6
# train_acc floors, from the CPU run of the same task at 20,000 rows
# (models.svm.synthetic_data(20000, 128) with algo="pallas": 0.9914;
# models.rf.synthetic_classification(20000, 64) with the default forest:
# 0.9976), less 0.02
SVM_ACC_FLOOR, RF_ACC_FLOOR = 0.97, 0.97

# streaming KMeans at the north star (BASELINE.json: 1B points, k = 1000,
# d = 300) on one card, in chunks of the reference's StreamConfig default;
# f32 at the CLI's default n; a seeded 1M-row host array (a ragged last
# chunk) for fit_streaming and the .npy ingest
STREAM_N, STREAM_F32_N, STREAM_D, STREAM_K = 1_000_000_000, 100_000_000, 300, 1000
STREAM_CHUNK, STREAM_ITERS, STREAM_BENCH_ITERS = 262_144, 2, 3
STREAM_HOST_N, STREAM_NPY_N, STREAM_CSV_FILES, STREAM_CSV_ROWS = 1_000_000, 1_000_000, 4, 2048

# Mistral-7B-v0.1's attention block (its config.json: hidden_size 4096, 32
# attention heads, 8 KV heads, head dim 128, sliding_window 4096,
# rope_theta 10000); the sequence length is the depth knob
MIS_HEADS, MIS_KV, MIS_DIM, MIS_WINDOW = 32, 8, 128, 4096
MIS_SEQ, MIS_TRAIN_SEQ, MIS_TRAIN_STEPS, MIS_FWD_REPS = 8192, 4096, 3, 5

# subgraph counting at the graded scale (scripts/measure_all.py's
# subgraph_1m: u5-tree on 1M power-law vertices, average degree 8,
# max_degree 16), and u7-tree at 50k vertices
SUB_N, SUB_DEG, SUB_MAX_DEG, SUB_U7_N = 1_000_000, 8, 16, 50_000
# the MLP at MNIST width (graded config #4: sizes (784, 512, 256, 10),
# 60,000 samples, batch 8192), CCD++ at MF-SGD's MovieLens-20M width
MLP_N, MLP_BATCH, CCD_RANK = 60_000, 8192, 32

# the stats suite: 10M x 64 rows (the CLI's d at 100x its n) drawn on the
# card, checked against the CPU on a 20,000-row slice; ALS at
# MovieLens-1M's counts (6,040 users, 3,706 items, 1M ratings), rank 8
STATS_N, STATS_D, STATS_CHECK_N = 10_000_000, 64, 20_000
ALS_USERS, ALS_ITEMS, ALS_NNZ, ALS_RANK, ALS_ITERS = 6_040, 3_706, 1_000_000, 8, 3
# weighted WDA-MDS at wdamds.benchmark's width (MDS_*), its CG steps, and
# the card-against-CPU size
WMDS_CG, WMDS_SMALL = 10, 256
# SVM's sparse path at the dense benchmark's shape, 10 % of the features
# set; the accuracy floor is the dense floor less the sparser signal's
# margin (a row holds 12.8 features on average)
SVMS_N, SVMS_D, SVMS_DENSITY, SVMS_SMALL, SVMS_ACC_FLOOR = (
    500_000, 128, 0.10, 2000, 0.90)
# durable runs: KMeans graded config #1 checkpointed every 2 iterations;
# MF-SGD and CCD++ at MovieLens-20M width with 2M ratings, LDA at the
# benchmark's vocabulary and topics with 20k docs; streaming int8 at
# 5e5 x 300, k = 1000, two chunks an epoch, three epochs (an epoch of real
# int8 data costs ~1 s a chunk of host quantization: 1e7 rows took 39 s
# an epoch, 2.5e6 rows 9.6 s, which the script's time limit could not
# keep)
DUR_EVERY, DUR_ML_NNZ, DUR_LDA_DOCS, DUR_EPOCHS = 2, 2_000_000, 20_000, 4
# cut from 1,000,000 rows over 4 epochs to make room for phase 46
DUR_STREAM_N, DUR_STREAM_EPOCHS = 500_000, 3
# the serving plane at full width (phase 40): each engine's synthetic state
# shape, or (MF-SGD) phase 39's checkpoint; the bench's default ladder
SERVE_SHAPES = {"kmeans": {"k": 1000, "d": 300},
                "lda": {"vocab_size": LDA_VOCAB, "n_topics": LDA_TOPICS},
                "mlp": {"sizes": (784, 512, 256, 10)},
                "rf": {"n_trees": 32, "max_depth": 6, "n_features": 64,
                       "n_bins": 32, "n_classes": 2},
                "svm": {"d": 128}}
# the burst bench: burst sizes taken in turn (each lands on a rung, the
# last three padded), over distinct requests served again until the
# timed window lasts SERVE_SECONDS (LDA: one round, ~50,000 floats of
# JSON a request); the sustained A/B's requests and dispatch fault rate
SERVE_BURSTS = (1, 8, 64, 512, 5, 40, 300)
SERVE_REQUESTS, SERVE_SECONDS = 4 * sum(SERVE_BURSTS), 1.0
SERVE_SUSTAINED, SERVE_FAULT_RATE = 40_000, 0.05
# the card against the CPU: the rows of each request, in bursts; the
# bursts give batches of 512, 512, 8 | 64 | 1 on the burst plane and
# 512, 512, 64, 8 on the continuous one.  LDA's CPU step at full width
# costs ~3 GFLOP a row, so it stays under the 512-rung: 64 | 64 | 8 | 1
# and 64, 64, 64
SERVE_CHECK_BURSTS = ((1, 5, 64, 300, 512, 148), (40, 24), (1,))
SERVE_CHECK_BURSTS_LDA = ((1, 5, 58), (64,), (8,), (1,))
# the pipeline at S = 1 (phase 41)
PIPE_M, PIPE_MB, PIPE_W = 8, 256, 512
# phase 38's Python libsvm parse runs on the file's first rows (the whole
# 500k-row parse took 7.0 s)
SVMS_PARSE_N = 50_000
# phase 47: kmeans_app on a quarter of graded config #1's points, and its
# card-against-CPU check at 2048 points: the CPU scan of the app's run
# (f64 distances along its f32 path) puts every point's two nearest
# centroids at least 1.5e-3 apart there (50 ulps of the ~300 distances),
# 6.8e-5 at 8192 points, inside the two devices' summation-order
# difference, where a flipped assignment moves a centroid by 1/its count;
# streaming_kmeans_app at the north star's d on its default 20,000 rows
# and k = 8: its points are k blobs at offsets 6 j, so at k = 1000 the sum
# of |x|^2 reaches ~2e14 and the f32 inertia (that sum plus the best
# scores) cancels to nothing: the reference's app fails its own 1e-3
# check there on the CPU, as the port's does (at d = 300 the CPU runs
# read 1.2e-5 at k = 8, 4.0e-5 at 16, 4.9e-4 at 32)
APP_KM_N, APP_KM_CHECK_N = 262_144, 2048
APP_STREAM_N, APP_STREAM_K = 20_000, 8


#: the benchmark rows phase 44 annotates with the card's roofline:
#: label -> (roofline config, row); phases 5, 8, 12 and 34 fill it
BENCH_ROWS: dict[str, tuple[str, dict]] = {}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_cli(app: str, *args: str) -> dict:
    """``python -m harp_tpu_torch <app> <args>``: its JSON row, which must
    name the card."""
    cli = subprocess.run([sys.executable, "-m", "harp_tpu_torch", app, *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    if cli.returncode:
        fail(f"{app} CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
    row = json.loads(cli.stdout.strip().splitlines()[-1])
    if row.get("backend") != "cuda":
        fail(f"{app} CLI row is not a cuda result: {row}")
    print(f"CLI: {json.dumps(row)}")
    return row


def blobs(n, d, k, gen, dev, spread=8.0, noise=0.5):
    """Separated clusters drawn on the card from ``gen``."""
    import torch

    centers = torch.randn((k, d), generator=gen, device=dev) * spread
    assign = torch.randint(0, k, (n,), generator=gen, device=dev)
    pts = centers[assign] + noise * torch.randn((n, d), generator=gen,
                                                device=dev)
    return pts, centers


def kernel_launches(fn) -> int:
    """The kernels of our own sources that one call of ``fn`` launches,
    counted from the CUDA graph that a second call captures on a side
    stream (torch.profiler can drop device records): graph nodes whose
    kernel name is not one of PyTorch's.  The first call runs on that
    stream, so that nothing is planned or created during the capture."""
    import torch

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)  # kept for debug_dump
    with torch.cuda.graph(g, stream=side):
        fn()
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # debug_dump warns that it dumps
        path = os.path.join(d, "graph.dot")
        g.debug_dump(path)
        with open(path) as f:
            nodes = re.split(r'(?="graph_\d+_node_\d+"\s*\[)', f.read())[1:]
    return sum("kernel" in n and "at6native" not in n
               and "at::native" not in n for n in nodes)


def k3_entries(dev, pairs, n_real: int, tile: int, C: int, seed: int):
    """Entries made by hand on the tile pairs ``pairs`` ([(tu, ti)], in
    entry order), each with ``n_real`` ratings uniform in its tile then
    pads, and f32 factors covering the tiles: ``(W, H, [eu, ei, ev, ou,
    oi])`` on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ne = len(pairs)
    tu, ti = (np.array(p, np.int32) for p in zip(*pairs))
    eu = np.full((ne, C), tile, np.int32)
    ei = np.full((ne, C), tile, np.int32)
    ev = np.zeros((ne, C), np.float32)
    eu[:, :n_real] = rng.integers(0, tile, (ne, n_real))
    ei[:, :n_real] = rng.integers(0, tile, (ne, n_real))
    ev[:, :n_real] = rng.normal(size=(ne, n_real))
    scale = 1.0 / ML_RANK ** 0.5
    W = rng.uniform(0, scale, ((tu.max() + 1) * tile, ML_RANK))
    H = rng.uniform(0, scale, ((ti.max() + 1) * tile, ML_RANK))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (T(W.astype(np.float32)), T(H.astype(np.float32)),
            [T(a) for a in (eu, ei, ev, tu * tile, ti * tile)])


def k3_check(K3, W, H, ent, kw, what: str) -> float:
    """K3 against its plain version on one call: W and H within rtol 1e-4
    / atol 1e-5, se within rtol 1e-5, cnt equal; the largest factor
    error."""
    import torch

    W1, H1, se1, c1 = K3.sgd_tile_update(W, H, *ent, **kw)
    W2, H2, se2, c2 = K3.sgd_tile_update_plain(W, H, *ent, **kw)
    torch.cuda.synchronize()
    werr = float((W1 - W2).abs().max())
    herr = float((H1 - H2).abs().max())
    serr = abs(float(se1) - float(se2)) / float(se2)
    ok_w = bool(((W1 - W2).abs() <= 1e-5 + 1e-4 * W2.abs()).all())
    ok_h = bool(((H1 - H2).abs() <= 1e-5 + 1e-4 * H2.abs()).all())
    real = float((ent[0] < kw["u_tile"]).sum())
    if not (ok_w and ok_h and serr <= 1e-5
            and float(c1) == float(c2) == real):
        fail(f"K3 {what} disagrees with its plain version: W err {werr}, "
             f"H err {herr}, se rel err {serr}, cnt {float(c1)} vs "
             f"{float(c2)}")
    if torch.equal(W1, W):
        fail(f"K3 {what} left W unchanged")
    return max(werr, herr)


def k3_phase(dev, card: str, model=None) -> dict:
    """Phase 6: K3 against its plain version for one rotation step at
    MovieLens-20M width, and on a deep chain and a wide step; returns K3's
    row of the kernels line.  ``model``: a pallas ``MFSGD`` at that width
    whose ``set_ratings`` already partitioned the ratings (phase 7's): its
    first block row and schedule are the step, so the 20M ratings are
    partitioned once; without it the phase partitions them itself."""
    import torch

    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    ut = it = 256
    if model is None:
        u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, ML_NNZ, seed=0)
        eu, ei, ev, ou, oi, _, _, ub, ibc = MF.partition_ratings_tiles(
            u, i, v, ML_USERS, ML_ITEMS, 1, ut, it, 2048, n_slices=2)
        del u, i, v
        sched = K3.LevelSchedule.build(eu[0], ei[0], ou[0], oi[0], ut, it,
                                       ub, ibc, dev)
        ent = [torch.from_numpy(a[0].copy()).to(dev)
               for a in (eu, ei, ev, ou, oi)]
    else:
        if MF.tiles(model.cfg) != (ut, it) or model.cfg.entry_cap != 2048:
            fail("k3_phase: the shared model is not at 256 x 256 tiles")
        ent = [a[0].contiguous() for a in model._blocks]
        eu, ei = (a[None].cpu().numpy() for a in ent[:2])
        sched, ub = model._schedules[0], model.u_bound
        ibc = model.i_bound // MF.rotate_chunks_resolved(model.cfg)
    work = k3_work(eu[0], ei[0], ut, it)
    ne, c = eu.shape[1:]
    n_sched, path = sched.order.numel(), sched.n_levels
    print(f"K3 prep: {time.perf_counter() - t0:.1f} s; one step: {ne} "
          f"entries x {c} slots ({n_sched} with a rating), {work['ratings']} "
          f"ratings, {work['rows']} distinct tile rows over the entries, W "
          f"[{ub}, {ML_RANK}], H chunk [{ibc}, {ML_RANK}]; critical path "
          f"{path} entries, at most {sched.max_width} entries a level")
    del eu, ei
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scale = 1.0 / ML_RANK ** 0.5
    W = torch.rand((ub, ML_RANK), generator=gen, device=dev) * scale
    H = torch.rand((ibc, ML_RANK), generator=gen, device=dev) * scale
    row = None
    for cd in (torch.bfloat16, torch.float32):
        kw = dict(lr=0.01, reg=0.05, u_tile=ut, i_tile=it, compute_dtype=cd,
                  schedule=sched)
        err = k3_check(K3, W, H, ent, kw, str(cd))
        ms = cuda_ms(lambda: K3.sgd_tile_update(W, H, *ent, **kw), reps=10,
                     warmup=1)
        plain = cuda_ms(lambda: K3.sgd_tile_update_plain(W, H, *ent, **kw),
                        reps=2, warmup=1)
        n_cuda = kernel_launches(
            lambda: K3.sgd_tile_update(W, H, *ent, **kw))
        b_ms, b_by = k3_bound_ms(work, ub, ibc, ML_RANK)
        print(f"K3 {str(cd).removeprefix('torch.')}: within tolerance of the "
              f"plain version (max factor err {err:.3e}), cnt "
              f"{work['ratings']} equal; kernel {ms:.4f} ms/call ({n_cuda} "
              f"CUDA launch(es) a call, counted in a CUDA graph; "
              f"{n_sched} entries, critical path {path} entries, "
              f"{ms * 1e3 / path:.3f} us a critical-path entry), plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if cd == torch.bfloat16:  # the main path's compute dtype
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by}
    del ent, W, H

    # a deep chain (every entry on one tile pair: width 1) and a wide step
    # (two levels of 2000 ready entries, more than the grid has clusters),
    # 349 ratings an entry as at MovieLens-20M width
    n_real, C = work["ratings"] // n_sched, c
    for arm, pairs in (("deep chain", [(0, 0)] * path),
                       ("wide step", [(k, k) for k in range(2000)]
                        + [(k, (k + 1) % 2000) for k in range(2000)])):
        W, H, ent = k3_entries(dev, pairs, n_real, ut, C, seed=len(pairs))
        kw = dict(lr=0.01, reg=0.05, u_tile=ut, i_tile=it,
                  compute_dtype=torch.bfloat16)
        kw["schedule"] = K3.LevelSchedule.build(
            *ent[:2], *ent[3:], ut, it, W.shape[0], H.shape[0], dev)
        err = k3_check(K3, W, H, ent, kw, arm)
        ms = cuda_ms(lambda: K3.sgd_tile_update(W, H, *ent, **kw), reps=5,
                     warmup=1)
        s = kw["schedule"]
        print(f"K3 {arm}, bf16: {len(pairs)} entries of {n_real} ratings, "
              f"critical path {s.n_levels}, at most {s.max_width} a level: "
              f"within tolerance (max factor err {err:.3e}); kernel "
              f"{ms:.4f} ms/call, {ms * 1e3 / len(pairs):.3f} us an entry "
              f"[{card}]")
        del W, H, ent
    return row


def k1_phase(dev, card: str, gen) -> dict:
    """Phase 2: K1 (kmeans_partials_int8) against its plain version at
    SHAPES on separated blobs drawn from ``gen``: sums and counts equal,
    best_sum within rtol 1e-5 (f32 summation order), all three outputs of a
    rerun bit-equal; the CUDA launches of one call (counted in a captured
    CUDA graph).  Returns K1's row of the kernels line: the main path's
    (N, D, K), with the k = 1000 time, plain time and bound beside it."""
    import torch

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils.timing import cuda_ms

    row: dict = {}
    for n, d, k in SHAPES:
        x, centers = blobs(n, d, k, gen, dev)
        q, scale = C.quantize_to_int8(x, x.abs().amax(0))
        del x
        args = (q, *KM._quantize_centroids(centers, scale), scale)
        s1, n1, b1 = KK.kmeans_partials_int8(*args)
        s2, n2, b2 = KK.kmeans_partials_int8_plain(*args)
        s3, n3, b3 = KK.kmeans_partials_int8(*args)
        torch.cuda.synchronize()
        if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
            fail(f"K1 sums/counts differ from the plain version at "
                 f"n={n} d={d} k={k}")
        rel = abs(float(b1) - float(b2)) / max(abs(float(b2)), 1e-30)
        if rel > 1e-5:
            fail(f"K1 best_sum rel err {rel} > 1e-5 at n={n} d={d} k={k}")
        if not (torch.equal(s1, s3) and torch.equal(n1, n3)
                and torch.equal(b1, b3)):
            fail(f"K1 reruns differ at n={n} d={d} k={k}")
        err = float((s1 - s2).abs().max())
        ms = cuda_ms(lambda: KK.kmeans_partials_int8(*args), reps=20)
        plain = cuda_ms(lambda: KK.kmeans_partials_int8_plain(*args),
                        reps=3, warmup=1)
        n_cuda = kernel_launches(lambda: KK.kmeans_partials_int8(*args))
        b_ms, b_by = k12_bound_ms(n, d, k, True)
        p = KK.plan("kmeans_partials_int8", dev, n, d, k)
        print(f"K1 n={n} d={d} k={k}: equal sums/counts, best_sum rel err "
              f"{rel:.2e}, reruns bit-equal; kernel {ms:.4f} ms "
              f"({n_cuda} CUDA launch(es) a call, counted in a CUDA graph; "
              f"{'fused' if p.fused else 'two-pass'}, {p.tile_rows}-point "
              f"tiles), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) "
              f"[{card}]")
        if (n, d, k) == (N, D, K):
            row.update({"max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "cuda_launches": n_cuda})
        elif (n, d) == (N, D):
            row.update({f"ms_k{k}": ms, f"plain_ms_k{k}": plain,
                        f"bound_ms_k{k}": b_ms, f"cuda_launches_k{k}": n_cuda})
        del q, args, s1, s2, s3
    return row


def k2_phase(dev, card: str, gen) -> dict:
    """Phase 3: K2 (kmeans_partials) against its plain version at SHAPES on
    separated blobs drawn from ``gen``: counts equal, sums within 1e-5 *
    max|x| * max count and inertia within 1e-5 * sum|x|^2 (f32 summation
    order), reruns bit-equal; the CUDA launches of one call (counted in a
    captured CUDA graph) and, at 1M x 300, the port's default f32 path
    models.kmeans._partials_block (torch.matmul) timed beside it.  Returns
    K2's row of the kernels line: the main path's (N, D, K), with the k =
    1000 numbers and both yardstick times beside it."""
    import torch

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.utils.timing import cuda_ms

    row: dict = {}
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
        n_cuda = kernel_launches(lambda: KK.kmeans_partials(x, centers))
        b_ms, b_by = k12_bound_ms(n, d, k, False)
        p = KK.plan("kmeans_partials", dev, n, d, k)
        line = (f"K2 n={n} d={d} k={k}: equal counts, sums max err "
                f"{err:.3e} (tol {tol:.3e}), inertia err {ierr:.3e} (tol "
                f"{1e-5 * x2:.3e}), reruns bit-equal; kernel {ms:.4f} ms "
                f"({n_cuda} CUDA launch(es) a call, counted in a CUDA graph; "
                f"{'fused' if p.fused else 'two-pass'}, {p.tile_rows}-point "
                f"tiles), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
        if n == N:
            c2 = (centers ** 2).sum(-1)
            yard = cuda_ms(lambda: KM._partials_block(x, centers, c2),
                           reps=5, warmup=1)
            line += (f"; yardstick: the port's default f32 path "
                     f"_partials_block (torch.matmul; not one library "
                     f"call) {yard:.4f} ms")
        print(line + f" [{card}]")
        if (n, d, k) == (N, D, K):
            row.update({"max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "cuda_launches": n_cuda, "yardstick_ms": yard})
        elif (n, d) == (N, D):
            row.update({f"ms_k{k}": ms, f"plain_ms_k{k}": plain,
                        f"bound_ms_k{k}": b_ms, f"cuda_launches_k{k}": n_cuda,
                        f"yardstick_ms_k{k}": yard})
        del x, s1, s2, s3
    return row


def kmeans_profile(dev, card: str) -> None:
    """torch.profiler over the int8 benchmark's timed window (ITERS Lloyd
    iterations of kmeans_step at N x D, k = K, one readback at the end):
    the device's busy and idle share and the top kernels, printed only
    when the trace holds every K1 launch that its count saw."""
    import torch

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils.timing import device_sync

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pts = torch.randn((N, D), generator=gen, device=dev)
    q = C.quantize_to_int8(pts, pts.abs().amax(0))
    del pts
    x2 = KM._hoisted_x2(q)
    cfg = KM.KMeansConfig(k=K, iters=1, quantize="int8")
    c0 = torch.randn((K, D), generator=gen, device=dev)

    def window():
        c, inertia = c0, None
        for _ in range(ITERS):
            c, inertia = KM.kmeans_step(q, c, cfg, x2=x2)
        device_sync(inertia)

    window()
    t0 = time.perf_counter()
    window()
    bare = time.perf_counter() - t0
    profile_run(window, card, "KMeans int8", f"benchmark window ({ITERS} "
                f"iterations at {N} x {D}, k={K})", bare,
                count=(KK.LAUNCHES, "kmeans_partials_int8", "main_kernel"))


def mfsgd_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 6-8; returns K3's row of the kernels line and its launches on
    the MF-SGD main path."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import mfsgd_kernel as K3

    # -- 7's model, whose partition phase 6 shares ----------------------------
    cfg = MF.MFSGDConfig(rank=ML_RANK, algo="pallas")
    model = MF.MFSGD(ML_USERS, ML_ITEMS, cfg, seed=0)
    u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, ML_NNZ, seed=0)
    t0 = time.perf_counter()
    model.set_ratings(u, i, v)
    prep = time.perf_counter() - t0
    del u, i, v

    # -- 6. K3 against its plain version ----------------------------------------
    row = k3_phase(dev, card, model)
    print(f"cut: phase 6 took the step from phase 7's set_ratings ({prep:.1f}"
          " s), not a partition of its own")

    # -- 7. MF-SGD through the public entry -----------------------------------
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
    BENCH_ROWS["MF-SGD pallas"] = ("mfsgd_pallas", out)
    if not (np.isfinite(out["rmse_final"])
            and out["rmse_final"] < out["rmse_first_epoch"]):
        fail(f"MF-SGD benchmark: RMSE not finite and falling: {out}")
    print(f"MFSGD benchmark pallas: {out['updates_per_sec_per_chip']:.6e} "
          f"updates/s per card, {out['sec_per_epoch']:.6f} s/epoch, rmse "
          f"{out['rmse_first_epoch']:.6f} -> {out['rmse_final']:.6f}, prep "
          f"{out['prep_sec']:.1f} s; K3 {row['ms']:.4f} ms/call x 2 calls "
          f"an epoch [{card}]")
    # the CLI at the durable runs' 2M ratings: the width is the same, and
    # the benchmark above already times the 20M-rating epoch
    crow = run_cli("mfsgd", "--algo", "pallas", "--epochs", str(EPOCHS),
                   "--nnz", str(DUR_ML_NNZ))
    if not np.isfinite(crow["rmse_final"]):
        fail(f"MF-SGD CLI row is not finite: {crow}")
    return row, launches


def traced_launches(prof, name: str, launched: int, wall: float
                    ) -> tuple[list, str | None]:
    """The device events of the kernel ``name`` in the torch.profiler trace
    ``prof``, and None when they are all ``launched`` launches; else what
    the trace holds (the profiler can drop device records), with where the
    held ones lie in the window of ``wall`` seconds."""
    import torch

    ev = [e for e in prof.events()
          if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
          and name in e.name]
    if len(ev) == launched:
        return ev, None
    where = (f", the held ones from {min(e.time_range.start for e in ev):.1f}"
             f" to {max(e.time_range.end for e in ev):.1f} us" if ev else "")
    return ev, (f"the trace holds {len(ev)} of the {launched} {name} "
                f"launches{where} of a {wall * 1e6:.1f} us window")


def k4_split(step, card: str) -> None:
    """Where one call of ``step`` (a K4 rotation step) spends its time on
    the card, from torch.profiler's device events: K4's launches, their
    summed kernel time, and the span from the first kernel's start to the
    last one's end; span - kernel time is the time between launches.  The
    split is printed only when the trace holds every launch that K4's
    count saw, since the profiler can drop device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harp_tpu_torch.ops import lda_kernel as K4

    torch.cuda.synchronize()
    before = K4.LAUNCHES["cgs_entry_update"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev, missed = traced_launches(
        prof, "step_kernel", K4.LAUNCHES["cgs_entry_update"] - before, wall)
    if missed:
        print(f"K4 trace of one step: {missed}; split not measured")
        return
    busy = sum(e.time_range.end - e.time_range.start for e in ev) / 1e3
    span = (max(e.time_range.end for e in ev)
            - min(e.time_range.start for e in ev)) / 1e3
    print(f"K4 trace of one step: {len(ev)} kernel launch(es), kernel time "
          f"{busy:.4f} ms, span {span:.4f} ms, profiled wall "
          f"{wall * 1e3:.4f} ms [{card}]")


def k4_phase(dev, card: str) -> dict:
    """Phase 9: K4 against its plain version at the LDA benchmark width
    (the first entries of a rotation step; the whole step timed); returns
    K4's row of the kernels line, whose ``plain_ms`` is the plain version's
    on ``plain_entries`` entries, beside the kernel's there
    (``ms_plain_entries``)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.utils.timing import cuda_ms

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
    chunks = plan.chunks
    print(f"K4 prep: {time.perf_counter() - t0:.1f} s; one step: {ne} "
          f"entries x {c} slots, {work['tokens']} tokens, cc {cc} (count "
          f"bounds {model._count_bounds}), {chunks} chunks, Ndk "
          f"{tuple(Ndk.shape)}, word chunk {tuple(Nwk.shape)}")
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
    # the plain version takes 105-155 s for the whole step: it is held to
    # K4 on the step's first entries that span K4_PLAIN_CHUNKS chunks (every
    # grid barrier of the kernel runs there), f32 and int16 Ndk
    n_pre = min(int(np.searchsorted(np.cumsum(plan.n_chunks),
                                    K4_PLAIN_CHUNKS)) + 1, ne)
    pre = [a[:n_pre] for a in full]
    pre_plan = K4.EntryPlan(plan.n_chunks[:n_pre].copy(), cc, plan.d_rows,
                            plan.w_rows)
    pa = [Ndk.clone(), Nwk.clone(), z0[:n_pre].clone()]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    d2 = K4.cgs_step_plain(pa[0], pa[1], Nk, pa[2], *pre,
                           seeds=seeds[:n_pre], **kw)
    end.record()
    end.synchronize()
    plain = start.elapsed_time(end)
    for dt in (torch.float32, torch.int16):
        kb = [Ndk.to(dt, copy=True), Nwk.clone(), z0[:n_pre].clone()]
        d1 = K4.cgs_step(kb[0], kb[1], Nk, kb[2], *pre, seeds=seeds[:n_pre],
                         plan=pre_plan, **kw)
        for a, b in zip(kb + [d1], pa + [d2]):
            err = max(err, float((a.float() - b.float()).abs().max()))
            if not torch.equal(a.float(), b.float()):
                fail(f"K4 (Philox arm, {dt}) differs from its plain version "
                     f"on the first {n_pre} entries of a rotation step")
    del pa, kb
    ms_pre = cuda_ms(lambda: K4.cgs_step(
        Ndk.clone(), Nwk.clone(), Nk, z0[:n_pre].clone(), *pre,
        seeds=seeds[:n_pre], plan=pre_plan, **kw), reps=3, warmup=1)
    ka = [Ndk.clone(), Nwk.clone(), z0.clone()]

    def step():
        return K4.cgs_step(ka[0], ka[1], Nk, ka[2], *full, seeds=seeds,
                           plan=plan, **kw)

    before = K4.LAUNCHES["cgs_entry_update"]
    ms = cuda_ms(step, reps=3, warmup=1)
    per_step = (K4.LAUNCHES["cgs_entry_update"] - before) / 4
    k4_split(step, card)
    b_ms, b_by = k4_bound_ms(work, Ndk.numel() * 4, Nwk.numel() * 4,
                             LDA_TOPICS)
    print(f"K4 Philox arm: bit-equal to the plain version on the first "
          f"{n_pre} entries ({K4_PLAIN_CHUNKS}+ of the step's {chunks} "
          f"chunks), f32 and int16 Ndk: plain {plain:.4f} ms, kernel "
          f"{ms_pre:.4f} ms there; the whole step: kernel {ms:.4f} ms/step "
          f"({per_step:g} K4 launches a step over 4 steps; "
          f"{ms * 1e3 / chunks:.3f} us a chunk), bound {b_ms:.4f} ms "
          f"({b_by}); first {n_sub} entries with injected uniforms: kernel "
          f"{ms_sub:.4f} ms, plain {plain_sub:.4f} ms [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "plain_entries": n_pre, "ms_plain_entries": ms_pre,
            "bound_ms": b_ms, "bound_by": b_by}


def lda_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 9-14; returns K4's row of the kernels line and its launches
    on the LDA main path (phase 12's benchmark)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.ops import lda_kernel as K4

    # -- 9. K4 against its plain version, one rotation step ------------------
    row = k4_phase(dev, card)
    cfg = LD.LDAConfig(n_topics=LDA_TOPICS, algo="pallas")

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
    BENCH_ROWS["LDA pallas"] = ("lda_pallas", out)
    if launches != 2 * (1 + LDA_EPOCHS):
        fail(f"LDA benchmark: K4 launches {launches}, expected 2 per epoch")
    if not np.isfinite(out["log_likelihood"]):
        fail(f"LDA benchmark: non-finite log-likelihood: {out}")
    print(f"LDA benchmark pallas: {out['tokens_per_sec_per_chip']:.6e} "
          f"tokens/s per card, {out['sec_per_epoch']:.6f} s/epoch, "
          f"log-likelihood {out['log_likelihood']:.6f}, prep "
          f"{out['prep_sec']:.1f} s; K4 {row['ms']:.4f} ms/step x 2 steps an "
          f"epoch, {launches} calls [{card}]")
    crow = run_cli("lda", "--algo", "pallas")
    if not np.isfinite(crow["log_likelihood"]):
        fail(f"LDA CLI row is not finite: {crow}")

    # -- 13. profile one sweep ------------------------------------------------
    model = LD.LDA(LDA_DOCS, LDA_VOCAB, cfg, seed=1)
    model.set_tokens(*LD.benchmark_corpus(LDA_DOCS, LDA_VOCAB, LDA_TPD, 0))
    model.sample_epoch()
    t0 = time.perf_counter()
    model.sample_epoch()
    bare = time.perf_counter() - t0
    profile_epoch(model, card, "LDA", "sample_epoch", bare,
                  (K4.LAUNCHES, "cgs_entry_update", "step_kernel"))
    del model

    # -- 14. enwiki-1M on this card -------------------------------------------
    if out["sec_per_epoch"] >= 3.0:
        print(f"LDA enwiki-1M skipped: the benchmark epoch took "
              f"{out['sec_per_epoch']:.3f} s (>= 3 s)")
        return row, launches
    torch.cuda.reset_peak_memory_stats()
    t_cut = time.perf_counter()
    big = LD.LDA(ENWIKI_SWEEP_DOCS, LDA_VOCAB, LD.LDAConfig(
        n_topics=LDA_TOPICS, algo="pallas", ndk_dtype="int16"), seed=0)
    corpus = LD.benchmark_corpus(ENWIKI_SWEEP_DOCS, LDA_VOCAB, LDA_TPD, 0)
    t0 = time.perf_counter()
    big.set_tokens(*corpus)
    prep = time.perf_counter() - t0
    del corpus
    t0 = time.perf_counter()
    big.sample_epoch()
    sweep = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_tok = ENWIKI_SWEEP_DOCS * LDA_TPD
    # exact sums in row blocks: a whole-table int64 copy would be 2 GB
    ndk_sum = sum(int(b.sum(dtype=torch.int64))
                  for b in big.Ndk.split(1 << 16))
    nwk_sum = int(big.Nwk.sum(dtype=torch.float64))
    ok = (ndk_sum == nwk_sum == big.n_tokens == n_tok
          and torch.equal(big.Nwk.sum(0), big.Nk)
          and int(big.Ndk.min()) >= 0 and float(big.Nwk.min()) >= 0)
    if not ok:
        fail(f"LDA enwiki-1M: invariants broken (Ndk sum {ndk_sum}, Nwk sum "
             f"{nwk_sum}, tokens {n_tok})")
    print(f"LDA enwiki-1M width ({ENWIKI_SWEEP_DOCS} of its "
          f"{ENWIKI_DOCS} docs x {LDA_VOCAB} words, {LDA_TOPICS} topics, "
          f"{n_tok} tokens, int16 Ndk {tuple(big.Ndk.shape)}): prep "
          f"{prep:.1f} s, one sample_epoch {sweep:.3f} s "
          f"({n_tok / sweep:.6e} tokens/s), cc {big.cc}, peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (set_tokens and the sweep), "
          f"invariants hold [{card}]")
    print(f"cut: the enwiki sweep at {ENWIKI_SWEEP_DOCS} docs took "
          f"{time.perf_counter() - t_cut:.1f} s")
    return row, launches


def k5_phase(dev, card: str) -> dict:
    """Phase 15: K5 against its plain version at 500,256 x 128, f32 and
    bf16 x; returns K5's row of the kernels line (f32, the main path's)."""
    import torch

    from harp_tpu_torch.ops import svm_kernel as K5
    from harp_tpu_torch.utils.timing import cuda_ms

    n, d = SVM_N + SVM_K, SVM_D  # a round's rows: the shard + the SV rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    # x on a grid of 1/32 in [-4, 4) and w of 2^-9 in (-0.5, 0.5): every
    # product is a multiple of 2^-14 below 2 and every margin below 2^8, so
    # each margin is exact in f32 whatever the order of its sum; so gs must
    # be equal, and gw, a sum over 500k rows, keeps the f32-order tolerance.
    # bf16 holds both grids exactly, so the bf16 arm takes w off its grid by
    # a factor 1 + e, |e| < 2^-10: below half a bf16 step, so bf16(w) is the
    # grid w and the margins stay exact only if K5 rounds w as it must.
    # coef is 0 or +-1 here, as on the main path, so its bf16 rounding is a
    # no-op; the card tests check that rounding with fractional weights.
    x32 = (torch.randn((n, d), generator=gen, device=dev) * 32).round().clamp(
        -128, 127) / 32
    y = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    sw = torch.ones(n, device=dev)
    sw[SVM_N:] = (torch.rand(SVM_K, generator=gen, device=dev) < 0.5).to(
        torch.float32)  # the SV rows' candidate mask
    w = (torch.randn(d, generator=gen, device=dev) * (2.0 / d ** 0.5)
         * 512).round().clamp(-255, 255) / 512
    b = torch.tensor(0.125, device=dev)
    w_off = w * (1 + (torch.rand(d, generator=gen, device=dev) - 0.5) / 512)
    if not (bool(torch.equal(w_off.to(torch.bfloat16).float(), w))
            and int((w_off != w).sum()) > d // 2):
        fail("K5 bf16: the off-grid w does not round back to the grid")
    row, done = None, []
    for xdt in (torch.float32, torch.bfloat16):
        x = x32.to(xdt)
        args = (w if xdt == torch.float32 else w_off, b, x, y, sw)
        gw1, gs1 = K5.pegasos_grad(*args)
        gw2, gs2 = K5.pegasos_grad_plain(*args)
        gw3, gs3 = K5.pegasos_grad(*args)
        torch.cuda.synchronize()
        err = float((gw1 - gw2).abs().max())
        tol = 1e-5 * (sw @ x.to(torch.float32).abs()) + 1e-6
        if float(gs1) != float(gs2):
            fail(f"K5 {xdt}: gs {float(gs1)} != plain {float(gs2)}")
        if not bool(((gw1 - gw2).abs() <= tol).all()):
            fail(f"K5 {xdt}: gw err {err} above 1e-5 * sum sw |x|")
        if not (torch.equal(gw1, gw3) and torch.equal(gs1, gs3)):
            fail(f"K5 {xdt}: reruns differ")
        ms = cuda_ms(lambda: K5.pegasos_grad(*args), reps=50, warmup=3)
        plain = cuda_ms(lambda: K5.pegasos_grad_plain(*args), reps=10,
                        warmup=2)
        b_ms, b_by = k5_bound_ms(n, d, x.element_size())
        done.append((xdt, args, float(gs1), err, float(tol.min()), ms, plain,
                     b_ms, b_by))
        if xdt == torch.float32:  # the main path's x
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by}
        del gw1, gw2, gw3
    # the launches of one call, traced after both arms are timed
    for xdt, args, gs, err, tol, ms, plain, b_ms, b_by in done:
        n_cuda = kernel_launches(lambda: K5.pegasos_grad(*args))
        print(f"K5 {str(xdt).removeprefix('torch.')} at {n} x {d}: gs "
              f"{gs:.0f} equal, gw max err {err:.3e} (tol >= {tol:.3e}), "
              f"reruns bit-equal; kernel {ms:.4f} ms ({n_cuda} CUDA "
              f"launch(es) a call, counted in a CUDA graph), plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
    del x32, done
    return row


def svm_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 15-16; returns K5's row of the kernels line and its launches
    on the SVM main path (one SVM.fit)."""
    import numpy as np

    from harp_tpu_torch.models import svm as SV
    from harp_tpu_torch.ops import svm_kernel as K5

    # -- 15. K5 against its plain version ----------------------------------
    row = k5_phase(dev, card)

    # -- 16. SVM through the public entry ----------------------------------
    x, yh = SV.synthetic_data(SVM_N, SVM_D, seed=0)
    K5.reset_launches()  # the SVM main path's run starts here
    t0 = time.perf_counter()
    model = SV.SVM(SV.SVMConfig(algo="pallas")).fit(x, yh)
    wall = time.perf_counter() - t0
    launches = K5.LAUNCHES["pegasos_grad"]  # ... and ends here
    acc = model.accuracy(x[:50_000], yh[:50_000])
    if launches != 1000:
        fail(f"SVM fit: K5 launches {launches}, expected 200 x 5 = 1000")
    if not (np.isfinite(model.w).all() and acc > SVM_ACC_FLOOR):
        fail(f"SVM fit: train_acc {acc} (floor {SVM_ACC_FLOOR}) or w not "
             "finite")
    print(f"SVM fit pallas at {SVM_N} x {SVM_D}: {wall:.3f} s incl. H2D, "
          f"train_acc {acc:.4f} on 50k rows (floor {SVM_ACC_FLOOR}), K5 "
          f"launches {launches} [{card}]")
    profile_run(lambda: model.fit(x, yh), card, "SVM", "fit",
                count=(K5.LAUNCHES, "pegasos_grad", "rows_kernel"))
    xs, ys = SV.synthetic_data(2000, 16, seed=3)
    for algo in ("xla", "pallas"):
        for wire in ("exact", "bf16", "int8"):
            cfg = SV.SVMConfig(algo=algo, sv_wire=wire, inner_steps=100,
                               outer_rounds=3, sv_per_worker=64)
            g = SV.SVM(cfg).fit(xs, ys)
            c = SV.SVM(cfg, device="cpu").fit(xs, ys)
            if not (np.allclose(g.w, c.w, rtol=1e-3, atol=1e-5)
                    and np.allclose(g.b, c.b, rtol=1e-3, atol=1e-6)):
                fail(f"SVM {algo} {wire}: the card and the CPU disagree on "
                     f"a small input (b {g.b} vs {c.b})")
    print("SVM: card and CPU agree on 2000 x 16 for xla and pallas on the "
          "exact, bf16 and int8 wires (w and b rtol 1e-3)")
    out = SV.benchmark(SVM_N, SVM_D, algo="pallas")
    if not out["train_acc"] > SVM_ACC_FLOOR:
        fail(f"SVM benchmark: train_acc {out['train_acc']}")
    print(f"SVM benchmark pallas: {out['samples_per_sec']:.6e} samples/s, "
          f"fit_sec {out['fit_sec']:.6f}, train_acc {out['train_acc']:.4f}; "
          f"K5 {row['ms']:.4f} ms/call x 1000 calls a fit [{card}]")
    crow = run_cli("svm", "--algo", "pallas")
    if not crow["train_acc"] > SVM_ACC_FLOOR:
        fail(f"SVM CLI: train_acc {crow['train_acc']}")
    return row, launches


def k6_phase(dev, card: str) -> dict:
    """Phase 17: K6 against its plain version at n = 4096, dim 3, f32 and
    bf16 delta, and at a ragged n = 4099; returns K6's row of the kernels
    line (f32 delta at n = 4096, the main path's)."""
    import torch

    from harp_tpu_torch.models import wdamds as WD
    from harp_tpu_torch.ops import wdamds_kernel as K6
    from harp_tpu_torch.utils.timing import cuda_ms, graph_ms

    row = None
    for N, ddt in ((MDS_N, torch.float32), (MDS_N, torch.bfloat16),
                   (MDS_N + 3, torch.float32)):
        delta = torch.from_numpy(WD.benchmark_delta(N, 0)).to(dev, ddt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(N)
        X = torch.randn((N, MDS_DIM), generator=gen, device=dev)
        rm = torch.ones(N, device=dev)
        args = (delta, rm, X, X, float(N))
        a = K6.smacof_bx(*args, eps=1e-9)
        p = K6.smacof_bx_plain(*args, eps=1e-9)
        a2 = K6.smacof_bx(*args, eps=1e-9)
        torch.cuda.synchronize()
        err = float((a - p).abs().max())
        if not bool(((a - p).abs() <= 1e-5 + 1e-4 * p.abs()).all()):
            fail(f"K6 N={N} {ddt}: err {err} above rtol 1e-4 / atol 1e-5")
        if not torch.equal(a, a2):
            fail(f"K6 N={N} {ddt}: reruns differ")
        # ms: back-to-back wrapper calls, what a call costs on the main
        # path; graph: the kernel alone, replayed from a CUDA graph (the
        # host launches a call more slowly than the kernel runs)
        ms = cuda_ms(lambda: K6.smacof_bx(*args, eps=1e-9), reps=50,
                     warmup=3)
        graph = graph_ms(lambda: K6.smacof_bx(*args, eps=1e-9), reps=20)
        plain = cuda_ms(lambda: K6.smacof_bx_plain(*args, eps=1e-9), reps=10,
                        warmup=2)
        b_ms, b_by = k6_bound_ms(N, N, MDS_DIM, delta.element_size())
        name = str(ddt).removeprefix("torch.")
        print(f"K6 N={N} dim {MDS_DIM} delta {name}: max err {err:.3e}, "
              f"reruns bit-equal; kernel {ms:.4f} ms (from a CUDA graph "
              f"{graph:.4f} ms), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}) [{card}]")
        if (N, ddt) == (MDS_N, torch.float32):  # the main path's shapes
            row = {"max_abs_err": err, "ms": ms, "graph_ms": graph,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        del delta, a, p, a2
    return row


def mds_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 17-18; returns K6's row of the kernels line and its launches
    on the WDA-MDS main path (one mds)."""
    import numpy as np

    from harp_tpu_torch.models import wdamds as WD
    from harp_tpu_torch.ops import wdamds_kernel as K6

    row = k6_phase(dev, card)

    # -- 18. WDA-MDS through the public entry -------------------------------
    delta = WD.benchmark_delta(MDS_N, 0)
    cfg = WD.MDSConfig(dim=MDS_DIM, iters=MDS_ITERS, algo="pallas")
    _, one = WD.mds(delta, WD.MDSConfig(dim=MDS_DIM, iters=1, algo="pallas"))
    K6.reset_launches()  # the WDA-MDS main path's run starts here
    t0 = time.perf_counter()
    X, stress = WD.mds(delta, cfg)
    wall = time.perf_counter() - t0
    launches = K6.LAUNCHES["smacof_bx"]  # ... and ends here
    if launches != MDS_ITERS:
        fail(f"mds: K6 launches {launches}, expected {MDS_ITERS}")
    if not (np.isfinite(stress) and np.isfinite(X).all() and stress < one):
        fail(f"mds: stress {stress} not finite and below one iteration's "
             f"{one}")
    print(f"WDA-MDS mds pallas n={MDS_N} dim {MDS_DIM}: stress {stress:.6e} "
          f"after {MDS_ITERS} iterations ({one:.6e} after one), {wall:.3f} s "
          f"incl. H2D, K6 launches {launches} [{card}]")
    profile_run(lambda: WD.mds(delta, cfg), card, "WDA-MDS", "mds",
                count=(K6.LAUNCHES, "smacof_bx", "bx_kernel"))
    small = WD.benchmark_delta(200, 1)
    for algo in ("xla", "pallas"):
        c = WD.MDSConfig(dim=MDS_DIM, iters=MDS_ITERS, algo=algo)
        sg = WD.mds(small, c)[1]
        sc = WD.mds(small, c, device="cpu")[1]
        if not abs(sg - sc) <= 1e-3 * abs(sc):
            fail(f"mds {algo}: the card's stress {sg} vs the CPU's {sc}")
    print("WDA-MDS: card and CPU agree on n=200 for xla and pallas (stress "
          "rtol 1e-3)")
    out = WD.benchmark(MDS_N, algo="pallas")
    if not np.isfinite(out["final_stress"]):
        fail(f"mds benchmark: stress {out['final_stress']}")
    print(f"WDA-MDS benchmark pallas: {out['iters_per_sec']:.6e} iters/s, "
          f"sec_total {out['sec_total']:.6f}, final_stress "
          f"{out['final_stress']:.6e}; K6 {row['ms']:.4f} ms/call x "
          f"{MDS_ITERS} [{card}]")
    run_cli("wdamds", "--algo", "pallas")
    return row, launches


def k7_phase(dev, card: str) -> dict:
    """Phase 19: K7 against its plain version at every level 0-5 of a real
    32-tree 200k x 64 fit; returns K7's row of the kernels line (sums over
    the six levels)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import rf as RF
    from harp_tpu_torch.ops import rf_kernel as K7
    from harp_tpu_torch.utils.timing import cuda_ms, graph_ms

    # -- 19. K7 against its plain version, every level of a real fit -------
    cfg = RF.RFConfig(n_trees=RF_TREES, max_depth=RF_DEPTH,
                      hist_algo="pallas")
    x, yh = RF.synthetic_classification(RF_N, RF_F, seed=0)
    edges = RF.quantile_bins(x, cfg.n_bins)
    bins = torch.from_numpy(RF.binize_chunked(x, edges).astype(np.uint8)).to(
        dev)
    y = torch.from_numpy(yh.astype(np.int64)).to(dev)
    weights, feat_mask = RF.tree_draws(cfg, RF_N, RF_F, range(RF_TREES), dev)
    w_i32 = weights.clamp(0, 127).to(torch.int32)
    nnz = int((w_i32 != 0).sum())
    node = torch.zeros((RF_TREES, RF_N), dtype=torch.int64, device=dev)
    C_, B = cfg.n_classes, cfg.n_bins
    tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0}
    for level in range(RF_DEPTH):
        R = 2 ** level * C_
        rc = (node * C_ + y[None, :]).to(torch.int32)
        h1 = K7.hist_bins(bins, rc, w_i32, R, B)
        h2 = K7.hist_bins_plain(bins, rc, w_i32, R, B)
        h3 = K7.hist_bins(bins.to(torch.int32), rc, w_i32, R, B)
        torch.cuda.synchronize()
        if not (torch.equal(h1, h2) and torch.equal(h3, h2)
                and torch.equal(h1, K7.hist_bins(bins, rc, w_i32, R, B))):
            fail(f"K7 level {level}: uint8 or int32 bins differ from the "
                 f"plain version, or a rerun differs")
        ms = cuda_ms(lambda: K7.hist_bins(bins, rc, w_i32, R, B), reps=10,
                     warmup=2)
        graph = graph_ms(lambda: K7.hist_bins(bins, rc, w_i32, R, B), reps=5,
                         replays=2)
        plain = cuda_ms(lambda: K7.hist_bins_plain(bins, rc, w_i32, R, B),
                        reps=2, warmup=1)
        # the library yardstick: the same weighted cells in one bincount
        # over a flat (tree, row code, feature, bin) index built untimed
        cols = (torch.arange(RF_F, device=dev)[None, :] * B
                + bins.to(torch.int64))
        flat = ((torch.arange(RF_TREES, device=dev)[:, None, None] * R
                 + rc.to(torch.int64)[:, :, None]) * (RF_F * B)
                + cols[None]).reshape(-1)
        wf = w_i32.to(torch.float32)[:, :, None].expand(
            RF_TREES, RF_N, RF_F).reshape(-1)
        lib_h = torch.bincount(flat, weights=wf,
                               minlength=RF_TREES * R * RF_F * B)
        if not torch.equal(lib_h.to(torch.int32).reshape(h1.shape), h1):
            fail(f"K7 level {level}: torch.bincount gives other counts")
        lib = cuda_ms(lambda: torch.bincount(
            flat, weights=wf, minlength=RF_TREES * R * RF_F * B), reps=3,
            warmup=1)
        del flat, wf, lib_h
        b_ms, b_by = k7_bound_ms(RF_N, RF_F, RF_TREES, R, B, nnz,
                                 bins.element_size())
        for k, v in (("ms", ms), ("graph_ms", graph), ("plain_ms", plain),
                     ("library_ms", lib), ("bound_ms", b_ms)):
            tot[k] += v
        print(f"K7 level {level} (R={R}): uint8 and int32 bins bit-equal "
              f"to the plain version, reruns bit-equal; kernel {ms:.4f} ms "
              f"(from a CUDA graph {graph:.4f} ms), plain {plain:.4f} ms, "
              f"torch.bincount "
              f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if level + 1 < RF_DEPTH:
            node = RF._grow_level(bins, y, weights, node, level, feat_mask,
                                  cfg)[2]
        del h1, h2, h3
    row = {"max_abs_err": 0.0, "ms": tot["ms"], "graph_ms": tot["graph_ms"],
           "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
           "bound_by": b_by, "library_ms": tot["library_ms"]}
    print(f"K7 over levels 0-{RF_DEPTH - 1} (one launch each, {nnz} "
          f"nonzero (tree, sample) weights): kernel {row['ms']:.4f} ms "
          f"(from a CUDA graph {row['graph_ms']:.4f} ms), "
          f"plain {row['plain_ms']:.4f} ms, torch.bincount "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}) [{card}]")
    del bins, y, weights, feat_mask, w_i32, node
    return row


def rf_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 19-20; returns K7's row of the kernels line and its launches
    on the RF main path (one RandomForest.fit)."""
    import numpy as np

    from harp_tpu_torch.models import rf as RF
    from harp_tpu_torch.ops import rf_kernel as K7

    row = k7_phase(dev, card)
    cfg = RF.RFConfig(n_trees=RF_TREES, max_depth=RF_DEPTH,
                      hist_algo="pallas")
    x, yh = RF.synthetic_classification(RF_N, RF_F, seed=0)

    # -- 20. RF through the public entry ------------------------------------
    K7.reset_launches()  # the RF main path's run starts here
    t0 = time.perf_counter()
    model = RF.RandomForest(cfg).fit(x, yh)
    wall = time.perf_counter() - t0
    launches = K7.LAUNCHES["hist_bins"]  # ... and ends here
    if launches != RF_DEPTH:
        fail(f"RF fit: K7 launches {launches}, expected one per level")
    dense = RF.RandomForest(RF.RFConfig(n_trees=RF_TREES, max_depth=RF_DEPTH,
                                        hist_algo="dense")).fit(x, yh)
    if not all(np.array_equal(a, b) for a, b in zip(model.forest,
                                                    dense.forest)):
        fail("RF: the pallas forest differs from the dense arm's")
    acc = model.accuracy(x[:20_000], yh[:20_000])
    if not acc > RF_ACC_FLOOR:
        fail(f"RF fit: train_acc {acc} (floor {RF_ACC_FLOOR})")
    print(f"RF fit pallas at {RF_N} x {RF_F}, {RF_TREES} trees, depth "
          f"{RF_DEPTH}: {wall:.3f} s incl. host binning, forest bit-equal "
          f"to the dense arm's, train_acc {acc:.4f} on 20k rows (floor "
          f"{RF_ACC_FLOOR}), K7 launches {launches} [{card}]")
    profile_run(lambda: model.fit(x, yh), card, "RF", "fit",
                count=(K7.LAUNCHES, "hist_bins", "hist_kernel"))
    out = RF.benchmark(RF_N, RF_F, RF_TREES, RF_DEPTH, hist_algo="pallas")
    if not out["train_acc"] > RF_ACC_FLOOR:
        fail(f"RF benchmark: train_acc {out['train_acc']}")
    print(f"RF benchmark pallas: {out['trees_per_sec']:.6e} trees/s, fit_sec "
          f"{out['fit_sec']:.6f}, predict_sec_20k "
          f"{out['predict_sec_20k']:.6f}, train_acc {out['train_acc']:.4f}; "
          f"K7 {row['ms']:.4f} ms over the {RF_DEPTH} launches a fit "
          f"[{card}]")
    run_cli("rf", "--hist-algo", "pallas")
    return row, launches


def within(a, b, rtol: float, atol: float) -> tuple[bool, float]:
    """(every |a - b| <= atol + rtol·|b|, max |a - b|), in f32."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return bool((err <= atol + rtol * b.abs()).all()), float(err.max())


def k8_faults(q, k, v, kw, ref, tile: int = 64) -> dict:
    """Row-scaled errors (against ``ref``) of K8's plain version with a
    fault of the kernel's kind planted: the p·v product of the key tile at
    N/2 dropped (its V zeroed), and, for a window, the window one tile
    short.  Both fall on the late rows, whose entries are the smallest."""
    from harp_tpu_torch.ops import flash_attention as K8

    n = q.shape[1]
    vz = v.clone()
    vz[:, n // 2:n // 2 + tile] = 0
    out = {"V tile dropped": K8.row_scaled_error(
        K8.flash_attention_plain(q, k, vz, **kw), ref)}
    if kw["window"] is not None:
        short = dict(kw, window=kw["window"] - tile)
        out["window a tile short"] = K8.row_scaled_error(
            K8.flash_attention_plain(q, k, v, **short), ref)
    return out


def k8_phase(dev, card: str, gen) -> dict:
    """Phase 21: K8 against its plain version; returns K8's row of the
    kernels line (the main path's call: f32, causal, window)."""
    import torch
    import torch.nn.functional as Fn

    from harp_tpu_torch.ops import flash_attention as K8
    from harp_tpu_torch.utils.timing import cuda_ms

    h, g, d, win = MIS_HEADS, MIS_KV, MIS_DIM, MIS_WINDOW
    n2, w2 = MIS_SEQ // 4, win // 8
    arms = [  # (name, bh, n, d, dtype, causal, window)
        ("bf16 causal", h, MIS_SEQ, d, torch.bfloat16, True, None),
        (f"bf16 causal w{win}", h, MIS_SEQ, d, torch.bfloat16, True, win),
        ("f32 causal", h, MIS_SEQ, d, torch.float32, True, None),
        (f"f32 causal w{win}", h, MIS_SEQ, d, torch.float32, True, win),
        (f"f32 non-causal w{w2}", h, n2, d, torch.float32, False, w2),
        ("bf16 causal D64", 2 * h, MIS_SEQ // 2, 64, torch.bfloat16, True,
         None)]
    row = None
    for name, bh, n, dd, dtype, causal, window in arms:
        # q [bh, n, dd] and K/V of bh / group heads repeated x group
        group = h // g if bh == h else 1
        q = torch.randn((bh, n, dd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bh // group, n, dd), generator=gen, device=dev)
                .to(dtype).repeat_interleave(group, dim=0) for _ in range(2))
        kw = {"causal": causal, "window": window}
        before = dict(K8.PATH_LAUNCHES)
        o1 = K8.flash_attention(q, k, v, **kw)
        path = ",".join(p for p, n in K8.PATH_LAUNCHES.items()
                        if n > before[p])
        o2 = K8.flash_attention_plain(q, k, v, **kw)
        o3 = K8.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((o1.float() - o2.float()).abs().max())
        if dtype == torch.float32:
            # the reference's own gate for its kernel
            ok, _ = within(o1, o2, 2e-4, 2e-5)
            limit = "rtol 2e-4 / atol 2e-5"
        else:
            # two bf16 steps of each entry's size or of its row's RMS; the
            # planted faults must fail the same test
            rel = K8.row_scaled_error(o1, o2)
            ok = rel <= K8.BF16_ROW_TOL
            faults = k8_faults(q, k, v, kw, o2)
            caught = [f for f, e in faults.items() if e > K8.BF16_ROW_TOL]
            if len(caught) < len(faults):
                fail(f"K8 {name}: a planted fault passes the check: {faults}")
            limit = (f"row-scaled err {rel:.4e} <= {K8.BF16_ROW_TOL}; "
                     "planted faults fail it: " + ", ".join(
                         f"{f} {e:.4e}" for f, e in faults.items()))
        if not ok:
            fail(f"K8 {name}: max err {err}, not within {limit}")
        if not torch.equal(o1, o3):
            fail(f"K8 {name}: reruns differ")
        ms = cuda_ms(lambda: K8.flash_attention(q, k, v, **kw), reps=5,
                     warmup=1)
        plain = cuda_ms(lambda: K8.flash_attention_plain(q, k, v, **kw),
                        reps=2, warmup=1)
        # the library yardstick: one SDPA call on the same tensors
        # ([1, heads, n, d]); the window as an explicit boolean mask
        sq, sk, sv = q[None], k[None], v[None]
        if window is None:
            def sdpa():
                return Fn.scaled_dot_product_attention(sq, sk, sv,
                                                       is_causal=causal)
        else:
            pos = torch.arange(n, device=dev)
            delta = pos[:, None] - pos[None, :]
            mask = ((delta >= 0) & (delta < window) if causal
                    else delta.abs() < window)

            def sdpa():
                return Fn.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask)
        lib_err = float((sdpa()[0].float() - o1.float()).abs().max())
        lib = cuda_ms(sdpa, reps=5, warmup=1)
        b_ms, b_by = k8_bound_ms(bh, n, dd, dtype == torch.bfloat16, causal,
                                 window)
        print(f"K8 {name} [{bh}, {n}, {dd}], path {path}: max err "
              f"{err:.3e} ({limit}), "
              f"reruns bit-equal, SDPA max diff {lib_err:.3e}; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {k8_pairs(n, causal, window)} pairs "
              f"a row [{card}]")
        if name == f"f32 causal w{win}":  # the main path's call
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        del q, k, v, o1, o2, o3, sq, sk, sv
    torch.cuda.empty_cache()
    return row


def attention_phases(dev, card: str) -> tuple[dict, int]:
    """Phases 21-24; returns K8's row of the kernels line and its launches
    on the attention main path (phase 22)."""
    import numpy as np
    import torch

    from harp_tpu_torch.convert import longctx_params_from_numpy, \
        moe_params_from_numpy
    from harp_tpu_torch.examples import longctx_layer as L
    from harp_tpu_torch.ops import flash_attention as K8
    from harp_tpu_torch.ops.a2a_attention import a2a_attention
    from harp_tpu_torch.ops.moe import moe_ffn, reference_moe
    from harp_tpu_torch.ops.ring_attention import ring_attention
    from harp_tpu_torch.ops.rope import apply_rope
    from harp_tpu_torch.parallel.mesh import WorkerMesh

    h, g, d, win = MIS_HEADS, MIS_KV, MIS_DIM, MIS_WINDOW
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    row = k8_phase(dev, card, gen)

    # -- 22. the attention schemes at Mistral width (the K8 main path) -------
    s = MIS_SEQ
    q = torch.randn((1, s, h, d), generator=gen, device=dev)
    k = torch.randn((1, s, g, d), generator=gen, device=dev)
    v = torch.randn((1, s, g, d), generator=gen, device=dev)
    outs, walls, peaks = {}, {}, {}
    K8.reset_launches()  # the attention main path's run starts here
    with torch.no_grad():
        qr, kr = apply_rope(q), apply_rope(k)

        def fold(x):
            return x[0].repeat_interleave(h // x.shape[2], dim=1).permute(
                1, 0, 2).contiguous()

        schemes = {
            "ring": lambda: ring_attention(qr, kr, v, causal=True,
                                           window=win),
            "a2a": lambda: a2a_attention(qr, kr, v, causal=True, window=win,
                                         block_k=s // 16),
            "K8": lambda: K8.flash_attention(
                fold(qr), fold(kr), fold(v), causal=True,
                window=win).permute(1, 0, 2)[None]}
        for name, fn in schemes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = K8.LAUNCHES["flash_attention"]  # ... and ends here
    if launches != 1:
        fail(f"attention main path: K8 launches {launches}, expected 1")
    for name in ("a2a", "K8"):
        ok, err = within(outs[name], outs["ring"], 2e-4, 2e-5)
        if not ok:
            fail(f"{name} disagrees with ring attention: max err {err}")
    if not (bool(torch.isfinite(outs["ring"]).all())
            and outs["K8"].shape == q.shape):
        fail("attention schemes: non-finite or misshapen output")
    print(f"attention at Mistral width (1 x {s} x {h}q/{g}kv x {d}, f32, "
          f"RoPE, causal window {win}): ring, a2a (block_k {s // 16}) and K8 "
          f"agree "
          f"within rtol 2e-4 / atol 2e-5; wall " + ", ".join(
              f"{n_} {walls[n_] * 1e3:.3f} ms (peak {peaks[n_]:.2f} GiB)"
              for n_ in schemes) + f"; K8 launches {launches} [{card}]")
    del q, k, v, qr, kr, outs
    torch.cuda.empty_cache()

    # -- 23. the long-context layer -----------------------------------------
    shape = {"heads": h, "kv_heads": g, "dim": d, "window": win}
    mesh = WorkerMesh(dev)
    params, x, _ = L.init_arrays(MIS_SEQ, h, g, d)
    p = longctx_params_from_numpy(params, dev)
    xs = mesh.shard_array(x, 1)
    del x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwds = []
    with torch.no_grad():
        for _ in range(MIS_FWD_REPS + 1):  # the first one warms up
            t0 = time.perf_counter()
            y = L.layer(p, xs, **shape)
            torch.cuda.synchronize()
            fwds.append(time.perf_counter() - t0)
            if not (bool(torch.isfinite(y).all()) and y.shape == xs.shape):
                fail("long-context layer: forward not finite at seq 8192")
            del y
    fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd = float(np.median(fwds[1:]))
    del xs
    params, x, teacher = L.init_arrays(MIS_TRAIN_SEQ, h, g, d)
    p = longctx_params_from_numpy(params, dev)
    t = longctx_params_from_numpy(teacher, dev)
    xs = mesh.shard_array(x, 1)
    with torch.no_grad():
        target = L.layer(t, xs, **shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(MIS_TRAIN_STEPS):
        t0 = time.perf_counter()
        p_new, loss = L.train_step(p, xs, target, **shape)
        losses.append(float(loss))  # a readback: the step has finished
        times.append(time.perf_counter() - t0)
        upd = [p_new[k_] - p[k_] for k_ in p]
        if not all(bool(torch.isfinite(u).all()) for u in upd):
            fail("long-context layer: non-finite gradient")
        p = p_new
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"long-context layer: losses {losses} not finite and falling")
    profile_run(lambda: L.train_step(p, xs, target, **shape)[1].item(), card,
                "long-context layer", "training step")
    step_s = float(np.median(times[1:]))
    print(f"long-context layer at Mistral width ({h}q/{g}kv x {d}, model "
          f"{h * d}, window {win}): forward at seq {MIS_SEQ}: median "
          f"{fwd:.4f} s of {MIS_FWD_REPS} after a warm-up (min "
          f"{min(fwds[1:]):.4f}, max {max(fwds[1:]):.4f}, warm-up "
          f"{fwds[0]:.4f}), {MIS_SEQ / fwd:.6e} tokens/s, peak "
          f"{fwd_peak:.2f} GiB; "
          f"training at seq {MIS_TRAIN_SEQ}: losses "
          f"{[round(l_, 6) for l_ in losses]}, steps "
          f"{[round(t_, 4) for t_ in times]} s (first incl. warm-up), "
          f"{MIS_TRAIN_SEQ / step_s:.6e} tokens/s, peak {train_peak:.2f} GiB "
          f"[{card}]")
    del p, t, xs, target, p_new, upd
    torch.cuda.empty_cache()
    lg, _ = L.run(mesh=mesh)
    lc, _ = L.run(mesh=WorkerMesh("cpu"))
    if not np.allclose(lg, lc, rtol=1e-3, atol=0):
        fail(f"long-context layer: the card's losses {lg} vs the CPU's {lc}")
    print(f"long-context layer: card and CPU agree at the example's defaults "
          f"(seq 512, 8q/2kv x 16, window 64, 10 steps; loss rtol 1e-3): "
          f"{lg[0]:.6f} -> {lg[-1]:.6f}")

    # -- 24. MoE on one card ---------------------------------------------------
    rng = np.random.default_rng(5)
    md, mh, tokens = 8, 16, 64
    w = {"gate": rng.normal(size=(md, 1)).astype(np.float32),
         "w1": rng.normal(size=(1, md, mh)).astype(np.float32) * 0.5,
         "b1": rng.normal(size=(1, mh)).astype(np.float32) * 0.1,
         "w2": rng.normal(size=(1, mh, md)).astype(np.float32) * 0.5,
         "b2": rng.normal(size=(1, md)).astype(np.float32) * 0.1}
    x = rng.normal(size=(tokens, md)).astype(np.float32)
    ys = []
    for where in (dev, torch.device("cpu")):
        a = moe_params_from_numpy(w, where, expert=0)
        y, dropped = moe_ffn(torch.from_numpy(x).to(where), a["gate"],
                             a["w1"], a["b1"], a["w2"], a["b2"],
                             capacity=tokens)
        if int(dropped) != 0:
            fail(f"MoE on {where}: {int(dropped)} drops at capacity = tokens")
        ys.append(y.cpu().numpy())
    host = reference_moe(x, w["gate"], w["w1"], w["b1"], w["w2"], w["b2"],
                         tokens, 1)
    if not (np.allclose(ys[0], ys[1], rtol=2e-4, atol=2e-5)
            and np.allclose(ys[0], host, rtol=2e-4, atol=2e-5)):
        fail("MoE: the card disagrees with the CPU or the host reference")
    print(f"MoE: card, CPU and host reference agree on {tokens} tokens x "
          f"{md} (rtol 2e-4 / atol 2e-5), zero drops at capacity {tokens}")
    return row, launches


def stream_chunk_phase(dev, card: str, gen) -> tuple[dict, dict]:
    """Phase 25: K1 and K2 at the streaming chunk shape (STREAM_CHUNK x
    STREAM_D, k = STREAM_K) on separated blobs drawn from ``gen``, each
    against its plain version as in phases 2-3, with the time of
    back-to-back wrapper calls (ms), of the kernel from a CUDA graph
    (graph_ms), the plain version's, the bound, and beside them the port's
    matmul routes: _partials_block_int8 for int8, _partials_block (the
    route the f32 stream takes) for f32.  Returns the keys the two kernels'
    rows of the kernels line gain."""
    import torch

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.parallel import collective as C
    from harp_tpu_torch.utils.timing import cuda_ms, graph_ms

    n, d, k = STREAM_CHUNK, STREAM_D, STREAM_K
    x, centers = blobs(n, d, k, gen, dev)
    c2 = (centers ** 2).sum(-1)
    q, scale = C.quantize_to_int8(x, x.abs().amax(0))
    args = (q, *KM._quantize_centroids(centers, scale), scale)
    s1, n1, b1 = KK.kmeans_partials_int8(*args)
    s2, n2, b2 = KK.kmeans_partials_int8_plain(*args)
    s3, n3, b3 = KK.kmeans_partials_int8(*args)
    torch.cuda.synchronize()
    rel = abs(float(b1) - float(b2)) / max(abs(float(b2)), 1e-30)
    if not (torch.equal(s1, s2) and torch.equal(n1, n2)) or rel > 1e-5:
        fail(f"K1 at the chunk shape: sums/counts differ or best_sum rel "
             f"err {rel} > 1e-5")
    if not (torch.equal(s1, s3) and torch.equal(n1, n3)
            and torch.equal(b1, b3)):
        fail("K1 reruns differ at the chunk shape")
    b_ms, b_by = k12_bound_ms(n, d, k, True)
    k1 = {"ms_chunk": cuda_ms(lambda: KK.kmeans_partials_int8(*args),
                              reps=20),
          "graph_ms_chunk": graph_ms(lambda: KK.kmeans_partials_int8(*args)),
          "plain_ms_chunk": cuda_ms(
              lambda: KK.kmeans_partials_int8_plain(*args), reps=3, warmup=1),
          "bound_ms_chunk": b_ms,
          "partials_block_int8_ms_chunk": cuda_ms(
              lambda: KM._partials_block_int8(q, scale, centers, c2),
              reps=3, warmup=1)}
    print(f"K1 chunk n={n} d={d} k={k}: equal sums/counts, best_sum rel err "
          f"{rel:.2e}, reruns bit-equal; kernel {k1['ms_chunk']:.4f} ms "
          f"(graph {k1['graph_ms_chunk']:.4f}), plain "
          f"{k1['plain_ms_chunk']:.4f} ms, _partials_block_int8 "
          f"{k1['partials_block_int8_ms_chunk']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}) [{card}]")
    del q, args, s1, s2, s3
    quantize_chunk_check(dev, card, gen)
    t1, m1, i1 = KK.kmeans_partials(x, centers)
    t2, m2, i2 = KK.kmeans_partials_plain(x, centers)
    torch.cuda.synchronize()
    err = float((t1 - t2).abs().max())
    tol = 1e-5 * float(x.abs().max()) * float(m1.max())
    x2 = float((x.double() ** 2).sum())
    if not torch.equal(m1, m2) or err > tol or abs(float(i1 - i2)) > 1e-5 * x2:
        fail(f"K2 at the chunk shape: counts differ, sums err {err} (tol "
             f"{tol}) or inertia err {abs(float(i1 - i2))}")
    b_ms, b_by = k12_bound_ms(n, d, k, False)
    k2 = {"ms_chunk": cuda_ms(lambda: KK.kmeans_partials(x, centers),
                              reps=20),
          "plain_ms_chunk": cuda_ms(lambda: KK.kmeans_partials_plain(
              x, centers), reps=3, warmup=1),
          "bound_ms_chunk": b_ms,
          "yardstick_ms_chunk": cuda_ms(
              lambda: KM._partials_block(x, centers, c2), reps=5, warmup=1)}
    print(f"K2 chunk n={n} d={d} k={k}: equal counts, sums max err "
          f"{err:.3e} (tol {tol:.3e}); kernel {k2['ms_chunk']:.4f} ms, plain "
          f"{k2['plain_ms_chunk']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); the "
          f"f32 stream's route _partials_block "
          f"{k2['yardstick_ms_chunk']:.4f} ms [{card}]")
    return k1, k2


def quantize_chunk_check(dev, card: str, gen) -> None:
    """Phase 25's fused quantize pass (kmeans_kernel.quantize_rows_int8)
    on a generated N(0, 1) chunk [STREAM_CHUNK, STREAM_D] with the
    benchmark's static 5σ scales: the int8 chunk bit-equal to the plain
    version's, x2 within 1e-6 of its f32 sum, reruns bit-equal; the
    kernel's time (back-to-back calls and from a CUDA graph) beside its
    bound (5 bytes an element) and the plain version's time."""
    import torch

    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.utils.roofline import HBM_BYTES_S
    from harp_tpu_torch.utils.timing import cuda_ms, graph_ms

    n, d = STREAM_CHUNK, STREAM_D
    x = torch.randn((n, d), device=dev, generator=gen)
    col = torch.full((d,), 5.0 / 127.0, device=dev)
    before = KK.LAUNCHES["kmeans_quantize_int8"]
    q1, y1 = KK.quantize_rows_int8(x, col)
    q2, y2 = KK.quantize_rows_int8_plain(x, col)
    q3, y3 = KK.quantize_rows_int8(x, col)
    torch.cuda.synchronize()
    launched = KK.LAUNCHES["kmeans_quantize_int8"] - before
    rel = abs(float(y1) - float(y2)) / float(y2)
    if not torch.equal(q1, q2) or rel > 1e-6 or launched != 2:
        fail(f"fused quantize at the chunk shape: int8 chunks differ, x2 "
             f"rel err {rel} > 1e-6 or {launched} launches for 2 calls")
    if not (torch.equal(q1, q3) and torch.equal(y1, y3)):
        fail("fused quantize reruns differ at the chunk shape")
    del q1, q2, q3
    bound = 5.0 * n * d / HBM_BYTES_S * 1e3
    ms = cuda_ms(lambda: KK.quantize_rows_int8(x, col), reps=50)
    g_ms = graph_ms(lambda: KK.quantize_rows_int8(x, col))
    plain = cuda_ms(lambda: KK.quantize_rows_int8_plain(x, col), reps=5,
                    warmup=1)
    print(f"fused quantize chunk n={n} d={d}: int8 chunk bit-equal, x2 rel "
          f"err {rel:.2e}, reruns bit-equal; kernel {ms:.4f} ms (graph "
          f"{g_ms:.4f}), plain {plain:.4f} ms, bound {bound:.4f} ms (bytes)"
          f" [{card}]")


def h2d_rates(dev, card: str) -> None:
    """GB/s of one chunk's host-to-device copy (f32 and int8 [STREAM_CHUNK,
    STREAM_D]) from pageable and from pinned memory: host clock around five
    copies ending in a synchronize, after one untimed."""
    import torch

    for dt in (torch.float32, torch.int8):
        host = torch.ones((STREAM_CHUNK, STREAM_D), dtype=dt)
        out = []
        for name, src in (("pageable", host), ("pinned", host.pin_memory())):
            dst = torch.empty_like(src, device=dev)
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            gbs = 5 * src.numel() * src.element_size() / 1e9 / (
                time.perf_counter() - t0)
            out.append(f"{name} {gbs:.2f} GB/s")
        print(f"H2D of one {str(dt).removeprefix('torch.')} chunk "
              f"[{STREAM_CHUNK}, {STREAM_D}]: " + ", ".join(out)
              + f" [{card}]")


def stream_fit_phase(dev, card: str) -> tuple:
    """Phase 26; returns (the host array, its explicit init, K1's launches
    on the streaming main path: the int8 fit at prefetch 2)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.ops import kmeans_kernel as KK

    g = torch.Generator(device=dev)
    g.manual_seed(2)
    # unit noise, as phase 4's points: int8 rounding then moves the
    # inertia well inside 2e-2 (0.5 % on a CPU run at 60k x 300, k = 1000)
    x, centers = blobs(STREAM_HOST_N, STREAM_D, STREAM_K, g, dev, noise=1.0)
    pts = x.cpu().numpy()
    # one centroid near each blob: the f32 and int8 runs share a basin
    init = (centers + 0.1 * torch.randn(centers.shape, generator=g,
                                        device=dev)).cpu().numpy()
    del x, centers
    n_chunks = -(-STREAM_HOST_N // STREAM_CHUNK)
    h2d_rates(dev, card)
    main_launches = None
    inertia = {}
    for q in (None, "int8"):
        runs = {}
        for p in (0, 1, 2, 4):
            inst: dict = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            main = q == "int8" and p == 2
            if main:
                KK.reset_launches()  # the streaming main path starts here
            t0 = time.perf_counter()
            runs[p] = KS.fit_streaming(
                pts, k=STREAM_K, iters=STREAM_ITERS,
                chunk_points=STREAM_CHUNK, init=init, quantize=q, prefetch=p,
                return_history=True, instrument=inst)
            wall = time.perf_counter() - t0
            if main:
                launches = dict(KK.LAUNCHES)  # ... and ends here
                main_launches = launches["kmeans_partials_int8"]
                want = n_chunks * STREAM_ITERS
                if launches != {"kmeans_partials_int8": want,
                                "kmeans_partials": 0}:
                    fail(f"fit_streaming int8: launches {launches}, "
                         f"expected K1 {want} times (once a chunk an epoch)")
            ep = inst["epochs"][-1]
            pl = ep["pipeline"]
            print(f"fit_streaming {q or 'f32'} prefetch {p}: inertia "
                  f"{runs[p][1]:.6e}, wall {wall:.3f} s for {STREAM_ITERS} "
                  f"epochs of {n_chunks} chunks; last epoch {ep['epoch_s']:.4f}"
                  f" s, host {ep['host_s']:.4f} s, device tail "
                  f"{ep['sync_s']:.4f} s, read {pl['read_s']:.4f} s, prep "
                  f"{pl['prep_s']:.4f} s, ship {pl['ship_s']:.4f} s, wait "
                  f"{pl['wait_s']:.4f} s, overlap_efficiency "
                  f"{pl['overlap_efficiency']:.4f}; peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
                  f"[{card}]")
        for p in (1, 2, 4):
            if not (np.array_equal(runs[p][0], runs[0][0])
                    and np.array_equal(runs[p][2], runs[0][2])):
                fail(f"fit_streaming {q or 'f32'}: prefetch {p} differs "
                     "from prefetch 0")
        c, i, h = runs[0]
        if not (np.isfinite(c).all() and np.isfinite(h).all()
                and h[-1] <= h[0]):
            fail(f"fit_streaming {q or 'f32'}: history {h}")
        inertia[q] = i
    if abs(inertia["int8"] - inertia[None]) > 2e-2 * abs(inertia[None]):
        fail(f"fit_streaming: int8 inertia {inertia['int8']} differs from "
             f"f32's {inertia[None]} by more than 2e-2")
    print(f"fit_streaming: every depth bit-identical, K1 {main_launches} "
          f"launches (once a chunk an epoch), int8/f32 inertia "
          f"{inertia['int8'] / inertia[None]:.6f}")
    small, small_init = pts[:4096, :32], pts[:8, :32].copy()
    for q in (None, "int8"):
        kw = dict(k=8, iters=3, chunk_points=1000, init=small_init,
                  quantize=q)
        cg, ig = KS.fit_streaming(small, **kw)
        cc, ic = KS.fit_streaming(small, device="cpu", **kw)
        if not (np.allclose(cg, cc, rtol=1e-4, atol=1e-4)
                and abs(ig - ic) <= 1e-4 * abs(ic)):
            fail(f"fit_streaming {q or 'f32'}: the card and the CPU "
                 "disagree on a small input")
    print("fit_streaming: card and CPU agree on 4096 x 32, k=8, f32 and "
          "int8 (rtol 1e-4)")
    return pts, init, main_launches


def stream_ingest_phase(dev, card: str, pts, init) -> None:
    """Phase 27 (see the module doc)."""
    import numpy as np

    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.native import build as NB
    from harp_tpu_torch.native.datasource import load_csv

    with tempfile.TemporaryDirectory() as tmp:
        f32, f16 = os.path.join(tmp, "p32.npy"), os.path.join(tmp, "p16.npy")
        np.save(f32, pts[:STREAM_NPY_N])
        np.save(f16, pts[:STREAM_NPY_N].astype(np.float16))
        for path, depths in ((f32, (0, 1, 2, 4)), (f16, (2,))):
            mm = np.load(path, mmap_mode="r")
            for p in depths:
                out = KS.benchmark_ingest(mm, k=STREAM_K, iters=STREAM_ITERS,
                                          chunk_points=STREAM_CHUNK,
                                          prefetch=p)
                if not np.isfinite(out["inertia"]):
                    fail(f"benchmark_ingest {out['wire_dtype']}: inertia")
                print(f"benchmark_ingest {mm.dtype} memmap {mm.shape} wire "
                      f"{out['wire_dtype']} prefetch {p}: "
                      f"{out['points_per_sec']:.6e} points/s, epoch "
                      f"{out['epoch_sec']:.4f} s, host "
                      f"{out['host_sec_per_epoch']:.4f} s "
                      f"({out['host_gb_per_sec']:.3f} GB/s of disk bytes), "
                      f"device tail {out['sync_sec_per_epoch']:.4f} s, "
                      f"overlap_efficiency {out['overlap_efficiency']:.4f}, "
                      f"ingest_bound_fraction "
                      f"{out['ingest_bound_fraction']:.4f} [{card}]")
        mm16 = np.load(f16, mmap_mode="r")
        kw = dict(k=STREAM_K, iters=STREAM_ITERS, chunk_points=STREAM_CHUNK,
                  init=init)
        c16, i16 = KS.fit_streaming(mm16, **kw)
        c32, i32 = KS.fit_streaming(np.asarray(mm16, np.float32), **kw)
        if not (np.array_equal(c16, c32) and i16 == i32):
            fail("the f16 wire is not bit-identical to the host cast")
        print("f16 wire: bit-identical to the host cast")
        if NB.load_native() is None:
            fail("the port's native loader did not build (g++)")
        paths = []
        for f in range(STREAM_CSV_FILES):
            paths.append(os.path.join(tmp, f"split_{f}.csv"))
            np.savetxt(paths[-1], pts[f * STREAM_CSV_ROWS:
                                      (f + 1) * STREAM_CSV_ROWS],
                       fmt="%.7e", delimiter=",")
        src = np.concatenate([load_csv(p) for p in paths])
        info: dict = {}
        cf, i_f = KS.fit_streaming_files(paths, info=info, **kw)
        cs, i_s = KS.fit_streaming(src, **kw)
        if not (np.allclose(cf, cs, rtol=1e-5, atol=1e-6)
                and abs(i_f - i_s) <= 1e-5 * abs(i_s)
                and info["n_total"] == len(src)):
            fail("fit_streaming_files over CSV splits disagrees with the "
                 "single-source fit")
        print(f"fit_streaming_files: {len(paths)} CSV splits, {len(src)} x "
              f"{src.shape[1]} rows through the native loader "
              f"({NB.so_path().name}), equal to the single-source fit "
              f"(rtol 1e-5)")


def stream_benchmark_phase(dev, card: str) -> int:
    """Phase 28; returns K1's launches in the north-star run."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.utils.timing import device_sync

    KK.reset_launches()
    n_launches = 0
    for n, q, iters in ((STREAM_N, "int8", STREAM_BENCH_ITERS),
                        (STREAM_F32_N, None, STREAM_ITERS)):
        before = KK.LAUNCHES["kmeans_partials_int8"]
        before_q = KK.LAUNCHES["kmeans_quantize_int8"]
        out = KS.benchmark_streaming(n=n, d=STREAM_D, k=STREAM_K,
                                     iters=iters, chunk_points=STREAM_CHUNK,
                                     quantize=q)
        launched = KK.LAUNCHES["kmeans_partials_int8"] - before
        fused = KK.LAUNCHES["kmeans_quantize_int8"] - before_q
        want = out["n_chunks"] * (1 + iters) if q else 0
        if (launched != want or fused != want
                or not np.isfinite(out["inertia"])):
            fail(f"benchmark_streaming {q or 'f32'}: K1 launches {launched},"
                 f" fused quantize launches {fused} (expected {want}) or "
                 f"inertia {out['inertia']}")
        if q:
            n_launches = launched
        print(f"benchmark_streaming {q or 'f32'} n={out['n']} d={STREAM_D} "
              f"k={STREAM_K} ({out['n_chunks']} chunks of "
              f"{out['chunk_points']}): {out['iters_per_sec']:.6f} iters/s, "
              f"{out['points_per_sec']:.6e} points/s, "
              f"{out['sec_per_iter']:.4f} s/iter, inertia "
              f"{out['inertia']:.6e}, peak device memory "
              f"{out['peak_mem_bytes'] / 2**30:.3f} GiB, K1 launches "
              f"{launched} [{card}]")
    # one int8 epoch of 128 chunks under the profiler
    gen = KS._make_chunk_gen(0, 0, STREAM_CHUNK, STREAM_D, torch.float32,
                             dev)
    cfg = KS.StreamConfig(k=STREAM_K, quantize="int8")
    col = torch.full((STREAM_D,), 5.0 / 127.0, device=dev)
    c0 = torch.randn((STREAM_K, STREAM_D), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))

    def epoch():
        device_sync(KS._synthetic_run(c0, 1, gen, 128, cfg, col)[1])

    epoch()
    t0 = time.perf_counter()
    epoch()
    bare = time.perf_counter() - t0
    profile_run(epoch, card, "kmeans-stream int8", "epoch of 128 chunks",
                bare, count=(KK.LAUNCHES, "kmeans_partials_int8",
                             "main_kernel"))
    row = run_cli("kmeans-stream", "--quantize", "int8", "--iters", "2")
    if not np.isfinite(row["inertia"]):
        fail(f"kmeans-stream CLI row is not finite: {row}")
    return n_launches


# -- 29-32: the collective surface, the tables, LDA push/pull, KMeans hier ---

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def verbs_phase(dev, card: str) -> None:
    """Phase 29: every quantized verb, every reshard lowering and
    allreduce_hier on the card's one-rank NCCL group, against numpy (bf16
    casts against torch's CPU cast: numpy has no bf16); then the bench app
    over 64 KB-256 MB."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from harp_tpu_torch import benchmark as BM
    from harp_tpu_torch.parallel import collective as C

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=dev)
    try:
        if dist.get_backend() != "nccl" or C.num_workers() != 1:
            fail("verbs: the one-rank NCCL group did not come up")
        rng = np.random.default_rng(3)
        xh = (rng.normal(size=(64, 48)) * 5).astype(np.float32)
        ih = rng.integers(-9, 10, size=(64, 2)).astype(np.int32)
        bh = rng.random((64, 1)) < 0.5
        x, i, b = (torch.from_numpy(a).to(dev) for a in (xh, ih, bh))
        scale = np.float32(max(np.abs(xh).max(), 1e-30)) / np.float32(127.0)
        q8 = (np.clip(np.round(xh / scale), -127, 127).astype(np.float32)
              * scale).astype(np.float32)
        b16 = torch.from_numpy(xh).to(torch.bfloat16).to(torch.float32).numpy()
        want = {torch.bfloat16: b16, torch.int8: q8}
        checked = 0
        for verb, kw in (("allreduce_quantized", {}),
                         ("push_quantized", {}),
                         ("regroup_quantized", {}),
                         ("regroup_quantized", {"split_dim": 1,
                                                "concat_dim": 0}),
                         ("rotate_quantized", {"shift": 1})):
            for wd in (torch.bfloat16, torch.int8):
                out = getattr(C, verb)((x, i, b), wire_dtype=wd, **kw)
                got = [o.cpu().numpy() for o in out]
                if not (np.array_equal(got[0], want[wd])
                        and np.array_equal(got[1], ih)
                        and np.array_equal(got[2], bh)
                        and out[2].dtype == torch.bool):
                    fail(f"verbs: {verb} {kw} on the {wd} wire disagrees "
                         "with numpy")
                checked += 1
        S = C.ShardSpec
        specs = {"R": S.replicated(), "S0": S.blocked(0), "S1": S.blocked(1),
                 "S0s1": S.blocked(0, 1), "S1s2": S.blocked(1, 2)}
        for wire, ref in (("exact", xh), ("bf16", b16), ("int8", q8)):
            for a in specs:
                for bb in specs:
                    got = C.reshard(x, specs[a], specs[bb], wire=wire)
                    ref_naive = C.reshard_reference(x, specs[a], specs[bb])
                    plan = C._reshard_plan(specs[a], specs[bb], 1)[0]
                    want_x = xh if plan in ("identity", "slice") else ref
                    if not (np.array_equal(got.cpu().numpy(), want_x)
                            and np.array_equal(ref_naive.cpu().numpy(), xh)):
                        fail(f"verbs: reshard {a} -> {bb} ({plan}) on the "
                             f"{wire} wire disagrees with numpy")
                    checked += 1
        for gs in (None, 1):
            got = C.allreduce_hier((x, i, b), group_size=gs)
            if not (np.array_equal(got[0].cpu().numpy(), xh)
                    and np.array_equal(got[1].cpu().numpy(), ih)
                    and np.array_equal(got[2].cpu().numpy(), bh)):
                fail(f"verbs: allreduce_hier(group_size={gs}) disagrees")
            checked += 1
        print(f"verbs: {checked} calls of the quantized verbs, reshard "
              "(every pair of 5 layouts on 3 wires) and allreduce_hier on "
              "the one-rank NCCL group equal numpy (one worker: each verb "
              f"is its local path) [{card}]")
    finally:
        dist.destroy_process_group()

    cli = subprocess.run([sys.executable, "-m", "harp_tpu_torch", "bench",
                          "--max-mb", "256"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if cli.returncode:
        fail(f"bench CLI exited {cli.returncode}:\n{cli.stderr[-2000:]}")
    rows = [json.loads(ln) for ln in cli.stdout.splitlines()]
    by_verb: dict[str, list] = {}
    for r in rows:
        if r["device"] != card or not (r["gb_per_sec"] > 0):
            fail(f"bench row does not name this card or has no rate: {r}")
        by_verb.setdefault(r["verb"], []).append(r)
    n_sizes = len(BM.sizes(64, 256))
    if set(by_verb) != set(BM.VERBS) | set(BM.SPARSE_VERBS) or any(
            len(v) != n_sizes for v in by_verb.values()):
        fail(f"bench: expected every verb at {n_sizes} sizes, got "
             f"{ {k: len(v) for k, v in by_verb.items()} }")
    print(f"bench (python -m harp_tpu_torch bench --max-mb 256; "
          f"{rows[0]['note']}) [{card}]: per verb, size MB: GB/s, us a call")
    for verb, rs in by_verb.items():
        print(f"  {verb}: " + " | ".join(
            f"{r['bytes'] / 2 ** 20:g}: {r['gb_per_sec']:.1f}, "
            f"{r['sec'] * 1e6:.1f}" for r in rs))


def tables_phase(dev, card: str) -> None:
    """Phase 30: the sparse row verbs on a [50,000, 1000] f32 row table with
    8192 Zipf ids (the LDA benchmark's word-topic table and chunk), against
    numpy gathers and np.add.at (integer counts and +-1 deltas: exact in any
    order), with the time a call."""
    import numpy as np
    import torch

    from harp_tpu_torch import table as T
    from harp_tpu_torch.utils.timing import cuda_ms

    rows, k, m = LDA_VOCAB, LDA_TOPICS, 8192
    rng = np.random.default_rng(7)
    table_h = rng.integers(0, 50, size=(rows, k)).astype(np.float32)
    ids_h = ((rng.zipf(1.1, size=m) - 1) % rows).astype(np.int32)
    deltas_h = rng.integers(-1, 2, size=(m, k)).astype(np.float32)
    table, ids, deltas = (torch.from_numpy(a).to(dev)
                          for a in (table_h, ids_h, deltas_h))
    pushed_h = table_h.copy()
    np.add.at(pushed_h, ids_h, deltas_h)
    distinct = len(np.unique(ids_h))
    for name in ("pull_rows_sparse", "pull_rows_sparse_dedup"):
        fn = getattr(T, name)
        got, ok, dropped = fn(table, ids, capacity=m)
        if not (np.array_equal(got.cpu().numpy(), table_h[ids_h])
                and bool(ok.all()) and int(dropped) == 0):
            fail(f"tables: {name} disagrees with the numpy gather")
        small = 256
        want_drop = (distinct if name.endswith("dedup") else m) - small
        if int(fn(table, ids, capacity=small)[2]) != want_drop:
            fail(f"tables: {name} at capacity {small} does not drop "
                 f"{want_drop}")
        ms = cuda_ms(lambda: fn(table, ids, capacity=m), reps=10)
        print(f"tables: {name} [{rows}, {k}] f32, {m} Zipf ids ({distinct} "
              f"distinct), capacity {m}: {ms:.4f} ms a call; equal to "
              f"numpy, drops {want_drop} at capacity {small} [{card}]")
    for name in ("push_rows_sparse", "push_rows_sparse_dedup"):
        fn = getattr(T, name)
        got, dropped = fn(table, ids, deltas, capacity=m)
        if not (np.array_equal(got.cpu().numpy(), pushed_h)
                and int(dropped) == 0):
            fail(f"tables: {name} disagrees with np.add.at")
        ms = cuda_ms(lambda: fn(table, ids, deltas, capacity=m), reps=10)
        print(f"tables: {name} of [{m}, {k}] +-1 deltas: {ms:.4f} ms a "
              f"call; equal to np.add.at [{card}]")
    # a chunk of padding only (a worker with fewer tokens than the busiest
    # one on a multi-card run): nothing pulled, pushed or dropped
    none = torch.zeros(m, dtype=torch.bool, device=dev)
    for name in ("push_rows_sparse", "push_rows_sparse_dedup"):
        got, dropped = getattr(T, name)(table, ids, deltas, capacity=m,
                                        valid=none)
        if not (torch.equal(got, table) and int(dropped) == 0):
            fail(f"tables: {name} with no valid id changed the table")
    got, ok, dropped = T.pull_rows_sparse_dedup(table, ids, capacity=m,
                                                valid=none)
    if bool(ok.any()) or bool(got.any()) or int(dropped) != 0:
        fail("tables: pull_rows_sparse_dedup with no valid id served rows")
    print("tables: push/pull with no valid id leave the table unchanged")


def _pushpull_split(model, card: str) -> float:
    """One sweep with CUDA events around each chunk and its pull and push:
    the device timeline's split of a chunk (gaps between launches
    included).  Returns the sweep's wall seconds."""
    import torch

    from harp_tpu_torch import table as T
    from harp_tpu_torch.models import lda as LD

    spans = {"chunk": [], "pull": [], "push": []}

    def timed(fn, key):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run

    saved = (LD._sample_chunk_pushpull, T.pull_rows_sparse_dedup,
             T.push_rows_sparse_dedup)
    LD._sample_chunk_pushpull = timed(saved[0], "chunk")
    T.pull_rows_sparse_dedup = timed(saved[1], "pull")
    T.push_rows_sparse_dedup = timed(saved[2], "push")
    try:
        t0 = time.perf_counter()
        model.sample_epoch()
        wall = time.perf_counter() - t0
    finally:
        (LD._sample_chunk_pushpull, T.pull_rows_sparse_dedup,
         T.push_rows_sparse_dedup) = saved
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    n = len(spans["chunk"])
    rest = ms["chunk"] - ms["pull"] - ms["push"]
    print(f"LDA pushpull split of one sweep ({n} chunks, wall {wall:.4f} s, "
          f"events on the stream): a chunk {ms['chunk'] / n:.4f} ms = pull "
          f"{ms['pull'] / n:.4f} + sample {rest / n:.4f} + push "
          f"{ms['push'] / n:.4f}; pull+push share "
          f"{(ms['pull'] + ms['push']) / ms['chunk']:.3f} [{card}]")
    return wall


def lda_pushpull_phases(dev, card: str) -> None:
    """Phase 31: LDA push/pull, this slice's main path: a small corpus on
    the card against the CPU, bit-equal under injected draws; benchmark(
    algo="pushpull") at the benchmark width with the split of a chunk;
    suggest_pull_cap; the invariants; the CLI."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import lda as LD

    # -- the card against the CPU, the same draws ---------------------------
    d, w = LD.synthetic_corpus(96, 64, 4, 50)
    # exprace: products and quotients, rounded alike on both devices (a
    # Gumbel draw's logs may differ in the last place between them)
    for kw in ({}, {"dedup_pulls": False}, {"pull_cap": 3},
               {"pull_cap": 8, "dedup_pulls": False}):
        cfg = dict(n_topics=8, algo="pushpull", chunk=64, **kw)
        models = [LD.LDA(96, 64, LD.LDAConfig(**cfg), seed=4),
                  LD.LDA(96, 64, LD.LDAConfig(**cfg), seed=4, device="cpu")]
        for m in models:
            m.set_tokens(d, w)
        rng = np.random.default_rng(9)
        T_pad = models[1]._tokens[0].shape[0]
        drops = []
        for _ in range(2):
            nz = rng.exponential(size=(T_pad, 8)).astype(np.float32)
            for m in models:
                m.sample_epoch(noise=lambda t, s, m=m: torch.from_numpy(
                    nz).to(m.mesh.device))
            drops.append((models[0].last_dropped, models[1].last_dropped))
        for k in ("Ndk", "Nwk", "Nk", "z_grid"):
            if not np.array_equal(getattr(models[0], k).cpu().numpy(),
                                  getattr(models[1], k).numpy()):
                fail(f"LDA pushpull {kw}: {k} on the card differs from the "
                     "CPU under the same draws")
        if any(a != b for a, b in drops):
            fail(f"LDA pushpull {kw}: drops {drops} differ")
    print("LDA pushpull 96 docs x 64 words, 8 topics, 2 sweeps: card == CPU "
          "bit for bit under injected exprace draws (dedup on/off, caps 3 "
          "and 8 that drop)")

    # -- benchmark at the LDA benchmark width ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    out = LD.benchmark(LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_TPD, LDA_EPOCHS,
                       algo="pushpull")
    peak = torch.cuda.max_memory_allocated()
    if out["dropped_tokens"] != 0 or not np.isfinite(out["log_likelihood"]):
        fail(f"LDA pushpull benchmark: {out}")
    print(f"LDA benchmark pushpull ({LDA_DOCS} docs x {LDA_VOCAB} words x "
          f"{LDA_TOPICS} topics x {LDA_TPD} tokens, chunk 8192, dedup, cap = "
          f"chunk): {out['tokens_per_sec_per_chip']:.6e} tokens/s per card, "
          f"{out['sec_per_epoch']:.6f} s/epoch, prep {out['prep_sec']:.3f} s, "
          f"log-likelihood {out['log_likelihood']:.6f}, dropped_tokens "
          f"{out['dropped_tokens']}, peak device memory "
          f"{peak / 2 ** 30:.2f} GiB [{card}]")

    # -- suggest_pull_cap, invariants, the split of a chunk, the profile ----
    # on a tenth of the docs at the same width and chunk shape (123
    # chunks, ~26k kernels in the trace): the benchmark above is the
    # full-size run
    t_cut = time.perf_counter()
    docs = LDA_DOCS // 10
    small = LD.LDA(docs, LDA_VOCAB, LD.LDAConfig(
        n_topics=LDA_TOPICS, algo="pushpull"), seed=1)
    small.set_tokens(*LD.benchmark_corpus(docs, LDA_VOCAB, LDA_TPD, 0))
    t0 = time.perf_counter()
    cap = small.suggest_pull_cap(apply=True)
    t_cap = time.perf_counter() - t0
    sweep = _pushpull_split(small, card)  # one sweep at the suggested cap
    n_tok = docs * LDA_TPD
    ndk_sum = int(small.Ndk.sum(dtype=torch.int64))
    if not (small.last_dropped == 0
            and torch.equal(small.Nwk.sum(0), small.Nk)
            and ndk_sum == n_tok == small.n_tokens
            and float(small.Nwk.min()) >= 0):
        fail(f"LDA pushpull at suggest_pull_cap {cap}: dropped "
             f"{small.last_dropped}, sum Ndk {ndk_sum}, tokens {n_tok}, or "
             "Nwk.sum(0) != Nk")
    print(f"LDA pushpull on {docs} docs, suggest_pull_cap: {cap} (of chunk "
          f"8192; {t_cap:.2f} s on the host), the split's sweep at it "
          f"{sweep:.4f} s, 0 dropped; Nwk.sum(0) == Nk and sum Ndk == "
          f"{n_tok} tokens [{card}]")
    # device busy and idle share of a sweep at the suggested cap
    t0 = time.perf_counter()
    small.sample_epoch()
    bare = time.perf_counter() - t0
    profile_epoch(small, card, "LDA pushpull", "sample_epoch", bare)
    del small
    crow = run_cli("lda", "--algo", "pushpull", "--epochs", "1", "--docs",
                   str(docs))
    if crow["dropped_tokens"] != 0 or not np.isfinite(crow["log_likelihood"]):
        fail(f"LDA pushpull CLI row: {crow}")
    print(f"cut: LDA pushpull's cap, split, profile and CLI on {docs} docs "
          f"took {time.perf_counter() - t_cut:.1f} s")


def kmeans_hier_phase(dev, card: str, gen) -> int:
    """Phase 32: models.kmeans.fit at 1M x 300, k = 100, int8, with
    psum_schedule="hier" (K1 once an iteration), bit-equal to one_shot on
    one card; returns K1's launches on the hier fit."""
    import numpy as np

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK

    pts = blobs(N, D, K, gen, dev)[0].cpu().numpy()
    one = KM.fit(pts, k=K, iters=ITERS, seed=0, quantize="int8")
    KK.reset_launches()  # the hier arm's run starts here
    t0 = time.perf_counter()
    c, inertia = KM.fit(pts, k=K, iters=ITERS, seed=0, quantize="int8",
                        psum_schedule="hier")
    wall = time.perf_counter() - t0
    launches = KK.LAUNCHES["kmeans_partials_int8"]  # ... and ends here
    if launches != ITERS:
        fail(f"KMeans hier: K1 launches {launches}, expected {ITERS}")
    if not (np.array_equal(c, one[0]) and inertia == one[1]):
        fail("KMeans hier: not bit-equal to one_shot on one card")
    print(f"KMeans fit int8 psum_schedule=hier at {N} x {D}, k={K}: {ITERS} "
          f"iterations, {wall:.3f} s incl. host prep, K1 launches "
          f"{launches}, bit-equal to one_shot (inertia {inertia:.6e}) "
          f"[{card}]")
    return launches


def subgraph_phase(dev, card: str) -> None:
    """Phase 33: subgraph counting (no kernel of ours): the card against
    the CPU bit for bit on a hub graph for both overflow algos (u5 and u7
    trees), the exact count on a complete graph, benchmark at the graded
    1M-vertex power-law shape for both algos (host prep and device DP
    seconds beside vertices/s), the CLI, u7-tree at 50k vertices, and
    torch.profiler over one trial."""
    import math

    import numpy as np

    from harp_tpu_torch.models import subgraph as SG
    from harp_tpu_torch.parallel.mesh import current_mesh

    rng = np.random.default_rng(9)
    n = 64
    edges = np.asarray([(0, i) for i in range(1, n)]
                       + [(1, i) for i in range(2, 40)]
                       + [(int(a), int(b)) for a, b in zip(
                           rng.integers(0, n, 120), rng.integers(0, n, 120))])
    for tpl in ("u5-tree", "u7-tree"):
        trials = {}
        for algo in ("segment", "onehot"):
            cfg = SG.SubgraphConfig(template=tpl, n_trials=4, trial_chunk=2,
                                    seed=5, max_degree=4, overflow_algo=algo,
                                    overflow_row_tile=8,
                                    overflow_entry_tile=16)
            card_t = SG.count_template(edges, n, cfg)[1]
            cpu_t = SG.count_template(edges, n, cfg, device="cpu")[1]
            if card_t != cpu_t:
                fail(f"subgraph {tpl} {algo}: card {card_t} != CPU {cpu_t}")
            trials[algo] = card_t
        if trials["segment"] != trials["onehot"]:
            fail(f"subgraph {tpl}: segment {trials['segment']} != onehot "
                 f"{trials['onehot']}")
    s = 7
    k7 = [(a, b) for a in range(s) for b in range(a + 1, s)]
    mesh = current_mesh()
    colors = np.zeros(16, np.int32)
    colors[:s] = np.arange(s)
    nbr, msk, ovf = SG.pad_csr(k7, 16, s)
    o = SG._partition_overflow(ovf, 16, 1)
    t = [mesh.replicated(a) for a in (nbr, msk, *o, colors[None, :])]
    out = SG.make_colorful_count_fn(SG.TEMPLATES["u7-tree"], s, mesh)(
        t[0].long(), t[1], t[2].long(), t[3].long(), t[4], t[5])
    if float(out[0]) != math.factorial(s):
        fail(f"subgraph u7-tree on K7: {float(out[0])} != 7!")
    print("subgraph: card == CPU bit for bit on a 64-vertex hub graph "
          "(u5-tree, u7-tree; max_degree 4, both overflow algos, which "
          "agree), u7-tree on K7 exactly 7! rooted colorful maps")

    # -- the graded shape: 1M power-law vertices (scripts/measure_all.py) ---
    est = {}
    for algo in ("segment", "onehot"):
        r = SG.benchmark(SUB_N, SUB_DEG, "u5-tree", graph="powerlaw",
                         max_degree=SUB_MAX_DEG, overflow_algo=algo)
        if not (np.isfinite(r["estimate"]) and r["estimate"] > 0):
            fail(f"subgraph benchmark {algo}: {r}")
        est[algo] = r["estimate"]
        print(f"subgraph benchmark u5-tree {algo}, {SUB_N} power-law "
              f"vertices, avg degree {SUB_DEG}, max_degree {SUB_MAX_DEG}: "
              f"{r['vertices_per_sec']:.6e} vertices/s, "
              f"{r['sec_per_trial']:.4f} s a trial (host prep "
              f"{r['prep_sec']:.4f} s, device DP {r['dp_sec']:.4f} s), "
              f"overflow_share {r['overflow_share']:.4f}, estimate "
              f"{r['estimate']:.6e} [{card}]")
    # above 2^24 the f32 sums round, and index_add_'s order varies
    if abs(est["segment"] - est["onehot"]) > 1e-5 * abs(est["segment"]):
        fail(f"subgraph benchmark: segment {est['segment']} and onehot "
             f"{est['onehot']} differ by more than rtol 1e-5")
    row = run_cli("subgraph", "--vertices", str(SUB_N), "--avg-degree",
                  str(SUB_DEG), "--max-degree", str(SUB_MAX_DEG), "--graph",
                  "powerlaw")
    if abs(row["estimate"] - est["segment"]) > 1e-5 * est["segment"]:
        fail(f"subgraph CLI estimate {row['estimate']} != benchmark's")
    r = SG.benchmark(SUB_U7_N, SUB_DEG, "u7-tree", graph="powerlaw",
                     max_degree=SUB_MAX_DEG)
    if not np.isfinite(r["estimate"]):
        fail(f"subgraph u7-tree benchmark: {r}")
    print(f"subgraph benchmark u7-tree, {SUB_U7_N} power-law vertices: "
          f"{r['vertices_per_sec']:.6e} vertices/s (host prep "
          f"{r['prep_sec']:.4f} s, device DP {r['dp_sec']:.4f} s), "
          f"estimate {r['estimate']:.6e} [{card}]")

    # -- device time of one trial --------------------------------------------
    rng = np.random.default_rng(0)
    n_edges = SUB_N * SUB_DEG // 2
    edges = np.stack([(rng.zipf(1.3, n_edges).astype(np.int64) - 1) % SUB_N,
                      rng.integers(0, SUB_N, n_edges)], 1)
    cfg = SG.SubgraphConfig(template="u5-tree", max_degree=SUB_MAX_DEG)
    SG.count_template(edges, SUB_N, cfg)
    split: dict = {}
    t0 = time.perf_counter()
    SG.count_template(edges, SUB_N, cfg, split=split)
    bare = time.perf_counter() - t0
    print(f"subgraph one trial: host prep {split['prep_sec']:.4f} s, device "
          f"DP {split['dp_sec']:.4f} s of {bare:.4f} s [{card}]")
    profile_run(lambda: SG.count_template(edges, SUB_N, cfg), card,
                "subgraph", "u5-tree trial (count_template whole)", bare)


def mlp_phase(dev, card: str) -> None:
    """Phase 34: the MLP trainers (no kernel of ours): the card against the
    CPU on a small input (three wires, ZeRO-1 adam, TP on 1 x 1), benchmark
    at MNIST width for the three wires and ZeRO-1 adam, a falling loss, TP
    on a 1 x 1 mesh_2d against the DP trainer at that width, fit for 2
    epochs through the CLI, and torch.profiler over ten steps."""
    import math

    import numpy as np
    import torch

    from harp_tpu_torch.models import mlp as ML
    from harp_tpu_torch.parallel.mesh import mesh_2d
    from harp_tpu_torch.utils.timing import device_sync

    x, y = ML.synthetic_mnist(n=64, d=16, classes=4, seed=1)
    for kw in ({}, {"grad_wire": "bf16"}, {"grad_wire": "int8"},
               {"optimizer": "adam", "zero1": True},
               {"optimizer": "momentum"}):
        cfg = ML.MLPConfig(sizes=(16, 32, 24, 4), lr=0.05, **kw)
        params = ML.init_params(cfg, torch.Generator().manual_seed(3))
        got = []
        for make in (lambda: ML.MLPTrainer(cfg, state={"params": params}),
                     lambda: ML.MLPTrainer(cfg, device="cpu",
                                           state={"params": params})):
            tr = make()
            hist = [tr.train_batch(x, y) for _ in range(5)]
            got.append((np.asarray(hist), torch.cat(
                [p.reshape(-1) for p in ML._leaves(tr.params)]).cpu().numpy()))
        if not (np.allclose(got[0][0], got[1][0], rtol=1e-4, atol=1e-6)
                and np.allclose(got[0][1], got[1][1], rtol=1e-4, atol=1e-6)):
            fail(f"MLP {kw}: the card and the CPU disagree on a small input")
    print("MLP: card == CPU (rtol 1e-4) over 5 steps at (16, 32, 24, 4) for "
          "the f32/bf16/int8 wires, ZeRO-1 adam and momentum")

    cfg = ML.MLPConfig()
    for name, c in (("f32", cfg), ("bf16", ML.MLPConfig(grad_wire="bf16")),
                    ("int8", ML.MLPConfig(grad_wire="int8")),
                    ("zero1 adam", ML.MLPConfig(optimizer="adam",
                                                zero1=True))):
        torch.cuda.reset_peak_memory_stats()
        r = ML.benchmark(n=MLP_N, batch=MLP_BATCH, cfg=c)
        if name == "f32":
            BENCH_ROWS["MLP f32 wire"] = ("mlp", r)
        # a trained model beats a uniform guess over the 10 classes
        if not (np.isfinite(r["loss"]) and r["loss"] < math.log(10)):
            fail(f"MLP benchmark {name}: loss {r['loss']}")
        print(f"MLP benchmark {name} wire, sizes {tuple(c.sizes)}, {MLP_N} "
              f"samples, batch {MLP_BATCH}: {r['samples_per_sec']:.6e} "
              f"samples/s (host loop {r['samples_per_sec_hostloop']:.6e}), "
              f"{r['steps_per_sec']:.3f} steps/s, loss {r['loss']:.6f}, "
              f"train_acc {r['train_acc']:.4f}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")

    xs, ys = ML.synthetic_mnist(n=MLP_BATCH, seed=2)
    params = ML.init_params(cfg, torch.Generator().manual_seed(0))
    dp = ML.MLPTrainer(cfg, state={"params": params})
    tp = ML.TPMLPTrainer(cfg, mesh_2d(1, 1), state={"params": params})
    h_dp = [dp.train_batch(xs, ys) for _ in range(5)]
    h_tp = [tp.train_batch(xs, ys) for _ in range(5)]
    if not np.allclose(h_dp, h_tp, rtol=1e-5, atol=1e-6):
        fail(f"MLP TP 1x1 {h_tp} != DP {h_dp}")
    if not h_dp[-1][0] < h_dp[0][0]:
        fail(f"MLP loss does not fall over 5 steps: {h_dp}")
    print(f"MLP TPMLPTrainer on a 1 x 1 mesh_2d == MLPTrainer over 5 steps "
          f"at batch {MLP_BATCH}: loss {h_dp[0][0]:.6f} -> {h_dp[-1][0]:.6f}")
    row = run_cli("mlp", "--train")
    if not row["last_loss"] < row["first_loss"]:
        fail(f"MLP fit CLI: {row}")

    # -- device time of a step ----------------------------------------------
    xb, yb = dp._shard(xs, ys)

    def steps(k=10):
        for _ in range(k):
            dp.params, dp.opt_state, loss, _ = dp._step(dp.params,
                                                        dp.opt_state, xb, yb)
        return device_sync(loss)

    steps()
    t0 = time.perf_counter()
    steps()
    bare = time.perf_counter() - t0
    print(f"MLP step at batch {MLP_BATCH}: {bare / 10 * 1e3:.4f} ms "
          f"({6 * MLP_BATCH * ML.param_count(cfg) / (bare / 10) / 1e12:.2f} "
          f"TFLOP/s of the 6·batch·params model) [{card}]")
    profile_run(steps, card, "MLP", f"10 f32 steps at batch {MLP_BATCH}",
                bare)


def ccd_phase(dev, card: str) -> None:
    """Phase 35: CCD++ (no kernel of ours): the card against the CPU on a
    small input, benchmark at MovieLens-20M width (a falling RMSE, seconds
    an epoch), and the CLI at its defaults."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import ccd as CD
    from harp_tpu_torch.models.mfsgd import synthetic_ratings

    u, i, v = synthetic_ratings(130, 96, 8000, rank=4, noise=0.05, seed=0)
    gen = torch.Generator().manual_seed(0)
    state = {"W": torch.rand((130, 8), generator=gen),
             "H": torch.rand((96, 8), generator=gen)}
    got = []
    for device in (None, "cpu"):
        m = CD.CCD(130, 96, CD.CCDConfig(rank=8, reg=0.05), device=device,
                   state=state)
        m.set_ratings(u, i, v)
        got.append((m.train_epochs(3), m.W.cpu().numpy(), m.H.cpu().numpy()))
    if not all(np.allclose(a, b, rtol=1e-4, atol=1e-6)
               for a, b in zip(got[0], got[1])):
        fail("CCD: the card and the CPU disagree on a small input")
    print(f"CCD: card == CPU (rtol 1e-4) over 3 epochs at 130 x 96, rank 8 "
          f"(RMSE {got[0][0][0]:.6f} -> {got[0][0][-1]:.6f})")
    torch.cuda.reset_peak_memory_stats()
    r = CD.benchmark(ML_USERS, ML_ITEMS, ML_NNZ, rank=CCD_RANK, epochs=2)
    if not (np.isfinite(r["rmse_final"]) and r["rmse_final"] < r["rmse_first"]):
        fail(f"CCD benchmark: {r}")
    print(f"CCD benchmark at {ML_USERS} x {ML_ITEMS}, {ML_NNZ} ratings, rank "
          f"{CCD_RANK}: {r['sec_per_epoch']:.6f} s an epoch, "
          f"{r['coord_updates_per_sec']:.6e} coordinate updates/s, RMSE "
          f"{r['rmse_first']:.6f} -> {r['rmse_final']:.6f}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"[{card}]")
    row = run_cli("ccd")
    if not row["rmse_final"] < row["rmse_first"]:
        fail(f"CCD CLI row: {row}")


def stats_phase(dev, card: str) -> None:
    """Phase 36: the stats suite (no kernel of ours) on 10M x 64 f32 rows
    drawn on the card (moments, covariance, PCA, linreg, ridge, TSQR, SVD,
    naive Bayes: seconds, rows/s, peak memory), the card against the CPU on
    a 20,000-row slice, TSQR's residual, the TF32 check, and ALS at
    MovieLens-1M's counts."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import stats as ST

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the test suite's rows (torch_world.stats_inputs): distinct column
    # scales (separated eigenvalues) and a mean of 2, so no sum sits near 0
    # where an f32 sum has no relative precision; the regressions take the
    # centered rows, as there
    z = torch.randn((STATS_N, STATS_D), generator=gen, device=dev)
    z *= torch.linspace(0.5, 3.0, STATS_D, device=dev)
    x = z + 2.0
    w_true = torch.randn((STATS_D,), generator=gen, device=dev)
    y = z @ w_true + 0.01 * torch.randn((STATS_N,), generator=gen,
                                        device=dev) + 1.5
    cls = torch.randint(0, 4, (STATS_N,), generator=gen, device=dev)
    # multinomial NB reads counts: nonnegative rows, each class boosting its
    # own quarter of the features (the CLI's task)
    xa = z.abs() + 3.0 * (torch.arange(STATS_D, device=dev)[None, :] % 4
                          == cls[:, None])
    apps = {
        "moments": lambda X, Y, C, d: ST.moments(X, device=d),
        "covariance": lambda X, Y, C, d: ST.covariance(X, device=d),
        "pca": lambda X, Y, C, d: ST.pca(X, device=d),
        "linreg": lambda X, Y, C, d: ST.linear_regression(X, Y, device=d),
        "ridge": lambda X, Y, C, d: ST.ridge_regression(X, Y, l2=1.0,
                                                        device=d),
        "tsqr": lambda X, Y, C, d: ST.tsqr(X, device=d),
        "svd": lambda X, Y, C, d: ST.svd(X, device=d),
        "naive_bayes": lambda X, Y, C, d: ST.naive_bayes_fit(X, C, 4,
                                                             device=d)}
    rows_of = {"naive_bayes": "xa", "linreg": "z", "ridge": "z"}
    data = {"x": x, "z": z, "xa": xa}
    full = {}
    for name, fn in apps.items():
        X = data[rows_of.get(name, "x")]
        fn(X[:100_000], y[:100_000], cls[:100_000], None)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        full[name] = fn(X, y, cls, None)
        dt = time.perf_counter() - t0
        print(f"stats {name} at {STATS_N} x {STATS_D}: {dt:.4f} s, "
              f"{STATS_N / dt:.6e} rows/s, peak device memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} "
              f"GiB above the {base / 2 ** 30:.3f} GiB of inputs [{card}]")
    del X
    q, r = full["tsqr"]
    qd = torch.from_numpy(q).to(dev)
    resid = float(torch.linalg.norm(qd @ torch.from_numpy(r).to(dev) - x)
                  / torch.linalg.norm(x))
    del qd
    if not resid < 1e-5:
        fail(f"stats tsqr: relative residual {resid} at {STATS_N} rows")
    coef, icpt = full["linreg"]  # fitted on the centered rows z
    if not (np.allclose(coef, w_true.cpu().numpy(), atol=1e-3)
            and abs(float(icpt) - 1.5) < 1e-3):
        fail(f"stats linreg: coefficients off the planted ones")
    nb_acc = float((ST.naive_bayes_predict(
        full["naive_bayes"], xa[:50_000].cpu().numpy())
        == cls[:50_000].cpu().numpy()).mean())
    print(f"stats: TSQR residual {resid:.3e}; linreg recovers the planted "
          f"coefficients (atol 1e-3); NB train_acc {nb_acc:.4f} on 50k rows; "
          f"top eigenvalues {np.round(full['pca'][1][:3], 6).tolist()}, "
          f"singular values {np.round(full['svd'][1][:3], 3).tolist()}")
    if nb_acc < 0.9:
        fail(f"stats naive_bayes: train_acc {nb_acc}")

    # the card against the CPU on a slice, at the stats tolerances
    n = STATS_CHECK_N
    sl = {"x": x[:n], "z": z[:n], "y": y[:n], "c": cls[:n], "xa": xa[:n]}
    host = {k: v.cpu() for k, v in sl.items()}
    tight = dict(rtol=1e-5, atol=1e-6)

    def worst(pairs):
        # (key, the largest |a - b| over rtol|b| + atol) of each pair
        return max(((k, float((np.abs(np.asarray(u) - np.asarray(v)) / (
            tight["atol"] + tight["rtol"] * np.abs(np.asarray(v)))).max()))
            for k, u, v in pairs), key=lambda t: t[1])

    for name, fn in apps.items():
        rows = rows_of.get(name, "x")
        a = fn(sl[rows], sl["y"], sl["c"], None)
        b = fn(host[rows], host["y"], host["c"], "cpu")
        if name in ("moments", "naive_bayes"):
            key, r = worst([(k, a[k], b[k]) for k in b])
            ok = r <= 1.0
        elif name in ("covariance", "linreg", "ridge"):
            key, r = worst([(str(i), u, v) for i, (u, v) in enumerate(zip(a,
                                                                          b))])
            ok = r <= 1.0
        elif name == "pca":
            ok = (np.allclose(a[1], b[1], rtol=1e-4) and np.allclose(
                np.abs((a[0] * b[0]).sum(1)), 1.0, atol=1e-3))
        elif name == "tsqr":
            xs = host["x"].numpy()
            ok = (np.linalg.norm(a[0] @ a[1] - xs) / np.linalg.norm(xs) < 1e-5
                  and np.allclose(np.abs(a[1]), np.abs(b[1]), rtol=1e-4,
                                  atol=1e-4 * np.abs(b[1]).max()))
        else:
            ok = np.allclose(a[1], b[1], rtol=1e-4)
        if not ok:
            detail = (f" (worst: {key}, {r:.3g} of the tolerance)"
                      if name in ("moments", "naive_bayes", "covariance",
                                  "linreg", "ridge") else "")
            fail(f"stats {name}: the card and the CPU disagree on {n} "
                 f"rows{detail}")
    # TF32: the port's covariance (TF32 off) against an f64 host Gram, and
    # the same Gram taken with TF32 on for contrast
    xs = host["x"].numpy().astype(np.float64)
    xc = xs - xs.mean(0)
    c64 = xc.T @ xc / n
    _, c32 = ST.covariance(sl["x"])
    err = np.linalg.norm(c32 - c64) / np.linalg.norm(c64)
    torch.backends.cuda.matmul.allow_tf32 = True
    xcd = sl["x"] - sl["x"].mean(0)
    ctf = ((xcd.T @ xcd) / n).cpu().numpy()
    torch.backends.cuda.matmul.allow_tf32 = False
    err_tf = np.linalg.norm(ctf - c64) / np.linalg.norm(c64)
    if not err <= 1e-5:
        fail(f"stats covariance: {err} from the f64 host Gram (TF32 on?)")
    print(f"stats: card == CPU on {n} rows for all 8 apps (rtol 1e-5 / atol "
          f"1e-6; PCA, TSQR and SVD rtol 1e-4, vectors up to sign); "
          f"covariance {err:.3e} from the f64 host Gram (the same Gram with "
          f"TF32 on: {err_tf:.3e}) [{card}]")
    del x, z, y, cls, xa, data, sl, xcd
    torch.cuda.empty_cache()

    # ALS at MovieLens-1M's counts, drawn as the CLI draws its ratings
    rng = np.random.default_rng(0)
    users = rng.integers(0, ALS_USERS, ALS_NNZ).astype(np.int32)
    items = rng.integers(0, ALS_ITEMS, ALS_NNZ).astype(np.int32)
    vals = rng.normal(size=ALS_NNZ).astype(np.float32)
    m = int(np.bincount(users, minlength=ALS_USERS).max())
    cells, r_ = ALS_USERS * m, ALS_RANK
    # the [users, m] lists (int32 ids, their int64 copy, f32 ratings and
    # mask), the W step's gathered [users, m, r] twice, the H step's
    # [users*m, r, r] outer products and its [users*m, r] rows twice
    reckon = cells * (4 + 8 + 4 + 4 + 2 * 4 * r_ + 4 * r_ * r_ + 2 * 4 * r_)
    print(f"ALS: {ALS_USERS} users x {ALS_ITEMS} items, {ALS_NNZ} ratings, "
          f"at most {m} a user: padded lists [{ALS_USERS}, {m}], reckoned "
          f"peak {reckon / 2 ** 20:.1f} MiB")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    _, _, hist = ST.als(users, items, vals, ALS_USERS, ALS_ITEMS,
                        rank=ALS_RANK, iters=ALS_ITERS)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        fail(f"ALS: RMSE history {hist} not finite and falling")
    print(f"ALS rank {ALS_RANK}, {ALS_ITERS} iterations: "
          f"{dt / ALS_ITERS:.4f} s an iteration (host prep included), RMSE "
          f"{[round(h, 6) for h in hist]}, peak device memory "
          f"{peak / 2 ** 20:.1f} MiB (reckoned {reckon / 2 ** 20:.1f}) "
          f"[{card}]")


def wmds_phase(dev, card: str) -> None:
    """Phase 37: weighted WDA-MDS (no kernel of ours) at wdamds.benchmark's
    width: a seeded symmetric 10 % of the pairs weighted 0 with their δ
    corrupted x5; iterations/s and the weighted stress; unit weights
    against the unweighted stress; the card against the CPU at n = 256."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import wdamds as WD

    def weighted(n, seed):
        delta = WD.benchmark_delta(n, seed)
        rng = np.random.default_rng(seed)
        ii, jj = np.triu_indices(n, 1)
        sel = rng.choice(len(ii), size=len(ii) // 10, replace=False)
        w = np.ones((n, n), np.float32)
        w[ii[sel], jj[sel]] = w[jj[sel], ii[sel]] = 0.0
        bad = delta.copy()
        bad[ii[sel], jj[sel]] *= 5.0
        bad[jj[sel], ii[sel]] *= 5.0
        return delta, bad, w

    delta, bad, w = weighted(MDS_N, 0)
    cfg = WD.MDSConfig(dim=MDS_DIM, iters=MDS_ITERS, cg_iters=WMDS_CG)
    WD.mds(bad, cfg, weights=w)  # warm-up
    t0 = time.perf_counter()
    X, stress = WD.mds(bad, cfg, weights=w)
    dt = time.perf_counter() - t0
    Xu, stress_u = WD.mds(bad, cfg)

    def true_stress(X):
        d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
        return float(((delta - d) ** 2)[np.triu_indices(MDS_N, 1)].sum())

    if not (np.isfinite(X).all() and np.isfinite(stress)):
        fail("weighted MDS: non-finite result")
    ts_w, ts_u = true_stress(X), true_stress(Xu)
    if not ts_w < ts_u:
        fail(f"weighted MDS: zero weights did not hide the corrupted δ "
             f"({ts_w} vs unweighted {ts_u})")
    _, s_u = WD.mds(delta, cfg)
    _, s_1 = WD.mds(delta, cfg, weights=np.ones_like(delta))
    if abs(s_1 - s_u) > 1e-3 * abs(s_u):
        fail(f"weighted MDS: unit weights give {s_1}, unweighted {s_u}")
    d_s, b_s, w_s = weighted(WMDS_SMALL, 1)
    got = [WD.mds(b_s, cfg, weights=w_s, device=d) for d in (None, "cpu")]
    if not (abs(got[0][1] - got[1][1]) <= 1e-3 * abs(got[1][1])
            and np.allclose(got[0][0], got[1][0], atol=1e-3)):
        fail("weighted MDS: the card and the CPU disagree at n = "
             f"{WMDS_SMALL}")
    print(f"weighted MDS at n = {MDS_N}, dim {MDS_DIM}, {MDS_ITERS} "
          f"iterations x {WMDS_CG} CG steps: {MDS_ITERS / dt:.4f} iters/s "
          f"({dt:.4f} s a run, H2D included), weighted stress {stress:.6e} "
          f"(the unweighted solver's stress on the same δ {stress_u:.6e}); "
          f"stress against the clean δ {ts_w:.6e} weighted vs {ts_u:.6e} "
          f"unweighted; unit weights {s_1:.6e} vs unweighted {s_u:.6e}; "
          f"card == CPU at n = {WMDS_SMALL} (rtol 1e-3) [{card}]")


def write_libsvm(path, x, y) -> None:
    """``x`` [n, d] dense rows with zeros, ``y`` labels: a 1-based libsvm
    text file of the nonzeros."""
    import numpy as np

    r, c = np.nonzero(x)
    vals = x[r, c].tolist()
    cols = (c + 1).tolist()
    ptr = np.searchsorted(r, np.arange(x.shape[0] + 1)).tolist()
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            a, b = ptr[i], ptr[i + 1]
            f.write(f"{int(y[i])} " + " ".join(
                f"{j}:{v:.6g}" for j, v in zip(cols[a:b], vals[a:b])) + "\n")


def svm_sparse_phase(dev, card: str, tmp: str) -> None:
    """Phase 38: SVM's sparse path (no kernel of ours: K5 takes dense rows)
    on a seeded 500k x 128 libsvm file at 10 % density: the native parser
    against the Python one, fit_sparse and the --libsvm CLI on the card
    (samples/s, train_acc), and the card against the CPU on a small file."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import svm as SV
    from harp_tpu_torch.native import datasource as DS

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((SVMS_N, SVMS_D), dtype=np.float32)
         * (rng.random((SVMS_N, SVMS_D), dtype=np.float32) < SVMS_DENSITY))
    y = np.sign(x @ rng.normal(size=SVMS_D).astype(np.float32)
                + 0.1 * rng.normal(size=SVMS_N).astype(np.float32))
    y[y == 0] = 1.0
    path = os.path.join(tmp, "svm.libsvm")
    head = os.path.join(tmp, "svm_head.libsvm")
    t0 = time.perf_counter()
    write_libsvm(path, x, y)
    t1 = time.perf_counter()
    native = DS.load_libsvm(path)
    t2 = time.perf_counter()
    t_cut = time.perf_counter()
    write_libsvm(head, x[:SVMS_PARSE_N], y[:SVMS_PARSE_N])
    load_native = DS.load_native
    DS.load_native = lambda: None
    try:
        python = DS.load_libsvm(head)
    finally:
        DS.load_native = load_native
    native_head = DS.load_libsvm(head)
    t3 = time.perf_counter()
    if not all(np.array_equal(a, b) for a, b in zip(native_head[:4],
                                                    python[:4])
               ) or native_head[4] != python[4]:
        fail("libsvm: the native parser and the Python parse disagree")
    print(f"cut: the Python libsvm parse on the first {SVMS_PARSE_N} rows "
          f"(from {SVMS_N}; its file written and parsed both ways) took "
          f"{t3 - t_cut:.1f} s")
    os.unlink(head)
    labels, indptr, indices, values, nf = native
    ids, vals, mask = DS.csr_to_ell(indptr, indices, values)
    print(f"libsvm {SVMS_N} x {SVMS_D} at {SVMS_DENSITY:.0%}: "
          f"{len(values)} nonzeros, ELL width {ids.shape[1]}; written in "
          f"{t1 - t0:.1f} s, native parse {t2 - t1:.3f} s; on its first "
          f"{SVMS_PARSE_N} rows native and Python parses equal")
    yl = np.where(labels == 1.0, 1.0, -1.0).astype(np.float32)
    SV.SVM().fit_sparse(ids[:4096], vals[:4096], mask[:4096], yl[:4096], nf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = SV.SVM().fit_sparse(ids, vals, mask, yl, nf)
    dt = time.perf_counter() - t0
    acc = float((np.sign((vals * model.w[ids] * mask).sum(1) + model.b)
                 == yl).mean())
    if acc < SVMS_ACC_FLOOR:
        fail(f"SVM fit_sparse: train_acc {acc}")
    row = run_cli("svm", "--libsvm", path)
    if row["train_acc"] < SVMS_ACC_FLOOR or row["n"] != SVMS_N:
        fail(f"SVM --libsvm CLI row: {row}")
    sm = slice(0, SVMS_SMALL)
    fits = [SV.SVM(device=d).fit_sparse(ids[sm], vals[sm], mask[sm], yl[sm],
                                        nf) for d in (None, "cpu")]
    if not (np.allclose(fits[0].w, fits[1].w, rtol=1e-3, atol=1e-5)
            and abs(fits[0].b - fits[1].b) <= 1e-3 * abs(fits[1].b) + 1e-5):
        fail("SVM fit_sparse: the card and the CPU disagree on "
             f"{SVMS_SMALL} rows")
    print(f"SVM fit_sparse at {SVMS_N} x {SVMS_D}: {SVMS_N / dt:.6e} "
          f"samples/s ({dt:.3f} s a fit), train_acc {acc:.4f}; CLI "
          f"--libsvm train_acc {row['train_acc']:.4f}; card == CPU on "
          f"{SVMS_SMALL} rows (rtol 1e-3) [{card}]")
    os.unlink(path)


class timed_saves:
    """Within the block, every CheckpointManager.save is timed and its
    directory's bytes counted: (seconds, bytes) a save, in ``self.saves``."""

    def __enter__(self):
        from harp_tpu_torch.utils import checkpoint as CK

        self._cls, self._orig, self.saves = CK.CheckpointManager, \
            CK.CheckpointManager.save, []
        orig = self._orig

        def save(mgr, step, state):
            t0 = time.perf_counter()
            out = orig(mgr, step, state)
            dt = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(out, f))
                         for f in os.listdir(out))
            self.saves.append((dt, nbytes))
            return out

        self._cls.save = save
        return self

    def __exit__(self, *exc):
        self._cls.save = self._orig

    def line(self) -> str:
        if not self.saves:
            return "no checkpoint written"
        secs = [a for a, _ in self.saves]
        return (f"{len(self.saves)} checkpoints, {sum(secs) / len(secs):.4f} "
                f"s and {self.saves[-1][1]} bytes a checkpoint")


def durable_phase(dev, card: str, tmp: str) -> dict:
    """Phase 39: durable runs on the kernels.  Each recovered run takes an
    injected ckpt_write fault on its second checkpoint (the step before it
    is replayed) and a worker failure at iteration or chunk 2, and must end
    on the uninterrupted run's bits: KMeans graded config #1 int8 (K1) and
    f32 use_pallas (K2), MF-SGD on K3, LDA on K4 and CCD++ (its sums add
    in an order fixed at set_ratings, so a second uninterrupted run is
    bit-equal too), and the MLP within rtol 1e-5 (its float index_add_ is
    not bit-deterministic on the card); streaming KMeans int8 at
    500k x 300 killed after two epochs and resumed through the CLI's
    --resume.  Returns each kernel's launches
    on the recovered runs."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import ccd as CD
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.models import mlp as ML
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.utils.checkpoint import CheckpointManager
    from harp_tpu_torch.utils.fault import (FaultInjector, InjectedFault,
                                            WorkerFailure)

    def injector():
        return FaultInjector(fail_at=(2,), fail={"ckpt_write": (2,)})

    def recovered(run, name):
        inj = injector()
        with inj.arm(), timed_saves() as ts:
            out = run(inj)
        if inj.fired != [2] or inj.injected["ckpt_write"] != 1:
            fail(f"{name}: the injected faults did not fire ({inj.fired}, "
                 f"{inj.counters()})")
        return out, ts.line()

    launches = {}
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(K, D)).astype(np.float32) * 8.0
    pts = centers[rng.integers(0, K, N)]
    pts += rng.normal(size=(N, D)).astype(np.float32)
    for name, kw, kernel in (("int8", {"quantize": "int8"},
                              "kmeans_partials_int8"),
                             ("f32 use_pallas", {"use_pallas": True},
                              "kmeans_partials")):
        KK.reset_launches()
        clean = KM.fit(pts, k=K, iters=ITERS, seed=0, **kw)
        n_clean = KK.LAUNCHES[kernel]
        ck = os.path.join(tmp, f"kmeans-{kernel}")
        KK.reset_launches()  # this path's run starts here
        got, saves = recovered(lambda inj: KM.fit(
            pts, k=K, iters=ITERS, seed=0, ckpt_dir=ck,
            ckpt_every=DUR_EVERY, fault=inj, **kw), f"KMeans {name}")
        launches[kernel] = KK.LAUNCHES[kernel]  # ... and ends here
        if not (np.array_equal(got[0], clean[0]) and got[1] == clean[1]):
            fail(f"KMeans {name}: the recovered centroids differ from the "
                 "uninterrupted run's")
        if (n_clean, launches[kernel]) != (ITERS, ITERS + DUR_EVERY):
            fail(f"KMeans {name}: launches {n_clean} uninterrupted and "
                 f"{launches[kernel]} recovered, expected {ITERS} and "
                 f"{ITERS + DUR_EVERY} (one chunk replayed)")
        print(f"durable KMeans {name} ({kernel}) at {N} x {D}, k={K}, "
              f"{ITERS} iterations, ckpt_every {DUR_EVERY}: recovered "
              f"centroids and inertia bit-equal to the uninterrupted fit; "
              f"launches {n_clean} uninterrupted, {launches[kernel]} "
              f"recovered (a chunk replayed); {saves} [{card}]")
    # a ckpt_write fault alone: the write's tmp.* stays, no step is damaged
    mgr = CheckpointManager(os.path.join(tmp, "ckpt-write"))
    mgr.save(0, {"centroids": clean[0]})
    inj = FaultInjector(fail={"ckpt_write": (1,)})
    with inj.arm():
        try:
            mgr.save(1, {"centroids": clean[0] + 1})
            fail("ckpt_write: the injected fault did not fire")
        except InjectedFault:
            pass
    left = sorted(os.listdir(mgr.root))
    step, st = mgr.restore_latest()
    if left != ["step_000000000000", "tmp.000000000001"] or step != 0 \
            or not np.array_equal(st["centroids"], clean[0]):
        fail(f"ckpt_write fault: left {left}, restored step {step}")
    print(f"ckpt_write fault: left {left}; step 0 restores bit-equal")
    del pts

    # MF-SGD on K3, at MovieLens-20M width with fewer ratings
    m = MF.MFSGD(ML_USERS, ML_ITEMS, MF.MFSGDConfig(rank=ML_RANK,
                                                    algo="pallas"), seed=0)
    m.set_ratings(*MF.synthetic_ratings(ML_USERS, ML_ITEMS, DUR_ML_NNZ,
                                        seed=0))
    W0, H0 = m.W.clone(), m.H.clone()
    m.fit(DUR_EPOCHS)
    clean = (m.W.clone(), m.H.clone())
    m.W, m.H = W0.clone(), H0.clone()
    K3.reset_launches()
    _, saves = recovered(lambda inj: m.fit(
        DUR_EPOCHS, os.path.join(tmp, "mfsgd"), ckpt_every=1, fault=inj),
        "MF-SGD")
    launches["sgd_tile_update"] = K3.LAUNCHES["sgd_tile_update"]
    if not (torch.equal(m.W, clean[0]) and torch.equal(m.H, clean[1])):
        fail("MF-SGD: the recovered factors differ from the uninterrupted "
             "run's")
    if launches["sgd_tile_update"] != 2 * (DUR_EPOCHS + 1):
        fail(f"MF-SGD: {launches['sgd_tile_update']} K3 launches recovered")
    print(f"durable MF-SGD (K3) at {ML_USERS} x {ML_ITEMS}, {DUR_ML_NNZ} "
          f"ratings, rank {ML_RANK}, {DUR_EPOCHS} epochs, ckpt_every 1: W "
          f"and H bit-equal to the uninterrupted fit; K3 launches "
          f"{launches['sgd_tile_update']} (an epoch replayed); {saves} "
          f"[{card}]")
    del m, W0, H0, clean

    # LDA on K4, at the benchmark's vocabulary and topics with fewer docs
    lda = LD.LDA(DUR_LDA_DOCS, LDA_VOCAB, LD.LDAConfig(n_topics=LDA_TOPICS,
                                                       algo="pallas"), seed=0)
    lda.set_tokens(*LD.benchmark_corpus(DUR_LDA_DOCS, LDA_VOCAB, LDA_TPD, 0))
    snap = (lda.Ndk.clone(), lda.Nwk.clone(), lda.Nk.clone(),
            lda.z_grid.clone(), lda._gen.get_state())
    lda.fit(DUR_EPOCHS)
    clean = (lda.Ndk.clone(), lda.Nwk.clone(), lda.z_grid.clone())
    lda.Ndk, lda.Nwk, lda.Nk, lda.z_grid = (t.clone() for t in snap[:4])
    lda._gen.set_state(snap[4])
    K4.reset_launches()
    _, saves = recovered(lambda inj: lda.fit(
        DUR_EPOCHS, os.path.join(tmp, "lda"), ckpt_every=1, fault=inj),
        "LDA")
    launches["cgs_entry_update"] = K4.LAUNCHES["cgs_entry_update"]
    if not all(torch.equal(a, b) for a, b in zip(
            (lda.Ndk, lda.Nwk, lda.z_grid), clean)):
        fail("LDA: the recovered counts differ from the uninterrupted run's")
    if launches["cgs_entry_update"] != 2 * (DUR_EPOCHS + 1):
        fail(f"LDA: {launches['cgs_entry_update']} K4 launches recovered")
    print(f"durable LDA (K4) at {DUR_LDA_DOCS} docs x {LDA_VOCAB} words, "
          f"{LDA_TOPICS} topics, {DUR_EPOCHS} epochs, ckpt_every 1: Ndk, Nwk "
          f"and z bit-equal to the uninterrupted chain; K4 launches "
          f"{launches['cgs_entry_update']} (an epoch replayed); {saves} "
          f"[{card}]")
    del lda, snap, clean

    # CCD++ adds its sums in a fixed order: two uninterrupted runs and the
    # recovered one end on the same bits.  The MLP's float index_add_ on
    # the card is not bit-deterministic: its recovered run is held to
    # rtol 1e-5
    def rel(a, b, atol):
        # the least rtol at which allclose(a, b, rtol, atol) holds
        return max(float(((u - v).abs() - atol).clamp_min(0).div(
            v.abs()).nan_to_num(0.0).max()) for u, v in zip(a, b))

    c = CD.CCD(ML_USERS, ML_ITEMS, CD.CCDConfig(rank=CCD_RANK), seed=0)
    c.set_ratings(*MF.synthetic_ratings(ML_USERS, ML_ITEMS, DUR_ML_NNZ,
                                        seed=0))
    W0, H0 = c.W.clone(), c.H.clone()
    runs = []
    for _ in range(2):
        c.W, c.H = W0.clone(), H0.clone()
        c.fit(DUR_EPOCHS)
        runs.append((c.W.clone(), c.H.clone()))
    c.W, c.H = W0.clone(), H0.clone()
    _, saves = recovered(lambda inj: c.fit(
        DUR_EPOCHS, os.path.join(tmp, "ccd"), ckpt_every=1, fault=inj),
        "CCD")
    spread = rel(runs[1], runs[0], 1e-6)
    err = rel((c.W, c.H), runs[0], 1e-6)
    print(f"durable CCD++ rank {CCD_RANK}, {DUR_ML_NNZ} ratings: recovered "
          f"within rtol {err:.3e} (atol 1e-6) of the uninterrupted fit, two "
          f"uninterrupted fits within rtol {spread:.3e} of each other; "
          f"{saves} [{card}]")
    if not all(torch.equal(a, b) for run in (runs[1], (c.W, c.H))
               for a, b in zip(run, runs[0])):
        fail("CCD: the recovered factors, or a second uninterrupted run's, "
             "differ from the uninterrupted run's")
    del c, runs, W0, H0
    x, yy = ML.synthetic_mnist(n=MLP_N, seed=0)
    cfg = ML.MLPConfig(optimizer="momentum")
    a = ML.MLPTrainer(cfg, seed=0)
    a.fit_ckpt(x, yy, DUR_EPOCHS, batch_size=MLP_BATCH)
    b = ML.MLPTrainer(cfg, seed=0)
    _, saves = recovered(lambda inj: b.fit_ckpt(
        x, yy, DUR_EPOCHS, os.path.join(tmp, "mlp"), batch_size=MLP_BATCH,
        ckpt_every=1, fault=inj), "MLP")
    err = rel([pb[k] for pb in b.params for k in pb],
              [pa[k] for pa in a.params for k in pa], 1e-6)
    print(f"durable MLP fit_ckpt at MNIST width, {MLP_N} samples, batch "
          f"{MLP_BATCH}, momentum: recovered params within rtol {err:.3e} "
          f"(atol 1e-6) of the uninterrupted run's; {saves} [{card}]")
    if not all(torch.allclose(pa[k], pb[k], rtol=1e-5, atol=1e-6)
               for pa, pb in zip(a.params, b.params) for k in pa):
        fail("MLP fit_ckpt: the recovered params are not within rtol 1e-5")
    del a, b, x, yy

    # streaming KMeans int8 from a .npy, killed after two epochs and resumed
    # through the CLI
    path = os.path.join(tmp, "stream.npy")
    t_cut = t0 = time.perf_counter()
    arr = np.lib.format.open_memmap(path, mode="w+", dtype=np.float16,
                                    shape=(DUR_STREAM_N, STREAM_D))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cent = torch.randn((STREAM_K, STREAM_D), generator=gen, device=dev) * 4
    step = 1_000_000
    for lo in range(0, DUR_STREAM_N, step):
        hi = min(lo + step, DUR_STREAM_N)
        pick = torch.randint(0, STREAM_K, (hi - lo,), generator=gen,
                             device=dev)
        arr[lo:hi] = (cent[pick] + torch.randn((hi - lo, STREAM_D),
                                                generator=gen, device=dev)
                      ).half().cpu().numpy()
    arr.flush()
    del arr, cent
    pts = np.load(path, mmap_mode="r")
    kw = dict(k=STREAM_K, iters=DUR_STREAM_EPOCHS, chunk_points=STREAM_CHUNK,
              quantize="int8", seed=0)
    print(f"stream data: {DUR_STREAM_N} x {STREAM_D} f16 .npy written in "
          f"{time.perf_counter() - t0:.1f} s")
    KK.reset_launches()
    t0 = time.perf_counter()
    c_clean, i_clean = KS.fit_streaming(pts, **kw)
    t_clean = time.perf_counter() - t0
    n_clean = KK.LAUNCHES["kmeans_partials_int8"]
    ck = os.path.join(tmp, "stream-ckpt")
    KK.reset_launches()
    with timed_saves() as ts:
        try:
            KS.fit_streaming(pts, ckpt_dir=ck, ckpt_every=1, max_restarts=0,
                             fault=FaultInjector(fail_at=(2,)), **kw)
            fail("streaming: the injected failure did not stop the run")
        except WorkerFailure:
            pass
    killed = KK.LAUNCHES["kmeans_partials_int8"]
    launches["stream_kmeans_partials_int8"] = killed
    if CheckpointManager(ck).latest_step() != 1:
        fail("streaming: the killed run did not leave epoch 2's checkpoint")
    row = run_cli("kmeans-stream", "--input", path, "--k", str(STREAM_K),
                  "--iters", str(DUR_STREAM_EPOCHS), "--chunk",
                  str(STREAM_CHUNK), "--quantize", "int8", "--ckpt-dir", ck,
                  "--ckpt-every", "1", "--resume")
    _, st = CheckpointManager(ck).restore_latest()
    if not (row["resumed_from"] == 1 and row["inertia"] == i_clean
            and np.array_equal(st["centroids"], c_clean)):
        fail(f"streaming: the resumed run differs from the uninterrupted "
             f"one (inertia {row['inertia']} vs {i_clean})")
    print(f"durable streaming int8 at {DUR_STREAM_N} x {STREAM_D}, k="
          f"{STREAM_K}, {DUR_STREAM_EPOCHS} epochs: uninterrupted "
          f"{t_clean:.2f} s, {t_clean / DUR_STREAM_EPOCHS:.2f} s an epoch "
          f"({n_clean} K1 launches); killed after 2 epochs "
          f"({killed} K1 launches), resumed by the CLI's --resume: "
          f"centroids and inertia bit-equal; {ts.line()} [{card}]")
    print(f"cut: durable streaming at {DUR_STREAM_N} x {STREAM_D} over "
          f"{DUR_STREAM_EPOCHS} epochs (from 1000000 rows over 4) took "
          f"{time.perf_counter() - t_cut:.1f} s")
    del pts
    os.unlink(path)
    return launches


def _serve_raw(srv, bursts: list, plane: str) -> tuple[list, int]:
    """The raw step outputs, batch by batch as ``(rung, array)``, of the
    requests of ``bursts`` answered by ``Server.process`` a burst at a
    time (``plane`` "burst": batch i+1 is staged while batch i is in
    flight) or all at once by a depth-2 ``ContinuousRunner`` on a fixed
    clock ("continuous": batch t+1 is dispatched before batch t is read
    back); and the most batches that were in flight at once."""
    got, most = [], 1
    readback = srv._readback

    def record(rung, out_dev):
        out = readback(rung, out_dev)
        got.append((rung, out))
        return out

    srv._readback = record
    try:
        if plane == "burst":
            resp = [r for burst in bursts for r in srv.process(burst)]
        else:
            runner = srv.make_runner(depth=2, clock=lambda: 0.0)
            pairs = []
            for i, r in enumerate(r for burst in bursts for r in burst):
                pairs += runner.submit(i, r, now=0.0)
            while runner.pending():
                pairs += runner.step(1.0)
                most = max(most, len(runner._in_flight))
            resp = [r for _, r in sorted(pairs, key=lambda kv: kv[0])]
    finally:
        del srv._readback
    if len(resp) != sum(map(len, bursts)) or any("result" not in r
                                                 for r in resp):
        fail(f"serve {srv.app} ({plane}): a request was not served: "
             f"{[r for r in resp if 'result' not in r][:1]}")
    return got, most


def _serve_agree(app: str, card_out: list, cpu_out: list, topk: int
                 ) -> float:
    """Fail unless the card's raw outputs match the CPU's at the app's
    tolerance; return the largest float difference."""
    import numpy as np

    if [r for r, _ in card_out] != [r for r, _ in cpu_out]:
        fail(f"serve {app}: the card's batches took rungs "
             f"{[r for r, _ in card_out]}, the CPU's "
             f"{[r for r, _ in cpu_out]}")
    worst = 0.0
    for (_, g), (_, c) in zip(card_out, cpu_out):
        if app in ("kmeans", "rf"):
            ok = np.array_equal(g, c)
        elif app == "mfsgd":
            ok = (np.array_equal(g[:, :topk], c[:, :topk])
                  and np.allclose(g[:, topk:], c[:, topk:], rtol=1e-5,
                                  atol=1e-6))
            worst = max(worst, float(np.abs(g[:, topk:] - c[:, topk:]).max()))
        elif app == "lda":
            ok = np.allclose(g, c, rtol=1e-4, atol=1e-6)
        elif app == "mlp":
            # a logit near zero is a cancellation of terms of the row's
            # size: its error is relative to that size, hence the atol
            ok = (np.allclose(g, c, rtol=1e-5,
                              atol=1e-5 * float(np.abs(c).max()))
                  and np.array_equal(g.argmax(1), c.argmax(1)))
        else:
            ok = (np.allclose(g, c, rtol=1e-5,
                              atol=1e-5 * float(np.abs(c).max()))
                  and np.array_equal(g >= 0, c >= 0))
        if app not in ("kmeans", "rf", "mfsgd"):
            worst = max(worst, float(np.abs(g - c).max()))
        if not ok:
            fail(f"serve {app}: the card's step output differs from the "
                 f"CPU's (max |diff| {np.abs(g.astype(np.float64) - c).max()})")
    return worst


def serve_phase(dev, card: str, tmp: str) -> None:
    """Phase 40: every serve engine at full width on the card (module
    docstring).  Needs phase 39's MF-SGD checkpoint under ``tmp``."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import (flash_attention, kmeans_kernel,
                                    lda_kernel, mfsgd_kernel, rf_kernel,
                                    svm_kernel, wdamds_kernel)
    from harp_tpu_torch.ops import build
    from harp_tpu_torch.parallel.mesh import WorkerMesh
    from harp_tpu_torch.serve import bench as SB
    from harp_tpu_torch.serve.engines import ENGINES
    from harp_tpu_torch.serve.server import Server
    from harp_tpu_torch.utils import flightrec, telemetry
    from harp_tpu_torch.utils.checkpoint import CheckpointManager

    if torch.backends.cuda.matmul.allow_tf32:
        fail("serve: TF32 must be off for the card-against-CPU checks")
    kernels = (flash_attention, kmeans_kernel, lda_kernel, mfsgd_kernel,
               rf_kernel, svm_kernel, wdamds_kernel)
    launched = [dict(k.LAUNCHES) for k in kernels]
    builds = set(build.BUILD_LOG)
    mesh, cpu = WorkerMesh(dev), WorkerMesh("cpu")
    print("serve: TF32 off; every product an f32 matmul on both sides")

    # MF-SGD: phase 39's checkpoint holds the trainer's padded layout;
    # serving takes the stripped factors (MFSGD.factors()), written as a
    # checkpoint of their own
    step, st = CheckpointManager(os.path.join(tmp, "mfsgd")).restore_latest()
    m = MF.MFSGD(ML_USERS, ML_ITEMS, MF.MFSGDConfig(rank=ML_RANK,
                                                    algo="pallas"), seed=0)
    m.W, m.H = (torch.as_tensor(st[k]).to(dev) for k in ("W", "H"))
    W, H = m.factors()
    del m, st
    mf_ckpt = os.path.join(tmp, "serve-mfsgd")
    CheckpointManager(mf_ckpt).save(step, {"W": W, "H": H})
    print(f"serve mfsgd: phase 39's checkpoint step {step} exported as "
          f"{W.shape[0]} x {H.shape[0]} factors, rank {W.shape[1]}")

    for app in sorted(ENGINES):
        t0 = time.perf_counter()
        cdir = os.path.join(tmp, f"graphs-{app}")
        kw = ({"ckpt": mf_ckpt} if app == "mfsgd"
              else {"state_shape": SERVE_SHAPES[app]})
        row = SB.benchmark(
            app=app, n_requests=(sum(SERVE_BURSTS) if app == "lda"
                                 else SERVE_REQUESTS),
            burst=SERVE_BURSTS, min_seconds=SERVE_SECONDS, mesh=mesh,
            cache_dir=cdir, **kw)
        n_rungs = len(row["ladder"])
        if not (row["steady_compiles"] == 0 and row["budget_violations"] == 0
                and row["steady_dispatches"] == row["batches"]
                == row["steady_readbacks"] > 0):
            fail(f"serve {app}: steady-state budget broken: {row}")
        if (row["startup_captures"], row["cache_misses"]) != (n_rungs,
                                                               n_rungs):
            fail(f"serve {app}: cold start captured "
                 f"{row['startup_captures']} graphs with "
                 f"{row['cache_misses']} misses for {n_rungs} rungs")
        print(f"serve {app} bench: {row['n_requests']} requests in "
              f"{row['window_s']} s (bursts {SERVE_BURSTS} in turn): "
              f"{row['qps']:.1f} qps, p50/p95/p99 "
              f"{row['p50_ms']}/{row['p95_ms']}/{row['p99_ms']} ms, "
              f"padding_frac {row['padding_frac']}, {row['batches']} "
              f"batches with {row['steady_dispatches']} dispatches and "
              f"{row['steady_readbacks']} readbacks, steady_compiles "
              f"{row['steady_compiles']}; startup {row['startup_sec']} s, "
              f"{row['startup_captures']} captures, cache "
              f"{row['cache_hits']} hits / {row['cache_misses']} misses, "
              f"exec_hbm {row['exec_hbm_bytes']} B [{card}]")
        # the same state (the bench's seed) on a warm start, and the CPU
        state = (None if app == "mfsgd" else ENGINES[app].synthetic_state(
            np.random.default_rng(0), **SERVE_SHAPES[app]))
        opts = {"topk": 10} if app == "mfsgd" else {}
        with telemetry.scope(True):
            t1 = time.perf_counter()
            srv = Server(app, state, ckpt=kw.get("ckpt"), mesh=mesh,
                         cache_dir=cdir, engine_opts=opts)
            info = srv.startup()
            warm_s = time.perf_counter() - t1
            events = {r["event"] for r in flightrec.compile_watch.records}
        if (info["cache_hits"], info["cache_misses"], info["captures"]) != (
                n_rungs, 0, n_rungs) or events != {"graph_capture"} \
                or set(build.BUILD_LOG) != builds:
            fail(f"serve {app}: warm restart {info}, compile events "
                 f"{events}, builds {sorted(set(build.BUILD_LOG) - builds)}")
        ref = Server(app, state, ckpt=kw.get("ckpt"), mesh=cpu,
                     engine_opts=opts)
        ref.startup()
        rng = np.random.default_rng(5)
        bursts = [[srv.engine.synthetic_request(rng, n) for n in b]
                  for b in (SERVE_CHECK_BURSTS_LDA if app == "lda"
                            else SERVE_CHECK_BURSTS)]
        checked = []
        for plane in ("burst", "continuous"):
            got, most = _serve_raw(srv, bursts, plane)
            want, _ = _serve_raw(ref, bursts, plane)
            worst = _serve_agree(app, got, want, 10)
            if plane == "continuous" and most != 2:
                fail(f"serve {app}: the continuous plane never had two "
                     f"batches in flight")
            checked.append(f"{plane} rungs {[r for r, _ in got]} (max "
                           f"float diff {worst:.3e})")
        print(f"serve {app}: warm restart {warm_s:.2f} s, {info['captures']}"
              f" captures, {info['cache_hits']} hits, no kernel build; the "
              f"card's raw outputs match the CPU's batch by batch on "
              f"{sum(map(len, bursts))} requests: {'; '.join(checked)}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        del srv, ref
        torch.cuda.empty_cache()

    res = SB.benchmark_sustained(
        app="kmeans", n_requests=SERVE_SUSTAINED, mesh=mesh,
        state_shape=SERVE_SHAPES["kmeans"], fault_rate=SERVE_FAULT_RATE,
        cache_dir=os.path.join(tmp, "graphs-kmeans"))
    # no deadline and no queue bound: nothing is shed, and at 5 % a batch
    # never fails all 1 + max_retries attempts, so every request is served
    if (res["served_requests"] + res["shed_requests"]
            + res["failed_requests"] != res["offered_requests"]
            or res["served_requests"] != res["offered_requests"]
            or res["engine_failures"] != 0
            or not 0 < res["faults_injected"] == res["fault_retries"]
            or res["steady_compiles"] != 0
            or res["steady_dispatches"] != res["batches"]
            or res["steady_readbacks"] != res["batches"]):
        fail(f"serve sustained: accounting broken: {res}")
    print(f"serve kmeans sustained (fault rate {SERVE_FAULT_RATE}): "
          f"offered {res['offered_qps']} qps, achieved {res['achieved_qps']}"
          f" qps (burst plane {res['burst_qps']}), p50/p99 "
          f"{res['p50_ms']}/{res['p99_ms']} ms; served "
          f"{res['served_requests']} + shed {res['shed_requests']} + failed "
          f"{res['failed_requests']} == offered {res['offered_requests']}; "
          f"faults {res['faults_injected']}, retries {res['fault_retries']}"
          f", budget drift {res['health_budget_drift']} [{card}]")
    after = [dict(k.LAUNCHES) for k in kernels]
    if after != launched:
        fail(f"serve: a kernel launched on the serve path: {launched} -> "
             f"{after}")
    print("serve: K1-K8 launched nothing on the serve path")


def pipeline_phase(dev, card: str) -> None:
    """Phase 41: the pipeline at S = 1 on the card against the CPU."""
    import numpy as np
    import torch

    from harp_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                  pipeline_loss_and_grads)

    rng = np.random.default_rng(0)
    w = (rng.normal(size=(PIPE_W, PIPE_W)) / np.sqrt(PIPE_W)).astype(
        np.float32)
    b = rng.normal(size=PIPE_W).astype(np.float32) * 0.1
    x = rng.normal(size=(PIPE_M, PIPE_MB, PIPE_W)).astype(np.float32)
    t = rng.normal(size=(PIPE_M, PIPE_MB, PIPE_W)).astype(np.float32)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def loss(o, tt):
        return ((o - tt) ** 2).mean()

    got = {}
    for where in (dev, torch.device("cpu")):
        p = {"w": torch.tensor(w, device=where),
             "b": torch.tensor(b, device=where)}
        t0 = time.perf_counter()
        out = pipeline_forward(stage, p, x, device=where)
        lval, g = pipeline_loss_and_grads(stage, loss, p, x, t, device=where)
        vals = (out.cpu().numpy(), float(lval), g["w"].cpu().numpy(),
                g["b"].cpu().numpy())
        got[where.type] = (vals, time.perf_counter() - t0)
    (co, cl, cw, cb), card_s = got["cuda"]
    (ho, hl, hw, hb), _ = got["cpu"]
    errs = [float(np.abs(a - c).max()) for a, c in ((co, ho), (cw, hw),
                                                     (cb, hb))]
    if not (np.allclose(co, ho, rtol=1e-4, atol=1e-5)
            and abs(cl - hl) <= 1e-4 * abs(hl) + 1e-5
            and np.allclose(cw, hw, rtol=1e-4, atol=1e-5)
            and np.allclose(cb, hb, rtol=1e-4, atol=1e-5)
            and np.isfinite(cw).all() and np.isfinite(cb).all()):
        fail(f"pipeline: the card differs from the CPU (max |diff| of "
             f"outputs, gw, gb: {errs}; loss {cl} vs {hl})")
    print(f"pipeline S=1, M={PIPE_M} x [{PIPE_MB}, {PIPE_W}]: outputs, loss"
          f" and stage gradients match the CPU (max |diff| {errs}); "
          f"{card_s:.2f} s for a forward and a loss-and-grads [{card}]")


def telemetry_phase(dev, card: str, tmp: str) -> int:
    """Phase 42: KMeans fit at graded config #1 (int8, K1) with telemetry
    off, then on: the zero-cost contract (bit-equal result, the same K1
    launches, dispatches and readbacks), the export's timeline, skew and
    report rows, and the report/timeline/health CLIs and the serve CLI's
    report.  Returns K1's launches on the telemetry run."""
    import numpy as np

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.utils import flightrec, steptrace, telemetry

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(K, D)).astype(np.float32) * 8.0
    pts = centers[rng.integers(0, K, N)]
    pts += rng.normal(size=(N, D)).astype(np.float32)
    path = os.path.join(tmp, "telemetry.jsonl")

    def run(on: bool):
        seen = {"dispatches": 0, "readbacks": 0}

        def bump(key):
            return lambda *a: seen.__setitem__(key, seen[key] + 1)

        KK.reset_launches()
        with flightrec.observe_dispatches(bump("dispatches")), \
                flightrec.observe_readbacks(bump("readbacks")), \
                telemetry.scope(on):
            t0 = time.perf_counter()
            c, inertia = KM.fit(pts, k=K, iters=ITERS, seed=0,
                                quantize="int8")
            wall = time.perf_counter() - t0
            if on:
                telemetry.export(path)
        return c, inertia, seen, KK.LAUNCHES["kmeans_partials_int8"], wall

    off, on = run(False), run(True)
    if not (np.array_equal(off[0], on[0]) and off[1] == on[1]):
        fail("telemetry: the fit with telemetry on differs from the fit "
             "with it off")
    if (off[2], off[3]) != (on[2], on[3]) or on[3] != ITERS \
            or on[2] != {"dispatches": 1, "readbacks": 1}:
        fail(f"telemetry: off {off[2]} / {off[3]} K1 launches, on {on[2]} "
             f"/ {on[3]}; expected one dispatch, one readback and {ITERS} "
             "launches both times")
    rows = telemetry.load_rows(path)
    st = steptrace.summarize_rows(rows["steptrace"])
    runs = [r for r in rows["steptrace"] if r.get("ev") == "run"]
    if (st["runs"], st["supersteps"], st["completed"]) != (1, 1, 1) \
            or st["dispatch_mismatch"] or runs[0]["phase"] != "kmeans.fit" \
            or runs[0]["flight"]["dispatches"] != 1:
        fail(f"telemetry: the timeline is not one run of one superstep: "
             f"{st}")
    sk = [r for r in rows["skew"] if r["phase"] == "kmeans.fit"]
    if len(sk) != 1 or sum(sk[0]["work"]) != N:
        fail(f"telemetry: the skew execution row does not sum to {N}: {sk}")
    print(f"telemetry: KMeans fit {N} x {D}, k={K}, int8, {ITERS} "
          f"iterations: off {off[4]:.3f} s, on {on[4]:.3f} s (host prep "
          f"included), centroids and inertia bit-equal, K1 launches "
          f"{on[3]} both, {on[2]} both; export {len(rows['steptrace'])} "
          f"steptrace / {len(rows['skew'])} skew / {len(rows['span'])} span "
          f"rows; superstep {st.get('step_p50_ms')} ms [{card}]")
    # the three CLIs on the export and the serve bench run together
    t_cut = time.perf_counter()
    procs = {app: subprocess.Popen(
        [sys.executable, "-m", "harp_tpu_torch", app, *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "HARP_TELEMETRY": "1"} if app == "serve"
        else None)
        for app, args in (("report", ("--telemetry", path, "--json-only")),
                          ("timeline", (path, "--perfetto",
                                        os.path.join(tmp, "perfetto.json"))),
                          ("health", (path,)),
                          ("serve", ("kmeans", "--bench")))}
    outs = {}
    try:
        for app, proc in procs.items():
            outs[app] = proc.communicate(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"cut: the report, timeline and health CLIs and the serve bench "
          f"ran together: {time.perf_counter() - t_cut:.1f} s")
    for app in ("report", "timeline", "health"):
        stdout, stderr = outs[app]
        if procs[app].returncode:
            fail(f"{app} CLI exited {procs[app].returncode} on the export:"
                 f"\n{stdout[-1000:]}{stderr[-1000:]}")
        if app == "report":
            row = json.loads(stdout.strip().splitlines()[-1])
            if row.get("skew", {}).get("kmeans.fit", {}).get("total") != N \
                    or row.get("transfer", {}).get("dispatches") != 1:
                fail(f"report row lacks the fit's skew or transfers: {row}")
        print(f"{app} CLI on the export: exit 0 "
              f"({stdout.strip().splitlines()[0][:100]}...)")
    stdout, stderr = outs["serve"]
    lines = stdout.strip().splitlines()
    if procs["serve"].returncode or not lines:
        fail(f"serve --bench with HARP_TELEMETRY=1 exited "
             f"{procs['serve'].returncode}:\n{stderr[-2000:]}")
    row = json.loads(lines[-1])
    if row.get("config") != "serve_kmeans_telemetry" \
            or row.get("backend") != "cuda" or "run report" not in stderr:
        fail(f"serve --bench with HARP_TELEMETRY=1 printed no run report: "
             f"{lines[-1][:300]}")
    print(f"serve kmeans --bench with HARP_TELEMETRY=1: its run report on "
          f"stderr and its row on stdout, "
          f"{row.get('transfer', {}).get('dispatches')} dispatches and "
          f"{row.get('compile', {}).get('count')} graph captures recorded "
          f"[{card}]")
    return on[3]


def elastic_phase(dev, card: str, tmp: str) -> dict:
    """Phase 43: elastic training on one card (module docstring).  Returns
    K3's and K4's launches on the uninterrupted elastic runs."""
    import numpy as np
    import torch

    from harp_tpu_torch.elastic import apps as EA
    from harp_tpu_torch.models import kmeans_stream as KS
    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import lda_kernel as K4
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.utils import telemetry
    from harp_tpu_torch.utils.fault import FaultInjector

    launches = {}

    def resumed(ad, epochs, name):
        """The elastic run again from ``ad``'s start, with a transient
        dispatch fault at epoch 1; returns its export's elastic rows."""
        inj = FaultInjector(fail={"dispatch": (2,)})
        path = os.path.join(tmp, f"elastic-{name}.jsonl")
        with telemetry.scope(True):
            EA.elastic_fit(ad, epochs, os.path.join(tmp, f"el-{name}"),
                           fault=inj)
            telemetry.export(path)
        if inj.injected["dispatch"] != 1:
            fail(f"elastic {name}: the dispatch fault did not fire")
        return telemetry.load_rows(path)["elastic"]

    # MF-SGD on K3 at graded config #2's width, on DUR_ML_NNZ ratings (cut
    # from its 20M: their host prep was most of the phase)
    t_cut = t0 = time.perf_counter()
    u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, DUR_ML_NNZ, seed=0)
    ad = EA.MFSGDElastic(ML_USERS, ML_ITEMS,
                         MF.MFSGDConfig(rank=ML_RANK, algo="pallas"),
                         seed=0, users=u, items=i, vals=v)
    prep = time.perf_counter() - t0
    # the home layout is the plain one: the identity remap, so the
    # adapter's model is the plain MFSGD of the same ratings and seed
    if ad.remap.new_n != ML_USERS or not np.array_equal(
            ad.remap.fwd, np.arange(ML_USERS)):
        fail("elastic MF-SGD: the home remap is not the identity")
    W0, H0 = ad.model.W.clone(), ad.model.H.clone()
    t0 = time.perf_counter()
    ad.model.fit(EPOCHS)
    W_p, H_p = ad.model.factors()
    t_plain = time.perf_counter() - t0

    def restart_mf():
        ad.model.W, ad.model.H = W0.clone(), H0.clone()
        ad._live = None

    restart_mf()
    K3.reset_launches()  # the elastic run starts here
    t0 = time.perf_counter()
    EA.elastic_fit(ad, EPOCHS)
    t_el = time.perf_counter() - t0
    launches["sgd_tile_update"] = K3.LAUNCHES["sgd_tile_update"]
    st = ad.canonical_state()
    if not (np.array_equal(st["W"], W_p) and np.array_equal(st["H"], H_p)):
        fail("elastic MF-SGD: the home layout differs from the plain fit")
    if launches["sgd_tile_update"] != 2 * EPOCHS:
        fail(f"elastic MF-SGD: {launches['sgd_tile_update']} K3 launches")
    restart_mf()
    t0 = time.perf_counter()
    el_rows = resumed(ad, EPOCHS, "mfsgd")
    t_res = time.perf_counter() - t0
    st2 = ad.canonical_state()
    if not (np.array_equal(st2["W"], st["W"])
            and np.array_equal(st2["H"], st["H"])):
        fail("elastic MF-SGD: the resumed run differs from the "
             "uninterrupted one")
    if [r["event"] for r in el_rows] != ["resume"] \
            or el_rows[0]["from_step"] != 0:
        fail(f"elastic MF-SGD: the export's elastic rows are {el_rows}")
    print(f"elastic MF-SGD (K3) at {ML_USERS} x {ML_ITEMS}, {DUR_ML_NNZ} "
          f"ratings, rank {ML_RANK}, bf16, {EPOCHS} epochs: home layout "
          f"bit-equal to the plain fit, a dispatch fault at epoch 1 resumed "
          f"from step 0 bit-equal (resume row exported); K3 launches "
          f"{launches['sgd_tile_update']}; prep {prep:.1f} s, plain "
          f"{t_plain:.2f} s, elastic {t_el:.2f} s, resumed run {t_res:.2f} s "
          f"[{card}]")
    # one worker cannot lose one: the shrink refuses, loudly
    restart_mf()
    try:
        EA.elastic_fit(ad, 1, os.path.join(tmp, "el-loss"),
                       fault=FaultInjector(permanent={"dispatch": (1,)},
                                           lost_worker=0))
        fail("elastic MF-SGD: a worker loss on one worker did not fail")
    except ValueError as e:
        if "single-worker" not in str(e):
            raise
        loud = str(e)
    print(f"elastic MF-SGD: a worker loss on one worker fails loudly "
          f"({loud})")
    print(f"cut: elastic MF-SGD on {DUR_ML_NNZ} ratings (from {ML_NNZ}) "
          f"took {time.perf_counter() - t_cut:.1f} s")
    del ad, W0, H0, W_p, H_p, st, st2, u, i, v

    # LDA on K4 at graded config #3's width
    t0 = time.perf_counter()
    d_ids, w_ids = LD.benchmark_corpus(LDA_DOCS, LDA_VOCAB, LDA_TPD, 0)
    ad = EA.LDAElastic(LDA_DOCS, LDA_VOCAB,
                       LD.LDAConfig(n_topics=LDA_TOPICS, algo="pallas"),
                       seed=0, doc_ids=d_ids, word_ids=w_ids)
    prep = time.perf_counter() - t0
    if not np.array_equal(ad.remap.fwd, np.arange(LDA_DOCS)):
        fail("elastic LDA: the home remap is not the identity")
    m = ad.model
    snap = (m.Ndk.clone(), m.Nwk.clone(), m.Nk.clone(), m.z_grid.clone())

    def restart_lda():
        m.Ndk, m.Nwk, m.Nk, m.z_grid = (t.clone() for t in snap)
        ad.model, ad.key_seed, ad._live = m, 0, None

    # the plain loop on the adapter's seed chain (the generator restarts
    # from the chain every sweep, as the elastic loop does)
    t0 = time.perf_counter()
    seed = 0
    for _ in range(LDA_EPOCHS):
        m._gen.manual_seed(seed * 65_537)
        m.sample_epoch()
        seed = EA._next_key_seed(seed)
    plain = (m.Ndk.clone(), m.Nwk.clone(), m.z_grid.clone())
    t_plain = time.perf_counter() - t0
    restart_lda()
    K4.reset_launches()  # the elastic run starts here
    t0 = time.perf_counter()
    EA.elastic_fit(ad, LDA_EPOCHS)
    t_el = time.perf_counter() - t0
    launches["cgs_entry_update"] = K4.LAUNCHES["cgs_entry_update"]
    if not all(torch.equal(a, b) for a, b in zip(
            (m.Ndk, m.Nwk, m.z_grid), plain)):
        fail("elastic LDA: the home layout differs from the plain loop")
    if launches["cgs_entry_update"] != 2 * LDA_EPOCHS:
        fail(f"elastic LDA: {launches['cgs_entry_update']} K4 launches")
    st = ad.canonical_state()
    restart_lda()
    t0 = time.perf_counter()
    el_rows = resumed(ad, LDA_EPOCHS, "lda")
    t_res = time.perf_counter() - t0
    st2 = ad.canonical_state()
    if not all(np.array_equal(st[k], st2[k]) for k in ("d", "w", "z")) \
            or st["key_seed"] != st2["key_seed"]:
        fail("elastic LDA: the resumed chain differs from the "
             "uninterrupted one")
    if [r["event"] for r in el_rows] != ["resume"]:
        fail(f"elastic LDA: the export's elastic rows are {el_rows}")
    print(f"elastic LDA (K4) at {LDA_DOCS} docs x {LDA_VOCAB} words, "
          f"{LDA_TOPICS} topics, {len(d_ids)} tokens, {LDA_EPOCHS} sweeps: "
          f"home layout bit-equal to the plain loop, a dispatch fault at "
          f"sweep 1 resumed bit-equal (chain rebuilt from its tokens, resume "
          f"row exported); K4 launches {launches['cgs_entry_update']}; prep "
          f"{prep:.1f} s, plain {t_plain:.2f} s, elastic {t_el:.2f} s, "
          f"resumed run {t_res:.2f} s (a rebuild included) [{card}]")
    del ad, m, snap, plain, st, st2, d_ids, w_ids

    # streaming KMeans, f32 through chunk_partials
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cen = rng.normal(size=(STREAM_K, STREAM_D)).astype(np.float32) * 4
    pts = cen[rng.integers(0, STREAM_K, STREAM_NPY_N)]
    pts += rng.normal(size=pts.shape).astype(np.float32)
    prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    ad = EA.kmeans_stream_elastic_fit(pts, k=STREAM_K, iters=STREAM_ITERS,
                                      chunk_rows=STREAM_CHUNK)
    t_el = time.perf_counter() - t0
    c, inertia = KS.fit_streaming(pts, k=STREAM_K, iters=STREAM_ITERS,
                                  chunk_points=STREAM_CHUNK, seed=0)
    if not (np.array_equal(ad.centroids, c) and ad.metric() == inertia):
        fail(f"elastic streaming: {ad.metric()} against fit_streaming's "
             f"{inertia}")
    print(f"elastic streaming KMeans at {STREAM_NPY_N} x {STREAM_D}, "
          f"k={STREAM_K}, f32, {STREAM_ITERS} epochs: centroids and inertia "
          f"bit-equal to fit_streaming; data {prep:.1f} s, elastic "
          f"{t_el:.2f} s [{card}]")
    return launches


def scheduler_check(dev, card: str, sched=None) -> dict:
    """Phase 44, step 1: the schedulers' stream order on the card
    (``sched``: a schedule module, this tree's by default).  A
    DynamicScheduler, started first, is handed items that the caller's
    stream writes after the start, and each result is read on the
    caller's stream straight after ``wait_output`` hands it out, before
    ``stop``; a StaticScheduler's results are read as ``schedule`` returns
    them.  Both streams spin before they write, so a missing wait reads
    stale memory.  Fails on a stale result of this tree's module; returns
    the stale results of each scheduler (another tree's are counted, not
    failed)."""
    import torch

    if sched is None:
        from harp_tpu_torch import schedule as sched
    own = sched.__name__ == "harp_tpu_torch.schedule"
    n, spin = 1 << 25, 20_000_000  # 128 MiB of f32 an item; ~10 ms spins

    def task(x):
        torch.cuda._sleep(spin)  # the task's stream lags the caller's
        return x * 2 + 1

    def item(v):
        x = torch.empty(n, device=dev)
        torch.cuda._sleep(spin)  # the caller's stream lags the host
        return x.fill_(float(v))

    stale = {}
    for cls in ("DynamicScheduler", "StaticScheduler"):
        t0 = time.perf_counter()
        bad = []
        if cls == "DynamicScheduler":
            s = sched.DynamicScheduler(task, n_threads=2, device=dev)
            s.start()
            for v in range(4):
                s.submit(item(v))  # written after the start
                idx, out = s.wait_output()
                if not bool((out == 2 * v + 1).all()):  # before stop
                    bad.append(v)
            s.stop()
        else:
            outs = sched.StaticScheduler(task, n_threads=2, device=dev
                                         ).schedule([item(v)
                                                     for v in range(4)])
            bad = [v for v, out in enumerate(outs)
                   if not bool((out == 2 * v + 1).all())]
        torch.cuda.synchronize()
        if bad and own:
            fail(f"{cls} on the card: the results of items {bad} were read "
                 "before their writes ended")
        stale[cls] = len(bad)
        print(f"{cls} ({'this tree' if own else sched.__name__}) on the "
              f"card: {4 - len(bad)} of 4 results of 128 MiB read whole "
              f"straight after hand-out, {len(bad)} stale "
              f"({time.perf_counter() - t0:.2f} s) [{card}]")
    return stale


def registry_check(dev, card: str, rows: dict) -> None:
    """Phase 44, step 2: every kernel of ops/kernel_registry.py at its
    registered shape, once on the card: its wrapper's LAUNCHES grows by the
    registered count, its outputs (and the arguments it updates) agree with
    its plain version within the kernel's class, and its stated shared
    memory fits the card's opt-in limit (K1's and K2's is the card's own
    plan's, K7's its plan on this card's limit).  The launch joins its
    kernel's row of the kernels line as ``registry_launches``."""
    import torch

    from harp_tpu_torch.ops import kernel_registry as KR
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.ops import rf_kernel as K7

    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    for name, build in KR.KERNELS.items():
        info, work = KR.KERNEL_INFO[name], KR.KERNEL_WORK[name]
        mod = KR.wrapper_module(name)
        fn, args = build(dev)
        before = mod.LAUNCHES[info["counter"]]
        got = KR.run_on_copies(fn, args)
        torch.cuda.synchronize()
        grew = mod.LAUNCHES[info["counter"]] - before
        if grew != info["launches"]:
            fail(f"registry {name} ({info['kernel']}): LAUNCHES grew by "
                 f"{grew}, registered {info['launches']}")
        want = KR.run_on_copies(KR.plain_of(name, fn), args)
        torch.cuda.synchronize()
        ok, err = KR.agree(name, got, want)
        if not ok:
            fail(f"registry {name} ({info['kernel']}): max |kernel - plain| "
                 f"{err} outside (rtol, atol) {info['tol']}")
        smem = work["smem_bytes"]
        if info["counter"] in ("kmeans_partials_int8", "kmeans_partials"):
            n, d = args[0].shape
            plan = KK.plan(info["counter"], dev, n, d, args[1].shape[0])
            if plan.smem != smem:
                fail(f"registry {name}: smem_bytes {smem}, the card's plan "
                     f"{plan.smem}")
        elif info["counter"] == "hist_bins":
            bins, rc = args[0], args[1]
            plan = K7.plan(rc.shape[0], bins.shape[0], bins.shape[1],
                           fn.keywords["n_bins"], fn.keywords[
                               "n_node_classes"], 1, optin,
                           props.multi_processor_count)
            if plan.smem != smem:
                fail(f"registry {name}: smem_bytes {smem}, the plan on this "
                     f"card {plan.smem}")
        if smem > optin:
            fail(f"registry {name}: smem_bytes {smem} above the card's "
                 f"opt-in {optin}")
        rows[info["counter"]]["registry_launches"] = grew
        print(f"registry {name} ({info['kernel']}): {grew} launch, within "
              f"{info['tol']} of the plain version (max err {err:.3e}); "
              f"flops {work['flops']}, min HBM bytes {work['min_hbm_bytes']},"
              f" smem {smem} of the card's {optin} [{card}]")


def profile_fit(dev, card: str) -> None:
    """Phase 44, step 3: the KMeans int8 fit at graded config #1 (1M x 300,
    k = 100, 10 iterations; K1 once an iteration) under
    utils.profiling.trace, its op_breakdown attributed to the mechanism
    buckets: K1's seconds and launches, the top kernels, the terms and the
    device's idle share; "not measured" when the trace holds fewer K1
    records than its LAUNCHES counted (the profiler can drop records)."""
    import numpy as np
    import torch

    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.profile import attribution as A
    from harp_tpu_torch.utils import profiling

    gen = torch.Generator()
    gen.manual_seed(44)
    centers = torch.randn((K, D), generator=gen) * 8.0
    pts = (centers[torch.randint(0, K, (N,), generator=gen)]
           + torch.randn((N, D), generator=gen)).numpy()
    KM.fit(pts[:4096], k=K, iters=1, quantize="int8")  # warm: plans, builds
    torch.cuda.synchronize()
    key = ("harp_tpu_torch.ops.kmeans_kernel", "kmeans_partials_int8")
    with tempfile.TemporaryDirectory() as logdir:
        before = KK.LAUNCHES["kmeans_partials_int8"]
        with profiling.trace(logdir):
            t0 = time.perf_counter()
            _, inertia = KM.fit(pts, k=K, iters=ITERS, seed=0,
                                quantize="int8")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = KK.LAUNCHES["kmeans_partials_int8"] - before
        events = profiling.load_events(logdir)
        breakdown = profiling.op_breakdown(logdir, top=10 ** 6,
                                           per_device=True, device=dev)
    if launched != ITERS or not np.isfinite(inertia):
        fail(f"profiled fit: K1 launched {launched} times (expected "
             f"{ITERS}), inertia {inertia}")
    seen, short = A.kernel_records(events, {key: launched})
    if short:
        print(f"profiled KMeans int8 fit: {short[0]}; K1's share and the "
              f"idle share not measured [{card}]")
        return
    attrib = A.attribute(breakdown, wall, 1)
    busy = sum(s for _, _, s in breakdown)
    k1 = sum(s for nm, _, s in breakdown if A.MAIN_SYMBOLS[key].search(nm))
    top = sorted(breakdown, key=lambda r: -r[2])[:4]
    print(f"profiled KMeans int8 fit (1M x 300, k={K}, {ITERS} iterations, "
          f"host prep included): wall {wall:.4f} s, device busy {busy:.4f} "
          f"s, idle share {1 - busy / wall:.3f}; K1 {k1 * 1e3:.4f} ms over "
          f"{seen['kmeans_partials_int8']['traced']} of {launched} launches "
          f"({k1 / wall:.4f} of the wall); bound {attrib['bound']}, terms "
          + ", ".join(f"{k} {v:.4f}" for k, v in attrib["terms"].items())
          + "; top: " + "; ".join(f"{nm[:50]} {s * 1e3:.3f} ms"
                                  for nm, _, s in top) + f" [{card}]")


def roofline_check(card: str) -> None:
    """Phase 44, step 4: the benchmark rows of phases 5, 8, 12 and 34 on
    the card's roofline (utils/roofline.py, the peak of each row's route);
    no share may read over 100 %."""
    from harp_tpu_torch.utils import roofline

    want = ("KMeans int8 (K1) k=100", "KMeans int8 (K1) k=1000",
            "KMeans f32 use_pallas (K2) k=100",
            "KMeans f32 use_pallas (K2) k=1000",
            "KMeans f32 default (matmul) k=100", "MF-SGD pallas",
            "LDA pallas", "MLP f32 wire")
    missing = [w for w in want if w not in BENCH_ROWS]
    if missing:
        fail(f"roofline: no benchmark row for {missing}")
    for label in want:
        config, row = BENCH_ROWS[label]
        ann = roofline.annotate(config, row)
        if "pct_peak_flops" not in ann:
            fail(f"roofline {label}: no work model for the row {row}")
        if ann["pct_peak_flops"] > 100 or ann["pct_peak_bw"] > 100:
            fail(f"roofline {label}: above a peak: {ann}")
        print(f"roofline {label}: {ann['achieved_tflops']} TFLOP/s = "
              f"{ann['pct_peak_flops']} % of {ann['roofline_peak']}, "
              f"{ann['achieved_gbs']} GB/s = {ann['pct_peak_bw']} % of HBM, "
              f"{ann['bound']}-bound [{card}]")


def profile_cli_check(card: str) -> None:
    """Phase 44, step 5: ``python -m harp_tpu_torch profile --all --json``
    on the card: a row an app, each reconciled or naming the records the
    profiler dropped as its only reason."""
    cli = subprocess.run([sys.executable, "-m", "harp_tpu_torch", "profile",
                          "--all", "--json"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    rows = [json.loads(x) for x in cli.stdout.splitlines()
            if x.startswith("{")]
    if cli.returncode not in (0, 1) or len(rows) != 11:
        fail(f"profile --all exited {cli.returncode} with {len(rows)} rows:"
             f"\n{cli.stderr[-2000:]}")
    for r in rows:
        if r.get("backend") != "cuda":
            fail(f"profile {r['app']}: not a cuda row: {r}")
        dropped = all("dropped device records" in w for w in r["why"])
        if not (r["reconciled"] or dropped):
            fail(f"profile {r['app']}: not reconciled: {r['why']}")
        kernels = ", ".join(f"{k} {v['traced']}/{v['launches']}"
                            for k, v in r["kernels"].items())
        print(f"profile {r['app']} ({r['program']}): wall {r['wall_s']} s "
              f"for {r['reps']} reps, bound {r['bound']}, "
              + ", ".join(f"{k} {v}" for k, v in r["terms"].items() if v)
              + (f"; kernels traced/launched {kernels}" if kernels else "")
              + ("" if r["reconciled"] else
                 f"; not measured: {r['why'][0]}") + f" [{card}]")


def checked_jit_check(dev, card: str) -> None:
    """Phase 44, step 6: checked_jit on the card: a NaN output raises, a
    clean call returns bit-equal to the bare call."""
    import torch

    from harp_tpu_torch.utils.check import CheckError, checked_jit

    def bad(x):
        return torch.log(x) / x

    def clean(x):
        return torch.softmax(x @ x.T, dim=1).sum(0)

    try:
        checked_jit(bad)(torch.tensor([-1.0, 2.0], device=dev))
    except CheckError as e:
        if "nan" not in str(e):
            fail(f"checked_jit on the card: {e} does not name nan")
    else:
        fail("checked_jit on the card: log(-1)/-1 did not raise")
    x = torch.randn((512, 256), device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    if not torch.equal(checked_jit(clean)(x), clean(x)):
        fail("checked_jit on the card: a clean call differs from the bare "
             "call")
    print(f"checked_jit on the card: log(-1)/-1 raises naming nan; a clean "
          f"[512, 256] softmax-Gram call bit-equal to the bare call [{card}]")


def measurement_phase(dev, card: str, rows: dict) -> None:
    """Phase 44: the measurement layer on the card, steps 1-6 in order
    (each function's docstring); ``rows`` are the kernels line's."""
    for name, step in (("schedulers", lambda: scheduler_check(dev, card)),
                       ("registry", lambda: registry_check(dev, card, rows)),
                       ("profiled fit", lambda: profile_fit(dev, card)),
                       ("roofline", lambda: roofline_check(card)),
                       ("profile CLI", lambda: profile_cli_check(card)),
                       ("checked_jit", lambda: checked_jit_check(dev, card))):
        t0 = time.perf_counter()
        step()
        print(f"measurement {name}: {time.perf_counter() - t0:.1f} s "
              f"[{card}]")


def costmodel_phase(dev, card: str) -> None:
    """Phase 45: the cost model and the fit gates on the card (under 30 s;
    any failure fails the run): the overhead probe beside the committed
    ``CALIBRATED_OVERHEADS`` (drift printed, not fatal); the shared-memory
    gate at K1's and K2's plans for their registry shape and the
    north-star chunk shape; a K3 config past the card's opt-in refused
    with MemoryError and no launch; an HBM request past the free memory
    refused before any allocation; ``presize`` for K1, K2, K3 and K7 at
    their graded shapes; ``plan_all`` on ``single_card`` over the eleven
    drivers (every site keeps, prices 0 and holds the ledger's bytes);
    ``predict --grade`` and the model gate on the committed evidence; and
    ``grade_bench_row`` over this run's KMeans int8 and MF-SGD rows
    (phases 5 and 8; a regression on a slow host is printed, not fatal)."""
    import torch

    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.health import grade as HG
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.perfmodel import cli as PCLI
    from harp_tpu_torch.perfmodel import measure as MS
    from harp_tpu_torch.perfmodel import model as PM
    from harp_tpu_torch.plan import planner as PL
    from harp_tpu_torch.plan.topology import single_card
    from harp_tpu_torch.utils import flightrec, memrec

    # -- the overheads, measured again ---------------------------------------
    probe = MS.probe_overheads(dev)
    print("overheads (this run, committed, drift): " + ", ".join(
        f"{k} {probe[k]:.6g}, {v:.6g}, x{probe[k] / v:.2f}"
        for k, v in flightrec.CALIBRATED_OVERHEADS.items()) + f" [{card}]")

    # -- the shared-memory gate at K1's and K2's plans -----------------------
    optin = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin
    for name, kernel in (("kmeans_partials_int8", "kmeans.partials_int8"),
                         ("kmeans_partials", "kmeans.partials")):
        for n, d, k in ((128, 256, 8), (STREAM_CHUNK, STREAM_D, STREAM_K)):
            p = KK.plan(name, dev, n, d, k)   # the plan runs both gates
            memrec.require_smem_fit(kernel, p.smem, device=dev)
            kind = "fused" if p.fused else "two-pass"
            print(f"smem gate {kernel} at ({n}, {d}, {k}): {p.smem} of "
                  f"{optin} B a block, fits ({kind}, tile {p.tile_rows})")

    # -- a K3 config past the opt-in: refused, nothing launched -------------
    tile = 512 * K3.CLUSTER
    u, i, v = MF.synthetic_ratings(200, 120, 5000, seed=0)
    eu, ei, ev, ou, oi, _, _, ub, ib = MF.partition_ratings_tiles(
        u, i, v, 200, 120, 1, tile, tile, 16, n_slices=1)
    ent = [torch.from_numpy(a[0].copy()).to(dev) for a in (eu, ei, ev, ou, oi)]
    W = torch.zeros((ub, 64), device=dev)
    H = torch.zeros((ib, 64), device=dev)
    before = K3.LAUNCHES["sgd_tile_update"]
    try:
        K3.sgd_tile_update(W, H, *ent, lr=0.1, reg=0.0, u_tile=tile,
                           i_tile=tile)
        fail(f"K3 at {tile} x {tile} tiles was not refused")
    except MemoryError as e:
        if K3.LAUNCHES["sgd_tile_update"] != before:
            fail("K3's refused config launched")
        print(f"K3 refused before dispatch, 0 launches: {e}")

    # -- an HBM request past the free memory: refused, nothing allocated ----
    free = memrec.hbm_free(dev)
    alloc = torch.cuda.memory_allocated(dev)
    try:
        memrec.require_hbm_fit("probe", free + 1, device=dev)
        fail("an HBM request past the free memory was not refused")
    except MemoryError as e:
        if torch.cuda.memory_allocated(dev) != alloc:
            fail("the refused HBM request allocated")
        print(f"HBM gate refused {free + 1} B against {free} B free: {e}")

    # -- presize at the graded shapes ----------------------------------------
    for kernel, shape in (("kmeans.partials_int8", {"n": N, "d": D, "k": K}),
                          ("kmeans.partials", {"n": N, "d": D, "k": K}),
                          ("mfsgd.sgd_tile_update", {"rank": ML_RANK}),
                          ("rf.hist_bins", {})):
        got = PM.presize(kernel, **shape)
        if got.get("tile") is None and got.get("plan") is None:
            fail(f"presize {kernel}: nothing fits: {got}")
        if "smem_bytes" in got and got["smem_bytes"] > optin:
            fail(f"presize {kernel}: {got['smem_bytes']} B past the opt-in")
        print(f"presize {kernel}: {got}")

    # -- plan_all on single_card over the eleven drivers --------------------
    t0 = time.perf_counter()
    for name in sorted(DRIVERS):
        sheet = PL.ledger_sheet(name, dev)
        plan = PL.plan_sheet(name, sheet, single_card())
        want = [e["payload_bytes"] for e in sheet["collectives"]]
        if not ([s.sheet_bytes for s in plan.sites] == want
                and all(s.schedule == "keep" and s.cost_s == 0.0
                        for s in plan.sites)):
            fail(f"plan {name}: {plan.row()} against the ledger's {want}")
    print(f"plan: {len(DRIVERS)} drivers on single_card, every site keeps at "
          f"0 s and holds the ledger's bytes ({time.perf_counter() - t0:.1f}"
          f" s) [{card}]")

    # -- the self-grade and the model gate on the committed evidence ---------
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = PCLI.main(["--grade", "--repo", REPO])
    if code != 0:
        fail(f"predict --grade failed on the committed evidence: "
             f"{err.getvalue()}")
    print(f"predict --grade: {err.getvalue().strip()}")
    ok, finding = HG.model_gate(REPO)
    if not ok:
        fail(f"the model gate: {finding}")
    print(f"model gate: {finding['verdict']}")

    # -- this run's full-width rows, graded ----------------------------------
    for label, cfg in (("KMeans int8 (K1) k=100", "kmeans_int8"),
                       ("MF-SGD pallas", "mfsgd_pallas")):
        row = {"config": cfg, "backend": "cuda", **BENCH_ROWS[label][1]}
        f = HG.grade_bench_row(row, REPO)
        if f is None:
            fail(f"grade_bench_row {cfg}: nothing to grade against")
        print(f"grade_bench_row {cfg}: verdict {f['verdict']}, measured "
              f"{f['measured']} vs incumbent {f.get('incumbent')} (ratio "
              f"{f.get('ratio_vs_incumbent')}), model x{f.get('model_factor')}"
              f" [{card}]")
        if f["verdict"] == "model_invalidated":
            fail(f"grade_bench_row {cfg}: the model is invalidated: {f}")


#: phase 46's tolerances of each new lint driver, card against CPU:
#: name -> (rtol, atol); None is bit-equal
ANALYSIS_TOL = {"ring_attention": (1e-4, 1e-5),
                "rotate.pipeline_chunked": (1e-6, 1e-6),
                "ingest.accum_chunk": (1e-5, 1e-4),
                "ingest.finish_epoch": (1e-6, 1e-6),
                "kmeans.fit_hier": (1e-4, 1e-4),
                # the int8 wire: one quantum (|max|/127 of a N(0, 1)
                # block) covers a rounding that falls the other way
                "collective.reshard": None,
                "collective.reshard_wire": (0.0, 0.04),
                "elastic.regather": None, "serve.mfsgd_topk": (1e-5, 1e-6),
                "serve.lda_infer": (1e-4, 1e-6),
                "serve.mlp_logits": (1e-5, 1e-5),
                "serve.rf_vote": None, "serve.svm_scores": (1e-5, 1e-5)}
#: phase 46's int8 KMeans fit, armed and disarmed
GUARD_N, GUARD_D, GUARD_K, GUARD_ITERS = 200_000, 64, 64, 3


def _arrays(out) -> list:
    """A driver's output as a flat list of numpy arrays."""
    import numpy as np

    if isinstance(out, (tuple, list)):
        return [a for x in out for a in _arrays(x)]
    return [np.asarray(out.cpu() if hasattr(out, "cpu") else out)]


def _launch_smem(dev) -> dict:
    """The dynamic shared memory K1, K2, K3 and K7 take at their registered
    shapes, as the wrappers hand it to the launch: K1's and K2's plans
    (the handle every launch takes), and the ``smem`` argument of K3's
    and K7's library calls, caught from one registry launch each."""
    from harp_tpu_torch.ops import kernel_registry as KR
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.ops import mfsgd_kernel as K3
    from harp_tpu_torch.ops import rf_kernel as K7

    out = {name: KK.plan(lib, dev, KR._KM_N, KR._KM_D, KR._KM_K).smem
           for name, lib in (("kmeans.partials", "kmeans_partials"),
                             ("kmeans.partials_int8",
                              "kmeans_partials_int8"))}
    for name, mod, sym in (("mfsgd.sgd_tile_update", K3, "sgd_tile_update"),
                           ("rf.hist_bins", K7, "rf_hist_bins")):
        lib = mod._lib()
        orig = getattr(lib, sym)
        seen = []

        def caught(*args, __orig=orig, __seen=seen):
            __seen.append(args[21])     # both take smem at argument 21
            return __orig(*args)

        setattr(lib, sym, caught)
        try:
            fn, args = KR.KERNELS[name](dev)
            fn(*args)
        finally:
            setattr(lib, sym, orig)
        if len(seen) != 1:
            fail(f"analysis: {name} made {len(seen)} launches, expected 1")
        out[name] = int(seen[0])
    return out


def analysis_phase(dev, card: str) -> None:
    """Phase 46: the lint layers and the thread guard on the card (under
    20 s; any failure fails the run): ``python -m harp_tpu_torch lint
    --json`` in a subprocess, clean (its wire layer runs every driver and
    protocol on the card, its kernels layer holds K1's and K2's
    declarations to the card's plans); each of the thirteen lint drivers
    once on the card against the CPU (ANALYSIS_TOL); the KMeans engine
    served over the real TCP transport with the guard armed (checks above
    0, no violation); the int8 KMeans fit on K1 armed and disarmed,
    bit-equal with the same launches, dispatches and readbacks; a tracked
    CUDA launch from a thread named like a forbidden pattern refused with
    ThreadOwnershipError; and the registry's smem_bytes held to the shared
    memory K1, K2, K3 and K7 take at launch (HL205)."""
    import socket
    import threading

    import numpy as np
    import torch

    from harp_tpu_torch.analysis import kernel_audit
    from harp_tpu_torch.analysis.drivers import DRIVERS
    from harp_tpu_torch.models import kmeans as KM
    from harp_tpu_torch.ops import kmeans_kernel as KK
    from harp_tpu_torch.serve.engines import KMeansAssign
    from harp_tpu_torch.serve.server import Server
    from harp_tpu_torch.serve.transport import TCPFrontEnd
    from harp_tpu_torch.utils import flightrec, telemetry, threadguard

    t0 = time.perf_counter()
    lint = subprocess.Popen(
        [sys.executable, "-m", "harp_tpu_torch", "lint", "--json"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # the thirteen drivers of this layer, card against CPU
        worst = {}
        for name, tol in ANALYSIS_TOL.items():
            fn, args = DRIVERS[name](dev)
            got = _arrays(fn(*args))
            fn, args = DRIVERS[name]("cpu")
            want = _arrays(fn(*args))
            if len(got) != len(want):
                fail(f"analysis driver {name}: {len(got)} outputs on the "
                     f"card, {len(want)} on the CPU")
            for g, w in zip(got, want):
                same = (np.array_equal(g, w) if tol is None else
                        np.allclose(g, w, rtol=tol[0], atol=tol[1]))
                if not same:
                    fail(f"analysis driver {name}: the card and the CPU "
                         f"disagree beyond {tol}")
            worst[name] = max(float(np.abs(g.astype(np.float64) - w).max())
                              if g.size else 0.0 for g, w in zip(got, want))
        print(f"analysis drivers: {len(worst)} on the card against the CPU, "
              f"each within its tolerance (ring_attention's local block on "
              f"the card: max |diff| {worst['ring_attention']:.3e}) [{card}]")

        # the KMeans engine over the real TCP transport, the guard armed
        rng = np.random.default_rng(46)
        state = KMeansAssign.synthetic_state(rng, k=16, d=32)
        srv = Server("kmeans", state=state, ladder=(1, 8))
        srv.startup()
        with threadguard.armed() as g:
            fe = TCPFrontEnd(srv, port=0).start_in_thread()
            try:
                with socket.create_connection(("127.0.0.1", fe.port),
                                              timeout=60) as sock:
                    f = sock.makefile("rw")
                    xs = [rng.normal(size=(1 + i % 5, 32)).astype(
                        np.float32) for i in range(16)]
                    for i, x in enumerate(xs):
                        f.write(json.dumps({"id": i, "x": x.tolist()})
                                + "\n")
                    f.flush()
                    got = sorted((json.loads(f.readline()) for _ in xs),
                                 key=lambda r: r["id"])
            finally:
                fe.shutdown()
                fe.join(60)
        cent = state["centroids"]
        for r, x in zip(got, xs):
            want = np.argmin(((x[:, None] - cent[None]) ** 2).sum(-1), 1)
            if r.get("result") != want.tolist():
                fail(f"analysis: TCP request {r.get('id')} answered "
                     f"{r.get('result')}, expected {want.tolist()}")
        if not (g.checks > 0 and g.violations == []):
            fail(f"analysis: the armed guard ran {g.checks} checks with "
                 f"violations {g.violations}")
        print(f"analysis: 16 requests over TCP with the thread guard "
              f"armed: answers right, {g.checks} ownership checks, 0 "
              f"violations [{card}]")

        # the int8 fit on K1, armed and disarmed
        pts = np.random.default_rng(7).normal(
            size=(GUARD_N, GUARD_D)).astype(np.float32)
        runs = []
        for armed in (False, True):
            KK.reset_launches()
            with telemetry.scope(True), (threadguard.armed() if armed
                                         else contextlib.nullcontext()):
                c, inertia = KM.fit(pts, k=GUARD_K, iters=GUARD_ITERS,
                                    seed=0, quantize="int8")
                tr = flightrec.transfers.summary()
            runs.append((c, inertia, dict(KK.LAUNCHES), tr["dispatches"],
                         tr["readbacks"]))
        (c0, i0, l0, d0, r0), (c1, i1, l1, d1, r1) = runs
        if not (np.array_equal(c0, c1) and i0 == i1
                and (l0, d0, r0) == (l1, d1, r1)
                and l1["kmeans_partials_int8"] == GUARD_ITERS):
            fail(f"analysis: the int8 fit armed differs from disarmed "
                 f"(launches {l0} / {l1}, dispatches {d0} / {d1}, "
                 f"readbacks {r0} / {r1})")
        print(f"analysis: int8 KMeans fit at {GUARD_N} x {GUARD_D}, k="
              f"{GUARD_K}, {GUARD_ITERS} iterations, armed and disarmed: "
              f"centroids and inertia bit-equal, K1 launches "
              f"{l1['kmeans_partials_int8']}, dispatches {d1}, readbacks "
              f"{r1} both ways [{card}]")

        # a tracked CUDA launch from a thread named like a forbidden pattern
        probe = flightrec.track(lambda x: x * 2, "analysis.probe")
        x = torch.ones(4, device=dev)
        box = []

        def launch():
            try:
                box.append(probe(x))
            except threadguard.ThreadOwnershipError as e:
                box.append(e)

        with threadguard.armed():
            t = threading.Thread(target=launch, name="harp-watchdog",
                                 daemon=True)
            t.start()
            t.join(30)
        if not (box and isinstance(box[0], threadguard.ThreadOwnershipError)):
            fail(f"analysis: a launch on harp-watchdog was not refused: "
                 f"{box}")
        print("analysis: a tracked CUDA launch on a thread named "
              "harp-watchdog raised ThreadOwnershipError")

        # HL205 at launch: the registry's smem_bytes against K1, K2, K3, K7
        smem = _launch_smem(dev)
        vs = kernel_audit.check_smem_declarations(smem)
        if vs:
            fail("analysis: " + "; ".join(v.format() for v in vs))
        print(f"analysis: registry smem_bytes within the band of the shared "
              f"memory taken at launch: {smem} [{card}]")

        out, err = lint.communicate(timeout=600)
    finally:
        if lint.poll() is None:
            lint.kill()
            lint.communicate()
    if lint.returncode:
        fail(f"lint exited {lint.returncode}:\n{out[-2000:]}\n"
             f"{err[-2000:]}")
    row = json.loads(out.strip().splitlines()[-1])
    if not (row.get("clean") and row.get("backend") == "cuda"
            and row["stale_allowlist"] == 0
            and set(row["byte_sheets"]) == set(DRIVERS)
            and not row.get("kernels_unchecked")):
        fail(f"lint row is not a clean card run: {json.dumps(row)[:2000]}")
    print(f"analysis: lint --json clean on the card: {row['files_scanned']} "
          f"files, {len(row['rules'])} rules, {row['allowlisted']} "
          f"allowlisted, byte sheets of {len(row['byte_sheets'])} drivers, "
          f"{time.perf_counter() - t0:.1f} s for the phase [{card}]")


def surface_phase(dev, card: str, tmp: str) -> int:
    """Phase 47: the reference's surface on the card (module docstring):
    the public API, LDA's pack cache at graded config #3, MF-SGD's carry_w
    at graded config #2's widths and the four runnable apps.  Returns K4's
    launches on each pack-cache run."""
    import numpy as np
    import torch

    # the public API's import line, the first line of a Harp-style app
    from harp_tpu_torch import CollectiveApp, Combiner, run_app  # noqa: F401
    from harp_tpu_torch import StaticScheduler, Table, WorkerMesh  # noqa: F401
    from harp_tpu_torch.examples import (kmeans_app, mfsgd_app,
                                         pipeline_moe_app,
                                         streaming_kmeans_app)
    from harp_tpu_torch.models import lda as LD
    from harp_tpu_torch.models import mfsgd as MF
    from harp_tpu_torch.ops import lda_kernel as K4

    # LDA benchmark(pack_cache=...) at graded config #3, cold then warm
    packs = os.path.join(tmp, "lda_packs")
    runs = {}
    for run in ("cold", "warm"):
        K4.reset_launches()  # this run's main path starts here
        t0 = time.perf_counter()
        out = LD.benchmark(n_docs=LDA_DOCS, vocab_size=LDA_VOCAB,
                           n_topics=LDA_TOPICS, tokens_per_doc=LDA_TPD,
                           epochs=LDA_EPOCHS, algo="pallas",
                           pack_cache=packs)
        runs[run] = (out, K4.LAUNCHES["cgs_entry_update"],
                     time.perf_counter() - t0)
    (cold, n_cold, w_cold), (warm, n_warm, w_warm) = runs["cold"], \
        runs["warm"]
    want = 2 * (1 + LDA_EPOCHS)
    if cold["log_likelihood"] != warm["log_likelihood"]:
        fail(f"pack_cache: the warm run's log-likelihood "
             f"{warm['log_likelihood']!r} differs from the cold run's "
             f"{cold['log_likelihood']!r}")
    if (n_cold, n_warm) != (want, want):
        fail(f"pack_cache: K4 launches {n_cold} cold, {n_warm} warm; "
             f"expected {want} each")
    files = sorted(os.listdir(packs))
    if len(files) != 1 or not files[0].endswith(".npz") \
            or ".tmp" in files[0]:
        fail(f"pack_cache: the cache holds {files}, not one .npz")
    size = os.path.getsize(os.path.join(packs, files[0]))
    print(f"pack_cache LDA (K4) at {LDA_DOCS} docs x {LDA_VOCAB} words, "
          f"{LDA_TOPICS} topics, {cold['n_tokens']} tokens: cold prep_sec "
          f"{cold['prep_sec']:.3f} (pack and write {size} bytes), warm "
          f"prep_sec {warm['prep_sec']:.3f} (load); log-likelihood "
          f"{cold['log_likelihood']!r} both; K4 launches {n_cold} / "
          f"{n_warm}; {cold['tokens_per_sec_per_chip']:.6e} / "
          f"{warm['tokens_per_sec_per_chip']:.6e} tokens/s; wall "
          f"{w_cold:.1f} / {w_warm:.1f} s [{card}]")
    shutil.rmtree(packs, ignore_errors=True)

    # MF-SGD algo="dense" (K3's plain version) with carry_w on and off
    t_cut = time.perf_counter()
    u, i, v = MF.synthetic_ratings(ML_USERS, ML_ITEMS, DUR_ML_NNZ, seed=0)
    res = {}
    for carry in (False, True):
        m = MF.MFSGD(ML_USERS, ML_ITEMS,
                     MF.MFSGDConfig(rank=ML_RANK, algo="dense",
                                    carry_w=carry), seed=0)
        m.set_ratings(u, i, v)
        t0 = time.perf_counter()
        rmse = m.train_epoch()
        res[carry] = (m.W.cpu(), m.H.cpu(), rmse, time.perf_counter() - t0)
        del m
    if not (torch.equal(res[True][0], res[False][0])
            and torch.equal(res[True][1], res[False][1])
            and res[True][2] == res[False][2] and np.isfinite(res[True][2])):
        fail("carry_w: the dense epoch with carry_w differs from the one "
             "without")
    print(f"MF-SGD dense at {ML_USERS} x {ML_ITEMS}, {DUR_ML_NNZ} ratings, "
          f"rank {ML_RANK}, bf16: carry_w on and off bit-equal after one "
          f"epoch (W, H, RMSE {res[True][2]!r}); epoch {res[False][3]:.2f} "
          f"/ {res[True][3]:.2f} s [{card}]")
    print(f"cut: MF-SGD carry_w on {DUR_ML_NNZ} of graded config #2's "
          f"{ML_NNZ} ratings, one epoch each: "
          f"{time.perf_counter() - t_cut:.1f} s")
    del res, u, i, v

    # the four apps through their main, on the card
    t_cut = time.perf_counter()
    km = kmeans_app.main(["--n", str(APP_KM_N), "--d", str(D), "--k",
                          str(K), "--iters", str(ITERS)])
    if not np.isfinite(km["centroid_norm"]):
        fail(f"kmeans_app: {km}")
    ck = [kmeans_app.run(APP_KM_CHECK_N, D, K, ITERS, mesh=WorkerMesh(d))
          for d in (dev, "cpu")]
    if not np.allclose(ck[0], ck[1], rtol=1e-4, atol=1e-6):
        fail(f"kmeans_app: the card and the CPU disagree at "
             f"{APP_KM_CHECK_N} points (max |diff| "
             f"{np.abs(ck[0] - ck[1]).max()})")
    print(f"kmeans_app at {APP_KM_N} x {D}, k={K}, {ITERS} iterations: "
          f"centroid_norm {km['centroid_norm']!r}; card == CPU at "
          f"{APP_KM_CHECK_N} points (rtol 1e-4 / atol 1e-6, max |diff| "
          f"{np.abs(ck[0] - ck[1]).max():.3e}) [{card}]")
    print(f"cut: kmeans_app on {APP_KM_N} of graded config #1's {N} points "
          f"took {time.perf_counter() - t_cut:.1f} s")
    mf = mfsgd_app.main([])
    if not (mf["workers"] == 1 and mf["rmse_final"] < mf["rmse_first"]):
        fail(f"mfsgd_app: {mf}")
    pm = pipeline_moe_app.main([])
    if not (pm["workers"] == 1 and pm["loss_final"] < pm["loss_first"]
            and pm["dropped"] == 0):
        fail(f"pipeline_moe_app: {pm}")
    print(f"mfsgd_app and pipeline_moe_app at their defaults on the card: "
          f"{mf}, {pm} [{card}]")
    t_cut = time.perf_counter()
    st = streaming_kmeans_app.main(["--n", str(APP_STREAM_N), "--d",
                                    str(STREAM_D), "--k", str(APP_STREAM_K)])
    if not (st["rel_diff"] < 1e-3 and np.isfinite(st["inertia_streamed"])):
        fail(f"streaming_kmeans_app: {st}")
    print(f"cut: streaming_kmeans_app at the north star's d = {STREAM_D}, "
          f"k = {APP_STREAM_K} (not its {STREAM_K}: the app's blobs) on "
          f"{APP_STREAM_N} of its {STREAM_N} rows took "
          f"{time.perf_counter() - t_cut:.1f} s (streamed and resident "
          f"inertia {st['inertia_streamed']!r} / "
          f"{st['inertia_resident']!r}) [{card}]")
    return n_cold


def profile_epoch(model, card: str, app: str = "MFSGD",
                  what: str = "train_epoch", bare: float | None = None,
                  count: tuple[dict, str, str] | None = None) -> None:
    """Device busy share of one epoch (``what``: its method), from
    torch.profiler's CUDA kernel times over the epoch's wall (the epoch ends
    in a readback); ``bare``, the wall of an unprofiled epoch, gives a
    second idle share free of the profiler's own host cost."""
    profile_run(getattr(model, what), card, app, what, bare, count)


def profile_run(fn, card: str, app: str, what: str,
                bare: float | None = None,
                count: tuple[dict, str, str] | None = None) -> None:
    """:func:`profile_epoch` of any call ``fn()`` that ends in a readback.
    ``count`` = (a wrapper's LAUNCHES, its key, its kernel's name): the
    share is printed only when the trace holds every launch that the count
    saw, since the profiler can drop device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = count[0][count[1]] if count else 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    missed = count and traced_launches(prof, count[2],
                                       count[0][count[1]] - before, wall)[1]
    if missed:
        print(f"{app} profile of one {what}: {missed}; idle share not "
              "measured")
        return
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

    # -- 2-3. K1 and K2 against their plain versions -----------------------
    rows["kmeans_partials_int8"] = k1_phase(dev, card, gen)
    rows["kmeans_partials"] = k2_phase(dev, card, gen)

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
    # three paths settle in the same Lloyd basin and their inertias
    # compare.  Lloyd's inertia does not rise from any start: each path's
    # fit after ITERS iterations against after one, on the first tenth of
    # the points from random rows (the k-means++ seeding was most of a
    # one-iteration fit: three full-size ones took 27 s)
    t_cut = time.perf_counter()
    tenth = pts_h[:N // 10]
    for p, kw in paths.items():
        one = KM.fit(tenth, k=K, iters=1, seed=0, **kw)[1]
        more = KM.fit(tenth, k=K, iters=ITERS, seed=0, **kw)[1]
        if not (np.isfinite(more) and more <= one * (1 + 1e-6)):
            fail(f"fit {p}: inertia {more} after {ITERS} iterations on "
                 f"{N // 10} points is worse than after one ({one})")
    print(f"cut: fit after {ITERS} iterations no worse than after one, all "
          f"three paths on {N // 10} points: {time.perf_counter() - t_cut:.1f}"
          " s")
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
        fits[p] = (c, inertia)
        print(f"fit {p}: {ITERS} iterations, inertia {inertia:.6e}, "
              f"launches {delta}, wall {wall:.3f} s incl. host data prep "
              f"[{card}]")
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
        for k in ((K, 1000) if p in kernel_of else (K,)):
            out = KM.benchmark(n=N, d=D, k=k, iters=ITERS, **kw)
            BENCH_ROWS[f"KMeans {p} k={k}"] = ("kmeans", out)
            if not np.isfinite(out["inertia"]):
                fail(f"benchmark {p} k={k}: non-finite inertia")
            line = (f"benchmark {p} k={k}: {out['iters_per_sec']:.2f} "
                    f"iter/s, {out['sec_per_iter'] * 1e3:.4f} ms/iter")
            if p in kernel_of:
                r = rows[kernel_of[p]]
                sfx = "" if k == K else f"_k{k}"
                line += (f"; kernel {r['ms' + sfx]:.4f} ms/launch, bound "
                         f"{r['bound_ms' + sfx]:.4f} ms")
            print(line + f" [{card}]")
    kmeans_profile(dev, card)
    row = run_cli("kmeans", "--bench", "--quantize", "int8")
    if not np.isfinite(row["inertia"]):
        fail(f"KMeans CLI row is not finite: {row}")

    # -- 6-8. MF-SGD ----------------------------------------------------------
    rows["sgd_tile_update"], launches["sgd_tile_update"] = mfsgd_phases(
        dev, card)

    # -- 9-14. LDA ------------------------------------------------------------
    rows["cgs_entry_update"], launches["cgs_entry_update"] = lda_phases(
        dev, card)

    # -- 15-16. SVM -------------------------------------------------------------
    rows["pegasos_grad"], launches["pegasos_grad"] = svm_phases(dev, card)

    # -- 17-18. WDA-MDS ----------------------------------------------------------
    rows["smacof_bx"], launches["smacof_bx"] = mds_phases(dev, card)

    # -- 19-20. Random Forest ----------------------------------------------------
    rows["hist_bins"], launches["hist_bins"] = rf_phases(dev, card)

    # -- 21-24. long-context attention -------------------------------------------
    rows["flash_attention"], launches["flash_attention"] = attention_phases(
        dev, card)

    # -- 25-28. streaming KMeans ---------------------------------------------------
    k1_chunk, k2_chunk = stream_chunk_phase(dev, card, gen)
    pts_s, init_s, stream_launches = stream_fit_phase(dev, card)
    stream_ingest_phase(dev, card, pts_s, init_s)
    del pts_s
    north_star_launches = stream_benchmark_phase(dev, card)
    rows["kmeans_partials_int8"].update(
        k1_chunk, stream_launches=stream_launches,
        north_star_launches=north_star_launches)
    rows["kmeans_partials"].update(k2_chunk)

    # -- 29-32. verbs, tables, LDA push/pull, KMeans hier --------------------
    for name, phase in (("verbs", lambda: verbs_phase(dev, card)),
                        ("tables", lambda: tables_phase(dev, card)),
                        ("LDA pushpull", lambda: lda_pushpull_phases(dev,
                                                                     card)),
                        ("KMeans hier", lambda: rows[
                            "kmeans_partials_int8"].update(
                                hier_launches=kmeans_hier_phase(dev, card,
                                                                gen)))):
        t0 = time.perf_counter()
        phase()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")

    # -- 33-35. subgraph, MLP, CCD++ ---------------------------------------
    for name, phase in (("subgraph", subgraph_phase), ("MLP", mlp_phase),
                        ("CCD", ccd_phase)):
        t0 = time.perf_counter()
        phase(dev, card)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s [{card}]")

    # -- 36-39. stats, weighted MDS, sparse SVM, durable runs ---------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name, phase in (("stats", lambda: stats_phase(dev, card)),
                            ("weighted MDS", lambda: wmds_phase(dev, card)),
                            ("SVM sparse",
                             lambda: svm_sparse_phase(dev, card, tmp))):
            t0 = time.perf_counter()
            phase()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        rec = durable_phase(dev, card, tmp)
        print(f"phase durable runs: {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        # -- 40-41. the serving plane, the pipeline ------------------------
        for name, phase in (("serve", lambda: serve_phase(dev, card, tmp)),
                            ("pipeline", lambda: pipeline_phase(dev, card))):
            t0 = time.perf_counter()
            phase()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s [{card}]")
        # -- 42-43. the training plane under telemetry, elastic training ---
        t0 = time.perf_counter()
        rows["kmeans_partials_int8"]["telemetry_launches"] = \
            telemetry_phase(dev, card, tmp)
        print(f"phase telemetry: {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        el = elastic_phase(dev, card, tmp)
        for name, n in el.items():
            rows[name]["elastic_launches"] = n
        print(f"phase elastic: {time.perf_counter() - t0:.1f} s [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("kmeans_partials_int8", "kmeans_partials",
                 "sgd_tile_update", "cgs_entry_update"):
        rows[name]["recovery_launches"] = rec[name]
    rows["kmeans_partials_int8"]["stream_recovery_launches"] = rec[
        "stream_kmeans_partials_int8"]

    # -- 44. the measurement layer -------------------------------------------
    t0 = time.perf_counter()
    measurement_phase(dev, card, rows)
    print(f"phase measurement: {time.perf_counter() - t0:.1f} s [{card}]")

    # -- 45. the cost model and the fit gates -------------------------------
    t0 = time.perf_counter()
    costmodel_phase(dev, card)
    print(f"phase cost model: {time.perf_counter() - t0:.1f} s [{card}]")

    # -- 46. the lint layers and the thread guard ----------------------------
    t0 = time.perf_counter()
    analysis_phase(dev, card)
    print(f"phase analysis: {time.perf_counter() - t0:.1f} s [{card}]")

    # -- 47. the reference's surface ----------------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        rows["cgs_entry_update"]["surface_launches"] = surface_phase(
            dev, card, tmp)
        print(f"phase surface: {time.perf_counter() - t0:.1f} s [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 48. result ----------------------------------------------------------
    from harp_tpu_torch.ops.kernel_registry import KERNEL_INFO

    src = {i["counter"]: (i["source"], i["replaces"])
           for i in sorted(KERNEL_INFO.values(), key=lambda i: i["kernel"])}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                "library_ms": None, **rows[name]} for name in src]
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
