// K3: MF-SGD tile-entry block update for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/mfsgd_kernel.py::sgd_tile_update (Pallas body
// _kernel).  One rotation step of one worker: for every entry (up to C
// ratings inside one u_tile x i_tile sub-tile, at tile offsets ou / oi),
// every rating scores against the entry-start W and H tiles, the gradients
// accumulate in f32, and ONE apply tile = snapshot + lr * acc lands at the
// entry's end.  Numerics of the TPU kernel: the gathered rows are rounded
// to the compute type (bf16 or f32) and read as f32; err = v - sum(w * h)
// is f32; gw = err * h - reg * w and gh = err * w - reg * h are rounded to
// the compute type before they are summed; sums and the apply are f32.  A
// slot is a pad when eu >= u_tile, and then its W and H rows are never
// read (its ei may lie one row past the tile).
//
// Entry order.  The TPU runs the entries as a sequential grid.  The host
// (harp_tpu_torch/ops/mfsgd_kernel.py, LevelSchedule) lists the entries
// with a rating in a topological order (`order`, level by level) and gives
// each position in it the positions of its two predecessors (`pred`): the
// previous entry with the same W tile and the previous entry with the same
// H tile.  An entry that starts after both have applied reads what the
// sequential order gives it, and no later entry of its W or H tile can
// start before it has applied.
//
// Bound on this card.  At MovieLens-20M width (rank 64, 256 x 256 tiles,
// ~349 ratings an entry, 28,673 entries and a critical path of 593 entries
// a step) the step must read the entry streams and read and write W and H
// once; its ~12 flops per rating and rank element run on the f32 CUDA
// cores.  Both come to about 0.1 ms.  What bounds this kernel is the
// chain: 593 entries one after another, each a gather, a reduction and an
// apply that the next one waits for.
//
// Design: one launch a step, ordered by dataflow, each entry on a cluster
// of CL blocks (CL = 2 on the main path; 1, 2, 4 or 8 work).
//  - A persistent grid of clusters takes positions of `order` from a global
//    counter.  Workers take positions only while running, in topological
//    order, so the lowest unfinished position always has its predecessors
//    done: no deadlock and no cooperative launch.  Before an entry runs,
//    thread 0 of each block waits with ld.acquire on the predecessors'
//    `done` counters (each counts its entry's blocks that have applied);
//    after the apply each block publishes with a fence and an atomic add.
//    A wait that lasts ~10 s traps rather than hang.
//  - While the predecessors run, every block loads the entry's real
//    ratings in the host's two stable sorts (LevelSchedule.sort), by W row
//    and by H row, into shared memory.
//  - Two passes, by W row then by H row.  A worker is 16 lanes; worker k
//    of the cluster takes the ratings from the run that holds position
//    n k / NW up to the run that holds n (k + 1) / NW, so each row's run is
//    one worker's: the worker keeps the row's running gradient sum in
//    registers and writes the row's final value, entry-start value + lr *
//    sum, when the row changes - no atomics and one order, so reruns are
//    bit-equal.  Lane g holds elements g + 16 k of both rows, read once a
//    pass through L2 (other SMs write them inside the launch); the dot
//    takes them in the plain version's order (dot_row).  The W pass hands
//    each rating's error to every block and leaves the W rows' final
//    values in the shared memory of block row % CL (so the tiles are
//    bounded by the cluster's shared memory, not one block's); after a
//    cluster barrier the H pass reads the errors and writes the H rows
//    straight to H (no one else reads them then).  After a second barrier
//    each block writes its touched W rows to W.
//  - The gradient terms and the apply use __fmul_rn / __fadd_rn, so nvcc
//    cannot contract them into FMAs that would round otherwise.
//  - se and cnt: one partial a position and block, in a fixed order.
// Float atomics into the cluster's shared memory (or each block's own, or
// L2) cost more than the sorted passes on an H100, and so did sorting in
// the kernel, 8 lanes a worker and fetching a step ahead (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;             // lanes a rating (a worker)
constexpr int kWorkers = 32 / kLanes;  // workers a warp
constexpr int kPer = 2;                // ratings a worker keeps in flight
constexpr int kCache = 4;              // elements a lane keeps (R <= 64)

template <bool kBF16>
__device__ __forceinline__ float rnd(float x) {
  if (kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// until `blocks` blocks have applied the entry at position p (none if
// p < 0); traps after ~10 s instead of hanging
__device__ __forceinline__ void wait_done(const int* done, int p, int blocks) {
  if (p < 0) return;
  const long long t0 = clock64();
  while (load_acquire(done + p) < blocks)
    if (clock64() - t0 > 20000000000ll) __trap();
}

// va / vb [k / 2 % 4] += x (vb for odd k), for a k known only at run time
// (the switch keeps the sums in registers)
__device__ __forceinline__ void add_k(float (&va)[4], float (&vb)[4], int k,
                                      float x) {
  switch (k & 7) {
    case 0: va[0] = __fadd_rn(va[0], x); break;
    case 1: vb[0] = __fadd_rn(vb[0], x); break;
    case 2: va[1] = __fadd_rn(va[1], x); break;
    case 3: vb[1] = __fadd_rn(vb[1], x); break;
    case 4: va[2] = __fadd_rn(va[2], x); break;
    case 5: vb[2] = __fadd_rn(vb[2], x); break;
    case 6: va[3] = __fadd_rn(va[3], x); break;
    default: vb[3] = __fadd_rn(vb[3], x);
  }
}

// The dot of two gathered rows on a 16-lane worker, in the plain version's
// order.  PyTorch's sum over the last dimension of [k, C, R] on the card
// gives lane l of a warp the products of elements l + 32 m, added into four
// sums by m % 4 and those in order, then adds the lanes by shuffles at 16,
// 8, 4, 2, 1.  Lane g of the worker holds elements g + 16 k: the even k
// are that order's lane g (m = k / 2), the odd k its lane g + 16, so the
// lane forms both lanes' sums, adds them (the shuffle at 16), and the
// worker adds its lanes at 8, 4, 2, 1; every lane ends with the same sum.
// a / b: the lane's first kCache elements (zero past R); the rest are read
// here.
template <bool kBF16>
__device__ __forceinline__ float dot_row(const float (&a)[kCache],
                                         const float (&b)[kCache],
                                         const float* wrow, const float* hrow,
                                         int R, int g, bool valid) {
  float va[4] = {0.f, 0.f, 0.f, 0.f}, vb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    float& v = (k & 1) ? vb[(k >> 1) & 3] : va[(k >> 1) & 3];
    v = __fadd_rn(v, __fmul_rn(a[k], b[k]));
  }
  for (int k = kCache, r = g + kLanes * kCache; valid && r < R;
       ++k, r += kLanes)
    add_k(va, vb, k, __fmul_rn(rnd<kBF16>(__ldcg(wrow + r)),
                               rnd<kBF16>(__ldcg(hrow + r))));
  float dot = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(va[0], va[1]), va[2]), va[3]),
      __fadd_rn(__fadd_rn(__fadd_rn(vb[0], vb[1]), vb[2]), vb[3]));
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
  return dot;
}

// The kPer ratings of a worker's slice from position j on (those at or
// past `end` are not read): their tile rows (s_cu, s_ci) in the pass's
// order, their values (s_v, in the W order: the W pass uses them), and
// the lane's elements g + kLanes k of their W and H rows, unrounded, read
// through L2 (other SMs write them inside the launch).
__device__ __forceinline__ void fetch(
    const int* s_cu, const int* s_ci, const float* s_v, const float* W,
    const float* H, long w0, long h0, int R, int g, int j, int end,
    int (&cu)[kPer], int (&ci)[kPer], float (&rv)[kPer],
    float (&w)[kPer][kCache], float (&h)[kPer][kCache]) {
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const bool valid = j + p < end;
    cu[p] = valid ? s_cu[j + p] : 0;
    ci[p] = valid ? s_ci[j + p] : 0;
    rv[p] = valid ? s_v[j + p] : 0.f;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float* wrow = W + (w0 + cu[p]) * R;
    const float* hrow = H + (h0 + ci[p]) * R;
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const bool in = j + p < end && g + kLanes * k < R;
      w[p][k] = in ? __ldcg(wrow + g + kLanes * k) : 0.f;
      h[p][k] = in ? __ldcg(hrow + g + kLanes * k) : 0.f;
    }
  }
}

// A W row's run is done: its final values, entry-start value + lr *
// sum, go to the row's place in the shared memory of block row % CL (W
// rows are read until the H pass ends), and its flag there is set.  The
// lane's first kCache elements come from registers; the rest were summed
// in place and take their entry-start values from `tile`.
__device__ __forceinline__ void finish_w(cg::cluster_group& cluster,
                                         float* fin, int* hit, int row,
                                         int lg_cl, int R, int g, float lr,
                                         const float (&run)[kCache],
                                         const float (&base)[kCache],
                                         const float* tile) {
  const unsigned owner = row & ((1 << lg_cl) - 1);
  float* dst = cluster.map_shared_rank(fin, owner) + (long)(row >> lg_cl) * R;
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (g + kLanes * k < R)
      dst[g + kLanes * k] = __fadd_rn(base[k], __fmul_rn(lr, run[k]));
  for (int r = g + kLanes * kCache; r < R; r += kLanes)
    dst[r] = __fadd_rn(__ldcg(tile + (long)row * R + r), __fmul_rn(lr, dst[r]));
  if (g == 0) cluster.map_shared_rank(hit, owner)[row >> lg_cl] = 1;
}

// An H row's run is done: its final values go straight to the H tile (no
// one else reads the row in the H pass); elements past the registers were
// summed in place in the shared memory of block row % CL, which is left
// zero.
__device__ __forceinline__ void finish_h(cg::cluster_group& cluster,
                                         float* fin, int row, int lg_cl,
                                         int R, int g, float lr,
                                         const float (&run)[kCache],
                                         const float (&base)[kCache],
                                         float* tile) {
  float* out = tile + (long)row * R;
#pragma unroll
  for (int k = 0; k < kCache; ++k)
    if (g + kLanes * k < R)
      __stcg(out + g + kLanes * k, __fadd_rn(base[k], __fmul_rn(lr, run[k])));
  if (R > kLanes * kCache) {
    float* sum = cluster.map_shared_rank(fin, row & ((1 << lg_cl) - 1)) +
                 (long)(row >> lg_cl) * R;
    for (int r = g + kLanes * kCache; r < R; r += kLanes) {
      __stcg(out + r, __fadd_rn(__ldcg(out + r), __fmul_rn(lr, sum[r])));
      sum[r] = 0.f;
    }
  }
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads, 1)
sgd_step_kernel(float* __restrict__ W, float* __restrict__ H,
            const int* __restrict__ eu, const int* __restrict__ ei,
            const float* __restrict__ ev, const int* __restrict__ ou,
            const int* __restrict__ oi, const int* __restrict__ order,
            const int* __restrict__ pred, const int* __restrict__ sort,
            const int* __restrict__ n_real, int n_sched, int C, int R,
            int u_tile, int i_tile, float lr, float reg,
            int* __restrict__ work, float* __restrict__ se_part,
            float* __restrict__ cnt_part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_ticket;
  __shared__ float s_red[2][kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // this block's rows (r % CL == rank) of the W tile and of the H tile:
  // the W rows' final values and a flag each (set when a rating touched
  // the row), and the H rows' sums of the elements past the registers
  const int UL = (u_tile + CL - 1) / CL, IL = (i_tile + CL - 1) / CL;
  float* fin_w = smem;
  float* fin_h = smem + (long)UL * R;
  int* hit_w = reinterpret_cast<int*>(smem + (long)(UL + IL) * R);
  // the entry's real ratings, each block all of them, in the host's two
  // stable sorts (LevelSchedule.sort): by W row - rows, values, errors
  // (from the W pass), run starts - and by H row - rows, run starts, and
  // each rating's place in the W order
  int* u_cu = hit_w + UL;
  int* u_ci = u_cu + C;
  float* u_v = reinterpret_cast<float*>(u_ci + C);
  float* u_err = u_v + C;
  int* u_start = reinterpret_cast<int*>(u_err + C);
  int* i_cu = u_start + C;
  int* i_ci = i_cu + C;
  int* i_start = i_ci + C;
  int* i_upos = i_start + C;
  int* counter = work;
  int* done = work + 1;
  const bool vec = R % 4 == 0 && (uintptr_t)W % 16 == 0;

  for (int i = t; i < (UL + IL) * R; i += kThreads) smem[i] = 0.f;
  for (int i = t; i < UL; i += kThreads) hit_w[i] = 0;
  float se = 0.f, cnt = 0.f;  // a worker's, of its ratings in the entry
  const int NW = kWorkers * CL * kWarps;  // workers a cluster
  const int wk = kWorkers * (rank * kWarps + warp) + lane / kLanes;
  const int gq = lane & (kLanes - 1), lg_cl = __ffs(CL) - 1;  // CL 2, 4, 8

  for (;;) {
    if (rank == 0 && t == 0) s_ticket = atomicAdd(counter, 1);
    cluster.sync();  // the ticket is out; the rows of the last entry are out
    const int pos = *cluster.map_shared_rank(&s_ticket, 0);
    if (pos >= n_sched) break;
    const int e = __ldg(order + pos);
    const int pu = __ldg(pred + 2 * pos), pi = __ldg(pred + 2 * pos + 1);
    const long w0 = (long)__ldg(ou + e), h0 = (long)__ldg(oi + e);
    const int n = __ldg(n_real + pos);

    // the entry into shared memory, sorted, while the predecessors may
    // still run
    const int* srt = sort + (long)pos * 5 * C;
    const long row0 = (long)e * C;
    for (int j = t; j < n; j += kThreads) {
      const int su = __ldg(srt + j), si = __ldg(srt + 2 * C + j);
      u_cu[j] = __ldg(eu + row0 + su);
      u_ci[j] = __ldg(ei + row0 + su);
      u_v[j] = __ldg(ev + row0 + su);
      u_start[j] = __ldg(srt + C + j);
      i_cu[j] = __ldg(eu + row0 + si);
      i_ci[j] = __ldg(ei + row0 + si);
      i_start[j] = __ldg(srt + 3 * C + j);
      i_upos[j] = __ldg(srt + 4 * C + j);
    }
    if (t == 0) {
      wait_done(done, pu, CL);
      wait_done(done, pi, CL);
      __threadfence();
    }
    __syncthreads();  // loaded, and the predecessors have applied

    // Two passes over the ratings, sorted by W row, then by H row.
    // Worker k of the cluster (kLanes lanes) takes the ratings from the run
    // that holds position n k / NW up to the run that holds n (k + 1) /
    // NW, so each row's run is one worker's: it keeps the row's running
    // gradient sum and, when the row changes, writes the row's final
    // values - no atomics, and one order, so reruns are bit-equal.  A
    // rating's rows are read once a pass, kPer ratings in flight, through
    // L2: other SMs write them inside the launch.
    //
    // The W pass computes each rating's error, hands it to every block of
    // the cluster, and leaves the W rows' final values in their blocks'
    // shared memory (W rows are read again in the H pass).  After a
    // cluster barrier no one reads an H row but its worker, so the H pass
    // writes its rows' final values straight to H.
    for (int side = 0; side < 2; ++side) {
      const int* s_cu = side ? i_cu : u_cu;
      const int* s_ci = side ? i_ci : u_ci;
      const int* start = side ? i_start : u_start;
      int cut[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = n * (wk + q) / NW;
        cut[q] = c >= n ? n : start[c];  // the start of c's run
      }
      // the current row's running sum and its entry-start values (f32,
      // unrounded)
      float run[kCache], base[kCache];
      int cur = -1;
      // the warp runs while any of its workers has ratings (the shuffles
      // need the whole warp)
      for (int j0 = cut[0]; __any_sync(0xffffffffu, j0 < cut[1]);
           j0 += kPer) {
        int cu[kPer], ci[kPer];
        float rv[kPer], wx[kPer][kCache], hx[kPer][kCache];
        fetch(s_cu, s_ci, u_v, W, H, w0, h0, R, gq, j0, cut[1], cu, ci, rv,
              wx, hx);
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const bool valid = j0 + p < cut[1];  // worker-uniform
          float w[kCache], h[kCache];
#pragma unroll
          for (int k = 0; k < kCache; ++k) {
            w[k] = rnd<kBF16>(wx[p][k]);
            h[k] = rnd<kBF16>(hx[p][k]);
          }
          const float* wrow = W + (w0 + cu[p]) * R;
          const float* hrow = H + (h0 + ci[p]) * R;
          float err;
          if (side == 0) {
            const float dot = dot_row<kBF16>(w, h, wrow, hrow, R, gq, valid);
            if (!valid) continue;
            err = __fsub_rn(rv[p], dot);
            se = __fadd_rn(se, __fmul_rn(err, err));
            cnt += 1.f;
            if (gq < CL) cluster.map_shared_rank(u_err, gq)[j0 + p] = err;
          } else {
            if (!valid) continue;
            err = u_err[i_upos[j0 + p]];
          }
          const int row = side ? ci[p] : cu[p];
          if (row != cur) {
            if (cur >= 0) {
              if (side == 0)
                finish_w(cluster, fin_w, hit_w, cur, lg_cl, R, gq, lr, run,
                         base, W + w0 * R);
              else
                finish_h(cluster, fin_h, cur, lg_cl, R, gq, lr, run, base,
                         H + h0 * R);
            }
            cur = row;
#pragma unroll
            for (int k = 0; k < kCache; ++k) {
              run[k] = 0.f;
              base[k] = side ? hx[p][k] : wx[p][k];
            }
          }
          // gw = err h - reg w (W pass), gh = err w - reg h (H pass)
#pragma unroll
          for (int k = 0; k < kCache; ++k) {
            const float x = side ? w[k] : h[k];
            const float y = side ? h[k] : w[k];
            run[k] = __fadd_rn(run[k], rnd<kBF16>(__fsub_rn(
                                           __fmul_rn(err, x), __fmul_rn(reg, y))));
          }
          if (R > kLanes * kCache) {  // elements past the registers: summed
            float* fin = side ? fin_h : fin_w;  // in place, the row is ours
            float* dst = cluster.map_shared_rank(fin, row & (CL - 1)) +
                         (long)(row >> lg_cl) * R;
            for (int r = gq + kLanes * kCache; r < R; r += kLanes) {
              const float wr = rnd<kBF16>(__ldcg(wrow + r));
              const float hr = rnd<kBF16>(__ldcg(hrow + r));
              const float x = side ? wr : hr, y = side ? hr : wr;
              dst[r] = __fadd_rn(dst[r], rnd<kBF16>(__fsub_rn(
                                             __fmul_rn(err, x), __fmul_rn(reg, y))));
            }
          }
        }
      }
      if (cur >= 0) {
        if (side == 0)
          finish_w(cluster, fin_w, hit_w, cur, lg_cl, R, gq, lr, run, base,
                   W + w0 * R);
        else
          finish_h(cluster, fin_h, cur, lg_cl, R, gq, lr, run, base,
                   H + h0 * R);
      }
      if (side == 0)
        cluster.sync();  // the errors have landed; no W-pass read is left
    }
    // se and cnt: the warp's workers', added into lane 0 in one order
    for (int off = kLanes; off < 32; off <<= 1) {
      se = __fadd_rn(se, __shfl_xor_sync(0xffffffffu, se, off));
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      s_red[0][warp] = se;
      s_red[1][warp] = cnt;
    }
    se = cnt = 0.f;
    cluster.sync();  // every final value of the entry has landed
    if (t == 0) {  // the block's se and cnt of the entry, warps in order
      float a = 0.f, c = 0.f;
      for (int k = 0; k < kWarps; ++k) {
        a = __fadd_rn(a, s_red[0][k]);
        c += s_red[1][k];
      }
      se_part[(long)pos * CL + rank] = a;
      cnt_part[(long)pos * CL + rank] = c;
    }

    // The apply: this block's touched W rows go to W (16 bytes a store
    // where R % 4 == 0 and W is 16-byte aligned); their places and flags
    // are left zero.
    const int V = vec ? 4 : 1, NC = R / V;
    const int n_all = ((u_tile - rank + CL - 1) / CL) * NC;
    for (int i = t; i < n_all; i += kThreads) {
      const int lrow = i / NC, c = (i - lrow * NC) * V;
      if (!hit_w[lrow]) continue;  // untouched: unchanged
      float* p = fin_w + (long)lrow * R + c;
      float* dst = W + (w0 + lrow * CL + rank) * R + c;
      if (vec) {
        __stcg(reinterpret_cast<float4*>(dst), *reinterpret_cast<float4*>(p));
        *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        __stcg(dst, *p);
        *p = 0.f;
      }
    }
    __syncthreads();
    if (t == 0) {
      __threadfence();
      atomicAdd(done + pos, 1);  // this block has applied
    }
    for (int i = t; i < UL; i += kThreads) hit_w[i] = 0;
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

using KernelFn = void (*)(float*, float*, const int*, const int*,
                          const float*, const int*, const int*, const int*,
                          const int*, const int*, const int*, int, int, int,
                          int, int, float, float, int*, float*, float*);

KernelFn pick(int bf16) {
  return bf16 ? sgd_step_kernel<true> : sgd_step_kernel<false>;
}

cudaLaunchConfig_t config(int blocks, int cl, size_t smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Once per process and card, before the first sgd_tile_update there:
// *limit receives the shared memory a block may use on the current card
// (the opt-in maximum) and *static_bytes the kernel's static shared memory;
// every instantiation may then take limit - static_bytes of dynamic shared
// memory.
int sgd_tile_update_init(int* limit, int* static_bytes) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  int most = 0;
  for (int k = 0; k < 2; ++k) {
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, pick(k));
    if (err != cudaSuccess) return (int)err;
    if ((int)a.sharedSizeBytes > most) most = (int)a.sharedSizeBytes;
  }
  *static_bytes = most;
  for (int k = 0; k < 2; ++k) {
    err = cudaFuncSetAttribute(pick(k),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit - most);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// *clusters receives how many clusters of cl blocks with smem bytes of
// dynamic shared memory the card holds at once (0: none fits).
int sgd_tile_update_plan(int cl, int smem, int bf16, int* clusters) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(cl, cl, (size_t)smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, pick(bf16), &cfg);
}

// One rotation step: W [*, R] and H [*, R] f32 updated in place; eu/ei
// int32, ev f32 [NE, C]; ou/oi int32 [NE]; order int32 [n_sched] and pred
// int32 [n_sched, 2], sort int32 [n_sched, 5, C] and n_real int32
// [n_sched] from LevelSchedule; clusters x cl blocks with smem
// bytes of dynamic shared memory (block_bytes in the wrapper); work
// int32 [1 + n_sched] zeroed by the caller (the ticket counter, then one
// done counter a position); se/cnt f32 [n_sched * cl] receive one partial
// a position and block.  One launch.  Returns the first CUDA error
// (0 on success).
int sgd_tile_update(void* W, void* H, const void* eu, const void* ei,
                    const void* ev, const void* ou, const void* oi,
                    const void* order, const void* pred, const void* sort,
                    const void* n_real, int n_sched, int C,
                    int R, int u_tile, int i_tile, float lr, float reg,
                    int bf16, int cl, int clusters, int smem, void* work,
                    void* se, void* cnt, void* stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(clusters * cl, cl, (size_t)smem,
                                  (cudaStream_t)stream, attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, pick(bf16), (float*)W, (float*)H, (const int*)eu,
      (const int*)ei, (const float*)ev, (const int*)ou, (const int*)oi,
      (const int*)order, (const int*)pred, (const int*)sort,
      (const int*)n_real, n_sched, C, R, u_tile, i_tile, lr,
      reg, (int*)work, (float*)se, (float*)cnt);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
