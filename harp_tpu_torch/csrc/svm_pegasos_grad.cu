// K5: fused Pegasos hinge gradient for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/svm_kernel.py::pegasos_grad (Pallas body _kernel).
// One pass over the samples x [n, d] (row-major, f32 or bf16):
//   margin_i = y_i * (x_i . w + b),  coef_i = [margin_i < 1] * sw_i * y_i,
//   gw = sum_i coef_i * x_i,  gs = sum_i coef_i.
// The bf16 arm mirrors the TPU kernel's numerics: w is rounded to bf16 before
// the margin dot and coef to bf16 before the gradient dot (bf16 x bf16
// products are exact in f32), accumulation is f32, and gs sums the f32 coef.
//
// Bound on this card: memory.  At 500,256 x 128 it must read x once (256.1 MB
// f32 or 128.1 MB bf16) plus y and sw (4 MB): 0.078 / 0.039 ms at 3.35 TB/s;
// its 4*n*d = 2.6e8 f32 operations take 0.004 ms at 67 TFLOP/s.
//
// Design: one launch, x read from device memory once and never again.
//  - The row arm (a row's 16-byte chunks fit in 32 lanes x K registers): a
//    group of LG lanes owns a row at a time (LG the power of two that covers
//    the row's chunks, so a warp takes 32 / LG rows at once), each lane
//    holding its chunks in registers: f32 as float4, bf16 as 8 x bf16, or
//    4-byte elements when d is not a multiple of the chunk or x is not
//    16-byte aligned.  The margin dot is a fixed xor-shuffle tree over the
//    LG lanes (every lane ends with the same sum), and each lane adds
//    coef * x for its own columns into register accumulators from the same
//    registers.  A warp issues U rows' loads before it uses any, so enough
//    bytes stay in flight to cover the device memory's latency; nothing
//    waits at a block barrier until the end.
//  - The tile arm (wider rows, d = 20,000 and 40,000 among them): a block
//    owns tiles of kTileN rows; its warps compute the tile's coef, then
//    thread j adds the tile's rows into column j of the block's accumulator
//    (shared memory when w and it fit, else the block's row of the
//    workspace).  Rows too long for registers are read twice here, the
//    second time from L1/L2.
//  - The end, both arms: each block sums its warps' partials in warp order
//    and writes its row of the [grid, d] workspace and its gs partial, then
//    fences and takes a ticket from a global counter; the block that draws
//    the last ticket sums the rows in block order, writes gw and gs and
//    resets the counter.  No float atomics: reruns are bit-equal.
//  - Any n and d: the ragged rows are masked; there is no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;  // the tile arm's rows a tile

enum Arm { kRows1 = 0, kRows4 = 1, kTileSmem = 2, kTileGlobal = 3 };

// the row arm's row steps in flight a warp, for E elements a chunk and K
// chunks a lane (on an H100 80GB HBM3 at 700 W, f32 at 500,256 x 128 took
// 0.0985 ms with 4 and two blocks an SM, 0.1030 with 8, 0.1015 with 16;
// bf16 0.0591 with 8, 0.0632 with 4, 0.0688 with 16)
__host__ __device__ constexpr int rows_in_flight(int E, int K) {
  return K == 1 ? (E == 8 ? 8 : 4) : 2;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits(unsigned b) {
  return __uint_as_float(b << 16);
}

// element i of x as f32
template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, long i) {
  if (kBf16) return bf16_bits(static_cast<const uint16_t*>(x)[i]);
  return static_cast<const float*>(x)[i];
}

// The raw words of E elements of x from element i on: one 16-byte load
// (E = 4 f32 or 8 bf16, i a multiple of E, x 16-byte aligned) into four
// words, or one 4- or 2-byte load (E = 1) into one.  Kept raw until used,
// so a bf16 chunk in flight holds four registers, not eight.
template <int E>
__host__ __device__ constexpr int words() { return E == 1 ? 1 : 4; }

template <bool kBf16, int E>
__device__ __forceinline__ void load_raw(const void* x, long i,
                                         unsigned (&r)[words<E>()]) {
  if constexpr (E == 1) {
    r[0] = kBf16 ? (unsigned)__ldg(static_cast<const unsigned short*>(x) + i)
                 : __float_as_uint(__ldg(static_cast<const float*>(x) + i));
  } else {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(x) + i / E);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  }
}

// element e of a raw chunk, as f32
template <bool kBf16, int E>
__device__ __forceinline__ float elem(const unsigned (&r)[words<E>()], int e) {
  if constexpr (E == 1) return kBf16 ? bf16_bits(r[0]) : __uint_as_float(r[0]);
  if constexpr (E == 8) return bf16_bits(e & 1 ? r[e >> 1] >> 16 : r[e >> 1] & 0xffffu);
  return __uint_as_float(r[e]);
}

// The end of both arms.  part: this block's gw partial in shared memory
// (stride d), gs its gs partial (thread 0's).  Writes the block's row of
// the workspace; the last block to finish sums the rows in block order.
__device__ void finish(const float* part, float gs, int d,
                       float* __restrict__ gw_part, float* __restrict__ gs_part,
                       unsigned* __restrict__ counter, float* __restrict__ gw,
                       float* __restrict__ gs_out) {
  __shared__ bool s_last;
  __shared__ float s_sum[kThreads];
  const int t = threadIdx.x;
  if (part != nullptr)
    for (int j = t; j < d; j += kThreads)
      gw_part[(long)blockIdx.x * d + j] = part[j];
  if (t == 0) gs_part[blockIdx.x] = gs;
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // S threads a column when d < kThreads, each over a contiguous range of
  // blocks, then the S sums in order: one fixed order for a given grid
  const int G = gridDim.x;
  const int S = d >= kThreads ? 1 : kThreads / d;
  const int span = (G + S - 1) / S;
  for (int j0 = 0; j0 < d; j0 += kThreads / S) {
    const int j = j0 + t / S, q = t % S;
    float s = 0.f;
    if (j < d && t / S < kThreads / S) {
      const int b1 = min(G, (q + 1) * span);
#pragma unroll 8
      for (int b = q * span; b < b1; ++b)
        s += __ldcg(gw_part + (long)b * d + j);
    }
    s_sum[t] = s;
    __syncthreads();
    if (q == 0 && j < d && t / S < kThreads / S) {
      float total = 0.f;
      for (int k = 0; k < S; ++k) total += s_sum[t + k];
      gw[j] = total;
    }
    __syncthreads();
  }
  if (t == 0) {
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += __ldcg(gs_part + b);
    *gs_out = s;
    *counter = 0u;  // ready for the next call on this stream
  }
}

// The row arm.  E elements a chunk, K chunks a lane.
template <bool kBf16, int E, int K>
__global__ void __launch_bounds__(kThreads, 1)
rows_kernel(const void* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, const float* __restrict__ y,
            const float* __restrict__ sw, int n, int d, int LG,
            float* __restrict__ gw_part, float* __restrict__ gs_part,
            unsigned* __restrict__ counter, float* __restrict__ gw,
            float* __restrict__ gs_out) {
  constexpr int U = rows_in_flight(E, K);
  extern __shared__ __align__(16) float part[];  // [kWarps, d]
  __shared__ float s_gs[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gl = lane % LG, sub = lane / LG, RPG = 32 / LG;
  const int nch = (d + E - 1) / E;
  const float bias = *b;
  float wv[K][E], acc[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = (gl + LG * k) * E + e;
      const float wj = (gl + LG * k < nch && j < d) ? w[j] : 0.f;
      wv[k][e] = kBf16 ? bf16_round(wj) : wj;
      acc[k][e] = 0.f;
    }
  float gs = 0.f;
  const long per_step = (long)U * RPG;
  const long steps = ((long)n + per_step - 1) / per_step;
  for (long st = (long)blockIdx.x * kWarps + warp; st < steps;
       st += (long)gridDim.x * kWarps) {
    unsigned xv[U][K][words<E>()];
    float yv[U], sv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long row = st * per_step + u * RPG + sub;
      const bool valid = row < n;
      yv[u] = valid ? __ldg(y + row) : 0.f;
      sv[u] = valid ? __ldg(sw + row) : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = gl + LG * k;
        if (valid && c < nch) {
          load_raw<kBf16, E>(x, row * d + (long)c * E, xv[u][k]);
        } else {
#pragma unroll
          for (int q = 0; q < words<E>(); ++q) xv[u][k][q] = 0u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e)
          dot = fmaf(elem<kBf16, E>(xv[u][k], e), wv[k][e], dot);
      for (int off = LG / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float margin = yv[u] * (dot + bias);
      const float coef = (margin < 1.f ? sv[u] : 0.f) * yv[u];
      if (gl == 0) gs += coef;
      const float c = kBf16 ? bf16_round(coef) : coef;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[k][e] = fmaf(c, elem<kBf16, E>(xv[u][k], e), acc[k][e]);
    }
  }
  // the warp's row groups hold the same columns: add them in a fixed order
  for (int off = LG; off < 32; off <<= 1) {
    gs += __shfl_xor_sync(0xffffffffu, gs, off);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = (gl + LG * k) * E + e;
        if (gl + LG * k < nch && j < d) part[warp * d + j] = acc[k][e];
      }
  }
  if (lane == 0) s_gs[warp] = gs;
  __syncthreads();
  // the block's partial: its warps in order, into warp 0's row
  for (int j = t; j < d; j += kThreads) {
    float s = part[j];
    for (int k = 1; k < kWarps; ++k) s += part[k * d + j];
    part[j] = s;
  }
  float g = 0.f;
  if (t == 0)
    for (int k = 0; k < kWarps; ++k) g += s_gs[k];
  __syncthreads();
  finish(part, g, d, gw_part, gs_part, counter, gw, gs_out);
}

// The tile arm: rows too wide for the row arm's registers.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const void* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, const float* __restrict__ y,
            const float* __restrict__ sw, int n, int d, bool in_smem,
            float* __restrict__ gw_part, float* __restrict__ gs_part,
            unsigned* __restrict__ counter, float* __restrict__ gw,
            float* __restrict__ gs_out) {
  extern __shared__ __align__(16) float smem[];
  float* coef_s = smem;
  float* w_s = smem + kTileN;
  float* acc = in_smem ? w_s + d : gw_part + (long)blockIdx.x * d;
  const float* wv = in_smem ? w_s : w;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float bias = *b;

  for (int j = t; j < d; j += kThreads) {
    if (in_smem) w_s[j] = w[j];
    acc[j] = 0.f;
  }
  float gs = 0.f;  // thread 0's copy is the block's
  const long ntiles = ((long)n + kTileN - 1) / kTileN;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = tile * kTileN;
    const int rows = (int)min((long)kTileN, (long)n - row0);
    __syncthreads();  // w_s ready; the previous tile's column pass is done
    for (int r = warp; r < rows; r += kWarps) {
      const long base = (row0 + r) * (long)d;
      float dot = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float wj = kBf16 ? bf16_round(wv[j]) : wv[j];
        dot = fmaf(load_x<kBf16>(x, base + j), wj, dot);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const float yi = y[row0 + r];
        const float margin = yi * (dot + bias);
        coef_s[r] = (margin < 1.f ? sw[row0 + r] : 0.f) * yi;
      }
    }
    __syncthreads();
    if (t == 0)
      for (int r = 0; r < rows; ++r) gs += coef_s[r];
    for (int j = t; j < d; j += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float c = kBf16 ? bf16_round(coef_s[r]) : coef_s[r];
        s = fmaf(c, load_x<kBf16>(x, (row0 + r) * (long)d + j), s);
      }
      acc[j] += s;  // column j is this thread's alone
    }
  }
  __syncthreads();
  finish(in_smem ? acc : nullptr, gs, d, gw_part, gs_part, counter, gw,
         gs_out);
}

using Fn = void (*)(const void*, const float*, const float*, const float*,
                    const float*, int, int, int, float*, float*, unsigned*,
                    float*, float*);
using TileFn = void (*)(const void*, const float*, const float*,
                        const float*, const float*, int, int, bool, float*,
                        float*, unsigned*, float*, float*);

// the row arm's instance: (bf16, vec, K = 4)
Fn rows_fn(int bf16, int vec, int k4) {
  switch ((bf16 ? 4 : 0) | (vec ? 2 : 0) | (k4 ? 1 : 0)) {
    case 0: return rows_kernel<false, 1, 1>;
    case 1: return rows_kernel<false, 1, 4>;
    case 2: return rows_kernel<false, 4, 1>;
    case 3: return rows_kernel<false, 4, 4>;
    case 4: return rows_kernel<true, 1, 1>;
    case 5: return rows_kernel<true, 1, 4>;
    case 6: return rows_kernel<true, 8, 1>;
    default: return rows_kernel<true, 8, 4>;
  }
}

TileFn tile_fn(int bf16) { return bf16 ? tile_kernel<true> : tile_kernel<false>; }

size_t smem_bytes(int arm, int d) {
  if (arm == kRows1 || arm == kRows4) return (size_t)kWarps * d * sizeof(float);
  return (size_t)(kTileN + (arm == kTileSmem ? 2 * (size_t)d : 0)) *
         sizeof(float);
}

const void* fn_of(int arm, int bf16, int vec) {
  if (arm == kRows1 || arm == kRows4)
    return (const void*)rows_fn(bf16, vec, arm == kRows4);
  return (const void*)tile_fn(bf16);
}

}  // namespace

extern "C" {

// Once per card, shape and layout (the wrapper keeps the answer): lets
// every instantiation take the card's opt-in shared memory (the kernels'
// static part aside, so a plan for one d never caps another), picks the arm
// for (d, bf16, vec) - vec: d a multiple of the 16-byte chunk and x 16-byte
// aligned - and returns it, the lanes a row (LG, row arm) and the number of
// blocks: enough to fill the card, at most one per unit of work.  The
// caller sizes the [grid, d] and [grid] workspaces with *grid.
int svm_pegasos_grad_plan(int n, int d, int bf16, int vec, int* grid,
                          int* arm, int* lanes) {
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int E = vec ? (bf16 ? 8 : 4) : 1;
  const int nch = (d + E - 1) / E;
  int lg = 1;
  while (lg < nch && lg < 32) lg <<= 1;
  *lanes = lg;
  const size_t dyn = (size_t)optin - 4096;  // room for static shared memory
  if (nch <= 32 && smem_bytes(kRows1, d) <= dyn) *arm = kRows1;
  else if (nch <= 128 && smem_bytes(kRows4, d) <= dyn) *arm = kRows4;
  else *arm = smem_bytes(kTileSmem, d) <= dyn ? kTileSmem : kTileGlobal;
  const void* fn = fn_of(*arm, bf16, vec);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, smem_bytes(*arm, d));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long units;
  if (*arm == kRows1 || *arm == kRows4) {
    const long per_step =
        (long)rows_in_flight(E, *arm == kRows1 ? 1 : 4) * (32 / lg);
    units = (((long)n + per_step - 1) / per_step + kWarps - 1) / kWarps;
  } else {
    units = ((long)n + kTileN - 1) / kTileN;
  }
  const long cap = (long)sms * per_sm;
  *grid = (int)(units < cap ? units : cap);
  if (*grid < 1) *grid = 1;
  return 0;
}

// x: [n, d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w [d], b [1], y [n],
// sw [n] f32.  vec, grid, arm and lanes come from svm_pegasos_grad_plan on
// this card.  gw_part holds grid * d floats and gs_part grid floats (no
// initialisation needed); counter is one unsigned int, zero before the
// first call and left zero by every call (one counter a stream); gw [d]
// and gs [1] are written.  One launch.  Returns cudaGetLastError() after
// it (0 on success).
int svm_pegasos_grad(const void* x, int x_bf16, const void* w, const void* b,
                     const void* y, const void* sw, int n, int d, int vec,
                     int grid, int arm, int lanes, void* gw_part,
                     void* gs_part, void* counter, void* gw, void* gs,
                     void* stream) {
  const size_t smem = smem_bytes(arm, d);
  cudaStream_t s = (cudaStream_t)stream;
  if (arm == kRows1 || arm == kRows4)
    rows_fn(x_bf16, vec, arm == kRows4)<<<grid, kThreads, smem, s>>>(
        x, (const float*)w, (const float*)b, (const float*)y,
        (const float*)sw, n, d, lanes, (float*)gw_part, (float*)gs_part,
        (unsigned*)counter, (float*)gw, (float*)gs);
  else
    tile_fn(x_bf16)<<<grid, kThreads, smem, s>>>(
        x, (const float*)w, (const float*)b, (const float*)y,
        (const float*)sw, n, d, arm == kTileSmem, (float*)gw_part,
        (float*)gs_part, (unsigned*)counter, (float*)gw, (float*)gs);
  return (int)cudaGetLastError();
}

}  // extern "C"
