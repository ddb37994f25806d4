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
// Design:
//  - A block owns tiles of kTileN rows (grid-stride).  Phase A: each warp
//    takes a row, its lanes stride the columns (coalesced), the dot is
//    reduced by a fixed xor-shuffle tree and lane 0 writes coef to shared
//    memory.  Phase B: thread j owns columns j, j + 256, ... and adds the
//    tile's rows in row order (the tile was just read, so from L1/L2) into
//    the block's accumulator row.  w and the accumulator live in shared
//    memory when 2*d floats fit, else w is read from global memory and the
//    accumulator is the block's own row of the [grid, d] workspace.
//  - No float atomics: every block writes its gw row and its gs partial, and
//    a second kernel adds them in block order, so reruns are bit-equal.
//  - Any n and d: the ragged tile is masked; there is no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float load_x(const void* x, long i) {
  if (kBf16)
    return __uint_as_float((unsigned)static_cast<const uint16_t*>(x)[i] << 16);
  return static_cast<const float*>(x)[i];
}

size_t smem_bytes(int d, bool in_smem) {
  return (size_t)(kTileN + (in_smem ? 2 * (size_t)d : 0)) * sizeof(float);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const void* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, const float* __restrict__ y,
            const float* __restrict__ sw, int n, int d, bool in_smem,
            float* __restrict__ gw_part, float* __restrict__ gs_part) {
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
    __syncthreads();  // w_s ready; the previous tile's phase B is done
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
  if (in_smem)
    for (int j = t; j < d; j += kThreads)
      gw_part[(long)blockIdx.x * d + j] = acc[j];
  if (t == 0) gs_part[blockIdx.x] = gs;
}

// gw[j] = sum over blocks, in order, of gw_part[b][j]; thread d does gs.
__global__ void reduce_kernel(const float* __restrict__ gw_part,
                              const float* __restrict__ gs_part, int grid,
                              int d, float* __restrict__ gw,
                              float* __restrict__ gs) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d) {
    float s = 0.f;
    for (int blk = 0; blk < grid; ++blk) s += gw_part[(long)blk * d + i];
    gw[i] = s;
  } else if (i == d) {
    float s = 0.f;
    for (int blk = 0; blk < grid; ++blk) s += gs_part[blk];
    *gs = s;
  }
}

}  // namespace

extern "C" {

// Once per card and shape (the wrapper keeps the answer): lets both
// instantiations take the card's opt-in shared memory (the kernel has no
// static part; the whole limit, so a plan for one d never caps another),
// and returns the number of blocks for (n, d) - enough to fill the card, at
// most one per tile - and whether w and the accumulator fit in shared
// memory.  The caller sizes the [grid, d] and [grid] workspaces with *grid.
int svm_pegasos_grad_plan(int n, int d, int* grid, int* in_smem) {
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  *in_smem = smem_bytes(d, true) <= (size_t)optin;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grad_kernel<false>, kThreads, smem_bytes(d, *in_smem));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long ntiles = ((long)n + kTileN - 1) / kTileN;
  const long cap = (long)sms * per_sm;
  *grid = (int)(ntiles < cap ? ntiles : cap);
  if (*grid < 1) *grid = 1;
  return 0;
}

// x: [n, d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w [d], b [1], y [n],
// sw [n] f32.  grid and in_smem come from svm_pegasos_grad_plan(n, d) on
// this card.  gw_part holds grid * d floats and gs_part grid floats (no
// initialisation needed); gw [d] and gs [1] are written.  Returns
// cudaGetLastError() after the launches (0 on success).
int svm_pegasos_grad(const void* x, int x_bf16, const void* w, const void* b,
                     const void* y, const void* sw, int n, int d,
                     void* gw_part, void* gs_part, void* gw, void* gs,
                     int grid, int in_smem, void* stream) {
  const size_t smem = smem_bytes(d, in_smem);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    grad_kernel<true><<<grid, kThreads, smem, s>>>(
        x, (const float*)w, (const float*)b, (const float*)y,
        (const float*)sw, n, d, in_smem, (float*)gw_part, (float*)gs_part);
  else
    grad_kernel<false><<<grid, kThreads, smem, s>>>(
        x, (const float*)w, (const float*)b, (const float*)y,
        (const float*)sw, n, d, in_smem, (float*)gw_part, (float*)gs_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((d + 1 + 255) / 256), 256, 0, s>>>(
      (const float*)gw_part, (const float*)gs_part, grid, d, (float*)gw,
      (float*)gs);
  return (int)cudaGetLastError();
}

}  // extern "C"
