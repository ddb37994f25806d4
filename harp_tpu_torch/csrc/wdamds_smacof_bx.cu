// K6: fused SMACOF distance + B(X)·X row block for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/wdamds_kernel.py::smacof_bx (Pallas body _kernel).
// For each local row i (Xl_i, row mask rm_i) against every column j < N of
// the replicated coordinates X:
//   D_ij = sqrt(max(|Xl_i|^2 - 2 Xl_i.X_j + |X_j|^2, 0)),
//   r_ij = (D_ij > eps ? delta_ij / max(D_ij, eps) : 0) * rm_i * [j < n_real],
//   out_i = (-sum_j r_ij X_j + (sum_j r_ij) Xl_i) / max(n_real, 1).
// D and r never leave registers.  A bf16 delta is promoted to f32 on load.
//
// Bound on this card: memory.  At N = n_loc = 4096, dim 3 it must read delta
// once (67.1 MB f32, 33.6 MB bf16): 0.020 / 0.010 ms at 3.35 TB/s; the ~20
// f32 operations, one sqrt and one division per pair (16.8M pairs) take
// 0.005 ms on the CUDA cores and 0.002 ms on the special-function units.
//
// Design:
//  - At dim 3 a tensor-core tile would be 97 % padding, so the CUDA cores do
//    the arithmetic.  A block stages a chunk of X (and |X_j|^2) in shared
//    memory - all of it when (dim + 1) * N floats fit the chunk (N = 4096 at
//    dim 3 is 64 KB), else the columns are walked in chunks.
//  - A block owns tiles of kTileRows rows; each warp keeps kRowsPerWarp rows
//    in registers and its lanes stride the columns (delta loads coalesce).
//    Each lane sums its columns in order, and a fixed xor-shuffle tree
//    reduces the lanes, so reruns are bit-equal (no atomics).
//  - Any N and n_loc; dim up to kMaxDim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kTileRows = kWarps * kRowsPerWarp;
constexpr int kMaxDim = 8;
constexpr int kChunkBytes = 96 * 1024;

template <bool kBf16>
__device__ __forceinline__ float load_delta(const void* p, long i) {
  if (kBf16)
    return __uint_as_float((unsigned)static_cast<const uint16_t*>(p)[i] << 16);
  return static_cast<const float*>(p)[i];
}

int chunk_cols(int N, int dim) {
  const int cap = kChunkBytes / ((dim + 1) * (int)sizeof(float));
  return N < cap ? N : cap;
}

size_t smem_bytes(int ch, int dim) {
  return (size_t)ch * (dim + 1) * sizeof(float);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
bx_kernel(const void* __restrict__ delta, const float* __restrict__ rm,
          const float* __restrict__ Xl, const float* __restrict__ X,
          int n_loc, int N, int dim, int ch, float nr, float eps,
          float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [ch, dim]
  float* y2s = smem + ch * dim;  // [ch]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ntiles = (n_loc + kTileRows - 1) / kTileRows;
  const int nchunks = (N + ch - 1) / ch;
  const float denom = fmaxf(nr, 1.f);
  bool staged = false;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int row[kRowsPerWarp];
    float xi[kRowsPerWarp][kMaxDim], x2[kRowsPerWarp], rmask[kRowsPerWarp];
    float rs[kRowsPerWarp], bx[kRowsPerWarp][kMaxDim];
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
      row[q] = tile * kTileRows + warp * kRowsPerWarp + q;
      const bool ok = row[q] < n_loc;
      x2[q] = 0.f;
      rs[q] = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k) {
        xi[q][k] = (ok && k < dim) ? Xl[(long)row[q] * dim + k] : 0.f;
        x2[q] += xi[q][k] * xi[q][k];
        bx[q][k] = 0.f;
      }
      rmask[q] = ok ? rm[row[q]] : 0.f;
    }
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * ch;
      const int cols = min(ch, N - c0);
      if (nchunks > 1 || !staged) {  // uniform over the block
        __syncthreads();
        for (int j = t; j < cols; j += kThreads) {
          float s = 0.f;
          for (int k = 0; k < dim; ++k) {
            const float v = X[(long)(c0 + j) * dim + k];
            xs[j * dim + k] = v;
            s += v * v;
          }
          y2s[j] = s;
        }
        __syncthreads();
        staged = true;
      }
#pragma unroll 2
      for (int j = lane; j < cols; j += 32) {
        float yj[kMaxDim];
#pragma unroll
        for (int k = 0; k < kMaxDim; ++k) yj[k] = k < dim ? xs[j * dim + k] : 0.f;
        const float y2 = y2s[j];
        const float colm = (float)(c0 + j) < nr ? 1.f : 0.f;
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q) {
          if (row[q] >= n_loc) continue;
          float cross = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k) cross += xi[q][k] * yj[k];
          const float D = sqrtf(fmaxf(x2[q] - 2.f * cross + y2, 0.f));
          const float dl = load_delta<kBf16>(delta, (long)row[q] * N + c0 + j);
          float r = D > eps ? __fdiv_rn(dl, fmaxf(D, eps)) : 0.f;
          r = r * rmask[q] * colm;
          rs[q] += r;
#pragma unroll
          for (int k = 0; k < kMaxDim; ++k) bx[q][k] += r * yj[k];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsPerWarp; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], off);
#pragma unroll
        for (int k = 0; k < kMaxDim; ++k)
          bx[q][k] += __shfl_xor_sync(0xffffffffu, bx[q][k], off);
      }
      if (lane == 0 && row[q] < n_loc) {
#pragma unroll
        for (int k = 0; k < kMaxDim; ++k)  // unrolled: the arrays stay in registers
          if (k < dim)
            out[(long)row[q] * dim + k] =
                __fdiv_rn(-bx[q][k] + rs[q] * xi[q][k], denom);
      }
    }
  }
}

}  // namespace

extern "C" {

// Once per card and shape (the wrapper keeps the answer): lets both
// instantiations take the card's opt-in shared memory (the kernel has no
// static part; the whole limit, so a plan for one shape never caps
// another), and returns the columns a chunk of X holds (*ch) and the number
// of blocks (*grid): enough to fill the card, at most one per row tile.
int wdamds_smacof_bx_plan(int n_loc, int N, int dim, int* grid, int* ch) {
  if (dim < 1 || dim > kMaxDim || n_loc < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  int dev, optin, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bx_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bx_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  *ch = chunk_cols(N, dim);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bx_kernel<false>, kThreads, smem_bytes(*ch, dim));
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (n_loc + kTileRows - 1) / kTileRows;
  const int cap = sms * per_sm;
  *grid = ntiles < cap ? ntiles : cap;
  return 0;
}

// delta: [n_loc, N] f32 (delta_bf16 = 0) or bf16 (1); rm [n_loc], Xl
// [n_loc, dim], X [N, dim] f32; out [n_loc, dim] f32 is written.  grid and
// ch come from wdamds_smacof_bx_plan(n_loc, N, dim) on this card.  Returns
// cudaGetLastError() after the launch (0 on success).
int wdamds_smacof_bx(const void* delta, int delta_bf16, const void* rm,
                     const void* Xl, const void* X, int n_loc, int N, int dim,
                     float n_real, float eps, int grid, int ch, void* out,
                     void* stream) {
  if (dim < 1 || dim > kMaxDim || n_loc < 1 || N < 1 || grid < 1 || ch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ch, dim);
  cudaStream_t s = (cudaStream_t)stream;
  if (delta_bf16)
    bx_kernel<true><<<grid, kThreads, smem, s>>>(
        delta, (const float*)rm, (const float*)Xl, (const float*)X, n_loc, N,
        dim, ch, n_real, eps, (float*)out);
  else
    bx_kernel<false><<<grid, kThreads, smem, s>>>(
        delta, (const float*)rm, (const float*)Xl, (const float*)X, n_loc, N,
        dim, ch, n_real, eps, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
