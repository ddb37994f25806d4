// K6: fused SMACOF distance + B(X)·X row block for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/wdamds_kernel.py::smacof_bx (Pallas body _kernel).
// For each local row i (Xl_i, row mask rm_i) against every column j < N of
// the replicated coordinates X:
//   D_ij = sqrt(max(|Xl_i|^2 - 2 Xl_i.X_j + |X_j|^2, 0)),
//   r_ij = (D_ij > eps ? delta_ij / max(D_ij, eps) : 0) * rm_i * [j < n_real],
//   out_i = (-sum_j r_ij X_j + (sum_j r_ij) Xl_i) / max(n_real, 1).
// D and r never leave registers.  A bf16 delta is promoted to f32 on load.
// The ratio is taken as delta * rsqrt(D^2) with the guard on D^2 > eps^2
// (within 2 ulp of delta / D), and rm_i multiplies the row's sums once.
//
// Bound on this card: memory.  At N = n_loc = 4096, dim 3 it must read delta
// once (67.1 MB f32, 33.6 MB bf16): 0.020 / 0.010 ms at 3.35 TB/s; the ~20
// f32 operations, one sqrt and one division per pair (16.8M pairs) take
// 0.005 ms on the CUDA cores and 0.002 ms on the special-function units.
//
// Design:
//  - At dim 3 a tensor-core tile would be 97 % padding, so the CUDA cores do
//    the arithmetic.  A persistent grid of one 16-warp block an SM stages X
//    once as records (X_j, |X_j|^2, padded to 16, 32 or 48 bytes) in shared
//    memory, swizzled so that a warp's reads spread over the banks - all
//    of it when the records fit the chunk (N = 4096 at dim 3 is 64 KB),
//    else the columns are walked in chunks - and then takes row tiles.
//  - A tile is 8 row-warps x kRows rows (4 at dim <= 3, 2 at dim 4-6, 1
//    above, so that a thread's sums stay in its registers), and its
//    columns are split between two halves of the block.  A lane streams
//    its rows' delta with one 16-byte load a row (4 f32 or 8 bf16 columns)
//    and loads the next block of columns while it computes this one, so
//    about 64 KB of delta is in flight an SM; each staged record serves
//    kRows pairs.  Rows whose delta is not 16-byte aligned (N not a
//    multiple of the load, or an unaligned base) take element loads of the
//    same columns.
//  - Each lane sums its columns in order, a fixed xor-shuffle tree reduces
//    the lanes and the two halves are added in a fixed order, so reruns are
//    bit-equal (no atomics).
//  - Any N and n_loc; dim 1 to kMaxDim (one instantiation each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWarps = kWarps / 2;  // warps of a column half
constexpr int kMaxDim = 8;
constexpr int kChunkBytes = 128 * 1024;

template <int DIM>
struct Shape {
  static constexpr int kRows = DIM <= 3 ? 4 : DIM <= 6 ? 2 : 1;  // rows a warp
  static constexpr int kTileRows = kRowWarps * kRows;   // rows a tile
  static constexpr int kRec = (DIM + 1 + 3) / 4 * 4;    // floats a record
};

__host__ __device__ inline int rec_floats(int dim) { return (dim + 1 + 3) / 4 * 4; }

int tile_rows(int dim) {
  return kRowWarps * (dim <= 3 ? 4 : dim <= 6 ? 2 : 1);
}

// columns a chunk of staged records: all N, or a multiple of 256 (one
// column block of bf16 loads) that fits kChunkBytes
int chunk_cols(int N, int dim) {
  const int cap = kChunkBytes / (rec_floats(dim) * (int)sizeof(float));
  return N <= cap ? N : cap / 256 * 256;
}

// the records' floats, in whole 128-byte groups of eight 16-byte units
// (the swizzle permutes units inside a group)
__host__ __device__ inline long rec_region(int ch, int dim) {
  return ((long)ch * rec_floats(dim) / 4 + 7) / 8 * 8 * 4;
}

size_t smem_bytes(int ch, int dim) {
  return (size_t)rec_region(ch, dim) * sizeof(float) +
         (size_t)2 * tile_rows(dim) * (kMaxDim + 1) * sizeof(float);
}

// Where 16-byte unit a of the records sits: its slot in its 128-byte group
// xor-ed with the group's index, so that the eight lanes of a quarter-warp,
// whose columns are 4 (f32) or 8 (bf16) records apart, read eight
// different groups of banks.
__device__ __forceinline__ int swz(int a) { return a ^ ((a >> 3) & 7); }

// One 16-byte load of delta: kE consecutive columns of a row, as f32.
template <bool kBf16>
struct Delta {
  static constexpr int kE = kBf16 ? 8 : 4;
  uint4 raw;

  template <bool kVec>
  __device__ __forceinline__ void load(const void* base, long at, int left) {
    if (kVec) {
      raw = __ldcs(reinterpret_cast<const uint4*>(
          static_cast<const char*>(base) + at * (kBf16 ? 2 : 4)));
    } else {  // element loads of the same columns (left: columns in range)
      unsigned v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        if (e < left) {
          unsigned x;
          if (kBf16)
            x = __ldcs(static_cast<const unsigned short*>(base) + at + e);
          else
            x = __float_as_uint(__ldcs(static_cast<const float*>(base) + at + e));
          if (kBf16)
            v[e / 2] |= x << (16 * (e % 2));
          else
            v[e] = x;
        }
      }
      raw = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }

  __device__ __forceinline__ float get(int e) const {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    if (kBf16) return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
    return __uint_as_float(w[e]);
  }
};

template <int DIM, bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
bx_kernel(const void* __restrict__ delta, const float* __restrict__ rm,
          const float* __restrict__ Xl, const float* __restrict__ X,
          int n_loc, int N, int ch, float nr, float eps2,
          float* __restrict__ out) {
  using Sh = Shape<DIM>;
  constexpr int kRows = Sh::kRows, kRec = Sh::kRec;
  constexpr int kE = Delta<kBf16>::kE;
  constexpr int kBlockCols = 32 * kE;  // columns of one warp step
  extern __shared__ __align__(16) float smem[];
  float4* recs = reinterpret_cast<float4*>(smem);      // [ch, kRec] swizzled
  float* part = smem + rec_region(ch, DIM);             // [2, tile, DIM+1]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int half = warp / kRowWarps, rw = warp % kRowWarps;
  const int ntiles = (n_loc + Sh::kTileRows - 1) / Sh::kTileRows;
  const int nchunks = (N + ch - 1) / ch;
  const float denom = fmaxf(nr, 1.f);
  bool staged = false;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int row[kRows];
    float xi[kRows][DIM], x2[kRows], rs[kRows], bx[kRows][DIM];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      row[q] = tile * Sh::kTileRows + rw * kRows + q;
      const bool ok = row[q] < n_loc;
      x2[q] = 0.f;
      rs[q] = 0.f;
#pragma unroll
      for (int k = 0; k < DIM; ++k) {
        xi[q][k] = ok ? Xl[(long)row[q] * DIM + k] : 0.f;
        x2[q] += xi[q][k] * xi[q][k];
        bx[q][k] = 0.f;
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * ch, cols = min(ch, N - c0);
      const int nblk = (cols + kBlockCols - 1) / kBlockCols;
      Delta<kBf16> cur[kRows], nxt[kRows];
      auto load = [&](Delta<kBf16>* d, int blk) {
        const int col = c0 + blk * kBlockCols + lane * kE;
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          d[q].raw = make_uint4(0, 0, 0, 0);
          if (row[q] < n_loc && col < c0 + cols)
            d[q].template load<kVec>(delta, (long)row[q] * N + col,
                                     c0 + cols - col);
        }
      };
      if (half < nblk) load(cur, half);  // flies while X is staged
      if (nchunks > 1 || !staged) {      // uniform over the block
        __syncthreads();
        for (int j = t; j < cols; j += kThreads) {
          float v[kRec];
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < kRec; ++k) v[k] = 0.f;
#pragma unroll
          for (int k = 0; k < DIM; ++k) {
            v[k] = X[(long)(c0 + j) * DIM + k];
            s += v[k] * v[k];
          }
          v[DIM] = s;
#pragma unroll
          for (int k = 0; k < kRec; k += 4)
            recs[swz(j * (kRec / 4) + k / 4)] =
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
        }
        __syncthreads();
        staged = true;
      }
      for (int blk = half; blk < nblk; blk += 2) {
        if (blk + 2 < nblk) load(nxt, blk + 2);
        const int col = blk * kBlockCols + lane * kE;  // within the chunk
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          if (col + e < cols) {
            float y[kRec];
#pragma unroll
            for (int k = 0; k < kRec; k += 4) {
              const float4 r4 = recs[swz((col + e) * (kRec / 4) + k / 4)];
              y[k] = r4.x;
              y[k + 1] = r4.y;
              y[k + 2] = r4.z;
              y[k + 3] = r4.w;
            }
            const bool live = (float)(c0 + col + e) < nr;
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
              float cross = 0.f;
#pragma unroll
              for (int k = 0; k < DIM; ++k) cross += xi[q][k] * y[k];
              const float d2 = fmaxf(x2[q] - 2.f * cross + y[DIM], 0.f);
              const float r =
                  (live && d2 > eps2) ? cur[q].get(e) * rsqrtf(d2) : 0.f;
              rs[q] += r;
#pragma unroll
              for (int k = 0; k < DIM; ++k) bx[q][k] += r * y[k];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) cur[q] = nxt[q];
      }
    }
    // lanes -> lane 0 by a fixed xor tree; halves -> out in a fixed order
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], off);
#pragma unroll
        for (int k = 0; k < DIM; ++k)
          bx[q][k] += __shfl_xor_sync(0xffffffffu, bx[q][k], off);
      }
      if (lane == 0) {
        float* pr = part + ((long)half * Sh::kTileRows + rw * kRows + q) * (DIM + 1);
        pr[0] = rs[q];
#pragma unroll
        for (int k = 0; k < DIM; ++k) pr[1 + k] = bx[q][k];
      }
    }
    __syncthreads();
    if (t < Sh::kTileRows) {
      const int i = tile * Sh::kTileRows + t;
      if (i < n_loc) {
        const float* p0 = part + (long)t * (DIM + 1);
        const float* p1 = part + (long)(Sh::kTileRows + t) * (DIM + 1);
        const float m = rm[i], s = p0[0] + p1[0];
#pragma unroll
        for (int k = 0; k < DIM; ++k)
          out[(long)i * DIM + k] = __fdiv_rn(
              m * (-(p0[1 + k] + p1[1 + k]) + s * Xl[(long)i * DIM + k]), denom);
      }
    }
    __syncthreads();  // part is rewritten by the next tile
  }
}

template <int DIM, bool kBf16, bool kVec>
cudaError_t launch_one(const void* delta, const float* rm, const float* Xl,
                       const float* X, int n_loc, int N, int ch, float nr,
                       float eps2, int grid, float* out, cudaStream_t s) {
  bx_kernel<DIM, kBf16, kVec><<<grid, kThreads, smem_bytes(ch, DIM), s>>>(
      delta, rm, Xl, X, n_loc, N, ch, nr, eps2, out);
  return cudaGetLastError();
}

template <int DIM>
cudaError_t launch_dim(const void* delta, bool bf16, bool vec, const float* rm,
                       const float* Xl, const float* X, int n_loc, int N,
                       int ch, float nr, float eps2, int grid, float* out,
                       cudaStream_t s) {
  if (bf16)
    return vec ? launch_one<DIM, true, true>(delta, rm, Xl, X, n_loc, N, ch, nr, eps2, grid, out, s)
               : launch_one<DIM, true, false>(delta, rm, Xl, X, n_loc, N, ch, nr, eps2, grid, out, s);
  return vec ? launch_one<DIM, false, true>(delta, rm, Xl, X, n_loc, N, ch, nr, eps2, grid, out, s)
             : launch_one<DIM, false, false>(delta, rm, Xl, X, n_loc, N, ch, nr, eps2, grid, out, s);
}

template <int DIM>
cudaError_t allow_dim(int optin) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bx_kernel<DIM, false, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bx_kernel<DIM, false, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bx_kernel<DIM, true, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  return cudaFuncSetAttribute(bx_kernel<DIM, true, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

cudaError_t allow(int dim, int optin) {
  switch (dim) {
    case 1: return allow_dim<1>(optin);
    case 2: return allow_dim<2>(optin);
    case 3: return allow_dim<3>(optin);
    case 4: return allow_dim<4>(optin);
    case 5: return allow_dim<5>(optin);
    case 6: return allow_dim<6>(optin);
    case 7: return allow_dim<7>(optin);
    default: return allow_dim<8>(optin);
  }
}

}  // namespace

extern "C" {

// Once per card and shape (the wrapper keeps the answer): lets the dim's
// instantiations take the card's opt-in shared memory (the kernel has no
// static part; the whole limit, so a plan for one shape never caps
// another), and returns the columns a chunk of X holds (*ch) and the number
// of blocks (*grid): one an SM, at most one per row tile.
int wdamds_smacof_bx_plan(int n_loc, int N, int dim, int* grid, int* ch) {
  if (dim < 1 || dim > kMaxDim || n_loc < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow(dim, optin)) != cudaSuccess) return (int)err;
  *ch = chunk_cols(N, dim);
  if (smem_bytes(*ch, dim) > (size_t)optin)
    return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (n_loc + tile_rows(dim) - 1) / tile_rows(dim);
  *grid = ntiles < sms ? ntiles : sms;
  return 0;
}

// delta: [n_loc, N] f32 (delta_bf16 = 0) or bf16 (1); rm [n_loc], Xl
// [n_loc, dim], X [N, dim] f32; out [n_loc, dim] f32 is written.  grid and
// ch come from wdamds_smacof_bx_plan(n_loc, N, dim) on this card.  Rows
// take 16-byte loads when N is a multiple of the load (4 f32, 8 bf16) and
// delta is 16-byte aligned.  Returns cudaGetLastError() after the launch
// (0 on success).
int wdamds_smacof_bx(const void* delta, int delta_bf16, const void* rm,
                     const void* Xl, const void* X, int n_loc, int N, int dim,
                     float n_real, float eps, int grid, int ch, void* out,
                     void* stream) {
  if (dim < 1 || dim > kMaxDim || n_loc < 1 || N < 1 || grid < 1 || ch < 1 ||
      (ch < N && ch % 256))
    return (int)cudaErrorInvalidValue;
  const bool vec = N % (delta_bf16 ? 8 : 4) == 0 && (uintptr_t)delta % 16 == 0;
  const float eps2 = eps * eps;
  const float* r = (const float*)rm;
  const float* xl = (const float*)Xl;
  const float* x = (const float*)X;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dim) {
    case 1: return (int)launch_dim<1>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 2: return (int)launch_dim<2>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 3: return (int)launch_dim<3>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 4: return (int)launch_dim<4>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 5: return (int)launch_dim<5>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 6: return (int)launch_dim<6>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    case 7: return (int)launch_dim<7>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
    default: return (int)launch_dim<8>(delta, delta_bf16, vec, r, xl, x, n_loc, N, ch, n_real, eps2, grid, o, s);
  }
}

}  // extern "C"
