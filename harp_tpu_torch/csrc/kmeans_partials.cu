// K2: fused f32 KMeans partials for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/kmeans_kernel.py::kmeans_partials (Pallas body
// _kernel).  One pass over points [n, d] (f32 or bf16) that reproduces the
// TPU kernel's numerics: points and centroids are rounded to bf16 for the
// dot, c2 comes from the bf16-rounded centroids (the wrapper passes both),
// score = c2 - 2 * dot, argmin with the lowest index winning ties, one-hot
// sums of the bf16-rounded points, counts, and inertia = sum |x|^2 (from the
// full-precision points) + sum of best scores.  bf16 x bf16 products are
// exact in f32, so the kernel differs from its plain version only in the
// order of f32 additions.
//
// Bound on this card: memory.  At 1M x 300, k = 100 it must read 1.2 GB of
// f32 points (about 360 us at 3.35 TB/s); the 2*n*k*d = 6e10 bf16 operations
// take about 60 us at the bf16 tensor-core rate.  This first kernel does its
// dots as f32 FMAs on the CUDA cores (67 TFLOP/s), which puts its floor near
// 0.9 ms: moving the dot onto the tensor cores is later work.
//
// Design:
//  - As K1: a block owns tiles of kTileN points (grid-stride); 256 threads
//    are kTileN points x kGroups centroid groups; each thread keeps 8 dot
//    products against a tile of kTileK centroids, the tiles looping over
//    any k.  The tile's points are rounded to bf16 as they are loaded and
//    kept in shared memory as bf16 pairs with an odd word stride; the
//    centroid tile is stored [feature][centroid] in f32 and read as float4
//    broadcasts.  Sum of |x|^2 is taken from the f32 values during the load.
//  - Running (best, index) per thread, replaced only on a strictly smaller
//    score; groups merged with index order on ties.
//  - Deterministic sums: each thread owns columns of d and adds the tile's
//    rows, in row order, into the block's f32 accumulator - in shared
//    memory when k*d fits (k = 100 at d = 300), else in the block's own
//    slab of a global [grid, k, d] workspace.  No float atomics: a second
//    kernel adds the slabs in block order.  Counts are int32 atomics (exact).
//    Each block writes one inertia partial (its tiles in a fixed order);
//    the wrapper sums them in a fixed order.  Reruns on one card are
//    bit-identical.
//  - Any n (ragged tile masked), any k (centroid tiles loop).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;
constexpr int kGroups = kThreads / kTileN;
constexpr int kPerThread = 8;
constexpr int kTileK = kGroups * kPerThread;

struct Layout {
  int dh;  // bf16 pairs per row: ceil(d / 2)
  int ds;  // shared row stride in 32-bit words: dh rounded up to odd
  size_t off_cen, off_c2, off_best, off_bidx, off_assign, off_bestv, off_x2,
      off_counts, off_acc, bytes_no_acc, bytes_acc;
};

__host__ __device__ Layout make_layout(int d, int k) {
  Layout L;
  L.dh = (d + 1) / 2;
  L.ds = L.dh | 1;
  size_t o = (size_t)kTileN * L.ds * 4;  // multiple of 16 bytes
  L.off_cen = o;     o += (size_t)2 * L.dh * kTileK * 4;
  L.off_c2 = o;      o += kTileK * 4;
  L.off_best = o;    o += kGroups * kTileN * 4;
  L.off_bidx = o;    o += kGroups * kTileN * 4;
  L.off_assign = o;  o += kTileN * 4;
  L.off_bestv = o;   o += kTileN * 4;
  L.off_x2 = o;      o += kThreads * 4;
  L.off_counts = o;  o += (size_t)k * 4;
  L.off_acc = o;
  L.bytes_no_acc = o;
  L.bytes_acc = o + (size_t)k * d * 4;
  return L;
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
partials_kernel(const void* __restrict__ pts_v, bool pts_bf16,
                const float* __restrict__ cen, const float* __restrict__ c2,
                int n, int d, int k, bool acc_in_smem,
                float* __restrict__ slabs, int* __restrict__ counts,
                float* __restrict__ inertia_partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(d, k);
  unsigned* pts_s = reinterpret_cast<unsigned*>(smem);
  float* cen_s = reinterpret_cast<float*>(smem + L.off_cen);
  float* c2_s = reinterpret_cast<float*>(smem + L.off_c2);
  float* best_s = reinterpret_cast<float*>(smem + L.off_best);
  int* bidx_s = reinterpret_cast<int*>(smem + L.off_bidx);
  int* assign_s = reinterpret_cast<int*>(smem + L.off_assign);
  float* bestv_s = reinterpret_cast<float*>(smem + L.off_bestv);
  float* x2_s = reinterpret_cast<float*>(smem + L.off_x2);
  int* counts_s = reinterpret_cast<int*>(smem + L.off_counts);
  float* acc = acc_in_smem ? reinterpret_cast<float*>(smem + L.off_acc)
                           : slabs + (long)blockIdx.x * k * d;
  const float* pts_f = static_cast<const float*>(pts_v);
  const uint16_t* pts_h = static_cast<const uint16_t*>(pts_v);

  const int t = threadIdx.x;
  const int p = t % kTileN;
  const int g = t / kTileN;
  for (int i = t; i < k; i += kThreads) counts_s[i] = 0;
  for (long i = t; i < (long)k * d; i += kThreads) acc[i] = 0.f;

  float x2 = 0.f;        // this thread's share of sum |x|^2
  float blk_best = 0.f;  // only thread 0's copy is used
  const int ntiles = (n + kTileN - 1) / kTileN;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTileN;
    const int rows = (int)min((long)kTileN, (long)n - row0);
    __syncthreads();
    for (int i = t; i < kTileN * L.dh; i += kThreads) {
      const int r = i / L.dh, w = i % L.dh;
      unsigned word = 0;
      if (r < rows) {
        const long base = (row0 + r) * d + 2 * w;
        const bool two = 2 * w + 1 < d;
        if (pts_bf16) {
          const unsigned lo = pts_h[base], hi = two ? pts_h[base + 1] : 0u;
          word = lo | (hi << 16);
          const float a = bf16_lo(word), b = bf16_hi(word);
          x2 += a * a + b * b;
        } else {
          const float a = pts_f[base], b = two ? pts_f[base + 1] : 0.f;
          x2 += a * a + b * b;
          word = bf16_bits(a) | (bf16_bits(b) << 16);
        }
      }
      pts_s[r * L.ds + w] = word;
    }

    float best = __int_as_float(0x7f800000);  // +inf
    int bi = -1;  // no centroid seen yet: the first one is taken even at +inf
    for (int c0 = 0; c0 < k; c0 += kTileK) {
      __syncthreads();
      for (int i = t; i < kTileK * 2 * L.dh; i += kThreads) {
        const int c = i / (2 * L.dh), f = i % (2 * L.dh);
        cen_s[f * kTileK + c] =
            (c0 + c < k && f < d) ? cen[(long)(c0 + c) * d + f] : 0.f;
      }
      if (t < kTileK) c2_s[t] = c0 + t < k ? c2[c0 + t] : 0.f;
      __syncthreads();

      float dot[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) dot[j] = 0.f;
      const unsigned* prow = pts_s + p * L.ds;
      const float4* cvec = reinterpret_cast<const float4*>(cen_s) + g * 2;
      for (int w = 0; w < L.dh; ++w) {
        const unsigned word = prow[w];
        const float a0 = bf16_lo(word), a1 = bf16_hi(word);
        const float4 lo0 = cvec[(2 * w) * (kTileK / 4)];
        const float4 hi0 = cvec[(2 * w) * (kTileK / 4) + 1];
        const float4 lo1 = cvec[(2 * w + 1) * (kTileK / 4)];
        const float4 hi1 = cvec[(2 * w + 1) * (kTileK / 4) + 1];
        dot[0] = fmaf(a0, lo0.x, dot[0]); dot[0] = fmaf(a1, lo1.x, dot[0]);
        dot[1] = fmaf(a0, lo0.y, dot[1]); dot[1] = fmaf(a1, lo1.y, dot[1]);
        dot[2] = fmaf(a0, lo0.z, dot[2]); dot[2] = fmaf(a1, lo1.z, dot[2]);
        dot[3] = fmaf(a0, lo0.w, dot[3]); dot[3] = fmaf(a1, lo1.w, dot[3]);
        dot[4] = fmaf(a0, hi0.x, dot[4]); dot[4] = fmaf(a1, hi1.x, dot[4]);
        dot[5] = fmaf(a0, hi0.y, dot[5]); dot[5] = fmaf(a1, hi1.y, dot[5]);
        dot[6] = fmaf(a0, hi0.z, dot[6]); dot[6] = fmaf(a1, hi1.z, dot[6]);
        dot[7] = fmaf(a0, hi0.w, dot[7]); dot[7] = fmaf(a1, hi1.w, dot[7]);
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int cl = g * kPerThread + j;
        if (c0 + cl < k) {
          // 2 * dot is exact, so an FMA here rounds exactly as c2 - 2*dot
          const float s = c2_s[cl] - 2.f * dot[j];
          if (s < best || bi < 0) {
            best = s;
            bi = c0 + cl;
          }
        }
      }
    }
    best_s[g * kTileN + p] = best;
    bidx_s[g * kTileN + p] = bi;
    __syncthreads();
    if (t < kTileN) {
      float b = best_s[t];
      int bidx = bidx_s[t];
      for (int gg = 1; gg < kGroups; ++gg) {
        const float s = best_s[gg * kTileN + t];
        const int i = bidx_s[gg * kTileN + t];
        // a group with no centroid below k holds i = -1 and is skipped;
        // group 0 always holds centroid 0
        if (i >= 0 && (s < b || (s == b && i < bidx))) {
          b = s;
          bidx = i;
        }
      }
      const bool valid = t < rows;
      assign_s[t] = valid ? bidx : -1;
      bestv_s[t] = valid ? b : 0.f;
      if (valid) atomicAdd(&counts_s[bidx], 1);
    }
    __syncthreads();
    if (t == 0)
      for (int r = 0; r < rows; ++r) blk_best += bestv_s[r];
    for (int j = t; j < d; j += kThreads) {
      for (int r = 0; r < rows; ++r) {
        const unsigned word = pts_s[r * L.ds + j / 2];
        const float v = (j & 1) ? bf16_hi(word) : bf16_lo(word);
        acc[(long)assign_s[r] * d + j] += v;  // column j is this thread's alone
      }
    }
  }
  x2_s[t] = x2;
  __syncthreads();
  if (acc_in_smem)
    for (long i = t; i < (long)k * d; i += kThreads)
      slabs[(long)blockIdx.x * k * d + i] = acc[i];
  for (int i = t; i < k; i += kThreads)
    if (counts_s[i]) atomicAdd(&counts[i], counts_s[i]);
  if (t == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s += x2_s[i];
    inertia_partial[blockIdx.x] = s + blk_best;
  }
}

// sums[i] = sum over blocks b, in order, of slabs[b][i].
__global__ void reduce_slabs_kernel(const float* __restrict__ slabs, int grid,
                                    long kd, float* __restrict__ sums) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kd) return;
  float s = 0.f;
  for (int b = 0; b < grid; ++b) s += slabs[(long)b * kd + i];
  sums[i] = s;
}

cudaError_t plan(int d, int k, size_t* smem, bool* acc_in_smem) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const Layout L = make_layout(d, k);
  *acc_in_smem = L.bytes_acc <= (size_t)optin;
  *smem = *acc_in_smem ? L.bytes_acc : L.bytes_no_acc;
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(partials_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

// Number of blocks for (n, d, k): enough to fill the card once, at most one
// per tile.  The caller sizes the [grid, k, d] slabs and the inertia
// partials with it.
int kmeans_partials_grid(int n, int d, int k, int* grid) {
  size_t smem;
  bool acc_in_smem;
  cudaError_t err = plan(d, k, &smem, &acc_in_smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, partials_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (n + kTileN - 1) / kTileN;
  *grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  if (*grid < 1) *grid = 1;
  return 0;
}

// pts: [n, d] f32 (pts_bf16 = 0) or bf16 (pts_bf16 = 1); cen: [k, d] f32
// holding bf16-rounded values; c2: [k] f32 from those.  slabs holds
// grid * k * d floats (no initialisation needed); counts [k] int32 must be
// zeroed; inertia_partial holds `grid` floats; sums [k, d] f32 is written.
// Returns cudaGetLastError() after the launches (0 on success).
int kmeans_partials(const void* pts, int pts_bf16, const void* cen,
                    const void* c2, int n, int d, int k, void* slabs,
                    void* counts, void* inertia_partial, void* sums, int grid,
                    void* stream) {
  size_t smem;
  bool acc_in_smem;
  cudaError_t err = plan(d, k, &smem, &acc_in_smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  partials_kernel<<<grid, kThreads, smem, s>>>(
      pts, pts_bf16 != 0, (const float*)cen, (const float*)c2, n, d, k,
      acc_in_smem, (float*)slabs, (int*)counts, (float*)inertia_partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long kd = (long)k * d;
  reduce_slabs_kernel<<<(unsigned)((kd + 255) / 256), 256, 0, s>>>(
      (const float*)slabs, grid, kd, (float*)sums);
  return (int)cudaGetLastError();
}

}  // extern "C"
