// K1: fused int8 KMeans partials for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/kmeans_kernel.py::kmeans_partials_int8 (Pallas body
// _kernel_int8).  One pass over int8 points [n, d]: score every point against
// the per-row requantized int8 centroids, score = c2 - 2 * (dot * c_scale),
// take the argmin (lowest index wins ties), and accumulate the one-hot sums
// (exact int32), the counts (int32) and one f32 partial of the sum of best
// scores per block.  The caller dequantizes the sums with col_scale and adds
// the hoisted sum of |x|^2.
//
// Bound on this card: memory.  At 1M x 300, k = 100 the kernel must read
// 300 MB of int8 points (about 90 us at 3.35 TB/s); the 2*n*k*d = 6e10 int8
// operations take about 30 us at the int8 tensor-core rate.
//
// Design, simple and right first (making it fast is later work):
//  - A block owns tiles of kTileN points (grid-stride over tiles, the grid
//    sized to fill the card once).  Its 256 threads are kTileN points x
//    kGroups centroid groups; each thread keeps 8 exact s8 x s8 -> s32 dot
//    products (__dp4a, four bytes at a time) against one tile of kTileK
//    centroids, and the centroid tiles loop over any k.  The point rows sit
//    in shared memory with an odd word stride, so a warp reading 32 rows at
//    once hits 32 banks; the centroid tile is stored [word][centroid] and
//    read as int4 broadcasts.
//  - Each thread keeps a running (best, index) and replaces it only on a
//    strictly smaller score; the groups are then merged with index order on
//    ties, so the lowest index wins across tiles and groups, as argmin does.
//  - Rounding: the score is c2 - 2 * round(float(dot) * c_scale), computed
//    with __fmul_rn / __fsub_rn so nvcc cannot contract it into an FMA;
//    a fused multiply-add would round once and could flip near-ties against
//    the plain version.  float(dot) is exact (|dot| <= 127^2 * d < 2^24 for
//    d <= 1040).
//  - While the tile is still in shared memory, each thread owns columns of
//    d and adds the tile's rows into the block's int32 accumulator: in shared
//    memory when k*d fits beside the tiles (k = 100 at d = 300), else
//    straight into the global sums with int32 atomics.  Integer sums are
//    exact and independent of order.  At the end a block adds its shared
//    accumulator and its counts into the global outputs with int32 atomics
//    and writes its partial sum of best scores (summed over its tiles in a
//    fixed order); the wrapper sums those partials in a fixed order.
//  - Any n: the ragged last tile is masked.  Any k: centroid tiles loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 64;                  // points per tile
constexpr int kGroups = kThreads / kTileN;  // centroid groups per point
constexpr int kPerThread = 8;               // centroids per thread per tile
constexpr int kTileK = kGroups * kPerThread;

struct Layout {
  int dw;      // 32-bit words per row: ceil(d / 4)
  int ds;      // shared row stride in words: dw rounded up to odd
  size_t off_cen, off_cscale, off_c2, off_best, off_bidx, off_assign,
      off_bestv, off_counts, off_acc, bytes_no_acc, bytes_acc;
};

__host__ __device__ Layout make_layout(int d, int k) {
  Layout L;
  L.dw = (d + 3) / 4;
  L.ds = L.dw | 1;
  size_t o = (size_t)kTileN * L.ds * 4;  // multiple of 16 bytes
  L.off_cen = o;     o += (size_t)L.dw * kTileK * 4;
  L.off_cscale = o;  o += kTileK * 4;
  L.off_c2 = o;      o += kTileK * 4;
  L.off_best = o;    o += kGroups * kTileN * 4;
  L.off_bidx = o;    o += kGroups * kTileN * 4;
  L.off_assign = o;  o += kTileN * 4;
  L.off_bestv = o;   o += kTileN * 4;
  L.off_counts = o;  o += (size_t)k * 4;
  L.off_acc = o;
  L.bytes_no_acc = o;
  L.bytes_acc = o + (size_t)k * d * 4;
  return L;
}

// Word w (bytes 4w..4w+3) of an int8 row of length d, zero past the end.
__device__ __forceinline__ int load_word(const int8_t* row, int w, int d,
                                         bool aligned) {
  if (aligned) return reinterpret_cast<const int*>(row)[w];
  unsigned v = 0;
  for (int b = 0; b < 4; ++b) {
    int j = 4 * w + b;
    unsigned byte = j < d ? (unsigned)(uint8_t)row[j] : 0u;
    v |= byte << (8 * b);
  }
  return (int)v;
}

__global__ void __launch_bounds__(kThreads)
partials_int8_kernel(const int8_t* __restrict__ pts, const int8_t* __restrict__ cq,
                     const float* __restrict__ cscale, const float* __restrict__ c2,
                     int n, int d, int k, bool aligned, bool acc_in_smem,
                     int* __restrict__ sums, int* __restrict__ counts,
                     float* __restrict__ best_partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(d, k);
  int* pts_s = reinterpret_cast<int*>(smem);
  int* cen_s = reinterpret_cast<int*>(smem + L.off_cen);
  float* cscale_s = reinterpret_cast<float*>(smem + L.off_cscale);
  float* c2_s = reinterpret_cast<float*>(smem + L.off_c2);
  float* best_s = reinterpret_cast<float*>(smem + L.off_best);
  int* bidx_s = reinterpret_cast<int*>(smem + L.off_bidx);
  int* assign_s = reinterpret_cast<int*>(smem + L.off_assign);
  float* bestv_s = reinterpret_cast<float*>(smem + L.off_bestv);
  int* counts_s = reinterpret_cast<int*>(smem + L.off_counts);
  int* acc_s = acc_in_smem ? reinterpret_cast<int*>(smem + L.off_acc) : nullptr;

  const int t = threadIdx.x;
  const int p = t % kTileN;
  const int g = t / kTileN;
  for (int i = t; i < k; i += kThreads) counts_s[i] = 0;
  if (acc_s)
    for (long i = t; i < (long)k * d; i += kThreads) acc_s[i] = 0;

  float blk_best = 0.f;  // only thread 0's copy is used
  const int ntiles = (n + kTileN - 1) / kTileN;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = (long)tile * kTileN;
    const int rows = (int)min((long)kTileN, (long)n - row0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = t; i < kTileN * L.dw; i += kThreads) {
      int r = i / L.dw, w = i % L.dw;
      pts_s[r * L.ds + w] =
          r < rows ? load_word(pts + (row0 + r) * d, w, d, aligned) : 0;
    }

    float best = __int_as_float(0x7f800000);  // +inf
    int bi = -1;  // no centroid seen yet: the first one is taken even at +inf
    for (int c0 = 0; c0 < k; c0 += kTileK) {
      __syncthreads();  // the previous centroid tile's readers are done
      for (int i = t; i < kTileK * L.dw; i += kThreads) {
        int c = i / L.dw, w = i % L.dw;
        cen_s[w * kTileK + c] =
            c0 + c < k ? load_word(cq + (long)(c0 + c) * d, w, d, aligned) : 0;
      }
      if (t < kTileK) {
        cscale_s[t] = c0 + t < k ? cscale[c0 + t] : 0.f;
        c2_s[t] = c0 + t < k ? c2[c0 + t] : 0.f;
      }
      __syncthreads();

      int acc[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[j] = 0;
      const int* prow = pts_s + p * L.ds;
      const int4* cvec = reinterpret_cast<const int4*>(cen_s) + g * 2;
      for (int w = 0; w < L.dw; ++w) {
        const int a = prow[w];
        const int4 lo = cvec[w * (kTileK / 4)];
        const int4 hi = cvec[w * (kTileK / 4) + 1];
        acc[0] = __dp4a(a, lo.x, acc[0]);
        acc[1] = __dp4a(a, lo.y, acc[1]);
        acc[2] = __dp4a(a, lo.z, acc[2]);
        acc[3] = __dp4a(a, lo.w, acc[3]);
        acc[4] = __dp4a(a, hi.x, acc[4]);
        acc[5] = __dp4a(a, hi.y, acc[5]);
        acc[6] = __dp4a(a, hi.z, acc[6]);
        acc[7] = __dp4a(a, hi.w, acc[7]);
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int cl = g * kPerThread + j;
        if (c0 + cl < k) {
          const float prod = __fmul_rn((float)acc[j], cscale_s[cl]);
          const float s = __fsub_rn(c2_s[cl], 2.f * prod);
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
        const int a = assign_s[r];
        const int v = reinterpret_cast<const int8_t*>(pts_s + r * L.ds)[j];
        if (acc_s)
          acc_s[(long)a * d + j] += v;  // column j is this thread's alone
        else
          atomicAdd(&sums[(long)a * d + j], v);
      }
    }
  }
  __syncthreads();
  if (acc_s)
    for (long i = t; i < (long)k * d; i += kThreads)
      if (acc_s[i]) atomicAdd(&sums[i], acc_s[i]);
  for (int i = t; i < k; i += kThreads)
    if (counts_s[i]) atomicAdd(&counts[i], counts_s[i]);
  if (t == 0) best_partial[blockIdx.x] = blk_best;
}

// Shared-memory bytes and whether the [k, d] accumulator lives there.
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
  return cudaFuncSetAttribute(partials_int8_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

// Number of blocks the kernel launches for (n, d, k): enough to fill the
// card once, at most one per tile.  The caller sizes best_partial with it.
int kmeans_partials_int8_grid(int n, int d, int k, int* grid) {
  size_t smem;
  bool acc_in_smem;
  cudaError_t err = plan(d, k, &smem, &acc_in_smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, partials_int8_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (n + kTileN - 1) / kTileN;
  *grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  if (*grid < 1) *grid = 1;
  return 0;
}

// sums [k, d] and counts [k] int32 must be zeroed by the caller;
// best_partial holds `grid` floats.  Returns cudaGetLastError() after the
// launch (0 on success).
int kmeans_partials_int8(const void* pts_q, const void* c_q, const void* c_scale,
                         const void* c2, int n, int d, int k, void* sums,
                         void* counts, void* best_partial, int grid,
                         void* stream) {
  size_t smem;
  bool acc_in_smem;
  cudaError_t err = plan(d, k, &smem, &acc_in_smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (d % 4 == 0) && ((uintptr_t)pts_q % 4 == 0) &&
                       ((uintptr_t)c_q % 4 == 0);
  partials_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)pts_q, (const int8_t*)c_q, (const float*)c_scale,
      (const float*)c2, n, d, k, aligned, acc_in_smem, (int*)sums,
      (int*)counts, (float*)best_partial);
  return (int)cudaGetLastError();
}

}  // extern "C"
