// K7: weighted label histogram for Random Forest growth on Hopper (sm_90a).
//
// Replaces harp_tpu/ops/rf_kernel.py::hist_bins (Pallas body _kernel).  For
// every tree t of the forest, one level's histogram
//   hist[t, r, k*B + b] = sum_i [rowcode[t, i] = r] * w[t, i] * [bins[i, k] = b]
// with exact int32 counts.  The TPU kernel multiplies a one-hot of the row
// codes against the one-hot bins BO [n, f*B] on the matrix unit; BO is
// one_hot(bins) by construction, so this kernel reads the bin ids (12.8 MB
// at 200k x 64 in uint8, where BO is 410 MB) and adds each weight where the
// one-hot product would put it.  Row codes or bins out of range add nothing,
// as in the one-hot product.  The tree axis is a grid dimension, so one
// launch grows a level of the whole forest.
//
// Bound on this card: at 32 trees, 200k x 64 features, 32 bins, level 5 it
// reads the bins once (12.8 MB), row codes and weights (51.2 MB) and writes
// the histogram (16.8 MB): 0.024 ms at 3.35 TB/s; the weighted increments,
// one per (tree, sample of nonzero weight, feature) - about 2.6e8 for
// Poisson(1) weights - take 0.031 ms at one 4-byte shared-memory update per
// bank and clock (32 banks x 132 SMs x 1.98 GHz).
//
// Design:
//  - The bins come transposed, [f, n], so a feature's ids are contiguous and
//    a warp's loads coalesce.
//  - A block owns (a slice of features, a tree, a range of samples) and keeps
//    that slice's [R, fs*B] int32 histogram in shared memory; the slice
//    width fs is set per level so the histogram fits (level 5 at R = 64 holds
//    12 of the 64 features in 96 KB).  Samples of weight 0 are skipped.
//  - int32 shared-memory atomics per increment, then one int32 global
//    atomicAdd per nonzero cell.  Integer adds commute, so the counts are
//    bit-identical in any order.
//  - Any n, f, B and R whose one-feature histogram fits in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSliceBytes = 96 * 1024;
constexpr int kMinChunk = 2048;

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const BinT* __restrict__ binsT, const int* __restrict__ rowcode,
            const int* __restrict__ weights, int n, int f, int B, int R,
            int fs, int chunk, int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int f0 = blockIdx.x * fs;
  const int nf = min(fs, f - f0);
  const int width = nf * B;  // this slice's columns
  const int tree = blockIdx.y;
  const long cells = (long)R * width;
  for (long c = threadIdx.x; c < cells; c += kThreads) sh[c] = 0;
  __syncthreads();

  const long i0 = (long)blockIdx.z * chunk;
  const long i1 = min((long)n, i0 + chunk);
  const int* rc = rowcode + (long)tree * n;
  const int* wt = weights + (long)tree * n;
  for (long i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const int w = wt[i];
    const int r = rc[i];
    if (w == 0 || (unsigned)r >= (unsigned)R) continue;
    int* row = sh + (long)r * width;
    for (int k = 0; k < nf; ++k) {
      const int b = (int)binsT[(long)(f0 + k) * n + i];
      if ((unsigned)b < (unsigned)B) atomicAdd(&row[k * B + b], w);
    }
  }
  __syncthreads();
  int* out = hist + (long)tree * R * f * B + (long)f0 * B;
  for (long c = threadIdx.x; c < cells; c += kThreads) {
    const int v = sh[c];
    if (v) atomicAdd(&out[(c / width) * (long)f * B + c % width], v);
  }
}

template <typename BinT>
cudaError_t launch(const void* binsT, const int* rowcode, const int* weights,
                   int T, int n, int f, int B, int R, int fs, int chunk,
                   int* hist, cudaStream_t s) {
  const int slices = (f + fs - 1) / fs;
  const size_t smem = (size_t)fs * R * B * sizeof(int);
  dim3 grid(slices, T, (unsigned)((n + chunk - 1) / chunk));
  hist_kernel<BinT><<<grid, kThreads, smem, s>>>(
      static_cast<const BinT*>(binsT), rowcode, weights, n, f, B, R, fs,
      chunk, hist);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per card and shape (the wrapper keeps the answer): lets both
// instantiations take the card's opt-in shared memory (the kernel has no
// static part; the whole limit, so a plan for one level never caps
// another), and returns the features a block's slice holds (*fs) and the
// samples a block takes (*chunk).  *fs is 0 when one feature's [R, B]
// histogram does not fit in a block's shared memory.
int rf_hist_bins_plan(int T, int n, int f, int B, int R, int* fs,
                      int* chunk) {
  if (T < 1 || n < 1 || f < 1 || B < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t per_feature = (size_t)R * B * sizeof(int);
  if (per_feature > (size_t)optin) {
    *fs = 0;
    return 0;
  }
  err = cudaFuncSetAttribute(hist_kernel<uint8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(hist_kernel<int32_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return (int)err;
  const size_t budget = per_feature > kSliceBytes ? (size_t)optin : kSliceBytes;
  *fs = (int)(budget / per_feature);
  if (*fs > f) *fs = f;
  const int slices = (f + *fs - 1) / *fs;
  // split the samples until the card holds about four blocks an SM
  long parts = (4L * sms + (long)slices * T - 1) / ((long)slices * T);
  const long max_parts = ((long)n + kMinChunk - 1) / kMinChunk;
  if (parts > max_parts) parts = max_parts;
  if (parts < 1) parts = 1;
  *chunk = (int)((n + parts - 1) / parts);
  return 0;
}

// binsT: [f, n] uint8 (bins_int32 = 0) or int32 (1); rowcode and weights
// [T, n] int32; hist [T, R, f*B] int32 must be zeroed.  fs and chunk come
// from rf_hist_bins_plan(T, n, f, B, R) on this card.  Returns a CUDA error
// code (0 on success).
int rf_hist_bins(const void* binsT, int bins_int32, const void* rowcode,
                 const void* weights, int T, int n, int f, int B, int R,
                 int fs, int chunk, void* hist, void* stream) {
  if (T < 1 || n < 1 || f < 1 || B < 1 || R < 1 || fs < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bins_int32)
    return (int)launch<int32_t>(binsT, (const int*)rowcode,
                                (const int*)weights, T, n, f, B, R, fs, chunk,
                                (int*)hist, s);
  return (int)launch<uint8_t>(binsT, (const int*)rowcode,
                              (const int*)weights, T, n, f, B, R, fs, chunk,
                              (int*)hist, s);
}

}  // extern "C"
