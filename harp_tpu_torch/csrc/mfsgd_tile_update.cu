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
// slot is a pad when eu >= u_tile, and then nothing of it is read (its ei
// may lie one row past the tile).
//
// Entry order.  The TPU runs the entries as a sequential grid.  The host
// gives every entry with a rating a level (harp_tpu_torch/ops/
// mfsgd_kernel.py, LevelSchedule): entries of one level touch distinct W
// tiles and distinct H tiles and read only what earlier levels finished.
// The C entry point below launches one kernel per level, in order, on the
// caller's stream: one call per rotation step, one launch per level.
//
// Bound on this card.  At MovieLens-20M width (rank 64, 256 x 256 tiles,
// about 10M ratings a step) the step must read the entry streams (12 bytes
// a slot) and read and write W and H once; its ~12 flops per rating and
// rank element run on the f32 CUDA cores.  Both come to about 0.1 ms.
// This first kernel is far above that: a level holds at most a few dozen
// entries, so a few dozen of the 132 SMs work, and the levels run one
// after another (hundreds of dependent launches a step).  Reworking the
// schedule is later work.
//
// Design, simple and right first:
//  - One block per entry of the level; a warp per rating slot, its lanes
//    over the rank, with a shuffle reduction for the dot.
//  - W and H are read straight from global memory.  Nothing is written
//    before the apply, so global memory is the entry-start snapshot.
//  - The gradients accumulate in shared memory, [u_tile, R] and
//    [i_tile, R] f32 (128 KB at 256 x 256, rank 64), with shared-memory
//    float atomicAdd: the summation order of duplicate rows varies from run
//    to run, so reruns agree to f32 rounding, not bit for bit.  Tiles whose
//    accumulators do not fit in a block's shared memory are refused by the
//    wrapper (never clipped).
//  - After __syncthreads the block applies the accumulators to its tiles;
//    w + lr * acc is computed with __fmul_rn / __fadd_rn, and the gradient
//    terms likewise, so nvcc cannot contract them into FMAs that would round
//    differently from the plain version.
//  - Per-entry se and cnt partials go to per-entry slots that the wrapper
//    sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <bool kBF16>
__device__ __forceinline__ float rnd(float x) {
  if (kBF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
level_kernel(float* __restrict__ W, float* __restrict__ H,
             const int* __restrict__ eu, const int* __restrict__ ei,
             const float* __restrict__ ev, const int* __restrict__ ou,
             const int* __restrict__ oi, const int* __restrict__ order,
             int C, int R, int u_tile, int i_tile, float lr, float reg,
             float* __restrict__ se_part, float* __restrict__ cnt_part) {
  extern __shared__ float smem[];
  float* acc_w = smem;                           // [u_tile, R]
  float* acc_h = smem + (size_t)u_tile * R;      // [i_tile, R]
  __shared__ float se_w[kWarps], cnt_w[kWarps];

  const int e = order[blockIdx.x];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long w0 = (long)ou[e], h0 = (long)oi[e];
  const int n_acc = (u_tile + i_tile) * R;
  for (int i = t; i < n_acc; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int* cu_e = eu + (long)e * C;
  const int* ci_e = ei + (long)e * C;
  const float* cv_e = ev + (long)e * C;
  float se = 0.f, cnt = 0.f;
  for (int s = warp; s < C; s += kWarps) {
    const int cu = cu_e[s];
    if (cu >= u_tile) continue;  // pad slot: warp-uniform, ei never read
    const int ci = ci_e[s];
    const float* wrow = W + (w0 + cu) * R;
    const float* hrow = H + (h0 + ci) * R;
    float dot = 0.f;
    for (int r = lane; r < R; r += 32)
      dot = __fadd_rn(dot, __fmul_rn(rnd<kBF16>(wrow[r]), rnd<kBF16>(hrow[r])));
    for (int off = 16; off > 0; off >>= 1)
      dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, off));
    // lanes may differ in the last bit (each added in its own order): all
    // take lane 0's sum, so one slot has one err
    dot = __shfl_sync(0xffffffffu, dot, 0);
    const float err = __fsub_rn(cv_e[s], dot);
    se = __fadd_rn(se, __fmul_rn(err, err));
    cnt += 1.f;
    for (int r = lane; r < R; r += 32) {
      const float w = rnd<kBF16>(wrow[r]), h = rnd<kBF16>(hrow[r]);
      const float gw = rnd<kBF16>(__fsub_rn(__fmul_rn(err, h), __fmul_rn(reg, w)));
      const float gh = rnd<kBF16>(__fsub_rn(__fmul_rn(err, w), __fmul_rn(reg, h)));
      atomicAdd(&acc_w[cu * R + r], gw);
      atomicAdd(&acc_h[ci * R + r], gh);
    }
  }
  if (lane == 0) {
    se_w[warp] = se;
    cnt_w[warp] = cnt;
  }
  __syncthreads();

  // one apply per entry, from the snapshot that global memory still holds
  for (int i = t; i < u_tile * R; i += kThreads) {
    float* p = W + w0 * R + i;
    *p = __fadd_rn(*p, __fmul_rn(lr, acc_w[i]));
  }
  for (int i = t; i < i_tile * R; i += kThreads) {
    float* p = H + h0 * R + i;
    *p = __fadd_rn(*p, __fmul_rn(lr, acc_h[i]));
  }
  if (t == 0) {
    float s = 0.f, c = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      s += se_w[k];
      c += cnt_w[k];
    }
    se_part[e] = s;
    cnt_part[e] = c;
  }
}

template <bool kBF16>
cudaError_t launch_levels(float* W, float* H, const int* eu, const int* ei,
                          const float* ev, const int* ou, const int* oi,
                          const int* order, const int* offsets, int n_levels,
                          int C, int R, int u_tile, int i_tile, float lr,
                          float reg, float* se, float* cnt,
                          cudaStream_t stream) {
  const size_t smem = (size_t)(u_tile + i_tile) * R * sizeof(float);
  cudaError_t err;
  for (int l = 0; l < n_levels; ++l) {
    const int width = offsets[l + 1] - offsets[l];
    if (width <= 0) continue;
    level_kernel<kBF16><<<width, kThreads, smem, stream>>>(
        W, H, eu, ei, ev, ou, oi, order + offsets[l], C, R, u_tile, i_tile,
        lr, reg, se, cnt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Once per process and card, before the first sgd_tile_update there:
// *limit receives the shared memory a block may use on the current card
// (the opt-in maximum) and *static_bytes the kernel's static shared memory;
// both instantiations may then take limit - static_bytes of dynamic
// shared memory.
int sgd_tile_update_init(int* limit, int* static_bytes) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a16, a32;
  err = cudaFuncGetAttributes(&a16, level_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncGetAttributes(&a32, level_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *static_bytes = (int)(a16.sharedSizeBytes > a32.sharedSizeBytes
                            ? a16.sharedSizeBytes : a32.sharedSizeBytes);
  const int dynamic = *limit - *static_bytes;
  err = cudaFuncSetAttribute(level_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(level_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   dynamic);
}

// One rotation step: W [*, R] and H [*, R] f32 updated in place; eu/ei
// int32, ev f32 [NE, C]; ou/oi int32 [NE]; order int32 (device) lists the
// scheduled entries level by level, offsets int32 [n_levels + 1] (HOST)
// bounds each level.  se/cnt [NE] f32 zeroed by the caller receive the
// per-entry partials.  Returns the first CUDA error (0 on success).
int sgd_tile_update(void* W, void* H, const void* eu, const void* ei,
                    const void* ev, const void* ou, const void* oi,
                    const void* order, const void* offsets, int n_levels,
                    int C, int R, int u_tile, int i_tile, float lr, float reg,
                    int bf16, void* se, void* cnt, void* stream) {
  auto go = bf16 ? launch_levels<true> : launch_levels<false>;
  return (int)go((float*)W, (float*)H, (const int*)eu, (const int*)ei,
                 (const float*)ev, (const int*)ou, (const int*)oi,
                 (const int*)order, (const int*)offsets, n_levels, C, R,
                 u_tile, i_tile, lr, reg, (float*)se, (float*)cnt,
                 (cudaStream_t)stream);
}

}  // extern "C"
