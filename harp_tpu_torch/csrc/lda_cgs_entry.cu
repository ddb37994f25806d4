// K4: LDA-CGS tile-entry resample for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/lda_kernel.py::cgs_entry_update (Pallas body
// _kernel).  One rotation step of one worker: the entries (up to C tokens
// inside one d_tile x w_tile sub-tile at row offsets od / ow) run in order,
// each walked in chunks of cc tokens.  Every token of a chunk samples
// against the same counts: the doc rows (Ndk, f32 or int16), the word rows
// (Nwk, f32) and the topic totals nk as the chunks and entries before it
// left them.  Per token and topic k, with old = (k == z):
//   a = max(ndk - old + alpha, 1e-10), b = max(nwk - old + beta, 1e-10),
//   c = max(nk - old + vbeta, 1e-10), ratio = (-log(u) * c) / (a * b),
// and the new topic is the argmin, ties to the lowest k.  The chunk's +-1
// deltas land after every token of the chunk has read.  A slot with
// cd >= d_tile is a pad: it keeps its topic and changes nothing.
//
// Exactness.  Counts are integers and every delta is +-1, so the atomics
// below give the same tables in any order (f32 holds integers to 2^24; the
// int16 doc counts use a compare-and-swap loop on the aligned 32-bit word,
// there being no 16-bit atomicAdd).  The ratio is built with __fsub_rn /
// __fadd_rn / __fmul_rn / __fdiv_rn and logf (the file is compiled without
// --use_fast_math), so nvcc cannot contract or approximate it, and the
// kernel agrees bit for bit with its plain PyTorch version on the card.
// exact == 0 rounds the gathered doc and word counts to bf16, as the TPU's
// single-dot gather does.
//
// Uniforms: injected (u [NE, C, K]) or Philox4x32-10 in the kernel, keyed
// by the entry's two seed words with the chunk folded into the second
// (s1 ^ j * 0x9E3779B9, as the TPU kernel seeds its generator), counter
// (slot, topic / 4, 0, 0); u = (bits >> 8) * 2^-24 + 2^-25.  The same
// generator is written in plain torch (ops/lda_kernel.py philox_uniforms).
//
// Bound on this card.  At the benchmark width (1000 topics, ~5M real tokens
// a rotation step) the step does one log and ~10 f32 operations per real
// token and topic: ~1.2 ms at the SFU rate, against ~0.3 ms to read and
// write the tables once.  The work is a chain: each chunk samples against
// the last one's deltas, and the entries against each other through nk, so
// a step of the LDA benchmark is ~45,000 dependent chunks of 128 tokens.
// The first kernel launched one 128-block grid per chunk (7.6 us each on an
// H100 80GB HBM3 at 700 W, PERF.md); this one launches once per step
// (4.0-4.1 us a chunk on the same card).
//
// Design:
//  - one persistent cooperative launch per rotation step: cc blocks of 256
//    threads (cc <= 256, so the grid is co-resident on the card's SMs; the
//    host checks that with the occupancy API and refuses otherwise).  Block
//    b owns slot j * cc + b of every chunk j.  The blocks walk the entries
//    in order and each entry's chunks in order (offsets [NE + 1], the
//    prefix sums of the plan's chunk counts, on the card);
//  - per chunk: the sample (the threads split the topics, keep the
//    lexicographic (ratio, k) minimum and reduce it by warp shuffles and
//    shared memory, so the winner is the lowest index among equal
//    ratios); a grid barrier (every read of the chunk is done); each block
//    applies its own token's +-1 deltas with atomics, six threads side by
//    side, and writes z; a grid barrier (the deltas are visible to the
//    next chunk's reads).  The deltas are integer +-1, so the tables come
//    out the same in any order;
//  - -log(u) of the next chunk's slot depends on no count: the block makes
//    it (Philox, one call per 4 topics, and logf) into shared memory (K
//    floats, so K up to ~58,000 topics; a larger K is refused at launch)
//    between its arrival at the second barrier and its wait there, and
//    prefetches the slot's doc and word rows into L2 (coherent, so safe
//    while the others' atomics land), so the sample after the barrier is
//    only the gathers, the ratio and the reduce, mostly from L2.  A thread
//    takes its topics four at a time and issues their twelve loads
//    together, so a chunk waits for about one L2 round trip, not four;
//  - the first barrier only orders reads before writes, and arrives
//    relaxed (see grid_arrive for what that relies on); the second
//    releases the atomics and acquires them;
//  - counts that other SMs change inside the launch are read through L2
//    (__ldcg), never through L1 or the read-only path; the barrier is a
//    monotone 64-bit arrival counter in device memory, waited on with
//    ld.acquire.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_uniform(unsigned b) {
  return __fadd_rn(__fmul_rn(__uint2float_rn(b >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

// counts that other blocks change inside the launch: read through L2
__device__ __forceinline__ float load_count(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float load_count(const short* p) {
  return (float)__ldcg(p);
}

template <bool kExact>
__device__ __forceinline__ float gathered(float v) {
  return kExact ? v : __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void add_count(float* p, float v) {
  atomicAdd(p, v);
}

// +-1 on an int16 count: CAS on the aligned 32-bit word that holds it
__device__ __forceinline__ void add_count(short* p, float v) {
  unsigned* word = (unsigned*)((uintptr_t)p & ~(uintptr_t)3);
  const unsigned shift = ((uintptr_t)p & 2) ? 16u : 0u;
  const unsigned short d = (unsigned short)(short)v;
  unsigned old = __ldcg(word), assumed;
  do {
    assumed = old;
    const unsigned short cur = (unsigned short)(assumed >> shift);
    const unsigned repl = (assumed & ~(0xFFFFu << shift)) |
                          ((unsigned)(unsigned short)(cur + d) << shift);
    old = atomicCAS(word, assumed, repl);
  } while (old != assumed);
}

__device__ __forceinline__ bool better(float r2, int k2, float r, int k) {
  return r2 < r || (r2 == r && k2 < k);
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The grid barrier, in two halves so that work independent of the other
// blocks fits between them.  bar counts arrivals over the whole launch
// (zeroed by the host), so the n-th barrier waits for n * gridDim.x.
// arrive: with kRelease, every write of the block before it is released
// to the grid; without, it only says the block is there.  The relaxed
// arrival (after each chunk's sample; 0.33 us a chunk cheaper than a
// release on an H100 80GB HBM3 at 700 W) relies on the block's __ldcg
// loads having completed once their values were consumed before
// bar.sync, so that no other block's +-1 write after the barrier can
// reach them.  The PTX memory model does not promise that; phase 9 of
// chip_smoke.py (the whole step bit-equal to its plain version) is the
// check that would catch a stale read.
template <bool kRelease>
__device__ __forceinline__ void grid_arrive(unsigned long long* bar,
                                            unsigned long long& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kRelease)
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar)
                   : "memory");
    else
      asm volatile("red.relaxed.gpu.global.add.u64 [%0], 1;" ::"l"(bar)
                   : "memory");
  }
}

// the 128-byte lines of one row of K counts into L2, ahead of its reads
template <typename T>
__device__ __forceinline__ void prefetch_row(const T* row, int K, int lane0) {
  const int lines = (int)((K * sizeof(T) + 127) / 128);
  for (int i = threadIdx.x - lane0; i >= 0 && i < lines; i += 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(row) + 128 * i));
}

// wait: every block has arrived, and its writes are visible.  A barrier
// that never fills (blocks not co-resident) traps after ~10 s instead of
// hanging.
__device__ __forceinline__ void grid_wait(const unsigned long long* bar,
                                          unsigned long long target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (load_acquire(bar) < target)
      if (clock64() - t0 > 20000000000ll) __trap();
  }
  __syncthreads();
}

// -log(u) of every topic for one slot of chunk j of entry e, into nl[K]:
// what the sample needs that no count changes, made while the block waits
// at a barrier
template <bool kInjected>
__device__ __forceinline__ void neg_log_uniforms(
    float* nl, const float* __restrict__ u, const int* __restrict__ seeds,
    int e, int j, int slot, long idx, int K) {
  if (kInjected) {
    const float* urow = u + idx * (long)K;
    for (int k = threadIdx.x; k < K; k += kThreads) nl[k] = -logf(urow[k]);
    return;
  }
  const unsigned k0 = (unsigned)seeds[2 * e];
  const unsigned k1 = (unsigned)seeds[2 * e + 1] ^ ((unsigned)j * kW0);
  for (int g = threadIdx.x; 4 * g < K; g += kThreads) {
    const uint4 bits = philox(make_uint4((unsigned)slot, (unsigned)g, 0u, 0u),
                              k0, k1);
    const unsigned w4[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * g + q < K) nl[4 * g + q] = -logf(to_uniform(w4[q]));
  }
}

template <typename T, bool kExact, bool kInjected>
__global__ void __launch_bounds__(kThreads)
step_kernel(T* ndk, float* nwk, float* nk, int* z, const int* __restrict__ cd,
            const int* __restrict__ cw, const int* __restrict__ od,
            const int* __restrict__ ow, const float* __restrict__ u,
            const int* __restrict__ seeds, const int* __restrict__ offsets,
            unsigned long long* bar, int NE, int C, int K, int cc,
            int d_tile, float alpha, float beta, float vbeta) {
  extern __shared__ float nl[];  // -log(u) of this block's slot, [K]
  __shared__ float s_r[kWarps];
  __shared__ int s_k[kWarps];
  __shared__ int s_zn;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long target = 0;
  const int total = offsets[NE];
  int e = 0, j = 0;  // the chunk being sampled: chunk j of entry e
  while (e < NE && offsets[e + 1] == offsets[e]) ++e;
  if (total > 0)
    neg_log_uniforms<kInjected>(nl, u, seeds, e, j, j * cc + blockIdx.x,
                                (long)e * C + j * cc + blockIdx.x, K);
  __syncthreads();
  for (int n = 0; n < total; ++n) {
    const int slot = j * cc + blockIdx.x;
    const long idx = (long)e * C + slot;
    const int dv = cd[idx];
    const int zo = z[idx];  // this block alone reads and writes the slot
    const long dr = ((long)od[e] + dv) * K;
    const long wr = ((long)ow[e] + cw[idx]) * K;
    int zn = zo;
    if (dv < d_tile) {  // block-uniform
      const T* drow = ndk + dr;
      const float* wrow = nwk + wr;
      float best = INFINITY;
      int bk = K;
      // four topics a pass: their twelve loads go out together
      for (int k4 = t; k4 < K; k4 += 4 * kThreads) {
        float cd_[4], cw_[4], cn_[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = k4 + r * kThreads;
          if (k < K) {
            cd_[r] = load_count(drow + k);
            cw_[r] = load_count(wrow + k);
            cn_[r] = load_count(nk + k);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = k4 + r * kThreads;
          if (k < K) {
            const float old = (k == zo) ? 1.f : 0.f;
            const float a = fmaxf(__fadd_rn(__fsub_rn(gathered<kExact>(cd_[r]),
                                                      old), alpha), 1e-10f);
            const float b = fmaxf(__fadd_rn(__fsub_rn(gathered<kExact>(cw_[r]),
                                                      old), beta), 1e-10f);
            const float c = fmaxf(__fadd_rn(__fsub_rn(cn_[r], old), vbeta),
                                  1e-10f);
            const float q = __fdiv_rn(__fmul_rn(nl[k], c), __fmul_rn(a, b));
            if (q < best) {  // k rises within a thread: strict < keeps the
              best = q;      // lowest
              bk = k;
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float r2 = __shfl_xor_sync(0xffffffffu, best, off);
        const int k2 = __shfl_xor_sync(0xffffffffu, bk, off);
        if (better(r2, k2, best, bk)) {
          best = r2;
          bk = k2;
        }
      }
      if (lane == 0) {
        s_r[warp] = best;
        s_k[warp] = bk;
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 1; w < kWarps; ++w)
          if (better(s_r[w], s_k[w], best, bk)) {
            best = s_r[w];
            bk = s_k[w];
          }
        zn = bk;
      }
    }
    if (t == 0) s_zn = zn;
    grid_arrive<false>(bar, target);  // every read of the chunk is done
    grid_wait(bar, target);
    // the token's six +-1 updates, one thread each (a pad slot keeps
    // zn == zo); -1 only at a topic inside the table
    zn = s_zn;
    if (zn != zo && t < 6 && (t >= 3 || (zo >= 0 && zo < K))) {
      const int k = t < 3 ? zo : zn;
      const float d = t < 3 ? -1.f : 1.f;
      if (t % 3 == 0)
        add_count(ndk + dr + k, d);
      else if (t % 3 == 1)
        atomicAdd(nwk + wr + k, d);
      else
        atomicAdd(nk + k, d);
      if (t == 3) z[idx] = zn;
    }
    grid_arrive<true>(bar, target);  // the chunk's deltas are released
    if (++j == offsets[e + 1] - offsets[e]) {
      j = 0;
      do ++e;
      while (e < NE && offsets[e + 1] == offsets[e]);
    }
    if (n + 1 < total) {
      // while the others apply: the next slot's doc and word rows into L2
      // (coherent, so no stale value), and its uniforms
      const long nidx = (long)e * C + j * cc + blockIdx.x;
      const int ndv = cd[nidx];
      if (ndv < d_tile) {
        prefetch_row(ndk + ((long)od[e] + ndv) * K, K, 0);
        prefetch_row(nwk + ((long)ow[e] + cw[nidx]) * K, K, 32);
      }
      neg_log_uniforms<kInjected>(nl, u, seeds, e, j, j * cc + blockIdx.x,
                                  nidx, K);
    }
    grid_wait(bar, target);  // ... and visible to every block
  }
}

template <typename T, bool kExact, bool kInjected>
cudaError_t run_step(T* ndk, float* nwk, float* nk, int* z, const int* cd,
                     const int* cw, const int* od, const int* ow,
                     const float* u, const int* seeds, const int* offsets,
                     unsigned long long* bar, int NE, int C, int K, int cc,
                     int d_tile, float alpha, float beta, float vbeta,
                     cudaStream_t stream) {
  auto kern = step_kernel<T, kExact, kInjected>;
  int dev, coop, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const size_t smem = sizeof(float) * (size_t)K;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (!coop || (long)per_sm * sms < cc)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&ndk, &nwk, &nk, &z, &cd, &cw, &od, &ow, &u, &seeds,
                  &offsets, &bar, &NE, &C, &K, &cc, &d_tile, &alpha, &beta,
                  &vbeta};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(cc),
                                    dim3(kThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(void* ndk, void* nwk, void* nk, void* z, const void* cd,
                     const void* cw, const void* od, const void* ow,
                     const void* u, const void* seeds, const void* offsets,
                     void* bar, int NE, int C, int K, int cc, int d_tile,
                     float alpha, float beta, float vbeta, int exact,
                     cudaStream_t stream) {
  auto go = exact ? (u ? run_step<T, true, true> : run_step<T, true, false>)
                  : (u ? run_step<T, false, true> : run_step<T, false, false>);
  return go((T*)ndk, (float*)nwk, (float*)nk, (int*)z, (const int*)cd,
            (const int*)cw, (const int*)od, (const int*)ow, (const float*)u,
            (const int*)seeds, (const int*)offsets, (unsigned long long*)bar,
            NE, C, K, cc, d_tile, alpha, beta, vbeta, stream);
}

}  // namespace

extern "C" {

// One rotation step, in place, in one cooperative launch: ndk [*, K] (f32,
// or int16 when ndk_i16) and nwk [*, K] f32 tables, nk [K] f32 topic totals
// (receives the step's deltas), z [NE, C] int32 topics; cd/cw [NE, C] and
// od/ow [NE] int32; either u [NE, C, K] f32 uniforms or seeds [NE, 2] int32
// (the other NULL); offsets int32 [NE + 1] on the card: entry e runs chunks
// offsets[e + 1] - offsets[e]; bar one zeroed 64-bit word of scratch.
// w_tile is checked by the caller.  Returns the first CUDA error (0 on
// success); cudaErrorCooperativeLaunchTooLarge when cc blocks cannot all be
// resident.
int cgs_step(void* ndk, int ndk_i16, void* nwk, void* nk, void* z,
             const void* cd, const void* cw, const void* od, const void* ow,
             const void* u, const void* seeds, const void* offsets, void* bar,
             int NE, int C, int K, int cc, int d_tile, int w_tile,
             float alpha, float beta, float vbeta, int exact, void* stream) {
  (void)w_tile;
  auto go = ndk_i16 ? dispatch<short> : dispatch<float>;
  return (int)go(ndk, nwk, nk, z, cd, cw, od, ow, u, seeds, offsets, bar, NE,
                 C, K, cc, d_tile, alpha, beta, vbeta, exact,
                 (cudaStream_t)stream);
}

}  // extern "C"
