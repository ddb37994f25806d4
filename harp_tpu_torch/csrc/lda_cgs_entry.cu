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
// write the tables once.  This first kernel is far above that: the chunks
// are dependent (each samples against the last one's deltas, and the
// entries against each other through nk), so the step is ~48,000 launches
// of a 128-block grid, each a few microseconds of launch latency.  A
// persistent kernel or a CUDA graph over the chunk sequence is later work.
//
// Design, simple and right first:
//  - one launch per chunk: one 128-thread block per token slot; the threads
//    split the topics in groups of 4 (one Philox call a group), keep the
//    lexicographic (ratio, k) minimum, and reduce it by warp shuffles and
//    shared memory, so the winner is the lowest index among equal ratios;
//  - each block writes its token's new topic to a scratch slot, fences, and
//    counts itself done on a global counter; the last block of the launch
//    (all reads of the chunk are finished by then) applies the chunk's
//    deltas with atomics, writes z, and resets the counter;
//  - the host loop below issues the launches of one step from one C call,
//    skipping each entry's trailing all-pad chunks (the caller's plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

__device__ __forceinline__ float load_count(const float* p) { return *p; }
__device__ __forceinline__ float load_count(const short* p) {
  return (float)*p;
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
  unsigned old = *word, assumed;
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

template <typename T, bool kExact, bool kInjected>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(T* __restrict__ ndk, float* __restrict__ nwk,
             float* __restrict__ nk, int* __restrict__ z,
             const int* __restrict__ cd, const int* __restrict__ cw,
             const int* __restrict__ od, const int* __restrict__ ow,
             const float* __restrict__ u, const int* __restrict__ seeds,
             int* __restrict__ z_new, unsigned* __restrict__ done, int e,
             int j, int C, int K, int cc, int d_tile, float alpha, float beta,
             float vbeta) {
  __shared__ float s_r[kWarps];
  __shared__ int s_k[kWarps];
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int slot = j * cc + blockIdx.x;
  const long idx = (long)e * C + slot;
  const int dv = cd[idx];
  const int zo = z[idx];

  if (dv < d_tile) {  // block-uniform
    const T* drow = ndk + ((long)od[e] + dv) * K;
    const float* wrow = nwk + ((long)ow[e] + cw[idx]) * K;
    const float* urow = kInjected ? u + idx * (long)K : nullptr;
    unsigned k0 = 0, k1 = 0;
    if (!kInjected) {
      k0 = (unsigned)seeds[2 * e];
      k1 = (unsigned)seeds[2 * e + 1] ^ ((unsigned)j * kW0);
    }
    float best = INFINITY;
    int bk = K;
    for (int g = t; 4 * g < K; g += kThreads) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (!kInjected) bits = philox(make_uint4((unsigned)slot, (unsigned)g,
                                               0u, 0u), k0, k1);
      const unsigned w4[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * g + q;
        if (k < K) {
          const float old = (k == zo) ? 1.f : 0.f;
          const float a = fmaxf(__fadd_rn(__fsub_rn(
              gathered<kExact>(load_count(drow + k)), old), alpha), 1e-10f);
          const float b = fmaxf(__fadd_rn(__fsub_rn(
              gathered<kExact>(wrow[k]), old), beta), 1e-10f);
          const float c = fmaxf(__fadd_rn(__fsub_rn(nk[k], old), vbeta),
                                1e-10f);
          const float uu = kInjected ? urow[k] : to_uniform(w4[q]);
          const float r = __fdiv_rn(__fmul_rn(-logf(uu), c), __fmul_rn(a, b));
          if (r < best) {  // k rises within a thread: strict < keeps lowest
            best = r;
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
      z_new[blockIdx.x] = bk;
    }
  } else if (t == 0) {
    z_new[blockIdx.x] = zo;
  }

  // the last block of the launch applies the chunk's deltas: every other
  // block has finished its reads and published its topic by then
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = t; i < cc; i += kThreads) {
    const long id2 = (long)e * C + (long)j * cc + i;
    const int d2 = cd[id2];
    if (d2 >= d_tile) continue;
    const int zo2 = z[id2];
    const int zn2 = __ldcg(z_new + i);
    if (zn2 == zo2) continue;
    const long dr = ((long)od[e] + d2) * K;
    const long wr = ((long)ow[e] + cw[id2]) * K;
    if (zo2 >= 0 && zo2 < K) {
      add_count(ndk + dr + zo2, -1.f);
      atomicAdd(nwk + wr + zo2, -1.f);
      atomicAdd(nk + zo2, -1.f);
    }
    add_count(ndk + dr + zn2, 1.f);
    atomicAdd(nwk + wr + zn2, 1.f);
    atomicAdd(nk + zn2, 1.f);
    z[id2] = zn2;
  }
  if (t == 0) *done = 0u;
}

template <typename T, bool kExact, bool kInjected>
cudaError_t run_step(T* ndk, float* nwk, float* nk, int* z, const int* cd,
                     const int* cw, const int* od, const int* ow,
                     const float* u, const int* seeds, const int* n_chunks,
                     int* z_new, unsigned* done, int NE, int C, int K, int cc,
                     int d_tile, float alpha, float beta, float vbeta,
                     cudaStream_t stream) {
  for (int e = 0; e < NE; ++e) {
    for (int j = 0; j < n_chunks[e]; ++j) {
      chunk_kernel<T, kExact, kInjected><<<cc, kThreads, 0, stream>>>(
          ndk, nwk, nk, z, cd, cw, od, ow, u, seeds, z_new, done, e, j, C, K,
          cc, d_tile, alpha, beta, vbeta);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(void* ndk, void* nwk, void* nk, void* z, const void* cd,
                     const void* cw, const void* od, const void* ow,
                     const void* u, const void* seeds, const int* n_chunks,
                     void* z_new, void* done, int NE, int C, int K, int cc,
                     int d_tile, float alpha, float beta, float vbeta,
                     int exact, cudaStream_t stream) {
  auto go = exact ? (u ? run_step<T, true, true> : run_step<T, true, false>)
                  : (u ? run_step<T, false, true> : run_step<T, false, false>);
  return go((T*)ndk, (float*)nwk, (float*)nk, (int*)z, (const int*)cd,
            (const int*)cw, (const int*)od, (const int*)ow, (const float*)u,
            (const int*)seeds, n_chunks, (int*)z_new, (unsigned*)done, NE, C,
            K, cc, d_tile, alpha, beta, vbeta, stream);
}

}  // namespace

extern "C" {

// One rotation step, in place: ndk [*, K] (f32, or int16 when ndk_i16) and
// nwk [*, K] f32 tables, nk [K] f32 topic totals (receives the step's
// deltas), z [NE, C] int32 topics; cd/cw [NE, C] and od/ow [NE] int32;
// either u [NE, C, K] f32 uniforms or seeds [NE, 2] int32 (the other NULL);
// n_chunks int32 [NE] (HOST): chunks each entry runs; z_new int32 [cc] and
// done (one zeroed word) are scratch.  w_tile is checked by the caller.
// Returns the first CUDA error (0 on success).
int cgs_step(void* ndk, int ndk_i16, void* nwk, void* nk, void* z,
             const void* cd, const void* cw, const void* od, const void* ow,
             const void* u, const void* seeds, const void* n_chunks,
             void* z_new, void* done, int NE, int C, int K, int cc,
             int d_tile, int w_tile, float alpha, float beta, float vbeta,
             int exact, void* stream) {
  (void)w_tile;
  auto go = ndk_i16 ? dispatch<short> : dispatch<float>;
  return (int)go(ndk, nwk, nk, z, cd, cw, od, ow, u, seeds,
                 (const int*)n_chunks, z_new, done, NE, C, K, cc, d_tile,
                 alpha, beta, vbeta, exact, (cudaStream_t)stream);
}

}  // extern "C"
