// K8: blockwise online-softmax attention for Hopper (sm_90a).
//
// Replaces harp_tpu/ops/flash_attention.py::flash_attention (Pallas body
// _flash_kernel).  On folded rows q, k, v [BH, N, D] (f32 or bf16), per row
// bh and query i:
//   s_ij = scale * (q_i . k_j)            (f32 sum, scaled after the dot)
//   keep_ij = [causal: i - j >= 0] & [window: i - j < W causal, |i - j| < W
//             otherwise]
//   o_i = sum_j softmax_j(s_ij masked) v_j, by the online softmax:
//   alpha = m_prev > -inf ? exp(m_prev - m_new) : 0, p = kept ? exp(s - m_new)
//   : 0, l = l * alpha + sum p, acc = acc * alpha + cast_v(p) . v, and
//   o = acc / max(l, 1e-30) in q's dtype.  p is rounded to V's dtype before
//   the p.v product (so a bf16 run rounds it to bf16), l sums p unrounded.
//
// Bound on this card: operations.  At [32, 8192, 128] causal the two
// products take 4 * 128 flops for each of 33,558,528 (query, key) pairs a
// row: 5.50e11 flops, 0.556 ms at the bf16 tensor rate (989 TFLOP/s) and
// 8.2 ms at the f32 rate of the CUDA cores (67 TFLOP/s); reading q, k, v
// and writing o once is 268 MB (bf16) or 537 MB (f32), 0.08 / 0.16 ms.
//
// Design (simple kernels first; wgmma, TMA and warp specialisation later):
//  - On the TPU the K sweep is the innermost, sequential grid axis and m, l
//    and acc persist in VMEM scratch.  Here one block owns one (row bh,
//    64-query tile) and loops over the K tiles itself, with m, l and acc in
//    registers.  Heavy causal tiles are launched first.
//  - The skipping rule becomes the loop's bounds: the first and last
//    64-key tile that can hold a kept key for some query of the tile.  The
//    per-element mask runs only on tiles that are not kept whole.
//  - bf16 with D in {16, 32, 64, 128} (mma_kernel): both products on the
//    tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Four
//    warps, 16 query rows each; the warp keeps its Q fragments, the 16 x 64
//    score tile and its 16 x D output in registers.  The score fragments
//    become the P operand of the second product in place (the accumulator
//    layout of m16n8 is the A layout of m16k16), rounded to bf16.  V is
//    stored transposed in shared memory, so each B fragment is one 32-bit
//    load; all row pitches stagger the banks.
//  - f32, and bf16 at other D (simt_kernel): both products with f32 FMAs on
//    the CUDA cores, so the f32 arm keeps full f32 accuracy (no TF32).  256
//    threads as 16 x 16: a thread owns query rows ty + 16 i (i < 4), score
//    columns tx + 16 j (j < 4) and output columns tx + 16 c (c < NC); the
//    16 threads of a row sit in one half-warp and reduce its max and sum by
//    xor shuffles.  Q, K, V and P tiles live in shared memory as f32 with
//    an odd row pitch.  D is any multiple of 8 up to 256 (16-byte row
//    loads), in four instantiations by the output columns a thread holds.
//  - N need not be a multiple of 64: rows past N load as zeros, are masked
//    as keys and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 256;

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [row0, row0 + R) of a contiguous [N, D] matrix into sX (pitch ld) as
// f32; rows past N are zero.  16-byte global loads (D % 8 == 0).
template <typename T>
__device__ __forceinline__ void load_tile(float* sX, const T* g, int row0,
                                          int R, int N, int D, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int e = threadIdx.x; e < R * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * kVec;
    float* dst = sX + r * ld + c;
    if (row0 + r < N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          g + (size_t)(row0 + r) * D + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = widen<T>(vals[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[u] = 0.f;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1));
}

// the keys [lo, hi] that can be kept for some query of [q0, q_last]
__device__ __forceinline__ void key_range(int q0, int q_last, int N,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = N - 1;
  if (causal) hi = q_last;
  if (window > 0) {
    lo = max(0, q0 - window + 1);
    if (!causal) hi = min(N - 1, q_last + window - 1);
  }
}

// is every (query, key) pair of the tile [q0, q_last] x [k0, k0 + kBK)
// kept?  Only the other tiles run the per-element mask.
__device__ __forceinline__ bool whole_tile(int q0, int q_last, int k0, int N,
                                           int causal, int window) {
  const int k_last = k0 + kBK - 1;
  bool whole = k_last < N;
  if (causal) whole = whole && k_last <= q0;
  if (window > 0)
    whole = whole && (causal ? q_last - k0 < window
                             : max(q_last - k0, k_last - q0) < window);
  return whole;
}

__device__ __forceinline__ bool kept(int qp, int kp, int N, int causal,
                                     int window) {
  const int dl = qp - kp;
  bool keep = kp < N;
  if (causal) keep = keep && dl >= 0;
  if (window > 0) keep = keep && (causal ? dl < window : abs(dl) < window);
  return keep;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int N, int D,
             float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ld = D + 1, ldp = kBK + 1;
  float* sQ = smem;
  float* sK = sQ + kBQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * ld;

  const int bh = blockIdx.y;
  // causal tiles grow with the query index: launch the heavy ones first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, N) - 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * N * D;

  int lo, hi;
  key_range(q0, q_last, N, causal, window, lo, hi);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  load_tile<T>(sQ, q + base, q0, kBQ, N, D, ld);
  for (int kt = lo / kBK; kt <= hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads of sK, sV and sP are done
    load_tile<T>(sK, k + base, k0, kBK, N, D, ld);
    load_tile<T>(sV, v + base, k0, kBK, N, D, ld);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    const bool whole = whole_tile(q0, q_last, k0, N, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * scale;
        s[i][j] = whole || kept(q0 + ty + 16 * i, k0 + tx + 16 * j, N,
                                causal, window)
                      ? x
                      : -INFINITY;
      }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mb = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float mn = fmaxf(m[i], half_warp_max(mb));
      const float alpha = m[i] > -INFINITY ? expf(m[i] - mn) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > -INFINITY ? expf(s[i][j] - mn) : 0.f;
        ps += p;
        sP[(ty + 16 * i) * ldp + tx + 16 * j] = widen<T>(narrow<T>(p));
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? sV[kk * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= N) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[base + (size_t)qp * D + col] = narrow<T>(acc[i][c] / den);
    }
  }
}


// ---- bf16 on the tensor cores ------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 query rows each

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as a bf16 pair in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBQ + kBK) * (D + 8) + (size_t)D * (kBK + 8));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           int N, float scale, int causal, int window) {
  constexpr int KD = D / 16;     // 16-wide chunks of the head dim
  constexpr int ND = D / 8;      // 8-wide output column tiles
  constexpr int CPR = D / 8;     // 16-byte chunks a row
  constexpr int LDQ = D + 8;     // pitch of sQ and sK (bf16)
  constexpr int LDV = kBK + 8;   // pitch of the transposed sVt (bf16)
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* sK = sQ + kBQ * LDQ;
  __nv_bfloat16* sVt = sK + kBK * LDQ;

  const int bh = blockIdx.y;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, N) - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t base = (size_t)bh * N * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int lo, hi;
  key_range(q0, q_last, N, causal, window, lo, hi);

  for (int e = tid; e < kBQ * CPR; e += kMmaThreads) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) =
        q0 + r < N ? *reinterpret_cast<const uint4*>(q + base +
                                                     (size_t)(q0 + r) * D + c)
                   : zero;
  }
  __syncthreads();
  // this warp's rows of Q as A fragments: rows gid and gid + 8 of its 16
  const int r0 = warp * 16 + gid;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const __nv_bfloat16* p0 = sQ + r0 * LDQ + kd * 16 + tig * 2;
    qa[kd][0] = ld32(p0);
    qa[kd][1] = ld32(p0 + 8 * LDQ);
    qa[kd][2] = ld32(p0 + 8);
    qa[kd][3] = ld32(p0 + 8 * LDQ + 8);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int kt = lo / kBK; kt <= hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads of sK and sVt are done
    for (int e = tid; e < kBK * CPR; e += kMmaThreads) {
      const int r = e / CPR, c = (e - r * CPR) * 8;
      *reinterpret_cast<uint4*>(sK + r * LDQ + c) =
          k0 + r < N ? *reinterpret_cast<const uint4*>(
                           k + base + (size_t)(k0 + r) * D + c)
                     : zero;
    }
    // V transposed: consecutive threads take consecutive keys, so the
    // 2-byte stores of a warp land in distinct banks
    for (int e = tid; e < kBK * CPR; e += kMmaThreads) {
      const int r = e % kBK, c = (e / kBK) * 8;
      const uint4 raw = k0 + r < N ? *reinterpret_cast<const uint4*>(
                                         v + base + (size_t)(k0 + r) * D + c)
                                   : zero;
      const __nv_bfloat16* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) sVt[(c + u) * LDV + r] = vals[u];
    }
    __syncthreads();

    // S = Q K^T: the warp's 16 x 64 tile as eight 16 x 8 accumulators
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + gid) * LDQ + kd * 16 + tig * 2;
        mma_bf16(s[nt], qa[kd], ld32(kp), ld32(kp + 8));
      }

    const bool whole = whole_tile(q0, q_last, k0, N, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e] * scale;
        s[nt][e] = whole || kept(q0 + r0 + (e >> 1) * 8,
                                 k0 + nt * 8 + tig * 2 + (e & 1), N, causal,
                                 window)
                       ? x
                       : -INFINITY;
      }

    // the online softmax of rows gid (rr = 0) and gid + 8 (rr = 1); the 4
    // lanes of a group share the row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mb = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mb = fmaxf(mb, fmaxf(s[nt][2 * rr], s[nt][2 * rr + 1]));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      const float mn = fmaxf(m[rr], mb);
      const float alpha = m[rr] > -INFINITY ? expf(m[rr] - mn) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const float p = s[nt][e] > -INFINITY ? expf(s[nt][e] - mn) : 0.f;
          s[nt][e] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mn;
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        acc[dt][2 * rr] *= alpha;
        acc[dt][2 * rr + 1] *= alpha;
      }
    }

    // O += P V, 16 keys at a time: score tiles 2kc and 2kc + 1 are the A
    // fragment of P
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        const __nv_bfloat16* vp = sVt + (dt * 8 + gid) * LDV + kc * 16 + tig * 2;
        mma_bf16(acc[dt], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qp = q0 + r0 + rr * 8;
    if (qp >= N) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)qp * D + dt * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(acc[dt][2 * rr] / den,
                                acc[dt][2 * rr + 1] / den);
  }
}

template <int D>
cudaError_t allow_mma_smem() {
  return cudaFuncSetAttribute(mma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)mma_smem_bytes<D>());
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
                int n, float scale, int causal, int window, cudaStream_t s) {
  const dim3 grid((n + kBQ - 1) / kBQ, bh);
  mma_kernel<D><<<grid, kMmaThreads, mma_smem_bytes<D>(), s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, n, scale, causal, window);
}

// ---- launch ---------------------------------------------------------------------

template <typename T, int NC>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(simt_kernel<T, NC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int NC>
void launch(const void* q, const void* k, const void* v, void* o, int bh,
            int n, int d, float scale, int causal, int window,
            cudaStream_t s) {
  const dim3 grid((n + kBQ - 1) / kBQ, bh);
  simt_kernel<T, NC><<<grid, kThreads, smem_bytes(d), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, d, scale, causal,
      window);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, void* o, int bh,
              int n, int d, float scale, int causal, int window,
              cudaStream_t s) {
  if (d <= 32)
    launch<T, 2>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else if (d <= 64)
    launch<T, 4>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else if (d <= 128)
    launch<T, 8>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else
    launch<T, 16>(q, k, v, o, bh, n, d, scale, causal, window, s);
}

}  // namespace

extern "C" {

// Once per card (the wrapper keeps the answer): lets every instantiation
// take the shared memory it needs (the SIMT one that of the largest head
// dim).
int flash_attention_plan(void) {
  const int bytes = (int)smem_bytes(kMaxD);
  cudaError_t err;
  if ((err = allow_smem<float, 2>(bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem<float, 4>(bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem<float, 8>(bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem<float, 16>(bytes)) != cudaSuccess) return (int)err;
  if ((err = allow_smem<__nv_bfloat16, 2>(bytes)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem<__nv_bfloat16, 4>(bytes)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem<__nv_bfloat16, 8>(bytes)) != cudaSuccess)
    return (int)err;
  if ((err = allow_smem<__nv_bfloat16, 16>(bytes)) != cudaSuccess)
    return (int)err;
  if ((err = allow_mma_smem<16>()) != cudaSuccess) return (int)err;
  if ((err = allow_mma_smem<32>()) != cudaSuccess) return (int)err;
  if ((err = allow_mma_smem<64>()) != cudaSuccess) return (int)err;
  if ((err = allow_mma_smem<128>()) != cudaSuccess) return (int)err;
  return 0;
}

// q, k, v, o: [bh, n, d] contiguous, 16-byte aligned, f32 (is_bf16 = 0) or
// bf16 (1); d a multiple of 8 in [8, 256]; window 0 means none.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bh, int n, int d, float scale, int causal,
                        int window, int is_bf16, void* stream) {
  if (bh < 1 || n < 1 || d < 8 || d > kMaxD || d % 8 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && d == 16)
    launch_mma<16>(q, k, v, o, bh, n, scale, causal, window, s);
  else if (is_bf16 && d == 32)
    launch_mma<32>(q, k, v, o, bh, n, scale, causal, window, s);
  else if (is_bf16 && d == 64)
    launch_mma<64>(q, k, v, o, bh, n, scale, causal, window, s);
  else if (is_bf16 && d == 128)
    launch_mma<128>(q, k, v, o, bh, n, scale, causal, window, s);
  else if (is_bf16)
    launch_d<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else
    launch_d<float>(q, k, v, o, bh, n, d, scale, causal, window, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
