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
// Every path: one block owns one (row bh, query tile) and loops over the
// key tiles (64 keys; on the wgmma path 128 at D = 64, 96 at D = 128) that
// the mask can reach for some query of the tile (key_range), with m, l and
// acc in registers; on the TPU the K sweep is the innermost, sequential
// grid axis with m, l and acc in VMEM scratch.  Heavy causal tiles launch
// first.  Only tiles not kept whole (whole_tile) run the per-element mask.
// Rows past N load as zeros, are masked as keys and are never stored.
// Two paths, by dtype and D (flash_attention_path):
//
//  - bf16, D in {64, 128} (wgmma_kernel): 128-query tiles, two consumer
//    warpgroups of 64 query rows and a producer warpgroup that hands its
//    registers to them (setmaxnreg).  The producer loads Q once and keeps
//    K and V tiles in flight by TMA, over a 3-D [BH, N, D] tensor map
//    (rows past N zero-fill within the head), into a ring of kStages
//    stages in shared memory with full/empty mbarriers, 128-byte
//    swizzled.  A tile is 128 keys at D = 64, 96 at D = 128 (registers).
//    S = Q K^T is wgmma m64n{128|96}k16 with both operands read from
//    shared memory (K-major); the online softmax runs on the accumulator
//    registers, in log2 units with the scale folded into one multiply
//    (ex2.approx); P is rounded to bf16 in registers and is the A operand
//    of O += P V, wgmma m64nDk16, with V read in its natural row-major
//    layout through the descriptor's transpose bit.  Tile i's P V runs on
//    the tensor cores while tile i + 1's scores go through the softmax,
//    and the two warpgroups take turns on the tensor cores (named
//    barriers), so one's softmax runs under the other's products; both
//    run every tile of the block (one the mask keeps off a warpgroup's
//    rows is an exact no-op for it).
//  - f32, and bf16 at any other D (simt_kernel): both products as f32 FMAs
//    on the CUDA cores (no TF32: the reference's gate is rtol 2e-4).  256
//    threads as 16 x 16; a thread owns RQ query rows (ty + 16 i) and 4 key
//    columns (tx + 16 j) of the score tile, and 4 * DC output columns
//    (64 h + 4 tx + c).  Q and K stay row-major in shared memory at a pitch
//    of D + 4 floats, so the 16-byte loads of a quarter-warp fall in
//    distinct banks; each loaded float4 feeds 4 to 8 FMAs.  P goes through
//    shared memory once per tile (pitch 80: the two half-warps' rows sit 16
//    banks apart).  The softmax works in log2 units (ex2.approx).  f32
//    tiles arrive by cp.async: K of the next tile loads during p.v, V of
//    the next tile during q.k; three block barriers a tile.  RQ = 8 (128
//    queries) up to D = 128, else RQ = 4 (64 queries), so the tiles fit in
//    shared memory; D 64 and 128 are fixed at compile time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// is every (query, key) pair of the tile [q0, q_last] x [k0, k0 + BK)
// kept?  Only the other tiles run the per-element mask.
template <int BK = kBK>
__device__ __forceinline__ bool whole_tile(int q0, int q_last, int k0, int N,
                                           int causal, int window) {
  const int k_last = k0 + BK - 1;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 2^x by the special-function unit (relative error ~2^-22): the softmax
// works in log2 units, with log2(e) folded into the scale
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- f32 (and bf16 at other D) on the CUDA cores ---------------------------

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + R) of a contiguous [N, D] matrix into sX (pitch ld) as
// f32; rows past N are zero.  f32 by cp.async (the caller commits and
// waits), bf16 by 16-byte loads widened on the way.
template <typename T>
__device__ __forceinline__ void load_rows(float* sX, const T* g, int row0,
                                          int R, int N, int D, int ld) {
  if constexpr (std::is_same<T, float>::value) {
    const int per_row = D / 4;
    for (int e = threadIdx.x; e < R * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const bool ok = row0 + r < N;
      cp_async16(sX + r * ld + c, g + (size_t)(ok ? row0 + r : 0) * D + c,
                 ok);
    }
  } else {
    const int per_row = D / 8;
    for (int e = threadIdx.x; e < R * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * 8;
      float* dst = sX + r * ld + c;
      if (row0 + r < N) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            g + (size_t)(row0 + r) * D + c);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) dst[u] = widen<T>(vals[u]);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) dst[u] = 0.f;
      }
    }
  }
}

constexpr int kLDP = kBK + 16;  // pitch of sP

template <int RQ, int DC>
size_t simt_smem_bytes(int D) {
  const size_t ld = D + 4, ldv = 64 * DC + 4;
  return sizeof(float) *
         ((16 * RQ + kBK) * ld + kBK * ldv + (size_t)16 * RQ * kLDP);
}

// kD > 0 fixes the head dim at compile time (D = 64 DC, the main
// shapes), so the product loops unroll into a schedule that loads ahead
template <typename T, int RQ, int DC, int kD>
__global__ void __launch_bounds__(kThreads, 1)
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int N, int d_arg,
            float scale, int causal, int window) {
  const int D = kD > 0 ? kD : d_arg;
  constexpr int BQ = 16 * RQ;
  constexpr int LDV = 64 * DC + 4;
  extern __shared__ float4 smem_simt[];
  const int ld = D + 4;
  float* sQ = reinterpret_cast<float*>(smem_simt);
  float* sK = sQ + BQ * ld;
  float* sV = sK + kBK * ld;
  float* sP = sV + kBK * LDV;

  const int bh = blockIdx.y;
  // causal tiles grow with the query index: launch the heavy ones first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, N) - 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t base = (size_t)bh * N * D;

  int lo, hi;
  key_range(q0, q_last, N, causal, window, lo, hi);
  const int kt_end = hi / kBK;
  // scores in log2 units: p = 2^(s * scale * log2(e) - m)
  const float sl2 = scale * 1.4426950408889634f;

  // V's columns [D, 64 DC) stay zero: no load writes them
  const int pad = 64 * DC - D;
  for (int e = tid; e < kBK * pad; e += kThreads)
    sV[(e / pad) * LDV + D + e % pad] = 0.f;

  float m[RQ], l[RQ], acc[RQ][4 * DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
  }

  // groups in flight: Q, K(lo), V(lo); then K(t + 1) and V(t + 1) in turn
  load_rows<T>(sQ, q + base, q0, BQ, N, D, ld);
  cp_async_commit();
  load_rows<T>(sK, k + base, (lo / kBK) * kBK, kBK, N, D, ld);
  cp_async_commit();
  load_rows<T>(sV, v + base, (lo / kBK) * kBK, kBK, N, D, LDV);
  cp_async_commit();

  for (int kt = lo / kBK; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait_all_but_one();  // Q and K(kt) have landed
    __syncthreads();

    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * ld + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }
    const bool whole = whole_tile(q0, q_last, k0, N, causal, window);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * sl2;
        s[i][j] = whole || kept(q0 + ty + 16 * i, k0 + tx + 16 * j, N,
                                causal, window)
                      ? x
                      : -INFINITY;
        mb = fmaxf(mb, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mb));
      const float alpha = m[i] > -INFINITY ? exp2_approx(m[i] - mn) : 0.f;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > -INFINITY ? exp2_approx(s[i][j] - mn) : 0.f;
        ps += p;
        sP[(ty + 16 * i) * kLDP + tx + 16 * j] = widen<T>(narrow<T>(p));
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait_all();  // V(kt) has landed
    __syncthreads();      // ... sP is written, and every read of sK done
    if (kt < kt_end)
      load_rows<T>(sK, k + base, k0 + kBK, kBK, N, D, ld);
    cp_async_commit();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        p[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * kLDP +
                                                kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[DC];
#pragma unroll
        for (int h = 0; h < DC; ++h)
          vv[h] = *reinterpret_cast<const float4*>(sV + (kk + u) * LDV +
                                                   64 * h + 4 * tx);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y
                         : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int h = 0; h < DC; ++h) {
            acc[i][4 * h] = fmaf(pu, vv[h].x, acc[i][4 * h]);
            acc[i][4 * h + 1] = fmaf(pu, vv[h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(pu, vv[h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(pu, vv[h].w, acc[i][4 * h + 3]);
          }
        }
      }
    }
    __syncthreads();  // every read of sV and sP is done
    if (kt < kt_end)
      load_rows<T>(sV, v + base, k0 + kBK, kBK, N, D, LDV);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= N) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int h = 0; h < DC; ++h) {
      const int col = 64 * h + 4 * tx;
      if (col >= D) continue;  // D % 8 == 0: all four columns or none
      T* dst = o + base + (size_t)qp * D + col;
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h] / den, acc[i][4 * h + 1] / den,
                        acc[i][4 * h + 2] / den, acc[i][4 * h + 3] / den);
      } else {
        reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(
            acc[i][4 * h] / den, acc[i][4 * h + 1] / den);
        reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(
            acc[i][4 * h + 2] / den, acc[i][4 * h + 3] / den);
      }
    }
  }
}

// ---- bf16 at D in {64, 128}: wgmma fed by TMA ------------------------------

// two f32 as a bf16 pair in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kWgBQ = 128;  // queries a block: two warpgroups of 64
// two consumer warpgroups and a producer warpgroup, whose first lane
// issues the copies.  Registers go by warpgroup; the producer gives its
// back at run time (setmaxnreg), though ptxas still compiles each thread
// to 168 (with it the D = 64 kernel measured ~5 % faster on an H100 80GB
// HBM3 at 700 W)
constexpr int kWgThreads = 3 * 128;

// D / 64 panels of [rows x 64] bf16, 128 bytes a row, 128-byte swizzled.
// kBK keys a tile: 128 at D = 64; 96 at D = 128, where a thread's scores,
// P and O of 128-key tiles do not fit the 168 registers ptxas gives each
// thread of three warpgroups (it spills, and serializes the products).
// kStages K and V tiles in flight.
template <int D>
struct WgLayout {
  static constexpr int kPanels = D / 64;
  static constexpr int kBK = D == 128 ? 96 : 128;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kWgBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes;
};

template <int D>
size_t wgmma_smem_bytes() {
  return WgLayout<D>::kBytes + 1024;  // + slack to align the base to 1024
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity; a phase
// that never completes (a copy that never lands) traps after ~10 s instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000ll) __trap();
  } while (!done);
}

// one [rows x 64] box of a [BH, N, D] bf16 tensor, at (col, row, bh)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int bh,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bh),
      "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// named barrier `id` over the 256 consumer threads: sync waits for the
// other warpgroup's arrive
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// every committed group but the newest N has completed
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}


// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 96] (+)= A[64 x 16] B[16 x 96], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major (V's
// row-major [16 x 64]) in shared memory: the transpose bit
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major (V's
// row-major [16 x 128]) in shared memory: the transpose bit
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s(float (&acc)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_s<96>(float (&acc)[48], uint64_t da,
                                            uint64_t db, int scale_d) {
  wgmma_ss_n96(acc, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_s<128>(float (&acc)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n128(acc, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(acc, a, db);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, int N, float scale, int causal,
             int window) {
  using L = WgLayout<D>;
  constexpr int kStages = L::kStages, kWgBK = L::kBK;
  constexpr int ND = D / 8;  // 8-wide output column blocks
  extern __shared__ uint8_t smem_wg[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t base = (smem_u32(smem_wg) + 1023) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + kStages + s]); };
  auto k_empty = [&](int s) { return smem_u32(&bars[1 + 2 * kStages + s]); };
  auto v_empty = [&](int s) { return smem_u32(&bars[1 + 3 * kStages + s]); };

  const int bh = blockIdx.y;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kWgBQ;
  int lo, hi;
  key_range(q0, min(q0 + kWgBQ, N) - 1, N, causal, window, lo, hi);
  const int kt_lo = lo / kWgBK, kt_hi = hi / kWgBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 256);
      mbar_init(v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // the producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + L::kQ + p * kWgBQ * 128, &tq, 64 * p, q0, bh, q_full);
      for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) - 1) & 1;
        const uint32_t dk = base + L::kK + s * L::kTileBytes;
        const uint32_t dv = base + L::kV + s * L::kTileBytes;
        if (i >= kStages) mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(dk + p * kWgBK * 128, &tk, 64 * p, kt * kWgBK, bh,
                   k_full(s));
        if (i >= kStages) mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), L::kTileBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load(dv + p * kWgBK * 128, &tv, 64 * p, kt * kWgBK, bh,
                   v_full(s));
      }
    }
  } else {  // a consumer warpgroup: query rows [q0w, q0w + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const int q0w = q0 + 64 * wg;
    const int q_last = min(q0w + 64, N) - 1;
    const int r0 = 16 * warp + (lane >> 2);  // rows r0 and r0 + 8 of the 64
    const int c0 = 2 * (lane & 3);           // columns c0, c0 + 1 of each 8
    const uint32_t q_tile = base + L::kQ + wg * 64 * 128;
    // scores in log2 units: p = 2^(s * scale * log2(e) - m)
    const float sl2 = scale * 1.4426950408889634f;
    // both warpgroups run every tile of the block: a tile the mask keeps
    // off a warpgroup's rows is an exact no-op of its recurrence (p = 0,
    // alpha = 1), and equal counts let the two take turns (below)
    const int n_tiles = kt_hi - kt_lo + 1;
    // S = Q K^T of tile i into sc: D / 16 steps of k16; a step inside a
    // 128-byte row moves the start by 32 bytes, past it to the next panel
    constexpr int NS = kWgBK / 2;  // score registers a thread
    float sc[NS];
    auto issue_s = [&](int i) {
      const uint32_t k_tile = base + L::kK + (i % kStages) * L::kTileBytes;
      mbar_wait(k_full(i % kStages), (i / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_s<kWgBK>(
            sc, smem_desc(q_tile + (kk / 4) * kWgBQ * 128 + off, 16, 1024),
            smem_desc(k_tile + (kk / 4) * kWgBK * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    // the online softmax of tile i's scores in sc, in place: sc becomes p;
    // m and l move on, alpha is what acc must be scaled by.  Element e is
    // row r0 + 8 ((e >> 1) & 1), key 8 (e >> 2) + c0 + (e & 1) of the tile.
    auto softmax = [&](int i) {
      const int k0 = (kt_lo + i) * kWgBK;
#pragma unroll
      for (int e = 0; e < NS; ++e) sc[e] *= sl2;
      if (!whole_tile<kWgBK>(q0w, q_last, k0, N, causal, window)) {
#pragma unroll
        for (int e = 0; e < NS; ++e)
          if (!kept(q0w + r0 + ((e >> 1) & 1) * 8,
                    k0 + 8 * (e >> 2) + c0 + (e & 1), N, causal, window))
            sc[e] = -INFINITY;
      }
      // rows r0 (rr = 0) and r0 + 8 (rr = 1); a quad of lanes shares a row
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mb = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NS / 4; ++nt)
          mb = fmaxf(mb, fmaxf(sc[4 * nt + 2 * rr], sc[4 * nt + 2 * rr + 1]));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
        const float mn = fmaxf(m[rr], mb);
        alpha[rr] = m[rr] > -INFINITY ? exp2_approx(m[rr] - mn) : 0.f;
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS / 4; ++nt)
#pragma unroll
          for (int e = 4 * nt + 2 * rr; e < 4 * nt + 2 * rr + 2; ++e) {
            const float p = sc[e] > -INFINITY ? exp2_approx(sc[e] - mn) : 0.f;
            sc[e] = p;
            ps += p;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[rr] = l[rr] * alpha[rr] + ps;
        m[rr] = mn;
      }
    };
    // P as the A operand, rounded to bf16: score blocks 2kc and 2kc + 1 are
    // keys [16 kc, 16 kc + 16), in the m16k16 fragment order
    uint32_t pa[kWgBK / 16][4];
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < kWgBK / 16; ++kc) {
        pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
        pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
      }
    };
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    // O += P V of tile i: V row-major, 16 keys are 2 KB of a panel, the
    // next 64 columns one panel (kWgBK * 128 bytes) on
    auto issue_pv = [&](int i) {
      const uint32_t v_tile = base + L::kV + (i % kStages) * L::kTileBytes;
      mbar_wait(v_full(i % kStages), (i / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kWgBK / 16; ++kc)
        wgmma_pv<D>(acc, pa[kc],
                    smem_desc(v_tile + kc * 16 * 128, kWgBK * 128, 1024));
      wgmma_commit();
    };

    // The warpgroups take turns to issue their products (named barriers 1
    // and 2, FA3's ping-pong): one's softmax runs while the other's
    // products hold the tensor cores.  Warpgroup 0 goes first.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    named_sync(my_turn);
    issue_s(0);
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    softmax(0);
    pack_p();
    // tile i's O += P V runs on the tensor cores while tile i + 1's scores
    // go through the softmax.  No branch between a commit and its wait, so
    // the compiler can see which group each wait retires.
    for (int i = 0; i + 1 < n_tiles; ++i) {
      named_sync(my_turn);
      issue_s(i + 1);
      issue_pv(i);
      named_arrive(their_turn);
      wgmma_wait<1>();  // the scores of tile i + 1 (committed first)
      fence_regs(sc);
      mbar_arrive(k_empty((i + 1) % kStages));
      softmax(i + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(v_empty(i % kStages));
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        acc[4 * dt] *= alpha[0];
        acc[4 * dt + 1] *= alpha[0];
        acc[4 * dt + 2] *= alpha[1];
        acc[4 * dt + 3] *= alpha[1];
      }
      pack_p();
    }
    named_sync(my_turn);
    issue_pv(n_tiles - 1);
    // warpgroup 0 has no turn left for warpgroup 1 to hand over
    if (wg == 0) named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(v_empty((n_tiles - 1) % kStages));

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qp = q0w + r0 + rr * 8;
      if (qp >= N) continue;
      const float den = fmaxf(l[rr], 1e-30f);
      __nv_bfloat16* dst = o + ((size_t)bh * N + qp) * D + c0;
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * dt) =
            __floats2bfloat162_rn(acc[4 * dt + 2 * rr] / den,
                                  acc[4 * dt + 2 * rr + 1] / den);
    }
  }  // the roles never meet again: setmaxnreg holds only so
}

template <typename T, int RQ, int DC, int kD = 0>
cudaError_t allow_simt_smem() {
  return cudaFuncSetAttribute(simt_kernel<T, RQ, DC, kD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)simt_smem_bytes<RQ, DC>(64 * DC));
}

template <typename T, int RQ, int DC, int kD = 0>
void launch_simt(const void* q, const void* k, const void* v, void* o,
                 int bh, int n, int d, float scale, int causal, int window,
                 cudaStream_t s) {
  const dim3 grid((n + 16 * RQ - 1) / (16 * RQ), bh);
  simt_kernel<T, RQ, DC, kD>
      <<<grid, kThreads, simt_smem_bytes<RQ, DC>(d), s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n, d, scale, causal,
      window);
}

template <typename T>
void launch_simt_d(const void* q, const void* k, const void* v, void* o,
                   int bh, int n, int d, float scale, int causal, int window,
                   cudaStream_t s) {
  if (std::is_same<T, float>::value && d == 64)
    launch_simt<T, 8, 1, 64>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else if (std::is_same<T, float>::value && d == 128)
    launch_simt<T, 8, 2, 128>(q, k, v, o, bh, n, d, scale, causal, window,
                              s);
  else if (d <= 64)
    launch_simt<T, 8, 1>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else if (d <= 128)
    launch_simt<T, 8, 2>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else if (d <= 192)
    launch_simt<T, 4, 3>(q, k, v, o, bh, n, d, scale, causal, window, s);
  else
    launch_simt<T, 4, 4>(q, k, v, o, bh, n, d, scale, causal, window, s);
}

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so the library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a [BH, N, D] bf16 tensor in boxes of [rows x 64], 128-byte swizzled;
// rows past N (within a head) read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d,
              int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t allow_wgmma_smem() {
  return cudaFuncSetAttribute(wgmma_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)wgmma_smem_bytes<D>());
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int bh, int n, float scale, int causal,
                         int window, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, n, D, kWgBQ) ||
      !make_map(&tk, k, bh, n, D, WgLayout<D>::kBK) ||
      !make_map(&tv, v, bh, n, D, WgLayout<D>::kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((n + kWgBQ - 1) / kWgBQ, bh);
  wgmma_kernel<D><<<grid, kWgThreads, wgmma_smem_bytes<D>(), s>>>(
      tq, tk, tv, (__nv_bfloat16*)o, n, scale, causal, window);
  return cudaSuccess;
}

// the path a (dtype, D) takes: 0 simt_kernel, 1 wgmma_kernel
int path_of(int d, int is_bf16) { return is_bf16 && (d == 64 || d == 128); }

}  // namespace

extern "C" {

// Once per card (the wrapper keeps the answer): lets every instantiation
// take the shared memory it needs, and finds the tensor-map encoder.
int flash_attention_plan(void) {
  cudaError_t err;
#define FA_TRY(x) \
  if ((err = (x)) != cudaSuccess) return (int)err
  FA_TRY((allow_simt_smem<float, 8, 1, 64>()));
  FA_TRY((allow_simt_smem<float, 8, 2, 128>()));
  FA_TRY((allow_simt_smem<float, 8, 1>()));
  FA_TRY((allow_simt_smem<float, 8, 2>()));
  FA_TRY((allow_simt_smem<float, 4, 3>()));
  FA_TRY((allow_simt_smem<float, 4, 4>()));
  FA_TRY((allow_simt_smem<__nv_bfloat16, 8, 1>()));
  FA_TRY((allow_simt_smem<__nv_bfloat16, 8, 2>()));
  FA_TRY((allow_simt_smem<__nv_bfloat16, 4, 3>()));
  FA_TRY((allow_simt_smem<__nv_bfloat16, 4, 4>()));
  FA_TRY(allow_wgmma_smem<64>());
  FA_TRY(allow_wgmma_smem<128>());
#undef FA_TRY
  return encode_tiled() ? 0 : (int)cudaErrorSymbolNotFound;
}

// 0 simt_kernel (CUDA cores, f32 FMAs), 1 wgmma_kernel (wgmma fed by TMA)
int flash_attention_path(int d, int is_bf16) { return path_of(d, is_bf16); }

// q, k, v, o: [bh, n, d] contiguous, 16-byte aligned, f32 (is_bf16 = 0) or
// bf16 (1); d a multiple of 8 in [8, 256]; window 0 means none.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int bh, int n, int d, float scale, int causal,
                        int window, int is_bf16, void* stream) {
  if (bh < 1 || n < 1 || d < 8 || d > kMaxD || d % 8 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  switch (path_of(d, is_bf16)) {
    case 1:
      err = d == 64 ? launch_wgmma<64>(q, k, v, o, bh, n, scale, causal,
                                        window, s)
                    : launch_wgmma<128>(q, k, v, o, bh, n, scale, causal,
                                        window, s);
      break;
    default:
      if (is_bf16)
        launch_simt_d<__nv_bfloat16>(q, k, v, o, bh, n, d, scale, causal,
                                     window, s);
      else
        launch_simt_d<float>(q, k, v, o, bh, n, d, scale, causal, window, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
