// Shared body of K1 (kmeans_partials_int8.cu) and K2 (kmeans_partials.cu):
// fused KMeans partials on Hopper's tensor cores.  Each source's head note
// states its bound and design; this header holds what the two share.
//
// The point tile and the centroids sit in shared memory as rows of bytes
// (int8, or bf16 pairs) at a stride of whole 32-byte MMA k-steps plus 16
// bytes: an odd number of 16-byte units, so the eight row addresses of an
// ldmatrix fall in distinct banks.  Both operands are K-major, so one
// ldmatrix layout feeds mma.sync m16n8k16 bf16 (K2) and m16n8k32 s8 (K1):
// a k-step is 32 bytes either way.
//
// main_kernel: a persistent grid of one block (8 warps) a SM; a block takes
// tiles of 16 * mt points (grid-stride).  A tile's points are one
// contiguous run, fetched by one 1-D bulk copy (cp.async.bulk, the copy
// engine, completing on an mbarrier) from the 16-byte chunk that holds its
// first byte into a staging buffer: any base alignment and any d.  A copy
// moves whole chunks, so it reads up to 15 bytes before a run's first
// element and after its last one, inside the aligned 16-byte chunks that
// hold them.  Such a chunk never crosses a page, so the read cannot fault
// whatever allocated the tensor; the extra bytes are never used.  It is
// still a read outside the view, which a memory checker reports.  The
// next tile's copy is in flight while this tile is scored and summed.  The
// warps re-stride the staged bytes into the tile's rows (rounding f32 to
// bf16 and summing |x|^2 for K2).  Scores, in one of two ways:
//  - centroids in shared memory (resident, or streamed in chunks of kc =
//    128 or 64 through a ring of 1 or 2 stages by cp.async): a warp scores
//    mw M-tiles (two when the tile has an even number, so each B fragment
//    feeds twice the MMAs) against every (8 / groups)-th centroid pair (16
//    centroids), up to four pairs a round;
//  - the register path (k <= 128, at most 20 k-steps): warp w owns pair w
//    and holds its B fragments for every k-step in registers for the whole
//    kernel, loaded once from the caller's centroids; it scores every
//    M-tile.  No centroid tile, so a larger point tile fits.
// Each thread keeps a running (best, index) per row and replaces it only on
// a strictly smaller score; candidates merge with the lower index winning
// ties (quad shuffles, then across warps in shared memory), so the lowest
// index wins as argmin does.  With `fused`, the block adds each tile's rows
// into a [k, d] accumulator in shared memory (scatter_rows: each thread
// owns a column pair, rows in order, no atomics) and counts in shared
// memory; otherwise it writes each point's assignment and range_kernel
// makes the sums.
//
// range_kernel: block (s, r) owns centroid range r and point stripe s; it
// selects the stripe's points assigned into its range (in point order),
// fetches their rows by one bulk copy each, re-strides them into a staging
// tile and adds them into its [range, d] accumulator as the fused path
// does.
//
// Built with -DKM_PHASES, both kernels sum clock64() cycles by phase into
// km_main_clk / km_range_clk (read by each source's kmeans_phases entry
// point); python -m harp_tpu_torch.examples.kmeans_phases prints them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace km {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 32;       // bytes of one MMA k-step
constexpr int kPB = 4;          // centroid pairs a warp scores at once
constexpr int kSelect = 1024;   // points a range block selects per round
constexpr int kRegSteps = 20;   // k-steps of one centroid pair a warp can
                                // hold in registers (the register path)

__host__ __device__ inline int ksteps(int row_bytes) {
  return (row_bytes + kStep - 1) / kStep;
}
__host__ __device__ inline int row_stride(int row_bytes) {
  return ksteps(row_bytes) * kStep + 16;
}
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// ---- small device helpers -------------------------------------------------

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
// a and b rounded to bf16 (nearest even) in one packed conversion: a low
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// e / d for 0 <= e < 2^22 from a float reciprocal, corrected to exact
struct Div {
  int d;
  float inv;
  __device__ explicit Div(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int quot(int e) const {
    int q = (int)(((float)e + 0.5f) * inv);
    const int r = e - q * d;
    if (r < 0) --q;
    else if (r >= d) ++q;
    return q;
  }
};

// no "memory" clobber: asm volatile already keeps its place among the
// barriers and the other asm, and a clobber would make the compiler reload
// every loop-invariant value after each ldmatrix
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b: bf16 m16n8k16 with f32 accumulation (K2)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b: s8 m16n8k32 with exact s32 accumulation (K1)
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// expect `bytes` more of the current phase's copies (no arrival)
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a copy
// that never lands traps after ~10 s instead of hanging the card
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
// one 1-D bulk copy (the copy engine; 16-byte aligned ends) that completes
// `bytes` of the barrier's phase; the fence orders the threads' earlier
// reads of dst before the copy's writes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// "no candidate yet": +inf at an index past every centroid; finite scores
// replace it, and finish() maps it to centroid 0 (argmin of all +inf)
constexpr int kNone = 0x7fffffff;

// (s, i) beats (bs, bi): a smaller score, or the same score at a lower index
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s < bs || (s == bs && i < bi);
}

// ---- point loads ------------------------------------------------------------

// A contiguous run of elements as the aligned 16-byte chunks that cover it
// (a bulk copy's source: any base alignment, any d).  The first and last
// chunk may hold bytes outside the run: they are read, never used.
struct Run {
  const uint4* a0;  // the chunk holding the run's first byte
  int lead;         // bytes from a0 to the run's first element
  int chunks;       // chunks covering the run
};

template <class S>
__device__ __forceinline__ Run make_run(const void* base, long first,
                                        int len) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(base) + (uintptr_t)first * sizeof(S);
  Run r;
  r.a0 = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
  r.lead = (int)(a & 15);
  r.chunks = (r.lead + len * (int)sizeof(S) + 15) >> 4;
  return r;
}

// Re-stride rows held in shared memory as raw source bytes into tile rows:
// row r's element e sits at byte src(r) + e * sizeof(S) of `raw`; it goes
// to column e of tile row r (int8, or rounded to bf16).  Threads take the
// (row, 4-byte word) pairs of the tile in one flat loop; columns past d get
// zero.  Unaligned source bytes come from two aligned words and a funnel
// shift, so there is no division in the loop and no per-byte store.
// Each thread keeps two positions in flight.
template <class S, class Src>
__device__ __forceinline__ void restride_rows(const unsigned char* raw,
                                              int rows, int d, const Src& src,
                                              unsigned char* tile, int sb,
                                              float& x2) {
  constexpr int kOut = std::is_same<S, int8_t>::value ? 4 : 2;  // per word
  const int words = (d + kOut - 1) / kOut;
  const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
  // two (row, word) positions a thread, kThreads apart, advanced by
  // 2 * kThreads without division; both loads go out before either store
  const int e0 = threadIdx.x, e1 = threadIdx.x + kThreads;
  int r0 = e0 / words, w0 = e0 - r0 * words;
  int r1 = e1 / words, w1 = e1 - r1 * words;
  const int dr = 2 * kThreads / words, dw = 2 * kThreads - dr * words;
  auto word = [&](int r, int w) -> uint32_t {
    const int e = w * kOut;
    const int off = src(r) + e * (int)sizeof(S);
    const int valid = min(kOut, d - e);
    uint32_t v;
    if constexpr (std::is_same<S, float>::value) {  // 4-byte aligned
      const float a = __uint_as_float(raw32[off >> 2]);
      const float b = valid > 1 ? __uint_as_float(raw32[(off >> 2) + 1]) : 0.f;
      x2 = fmaf(a, a, x2);
      x2 = fmaf(b, b, x2);
      v = bf16_pair(a, b);
    } else {
      v = __funnelshift_r(raw32[off >> 2], raw32[(off >> 2) + 1],
                          8 * (off & 3));
      if (valid < kOut) v &= (1u << (8 * (int)sizeof(S) * valid)) - 1u;
      if constexpr (std::is_same<S, __nv_bfloat16>::value) {
        const float a = bf16_lo(v), b = bf16_hi(v);
        x2 = fmaf(a, a, x2);
        x2 = fmaf(b, b, x2);
      }
    }
    return v;
  };
  auto put = [&](int r, int w, uint32_t v) {
    *reinterpret_cast<uint32_t*>(tile + (size_t)r * sb + 4 * w) = v;
  };
  while (r1 < rows) {  // r1 > r0: both positions in the tile
    const uint32_t v0 = word(r0, w0), v1 = word(r1, w1);
    put(r0, w0, v0);
    put(r1, w1, v1);
    r0 += dr;
    w0 += dw;
    if (w0 >= words) {  // dw < words
      w0 -= words;
      ++r0;
    }
    r1 += dr;
    w1 += dw;
    if (w1 >= words) {
      w1 -= words;
      ++r1;
    }
  }
  if (r0 < rows) put(r0, w0, word(r0, w0));
}

// ---- scores and argmin --------------------------------------------------------

struct EpiBf16 {  // K2: c2 - 2 * dot (2 * dot is exact, so an FMA rounds alike)
  const float* c2;
  __device__ float operator()(float dot, int c) const {
    return c2[c] - 2.f * dot;
  }
};

struct EpiInt8 {  // K1: c2 - 2 * round(float(dot) * c_scale), no contraction
  const float* c2;
  const float* cs;
  __device__ float operator()(int dot, int c) const {
    return __fsub_rn(c2[c], 2.f * __fmul_rn((float)dot, cs[c]));
  }
};

// One round of score_pairs: MW M-tiles (from a_addr) against NQ pairs p0,
// p0 + nw, ... (MW and NQ fixed, so no MMA is predicated); fragments of
// k-step kk + 1 load while k-step kk runs on the tensor cores (asm volatile
// keeps program order, so the order below is the order they go out).
template <int MW, int NQ, class Dot, class Epi>
__device__ __forceinline__ void score_round(uint32_t a_addr, uint32_t b_addr,
                                            int sb, int ks, int p0, int nw,
                                            int c_base, int k, const Epi& epi,
                                            float (&best)[2][2],
                                            int (&bidx)[2][2]) {
  const int lane = threadIdx.x & 31;
  Dot acc[MW][NQ][2][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][h][e] = 0;
  uint32_t bq[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) bq[q] = b_addr + (p0 + q * nw) * 16 * sb;
  auto load = [&](uint32_t(&af)[MW][4], uint32_t(&bf)[NQ][4], int kk) {
#pragma unroll
    for (int i = 0; i < MW; ++i) ldsm_x4(a_addr + i * 16 * sb + kk * kStep, af[i]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) ldsm_x4(bq[q] + kk * kStep, bf[q]);
  };
  auto compute = [&](const uint32_t(&af)[MW][4], const uint32_t(&bf)[NQ][4]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        mma(acc[i][q][0], af[i], bf[q][0], bf[q][1]);
        mma(acc[i][q][1], af[i], bf[q][2], bf[q][3]);
      }
  };
  uint32_t a0[MW][4], a1[MW][4], b0[NQ][4], b1[NQ][4];
  load(a0, b0, 0);
  int kk = 0;
  for (; kk + 2 <= ks; kk += 2) {
    load(a1, b1, kk + 1);
    compute(a0, b0);
    if (kk + 2 < ks) load(a0, b0, kk + 2);
    compute(a1, b1);
  }
  if (kk < ks) compute(a0, b0);
  // the test c < k only where this round's pairs reach past k
  auto epilogue = [&](auto tail) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c =
              c_base + 16 * (p0 + q * nw) + 8 * h + 2 * (lane & 3) + e;
          if (decltype(tail)::value && c >= k) continue;
#pragma unroll
          for (int i = 0; i < MW; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float s = epi(acc[i][q][h][2 * r + e], c - c_base);
              if (s < best[i][r]) {
                best[i][r] = s;
                bidx[i][r] = c;
              }
            }
        }
  };
  if (c_base + 16 * (p0 + (NQ - 1) * nw) + 16 > k)
    epilogue(std::true_type{});
  else
    epilogue(std::false_type{});
}

// Score MW M-tiles from M-tile m0 of the tile against centroid pairs g,
// g + nw, ... below npairs of a centroid block whose first centroid is
// c_base; update each thread's running (best, index) of its rows (lane / 4
// and lane / 4 + 8 of each M-tile).  A thread meets its centroids in
// increasing order.
template <int MW, class Dot, class Epi>
__device__ __forceinline__ void score_pairs(uint32_t tile_sa, uint32_t cen_sa,
                                            int sb, int ks, int m0, int g,
                                            int nw, int npairs, int c_base,
                                            int k, const Epi& epi,
                                            float (&best)[2][2],
                                            int (&bidx)[2][2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t a_addr = tile_sa +
                          (m0 * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * sb +
                          16 * (lane >> 4);
  const uint32_t b_addr =
      cen_sa + ((lane & 7) + 8 * (lane >> 4)) * sb + 16 * ((lane >> 3) & 1);
  for (int p0 = g; p0 < npairs; p0 += nw * kPB) {
    switch (min(kPB, (npairs - p0 + nw - 1) / nw)) {  // pairs this round
      case 4:
        score_round<MW, 4, Dot>(a_addr, b_addr, sb, ks, p0, nw, c_base, k,
                                epi, best, bidx);
        break;
      case 3:
        score_round<MW, 3, Dot>(a_addr, b_addr, sb, ks, p0, nw, c_base, k,
                                epi, best, bidx);
        break;
      case 2:
        score_round<MW, 2, Dot>(a_addr, b_addr, sb, ks, p0, nw, c_base, k,
                                epi, best, bidx);
        break;
      default:
        score_round<MW, 1, Dot>(a_addr, b_addr, sb, ks, p0, nw, c_base, k,
                                epi, best, bidx);
    }
  }
}

// ---- the register path: each warp owns one centroid pair ---------------------

// The pair's B fragments for every k-step, loaded once from the caller's
// [k, d] centroids (zero past k and d), and its columns' c2 (and c_scale):
// column q = 2h + e of a thread is centroid 16 pair + 8h + 2 (lane % 4) + e.
struct PairFrags {
  uint32_t b[kRegSteps][4];
  float c2[4], cs[4];
};

template <bool kInt8>
__device__ __forceinline__ void load_pair(PairFrags& F, const void* cen,
                                          const float* c2, const float* cs,
                                          int pair, int k, int d, int ks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kRegSteps; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 16 * pair + 8 * (q >> 1) + (lane >> 2);
      uint32_t w = 0;
      if (kk < ks && c < k) {
        if constexpr (kInt8) {
          const int e0 = kk * 32 + 16 * (q & 1) + 4 * (lane & 3);
          const uint8_t* row = static_cast<const uint8_t*>(cen) + (size_t)c * d;
          for (int b = 0; b < 4; ++b)
            if (e0 + b < d) w |= (uint32_t)row[e0 + b] << (8 * b);
        } else {
          const int e0 = kk * 16 + 8 * (q & 1) + 2 * (lane & 3);
          const float* row = static_cast<const float*>(cen) + (size_t)c * d;
          w = (e0 < d ? bf16_bits(row[e0]) : 0u) |
              ((e0 + 1 < d ? bf16_bits(row[e0 + 1]) : 0u) << 16);
        }
      }
      F.b[kk][q] = w;
    }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 16 * pair + 8 * (q >> 1) + 2 * (lane & 3) + (q & 1);
    F.c2[q] = c < k ? c2[c] : 0.f;
    F.cs[q] = (kInt8 && c < k) ? cs[c] : 0.f;
  }
}

__device__ __forceinline__ float reg_score(float dot, const PairFrags& F,
                                           int q) {
  return F.c2[q] - 2.f * dot;
}
__device__ __forceinline__ float reg_score(int dot, const PairFrags& F,
                                           int q) {
  return __fsub_rn(F.c2[q], 2.f * __fmul_rn((float)dot, F.cs[q]));
}

// MW (1 or 2) M-tiles from a0_addr against this warp's pair; A fragments
// of k-step kk + 1 load while k-step kk runs (a ping-pong on compile-time
// stage indices, no copies and no predicated MMA); each row's best (lowest
// index on ties) goes to cb/ci[warp][row].
template <int MW, class Dot>
__device__ __forceinline__ void score_regs_mtiles(const PairFrags& F,
                                                  uint32_t a0_addr, int sb,
                                                  int ks, int m, int pair,
                                                  int k, float* cb, int* ci,
                                                  int tn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Dot acc[MW][2][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0;
  uint32_t a[2][MW][4];
#pragma unroll
  for (int i = 0; i < MW; ++i) ldsm_x4(a0_addr + i * 16 * sb, a[0][i]);
#pragma unroll
  for (int kk = 0; kk < kRegSteps; ++kk) {
    if (kk >= ks) break;
    const int cur = kk & 1;
    if (kk + 1 < ks)
#pragma unroll
      for (int i = 0; i < MW; ++i)
        ldsm_x4(a0_addr + i * 16 * sb + (kk + 1) * kStep, a[cur ^ 1][i]);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      mma(acc[i][0], a[cur][i], F.b[kk][0], F.b[kk][1]);
      mma(acc[i][1], a[cur][i], F.b[kk][2], F.b[kk][3]);
    }
  }
  const bool tail = 16 * pair + 16 > k;  // the pair reaches past k
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float bs = __int_as_float(0x7f800000);
      int bi = kNone;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 16 * pair + 8 * (q >> 1) + 2 * (lane & 3) + (q & 1);
        const float s = reg_score(acc[i][q >> 1][2 * r + (q & 1)], F, q);
        if ((!tail || c < k) && s < bs) {
          bs = s;
          bi = c;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float s2 = __shfl_xor_sync(0xffffffffu, bs, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(s2, i2, bs, bi)) {
          bs = s2;
          bi = i2;
        }
      }
      if ((lane & 3) == 0) {
        const int row = (m + i) * 16 + (lane >> 2) + 8 * r;
        cb[warp * tn + row] = bs;
        ci[warp * tn + row] = bi;
      }
    }
}

// Score every row of the tile against this warp's pair, two M-tiles at a
// time.
template <class Dot>
__device__ __forceinline__ void score_regs(const PairFrags& F,
                                           uint32_t tile_sa, int sb, int ks,
                                           int mt, int pair, int k, float* cb,
                                           int* ci, int tn) {
  const int lane = threadIdx.x & 31;
  const uint32_t a_base = tile_sa +
                          ((lane & 7) + 8 * ((lane >> 3) & 1)) * sb +
                          16 * (lane >> 4);
  int m = 0;
  for (; m + 2 <= mt; m += 2)
    score_regs_mtiles<2, Dot>(F, a_base + m * 16 * sb, sb, ks, m, pair, k, cb,
                              ci, tn);
  if (m < mt)
    score_regs_mtiles<1, Dot>(F, a_base + m * 16 * sb, sb, ks, m, pair, k, cb,
                              ci, tn);
}

// merge the candidates of the four lanes that share a row
__device__ __forceinline__ void quad_merge(float& best, int& bidx) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float s = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, bidx, o);
    if (better(s, i, best, bidx)) {
      best = s;
      bidx = i;
    }
  }
}

// sum of v[0, rows) by one warp, in a fixed order
__device__ __forceinline__ float warp_sum(const float* v, int rows) {
  float s = 0.f;
  for (int r = threadIdx.x & 31; r < rows; r += 32) s += v[r];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---- one-hot sums in shared memory --------------------------------------------

// Rows [0, rows) of the tile, row r into accumulator row rows_a[r]
// (rows_a 16-byte aligned; row stride dA = d rounded up to even; the
// tile's pad column is zero): each thread owns a column pair and adds the
// rows in order.  Four rows whose
// centroids differ go at once (their cells are distinct), else one by one,
// so every sum has the one order of the rows: K1's int32 sums are exact and
// K2's f32 sums are bit-equal on reruns.  No atomics.
template <class Sum>
__device__ __forceinline__ void scatter_rows(const unsigned char* tile, int sb,
                                             const int* rows_a, int rows,
                                             int d, Sum* acc) {
  constexpr bool kInt = std::is_same<Sum, int>::value;
  using Sum2 = typename std::conditional<kInt, int2, float2>::type;
  const int dA = d + (d & 1), np = dA >> 1;
  auto raw = [&](int r, int p) -> uint32_t {  // the pair's tile bits
    const unsigned char* row = tile + (size_t)r * sb;
    if constexpr (kInt)
      return *reinterpret_cast<const uint16_t*>(row + 2 * p);
    else
      return *reinterpret_cast<const uint32_t*>(row + 4 * p);
  };
  auto add = [&](Sum2& c, uint32_t w) {
    if constexpr (kInt) {
      c.x += (int)(int8_t)(uint8_t)(w & 0xffu);
      c.y += (int)(int8_t)(uint8_t)(w >> 8);
    } else {
      c.x += bf16_lo(w);
      c.y += bf16_hi(w);
    }
  };
  for (int p = threadIdx.x; p < np; p += kThreads) {
    Sum2* col = reinterpret_cast<Sum2*>(acc) + p;
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
      const int4 a4 = *reinterpret_cast<const int4*>(rows_a + r);
      const int a[4] = {a4.x, a4.y, a4.z, a4.w};
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = raw(r + j, p);
      if (a[0] != a[1] && a[0] != a[2] && a[0] != a[3] && a[1] != a[2] &&
          a[1] != a[3] && a[2] != a[3]) {
        Sum2 c[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = col[(size_t)a[j] * np];
#pragma unroll
        for (int j = 0; j < 4; ++j) add(c[j], w[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) col[(size_t)a[j] * np] = c[j];
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Sum2 c = col[(size_t)a[j] * np];
          add(c, w[j]);
          col[(size_t)a[j] * np] = c;
        }
      }
    }
    for (; r < rows; ++r) {
      Sum2 c = col[(size_t)rows_a[r] * np];
      add(c, raw(r, p));
      col[(size_t)rows_a[r] * np] = c;
    }
  }
}

// ---- the kernels ----------------------------------------------------------------

// Traits: Src the points' element type, Dot the MMA accumulator, Sum the
// one-hot accumulator (int32 for K1, f32 for K2).
struct Int8Traits {
  using Src = int8_t;
  using Dot = int;
  using Sum = int;
  static constexpr bool kX2 = false;
};
template <class S>
struct Bf16Traits {
  using Src = S;
  using Dot = float;
  using Sum = float;
  static constexpr bool kX2 = true;
};

// accumulator row stride: d rounded up to even (column pairs)
__host__ __device__ inline int acc_stride(int d) { return d + (d & 1); }

#ifdef KM_PHASES
// clock64() cycles by phase, summed by thread 0 of each block: main kernel
// [store, score, merge, sums, loop, wait (of store), wait and re-stride (of
// store)], range kernel [select, gather (copies and re-stride), sums]
__device__ unsigned long long km_main_clk[1024][7];
__device__ unsigned long long km_range_clk[1024][3];
#define KM_T(v) const long long v = clock64()
#define KM_ADD(arr, i, a, b) \
  if (threadIdx.x == 0) arr[i] += (unsigned long long)((b) - (a))
#else
#define KM_T(v)
#define KM_ADD(arr, i, a, b)
#endif

struct MainArgs {
  const void* pts;
  const void* cen_raw;       // the caller's [k, d] centroids (resident)
  const float* c2_raw;       // [k]
  const float* cs_raw;       // [k] (K1)
  const unsigned char* cen;  // packed [k_pad, sb] bytes (streamed)
  const float* c2;           // [k_pad] (streamed)
  const float* cs;           // [k_pad] (streamed, K1)
  int n, d, k;
  int fused, mt, mw, kc, stages;  // kc = 0: resident centroids; mw M-tiles
                                 // a warp (shared-memory centroids)
  int sb, ks, k16;
  int o_tile, o_cen, o_c2, o_cs, o_cb, o_ci, o_assign, o_bestv, o_red,
      o_counts, o_acc, o_stage, o_bar;
  void* sums;      // fused: K1 int32 [k, d] (atomics); K2 f32 slabs [grid, k*d]
  int* counts;     // fused: [k] int32 (atomics)
  int* assign;     // not fused: [n]
  float* partial;  // [grid]: the block's sum of best scores (+ sum |x|^2, K2)
};

template <class Tr, bool kRegs>
__global__ void __launch_bounds__(kThreads, 1) main_kernel(const MainArgs A) {
  using S = typename Tr::Src;
  using Sum = typename Tr::Sum;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int tn = 16 * A.mt, mgroups = A.mt / A.mw, nw = kWarps / mgroups;
  const int m0 = (warp % mgroups) * A.mw, g = warp / mgroups;
  unsigned char* tile = smem + A.o_tile;
  unsigned char* cen = smem + A.o_cen;
  float* c2s = reinterpret_cast<float*>(smem + A.o_c2);
  float* css = reinterpret_cast<float*>(smem + A.o_cs);
  float* cb = reinterpret_cast<float*>(smem + A.o_cb);
  int* ci = reinterpret_cast<int*>(smem + A.o_ci);
  int* assign_s = reinterpret_cast<int*>(smem + A.o_assign);
  float* bestv = reinterpret_cast<float*>(smem + A.o_bestv);
  float* red = reinterpret_cast<float*>(smem + A.o_red);
  int* counts_s = reinterpret_cast<int*>(smem + A.o_counts);
  Sum* acc = reinterpret_cast<Sum*>(smem + A.o_acc);
  unsigned char* stage = smem + A.o_stage;
  const uint32_t bar = smem_addr(smem + A.o_bar);
  const int dA = acc_stride(A.d);
  const int ntiles = (int)((A.n + tn - 1) / tn);
  auto run_of = [&](int ti) {
    const long row0 = (long)ti * tn;
    const int rows = (int)min((long)tn, (long)A.n - row0);
    return make_run<S>(A.pts, row0 * A.d, rows * A.d);
  };
  // a tile's points arrive as one bulk copy of their contiguous run (from
  // the 16-byte chunk holding its first byte) into the staging buffer
  auto fetch = [&](int ti) {
    const Run R = run_of(ti);
    mbar_expect(bar, R.chunks * 16);
    bulk_copy(smem_addr(stage), R.a0, R.chunks * 16, bar);
    mbar_arrive(bar);
  };
  if (t == 0) {
    mbar_init(bar, 1);
    if ((int)blockIdx.x < ntiles) fetch(blockIdx.x);
  }

  // the tile's pad columns stay zero: loads write only columns < d
  for (int i = t; i < tn * A.sb / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(tile)[i] = 0u;
  if (A.fused) {
    for (int i = t; i < A.k; i += kThreads) counts_s[i] = 0;
    for (int i = t; i < A.k * dA; i += kThreads) acc[i] = 0;
  }
  const int cen_rows = A.kc ? A.kc : A.k16;
  auto load_cen = [&](int chunk, int st) {
    const unsigned char* src = A.cen + (size_t)chunk * cen_rows * A.sb;
    unsigned char* dst = cen + (size_t)st * cen_rows * A.sb;
    for (int i = t; i < cen_rows * A.sb / 16; i += kThreads)
      cp_async16(smem_addr(dst + 16 * i), src + 16 * i);
    for (int i = t; i < cen_rows / 4; i += kThreads) {
      cp_async16(smem_addr(c2s + st * cen_rows + 4 * i),
                 A.c2 + (size_t)chunk * cen_rows + 4 * i);
      if (!Tr::kX2)
        cp_async16(smem_addr(css + st * cen_rows + 4 * i),
                   A.cs + (size_t)chunk * cen_rows + 4 * i);
    }
    cp_commit();
  };
  const Div dv(A.d);
  const int npairs = A.k16 / 16;
  PairFrags F;
  if constexpr (kRegs) {
    if (warp < npairs)
      load_pair<!Tr::kX2>(F, A.cen_raw, A.c2_raw, A.cs_raw, warp, A.k, A.d,
                          A.ks);
  } else if (A.kc) {
    load_cen(0, 0);
  } else {
    // resident: every centroid, from the caller's [k, d] layout, into rows
    // at the tile's stride (pad rows and columns zero), once a block
    for (int i = t; i < A.k16 * A.sb / 4; i += kThreads)
      reinterpret_cast<uint32_t*>(cen)[i] = 0u;
    for (int i = t; i < A.k16; i += kThreads) {
      c2s[i] = i < A.k ? A.c2_raw[i] : 0.f;
      if (!Tr::kX2) css[i] = i < A.k ? A.cs_raw[i] : 0.f;
    }
    __syncthreads();
    for (int i = t; i < A.k * A.d; i += kThreads) {
      const int c = dv.quot(i), e = i - c * A.d;
      if constexpr (Tr::kX2)
        *reinterpret_cast<uint16_t*>(cen + (size_t)c * A.sb + 2 * e) =
            (uint16_t)bf16_bits(static_cast<const float*>(A.cen_raw)[i]);
      else
        cen[(size_t)c * A.sb + e] = static_cast<const uint8_t*>(A.cen_raw)[i];
    }
  }
  __syncthreads();

  const int nch = A.kc ? (A.k + A.kc - 1) / A.kc : 1;
  float x2 = 0.f, blk = 0.f;
  uint32_t phase = 0;
  int gc = 0;  // streamed chunks consumed so far
  const uint32_t tile_sa = smem_addr(tile);
#ifdef KM_PHASES
  unsigned long long clk[7] = {0, 0, 0, 0, 0, 0, 0};
#endif
  KM_T(t_loop);
  for (int ti = blockIdx.x; ti < ntiles; ti += gridDim.x) {
    const long row0 = (long)ti * tn;
    const int rows = (int)min((long)tn, (long)A.n - row0);
    const Run R = run_of(ti);
    __syncthreads();  // the previous tile's readers are done
    KM_T(t0);
    mbar_wait(bar, phase);
    phase ^= 1;
    KM_T(tw);
    KM_ADD(clk, 5, t0, tw);
    restride_rows<S>(
        stage, rows, A.d,
        [&](int r) { return R.lead + r * A.d * (int)sizeof(S); }, tile, A.sb,
        x2);
    KM_T(tc);
    KM_ADD(clk, 6, t0, tc);
    __syncthreads();  // the staging buffer is free, the tile is whole
    if (t == 0 && ti + (int)gridDim.x < ntiles) fetch(ti + gridDim.x);
    KM_T(t1);
    KM_ADD(clk, 0, t0, t1);

    float best[2][2];
    int bidx[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        best[i][r] = __int_as_float(0x7f800000);
        bidx[i][r] = kNone;
      }
    // shared-memory centroids: one or two M-tiles a warp
    auto score = [&](uint32_t cen_sa, int np, int c_base, const float* c2p,
                     const float* csp) {
      if constexpr (Tr::kX2) {
        if (A.mw == 2)
          score_pairs<2, typename Tr::Dot>(tile_sa, cen_sa, A.sb, A.ks, m0, g,
                                           nw, np, c_base, A.k, EpiBf16{c2p},
                                           best, bidx);
        else
          score_pairs<1, typename Tr::Dot>(tile_sa, cen_sa, A.sb, A.ks, m0, g,
                                           nw, np, c_base, A.k, EpiBf16{c2p},
                                           best, bidx);
      } else {
        if (A.mw == 2)
          score_pairs<2, typename Tr::Dot>(tile_sa, cen_sa, A.sb, A.ks, m0, g,
                                           nw, np, c_base, A.k,
                                           EpiInt8{c2p, csp}, best, bidx);
        else
          score_pairs<1, typename Tr::Dot>(tile_sa, cen_sa, A.sb, A.ks, m0, g,
                                           nw, np, c_base, A.k,
                                           EpiInt8{c2p, csp}, best, bidx);
      }
    };
    if constexpr (kRegs) {
      if (warp < npairs)
        score_regs<typename Tr::Dot>(F, tile_sa, A.sb, A.ks, A.mt, warp, A.k,
                                     cb, ci, tn);
    } else if (!A.kc) {
      score(smem_addr(cen), A.k16 / 16, 0, c2s, css);
    } else {
      for (int ch = 0; ch < nch; ++ch) {
        const int st = A.stages == 2 ? (gc & 1) : 0;
        if (A.stages == 2) {
          load_cen((ch + 1) % nch, st ^ 1);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        score(smem_addr(cen + (size_t)st * A.kc * A.sb),
              min(A.kc, A.k16 - ch * A.kc) / 16, ch * A.kc, c2s + st * A.kc,
              css + st * A.kc);
        __syncthreads();  // the stage may be refilled
        if (A.stages == 1) load_cen((ch + 1) % nch, 0);
        ++gc;
      }
    }

    KM_T(t2);
    KM_ADD(clk, 1, t1, t2);
    if (!kRegs)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) quad_merge(best[i][r], bidx[i][r]);
    auto finish = [&](int row, float s, int i) {
      const bool valid = row < rows;
      if (i >= A.k) i = 0;
      assign_s[row] = i;
      bestv[row] = valid ? s : 0.f;
      if (!valid) return;
      if (A.fused)
        atomicAdd(&counts_s[i], 1);
      else
        A.assign[row0 + row] = i;
    };
    if (kRegs) {
      __syncthreads();
      if (t < tn) {
        float s = cb[t];
        int i = ci[t];
        for (int gg = 1; gg < npairs; ++gg)
          if (better(cb[gg * tn + t], ci[gg * tn + t], s, i)) {
            s = cb[gg * tn + t];
            i = ci[gg * tn + t];
          }
        finish(t, s, i);
      }
    } else if (nw == 1) {
      if ((lane & 3) == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)  // compile-time indices: best stays in
          if (i < A.mw)               // registers
#pragma unroll
            for (int r = 0; r < 2; ++r)
              finish((m0 + i) * 16 + (lane >> 2) + 8 * r, best[i][r],
                     bidx[i][r]);
    } else {
      if ((lane & 3) == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (i < A.mw)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = (m0 + i) * 16 + (lane >> 2) + 8 * r;
              cb[g * tn + row] = best[i][r];
              ci[g * tn + row] = bidx[i][r];
            }
      __syncthreads();
      if (t < tn) {
        float s = cb[t];
        int i = ci[t];
        for (int gg = 1; gg < nw; ++gg)
          if (better(cb[gg * tn + t], ci[gg * tn + t], s, i)) {
            s = cb[gg * tn + t];
            i = ci[gg * tn + t];
          }
        finish(t, s, i);
      }
    }
    __syncthreads();
    KM_T(t3);
    KM_ADD(clk, 2, t2, t3);
    if (A.fused) scatter_rows(tile, A.sb, assign_s, rows, A.d, acc);
    if (warp == 0) blk += warp_sum(bestv, rows);
    KM_T(t4);
    KM_ADD(clk, 3, t3, t4);
  }
  cp_wait<0>();  // the chunk prefetched past the last tile
#ifdef KM_PHASES
  KM_T(t_end);
  KM_ADD(clk, 4, t_loop, t_end);
  if (t == 0)
    for (int i = 0; i < 7; ++i) km_main_clk[blockIdx.x][i] = clk[i];
#endif

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x2 += __shfl_xor_sync(0xffffffffu, x2, o);
  if (lane == 0) red[warp] = x2;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
    if (Tr::kX2)
      for (int i = 0; i < kWarps; ++i) s += red[i];
    A.partial[blockIdx.x] = s + blk;
  }
  if (A.fused) {
    if constexpr (Tr::kX2) {
      float* slab = reinterpret_cast<float*>(A.sums) +
                    (size_t)blockIdx.x * A.k * A.d;
      for (int i = t; i < A.k * A.d; i += kThreads) {
        const int c = dv.quot(i);
        slab[i] = acc[c * dA + (i - c * A.d)];
      }
    } else {
      int* sums = reinterpret_cast<int*>(A.sums);
      for (int i = t; i < A.k * A.d; i += kThreads) {
        const int c = dv.quot(i), v = acc[c * dA + (i - c * A.d)];
        if (v) atomicAdd(&sums[i], v);
      }
    }
    for (int i = t; i < A.k; i += kThreads)
      if (counts_s[i]) atomicAdd(&A.counts[i], counts_s[i]);
  }
}

struct RangeArgs {
  const void* pts;
  const int* assign;  // [n]
  int n, d, k;
  int range_k, stripes, tr, sb;
  int o_acc, o_counts, o_idx, o_a, o_stage, o_warp, o_raw, o_bar;
  void* sums;   // K1: int32 [k, d] (atomics); K2: f32 slabs [stripes, k*d]
  int* counts;  // [k] int32 (atomics)
};

template <class Tr>
__global__ void __launch_bounds__(kThreads, 1) range_kernel(const RangeArgs A) {
  using S = typename Tr::Src;
  using Sum = typename Tr::Sum;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  Sum* acc = reinterpret_cast<Sum*>(smem + A.o_acc);
  int* counts_s = reinterpret_cast<int*>(smem + A.o_counts);
  int* idx_s = reinterpret_cast<int*>(smem + A.o_idx);
  int* a_s = reinterpret_cast<int*>(smem + A.o_a);
  unsigned char* stage = smem + A.o_stage;
  int* wcount = reinterpret_cast<int*>(smem + A.o_warp);
  unsigned char* raw = smem + A.o_raw;
  const uint32_t bar = smem_addr(smem + A.o_bar);
  if (t == 0) mbar_init(bar, 1);
  const int s = blockIdx.x, clo = blockIdx.y * A.range_k;
  const int kr = min(A.range_k, A.k - clo);
  const long plo = (long)A.n * s / A.stripes;
  const long phi = (long)A.n * (s + 1) / A.stripes;
  const int dA = acc_stride(A.d);

  for (int i = t; i < kr * dA; i += kThreads) acc[i] = 0;
  for (int i = t; i < kr; i += kThreads) counts_s[i] = 0;
  for (int i = t; i < A.tr * A.sb / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(stage)[i] = 0u;
  __syncthreads();

  const Div dv(A.d);
  const int row_bytes = A.d * (int)sizeof(S);
  const int cr = (15 + row_bytes + 15) >> 4;  // chunks a row can touch
  float unused = 0.f;
  uint32_t phase = 0;
#ifdef KM_PHASES
  unsigned long long clk[3] = {0, 0, 0};
#endif
  for (long base = plo; base < phi; base += kSelect) {
    KM_T(t0);
    // the points of [base, base + kSelect) assigned into the range, in order
    int m_total = 0;
    int av[kSelect / kThreads];  // the round's assignments, loaded at once
#pragma unroll
    for (int j = 0; j < kSelect / kThreads; ++j) {
      const long p = base + j * kThreads + t;
      av[j] = p < phi ? A.assign[p] : -1;
    }
#pragma unroll
    for (int j = 0; j < kSelect / kThreads; ++j) {
      const long p = base + j * kThreads + t;
      const int a = av[j];
      const bool sel = a >= clo && a < clo + kr;
      const unsigned ball = __ballot_sync(0xffffffffu, sel);
      if (lane == 0) wcount[warp] = __popc(ball);
      __syncthreads();
      int before = m_total, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) before += wcount[w];
        total += wcount[w];
      }
      if (sel) {
        const int pos = before + __popc(ball & ((1u << lane) - 1u));
        idx_s[pos] = (int)p;
        a_s[pos] = a - clo;
        atomicAdd(&counts_s[a - clo], 1);
      }
      m_total += total;
      __syncthreads();  // wcount is rewritten next round
    }
    KM_T(t1);
    KM_ADD(clk, 0, t0, t1);
    for (int m0 = 0; m0 < m_total; m0 += A.tr) {
      KM_T(t2);
      const int rows = min(A.tr, m_total - m0);
      // one bulk copy a row into its raw slot, one barrier phase a batch
      if (t < rows) {
        const Run R = make_run<S>(A.pts, (long)idx_s[m0 + t] * A.d, A.d);
        mbar_expect(bar, R.chunks * 16);
        bulk_copy(smem_addr(raw + (size_t)t * cr * 16), R.a0, R.chunks * 16,
                  bar);
      }
      __syncthreads();
      if (t == 0) mbar_arrive(bar);
      mbar_wait(bar, phase);
      phase ^= 1;
      restride_rows<S>(
          raw, rows, A.d,
          [&](int m) {
            const Run R = make_run<S>(A.pts, (long)idx_s[m0 + m] * A.d, A.d);
            return m * cr * 16 + R.lead;
          },
          stage, A.sb, unused);
      __syncthreads();
      KM_T(t3);
      KM_ADD(clk, 1, t2, t3);
      scatter_rows(stage, A.sb, a_s + m0, rows, A.d, acc);
      __syncthreads();
      KM_T(t4);
      KM_ADD(clk, 2, t3, t4);
    }
  }
#ifdef KM_PHASES
  if (t == 0)
    for (int i = 0; i < 3; ++i)
      km_range_clk[blockIdx.y * gridDim.x + blockIdx.x][i] = clk[i];
#endif

  if constexpr (Tr::kX2) {
    float* slab = reinterpret_cast<float*>(A.sums) +
                  (size_t)s * A.k * A.d + (size_t)clo * A.d;
    for (int i = t; i < kr * A.d; i += kThreads) {
      const int c = dv.quot(i);
      slab[i] = acc[c * dA + (i - c * A.d)];
    }
  } else {
    int* sums = reinterpret_cast<int*>(A.sums) + (size_t)clo * A.d;
    for (int i = t; i < kr * A.d; i += kThreads) {
      const int c = dv.quot(i), v = acc[c * dA + (i - c * A.d)];
      if (v) atomicAdd(&sums[i], v);
    }
  }
  for (int i = t; i < kr; i += kThreads)
    if (counts_s[i]) atomicAdd(&A.counts[clo + i], counts_s[i]);
}

// ---- host-side plan ----------------------------------------------------------------

struct Plan {
  int n, d, k;  // the shape it was made for
  int fused, regs, mt, kc, stages, grid, k16, k_pad, sb, ks;
  int ranges, range_k, stripes, tr;
  size_t smem_main, smem_range;
  MainArgs main;    // shape, plan and layout fields filled
  RangeArgs range;  // likewise
};

// the bytes a run of `elems` elements of `es` bytes can touch in 16-byte
// chunks from any base alignment
inline size_t run_bytes(long elems, int es) {
  return (size_t)((15 + elems * es + 15) / 16) * 16;
}

// two M-tiles a warp on the shared-memory paths when the tile has an even
// number of them: each B fragment feeds twice the MMAs
inline int warp_mtiles(int mt) { return mt % 2 == 0 ? 2 : 1; }

inline size_t main_layout(MainArgs& L, int k, int k16, int d, int es_src,
                          int sb, int mt, int kc, int stages, bool fused,
                          bool regs, bool scales, int dA) {
  const size_t stage_bytes = run_bytes((long)16 * mt * d, es_src);
  const int tn = 16 * mt, nw = regs ? kWarps : kWarps / (mt / warp_mtiles(mt));
  const int cen_rows = regs ? 0 : kc ? kc * stages : k16;
  size_t o = 0;
  L.o_tile = (int)o;   o = align16(o + (size_t)tn * sb);
  L.o_cen = (int)o;    o = align16(o + (size_t)cen_rows * sb);
  L.o_c2 = (int)o;     o = align16(o + (size_t)cen_rows * 4);
  L.o_cs = (int)o;     o = align16(o + (scales ? (size_t)cen_rows * 4 : 0));
  L.o_cb = (int)o;     o = align16(o + (size_t)nw * tn * 4);
  L.o_ci = (int)o;     o = align16(o + (size_t)nw * tn * 4);
  L.o_assign = (int)o; o = align16(o + (size_t)tn * 4);
  L.o_bestv = (int)o;  o = align16(o + (size_t)tn * 4);
  L.o_red = (int)o;    o = align16(o + (size_t)kWarps * 4);
  L.o_counts = (int)o; o = align16(o + (fused ? (size_t)k * 4 : 0));
  L.o_acc = (int)o;    o = align16(o + (fused ? (size_t)k * dA * 4 : 0));
  L.o_stage = (int)o;  o = align16(o + (size_t)stage_bytes);
  L.o_bar = (int)o;    o = align16(o + 8);
  return o;
}

inline size_t range_layout(RangeArgs& L, int range_k, int tr, int sb,
                           int crb, int dA) {
  size_t o = 0;
  L.o_acc = (int)o;    o = align16(o + (size_t)range_k * dA * 4);
  L.o_counts = (int)o; o = align16(o + (size_t)range_k * 4);
  L.o_idx = (int)o;    o = align16(o + (size_t)kSelect * 4);
  L.o_a = (int)o;      o = align16(o + (size_t)kSelect * 4);
  L.o_stage = (int)o;  o = align16(o + (size_t)tr * sb);
  L.o_warp = (int)o;   o = align16(o + (size_t)kWarps * 4);
  L.o_raw = (int)o;    o = align16(o + (size_t)tr * crb);
  L.o_bar = (int)o;    o = align16(o + 8);
  return o;
}

// The launch plan for (n, d, k) on the current device: the fused path when
// the [k, d] accumulator, the resident centroids and a tile of at least 32
// points fit in shared memory (the largest such tile); else the two-pass
// path with the largest tile and centroid ring that fit, and centroid ranges
// whose accumulator fits.  It lets each kernel it plans take the card's
// whole opt-in shared memory, so plans of other shapes never cap it.
template <class Tr>
cudaError_t make_plan(int n, int d, int k, Plan* P) {
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (n < 1 || d < 1 || k < 1) return cudaErrorInvalidValue;
  const int es = Tr::kX2 ? 2 : 1;  // tile element bytes
  const int es_src = (int)sizeof(typename Tr::Src);
  const int crb = (int)run_bytes(d, es_src);  // raw bytes of one gathered row
  const int dA = acc_stride(d);
  *P = Plan{};
  P->n = n;
  P->d = d;
  P->k = k;
  P->sb = row_stride(d * es);
  P->ks = ksteps(d * es);
  P->k16 = (k + 15) / 16 * 16;
  P->k_pad = (k + 63) / 64 * 64;
  P->mt = 0;
  const bool regs_fit = P->k16 / 16 <= kWarps && P->ks <= kRegSteps;
  // order: shared-memory centroids with tiles of 64 rows or more, then
  // register fragments (no centroid tile: room for a larger point tile),
  // then shared-memory centroids with any tile
  const int kTry[3][2] = {{0, 4}, {1, 1}, {0, 1}};  // {regs, least mt}
  for (int i = 0; i < 3 && !P->mt; ++i) {
    const int regs = kTry[i][0];
    if (regs && !regs_fit) continue;
    for (int mt = 8; mt >= kTry[i][1] && !P->mt; --mt) {
      if (!regs && (kWarps % mt)) continue;
      MainArgs L{};
      const size_t bytes = main_layout(L, k, P->k16, d, es_src, P->sb, mt, 0,
                                       1, true, regs, !Tr::kX2, dA);
      if (bytes <= (size_t)optin) {
        P->fused = 1;
        P->regs = regs;
        P->mt = mt;
        P->kc = 0;
        P->stages = 1;
        P->smem_main = bytes;
        P->main = L;
      }
    }
  }
  static const int kRing[5][2] = {{128, 2}, {64, 2}, {64, 1}, {32, 1},
                                  {16, 1}};
  for (int mt = 8; mt >= 1 && !P->mt; mt >>= 1)
    for (int i = 0; i < 5 && !P->mt; ++i) {
      MainArgs L{};
      const size_t bytes =
          main_layout(L, k, P->k16, d, es_src, P->sb, mt, kRing[i][0],
                      kRing[i][1], false, false, !Tr::kX2, dA);
      if (bytes <= (size_t)optin) {
        P->fused = 0;
        P->mt = mt;
        P->kc = kRing[i][0];
        P->stages = kRing[i][1];
        P->smem_main = bytes;
        P->main = L;
      }
    }
  if (!P->mt) return cudaErrorInvalidValue;  // d too wide for one row tile

  const int tn = 16 * P->mt;
  const long ntiles = ((long)n + tn - 1) / tn;
  void (*kern)(MainArgs) =
      P->regs ? main_kernel<Tr, true> : main_kernel<Tr, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      P->smem_main);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  P->grid = (int)(ntiles < (long)sms * per_sm ? ntiles : (long)sms * per_sm);

  if (!P->fused) {
    // two blocks an SM when half of its shared memory holds a block's
    // staging and some centroids (one block's gather latency hides behind
    // the other's work), else one
    int per_sm_smem = 0;
    err = cudaDeviceGetAttribute(&per_sm_smem,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 dev);
    if (err != cudaSuccess) return err;
    RangeArgs L{};
    size_t budget = (size_t)per_sm_smem / 2 - 1024, fixed = 0;
    int tr = 0;
    for (int half = 1; half >= 0 && !tr; --half) {
      if (!half) budget = (size_t)optin;
      int t = 128;
      while (t > 1 && (size_t)t * (P->sb + crb) * 2 > budget) t >>= 1;
      fixed = range_layout(L, 0, t, P->sb, crb, dA);
      if (fixed + (size_t)dA * 4 + 4 + 32 <= budget) tr = t;
    }
    if (!tr) return cudaErrorInvalidValue;
    int rk = (int)((budget - fixed - 32) / ((size_t)dA * 4 + 4));
    if (rk > k) rk = k;
    P->ranges = (k + rk - 1) / rk;
    P->range_k = (k + P->ranges - 1) / P->ranges;
    P->tr = tr;
    P->smem_range = range_layout(L, P->range_k, tr, P->sb, crb, dA);
    P->range = L;
    err = cudaFuncSetAttribute(range_kernel<Tr>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, range_kernel<Tr>, kThreads, P->smem_range);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    long stripes = (long)sms * per_sm / P->ranges;
    const long rounds = ((long)n + kSelect - 1) / kSelect;
    if (stripes > rounds) stripes = rounds;
    P->stripes = stripes < 1 ? 1 : (int)stripes;
  }
  return cudaSuccess;
}

// A *_plan entry point's work: make the plan for (n, d, k) on the current
// device and hand it out as an opaque handle, which the caller keeps for
// the process's life and passes to every launch of that shape, and as
// out[0] fused, out[1] the main grid, out[2] k_pad, out[3] sb (the packed
// centroid row stride in bytes), out[4] tile rows, out[5] centroid ranges,
// out[6] point stripes.
template <class Tr>
int export_plan(int n, int d, int k, int* out, void** handle) {
  Plan* P = new Plan;
  const cudaError_t err = make_plan<Tr>(n, d, k, P);
  if (err != cudaSuccess) {
    delete P;
    return (int)err;
  }
  const int fields[7] = {P->fused, P->grid,  P->k_pad,  P->sb,
                         16 * P->mt, P->ranges, P->stripes};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  *handle = P;
  return 0;
}

// The plan behind a launch's handle, or null when it was made for another
// shape.
inline const Plan* plan_of(const void* handle, int n, int d, int k) {
  const Plan* P = static_cast<const Plan*>(handle);
  return P && P->n == n && P->d == d && P->k == k ? P : nullptr;
}

template <class Tr>
void launch_main(const Plan& P, const MainArgs& M, cudaStream_t s) {
  if (P.regs)
    main_kernel<Tr, true><<<P.grid, kThreads, P.smem_main, s>>>(M);
  else
    main_kernel<Tr, false><<<P.grid, kThreads, P.smem_main, s>>>(M);
}

// Fill the shape, plan and layout fields of the kernels' arguments.
inline void fill_args(const Plan& P, int n, int d, int k, MainArgs* M,
                      RangeArgs* R) {
  *M = P.main;
  M->n = n;
  M->d = d;
  M->k = k;
  M->fused = P.fused;
  M->mt = P.mt;
  M->mw = P.regs ? 1 : warp_mtiles(P.mt);
  M->kc = P.kc;
  M->stages = P.stages;
  M->sb = P.sb;
  M->ks = P.ks;
  M->k16 = P.k16;
  *R = P.range;
  R->n = n;
  R->d = d;
  R->k = k;
  R->range_k = P.range_k;
  R->stripes = P.stripes;
  R->tr = P.tr;
  R->sb = P.sb;
}

}  // namespace km
