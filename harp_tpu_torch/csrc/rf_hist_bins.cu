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
// as in the one-hot product.  One launch grows a level of the whole forest.
//
// Bound on this card: at 32 trees, 200k x 64 features, 32 bins, level 5 it
// reads the bins once (12.8 MB), row codes and weights (51.2 MB) and writes
// the histogram (16.8 MB): 0.024 ms at 3.35 TB/s; the weighted increments,
// one per (tree, sample of nonzero weight, feature) - 2.59e8 for the
// Poisson(1) weights of the benchmark's fit - take 0.031 ms at one 4-byte
// shared-memory update per bank and clock (32 banks x 132 SMs x 1.98 GHz).
//
// Design (the launch plan - slice width FS, trees a block TG, lanes an item
// W, sub-tiles a super-tile NS, sample chunks - and the block's
// shared-memory layout are made once per card and shape by
// harp_tpu_torch/ops/rf_kernel.py::plan; the launch checks the layout):
//  - A block owns (a group of TG trees, a slice of FS features, a chunk of
//    samples) and keeps those trees' [R, B, FS] int32 histograms in shared
//    memory, the feature fastest.  One staged copy of a sample's bins
//    serves all TG trees.
//  - The block walks its samples in super-tiles of 32 * NS through a ring
//    of kStages shared-memory slots filled by cp.async (16-byte copies
//    where the rows allow, else 4-byte copies of the row codes and weights
//    and element loads of the bins): three super-tiles are in flight while
//    one is counted, and a slot holds the bins [32 NS, FS] and the TG
//    trees' row codes and weights.
//  - Each super-tile is counted in two steps.  The warps take its (tree,
//    32 samples) units: a ballot keeps the samples of nonzero weight and
//    in-range code, and their (row, sample, weight) items go to the
//    block's queue (one shared atomic a unit), so no lane idles on a zero
//    weight.  Then the warps take the queue's batches in turn, so they
//    share the work evenly whatever the weights.
//  - An item's features go to W lanes (32 / W items an instruction; up to
//    2 W features, in two passes).  The cell of (row r, bin b, feature k)
//    sits at (r*B + b)*FSP + k, FSP a multiple of W, so at W = 32 the 32
//    lanes of an update hit 32 banks whatever the bins are (at W = 16 two
//    items share the banks).  A lane group reads the queue entries and bin
//    ids of four items before it issues their increments, so their
//    shared-memory latencies overlap.
//  - int32 shared-memory atomics per increment.  A block that owns its
//    cells (one chunk) stores them; otherwise it adds each nonzero cell to
//    the zeroed histogram with one global atomic.  Integer adds commute,
//    so the counts are bit-identical in any order.
//  - Any n, f, B and R whose one-feature histogram fits in shared memory.
//
// What bounds it (examples/k67_phases.py): the per-item shared-memory
// traffic (a queue entry, one or two bin ids and one or two atomics an
// item and lane group) and, where one tree's 64-feature histogram does not
// fit in a block (levels 4-5 at R = 32, 64), the blocks that each read
// every (tree, sample) again for their own feature slice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // super-tiles in the ring: three in flight
constexpr int kBatch = 4;   // queued items a lane group takes at once

// The launch plan and the block's shared-memory layout, both made by
// rf_kernel.plan / rf_kernel.layout (the one owner of the layout; the
// launch checks that each region holds what the kernel puts there).
struct Plan {
  int fs, tg, w, ns, chunk, nchunks, nslices;
  int fsp;        // histogram columns a (row, bin): fs rounded up to w
  int counts_at;  // bytes: the [tg, R, B, fsp] int32 histograms, then
  int queue_at;   // two int32 counters, the int2 item queue,
  int ring_at;    // and kStages ring slots of
  int slot;       // this many bytes: the bins [32 ns, fs], then at
  int rcw_at;     // this offset the row codes and weights [tg, 32 ns]
};

// cp.async of 16 or 4 bytes, zero-filling what lies past src_bytes
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kVecBins: 16-byte copies of the bins (rows and slices 16-byte aligned),
// else element loads; kVecRcw: 16-byte copies of the row codes and weights
// (n a multiple of 4, aligned bases), else 4-byte copies.
template <typename BinT, bool kVecBins, bool kVecRcw>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const BinT* __restrict__ bins, const int* __restrict__ rowcode,
            const int* __restrict__ weights, int T, int n, int f, int B,
            int R, Plan p, int* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fs = p.fs, fsp = p.fsp;
  const int chunk_id = blockIdx.x % p.nchunks;
  const int g = blockIdx.x / p.nchunks;
  const int f0 = (g % p.nslices) * fs, nf = min(fs, f - f0);
  const int t0 = (g / p.nslices) * p.tg, ntr = min(p.tg, T - t0);
  const int S = p.ns * 32;
  // The offsets are multiples of 16 (the launch checks it); the masks say
  // so to the compiler, which then addresses the regions as aligned
  // (without them K7 is slower: k67_phases' "no alignment hints")
  int* hs = reinterpret_cast<int*>(smem);
  int* counts = reinterpret_cast<int*>(smem + (p.counts_at & ~15L));
  int2* queue = reinterpret_cast<int2*>(smem + (p.queue_at & ~15L));
  unsigned char* ring = smem + (p.ring_at & ~15L);
  const long sb = p.slot & ~15L, bb = p.rcw_at & ~15L;

  {  // zero this block's histograms (16-byte stores over the rounded region)
    int4* h4 = reinterpret_cast<int4*>(hs);
    const long n4 = p.counts_at >> 4;
    for (long c = tid; c < n4; c += kThreads) h4[c] = make_int4(0, 0, 0, 0);
    if (tid < 2) counts[tid] = 0;
  }

  const long i_begin = (long)chunk_id * p.chunk;
  const long i_end = min((long)n, i_begin + p.chunk);
  const long tiles = i_end > i_begin ? (i_end - i_begin + S - 1) / S : 0;

  // the loads of super-tile `tile` into ring slot `slot`
  auto issue = [&](long tile, int slot) {
    const long i0 = i_begin + tile * S;
    BinT* sbins = reinterpret_cast<BinT*>(ring + slot * sb);
    int* src = reinterpret_cast<int*>(ring + slot * sb + bb);
    int* sw = src + p.tg * S;
    if (kVecBins) {
      constexpr int kE = 16 / sizeof(BinT);
      const int cpr = nf / kE;
      for (int c = tid; c < S * cpr; c += kThreads) {
        const int row = c / cpr, col = (c % cpr) * kE;
        const long i = i0 + row;
        copy16(sbins + row * fs + col, i < i_end ? bins + i * f + f0 + col : bins,
               i < i_end ? 16 : 0);
      }
    } else {
      for (int e = tid; e < S * nf; e += kThreads) {
        const int row = e / nf, col = e % nf;
        const long i = i0 + row;
        sbins[row * fs + col] = i < i_end ? bins[i * f + f0 + col] : BinT(0);
      }
    }
    if (kVecRcw) {
      const int q = S / 4;
      for (int c = tid; c < ntr * q; c += kThreads) {
        const int tl = c / q, j = (c % q) * 4;
        const long i = i0 + j;
        const int nb = (int)max(0L, min(16L, (i_end - i) * 4));
        const long at = nb ? (long)(t0 + tl) * n + i : 0;
        copy16(src + tl * S + j, rowcode + at, nb);
        copy16(sw + tl * S + j, weights + at, nb);
      }
    } else {
      for (int c = tid; c < ntr * S; c += kThreads) {
        const int tl = c / S, j = c % S;
        const long i = i0 + j;
        const long at = i < i_end ? (long)(t0 + tl) * n + i : 0;
        copy4(src + tl * S + j, rowcode + at, i < i_end ? 4 : 0);
        copy4(sw + tl * S + j, weights + at, i < i_end ? 4 : 0);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) issue(s, s);
    commit();
  }
  const int W = p.w, G = 32 / W, h = lane / W, k0 = lane % W;
  const unsigned lt = (1u << lane) - 1u;
  const int units = ntr * p.ns;
  for (long tile = 0; tile < tiles; ++tile) {
    wait_copies<kStages - 2>();  // this thread's copies of `tile` landed
    __syncthreads();             // ... everyone's; and `tile - 1` is done
    if (tid == 0) counts[(tile + 1) & 1] = 0;  // the next tile's count
    if (tile + kStages - 1 < tiles)
      issue(tile + kStages - 1, (int)((tile + kStages - 1) % kStages));
    commit();
    const int slot = (int)(tile % kStages);
    const BinT* sbins = reinterpret_cast<const BinT*>(ring + slot * sb);
    const int* src = reinterpret_cast<const int*>(ring + slot * sb + bb);
    const int* sw = src + p.tg * S;
    int* count = counts + (tile & 1);
    // the super-tile's items (nonzero weight, code in range) into the
    // block's queue, a ballot and one shared atomic a (tree, 32 samples)
    for (int u = warp; u < units; u += kWarps) {
      const int tl = u % ntr, s = (u / ntr) * 32 + lane;
      const int r = src[tl * S + s], w = sw[tl * S + s];
      const bool ok = w != 0 && (unsigned)r < (unsigned)R;
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      int at = 0;
      if (lane == 0 && mask) at = atomicAdd(count, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (ok) queue[at + __popc(mask & lt)] = make_int2(((tl * R + r) << 11) | s, w);
    }
    __syncthreads();
    // ... then the warps take its batches in turn, so they share the work
    // evenly whatever the weights
    const int cnt = *count;
    for (int base = warp * G * kBatch; base < cnt; base += kWarps * G * kBatch) {
      // all loads of the batch first, then its increments
      int2 it[kBatch];
      int b0[kBatch], b1[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int idx = base + q * G + h;
        it[q] = idx < cnt ? queue[idx] : make_int2(0, 0);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const BinT* brow = sbins + (it[q].x & 2047) * fs;
        b0[q] = k0 < nf ? (int)brow[k0] : B;
        b1[q] = k0 + W < nf ? (int)brow[k0 + W] : B;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (it[q].y == 0) continue;
        int* hrow = hs + (long)(it[q].x >> 11) * B * fsp;
        if ((unsigned)b0[q] < (unsigned)B)
          atomicAdd(hrow + b0[q] * fsp + k0, it[q].y);
        if ((unsigned)b1[q] < (unsigned)B)
          atomicAdd(hrow + b1[q] * fsp + k0 + W, it[q].y);
      }
    }
  }
  wait_copies<0>();
  __syncthreads();

  // flush: a (tree, row, feature) row of B cells a warp at a time, in the
  // global order (hist[t, r, k*B + b])
  const bool owner = p.nchunks == 1;
  for (int row = warp; row < ntr * R * nf; row += kWarps) {
    const int k = row % nf, r = (row / nf) % R, tl = row / (nf * R);
    const int* src = hs + (long)(tl * R + r) * B * fsp + k;
    int* dst = hist + (((long)(t0 + tl) * R + r) * f + f0 + k) * B;
    for (int b = lane; b < B; b += 32) {
      const int v = src[b * fsp];
      if (owner)
        dst[b] = v;
      else if (v)
        atomicAdd(dst + b, v);
    }
  }
}

template <typename BinT, bool kVecBins, bool kVecRcw>
cudaError_t launch(const void* bins, const int* rowcode, const int* weights,
                   int T, int n, int f, int B, int R, const Plan& p,
                   long smem, int* hist, cudaStream_t s) {
  const int blocks = (T + p.tg - 1) / p.tg * p.nslices * p.nchunks;
  hist_kernel<BinT, kVecBins, kVecRcw><<<blocks, kThreads, smem, s>>>(
      static_cast<const BinT*>(bins), rowcode, weights, T, n, f, B, R, p,
      hist);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_bins(const void* bins, bool vec_bins, bool vec_rcw,
                        const int* rowcode, const int* weights, int T, int n,
                        int f, int B, int R, const Plan& p, long smem,
                        int* hist, cudaStream_t s) {
  if (vec_bins)
    return vec_rcw ? launch<BinT, true, true>(bins, rowcode, weights, T, n, f, B, R, p, smem, hist, s)
                   : launch<BinT, true, false>(bins, rowcode, weights, T, n, f, B, R, p, smem, hist, s);
  return vec_rcw ? launch<BinT, false, true>(bins, rowcode, weights, T, n, f, B, R, p, smem, hist, s)
                 : launch<BinT, false, false>(bins, rowcode, weights, T, n, f, B, R, p, smem, hist, s);
}

template <typename BinT>
cudaError_t allow(int optin) {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(hist_kernel<BinT, true, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(hist_kernel<BinT, true, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(hist_kernel<BinT, false, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  optin)) != cudaSuccess)
    return err;
  return cudaFuncSetAttribute(hist_kernel<BinT, false, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

}  // namespace

extern "C" {

// Once per card (the wrapper keeps the answer): lets every instantiation
// take the card's opt-in shared memory (the kernel has no static part; the
// whole limit, so a plan for one shape never caps another), and returns
// that limit (*optin, bytes) and the SM count (*sms) for the planner.
int rf_hist_bins_setup(int* optin, int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if ((err = allow<uint8_t>(*optin)) != cudaSuccess) return (int)err;
  return (int)allow<int32_t>(*optin);
}

// bins: [n, f] uint8 (bins_int32 = 0) or int32 (1), row-major; rowcode and
// weights [T, n] int32; hist [T, R, f*B] int32, zeroed unless nchunks is 1
// (each block then stores every cell it owns).  The plan (fs, tg, w, ns,
// chunk, nchunks) and the shared-memory layout (fsp, the byte offsets
// counts_at, queue_at and ring_at, a ring slot's bytes and its row codes'
// offset rcw_at, smem in all) come from rf_kernel.plan on this card.  The
// bins take 16-byte copies when their rows and slices are 16-byte aligned,
// the row codes and weights when n is a multiple of 4 and both are aligned.
// Returns a CUDA error code (0 on success).
int rf_hist_bins(const void* bins, int bins_int32, const void* rowcode,
                 const void* weights, int T, int n, int f, int B, int R,
                 int fs, int tg, int w, int ns, int chunk, int nchunks,
                 int fsp, long counts_at, long queue_at, long ring_at,
                 long slot, long rcw_at, long smem, void* hist,
                 void* stream) {
  const int in_size = bins_int32 ? 4 : 1;
  const long S = 32L * ns;
  if (T < 1 || n < 1 || f < 1 || B < 1 || R < 1 || fs < 1 || fs > f ||
      fs > 2 * w || tg < 1 || w < 1 || w > 32 || 32 % w || ns < 1 ||
      ns > 64 || chunk < 1 || chunk % S || nchunks < 1 ||
      (long)chunk * nchunks < n || (long)tg * R > (1 << 20))
    return (int)cudaErrorInvalidValue;
  // each region holds what the kernel puts there, on 16-byte boundaries
  if (fsp < fs || fsp % w || counts_at % 16 || queue_at % 16 ||
      ring_at % 16 || slot % 16 || rcw_at % 16 ||
      counts_at < (long)tg * R * B * fsp * 4 || queue_at < counts_at + 8 ||
      ring_at < queue_at + tg * S * 8 || rcw_at < S * fs * in_size ||
      slot < rcw_at + 2 * tg * S * 4 || smem < ring_at + kStages * slot ||
      smem > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const bool vec_bins = (f * in_size) % 16 == 0 && (fs * in_size) % 16 == 0 &&
                        (uintptr_t)bins % 16 == 0;
  const bool vec_rcw = n % 4 == 0 && (uintptr_t)rowcode % 16 == 0 &&
                       (uintptr_t)weights % 16 == 0;
  Plan p{fs, tg, w, ns, chunk, nchunks, (f + fs - 1) / fs, fsp,
         (int)counts_at, (int)queue_at, (int)ring_at, (int)slot, (int)rcw_at};
  cudaStream_t s = (cudaStream_t)stream;
  const int* rc = (const int*)rowcode;
  const int* wt = (const int*)weights;
  int* out = (int*)hist;
  if (bins_int32)
    return (int)launch_bins<int32_t>(bins, vec_bins, vec_rcw, rc, wt, T, n, f,
                                     B, R, p, smem, out, s);
  return (int)launch_bins<uint8_t>(bins, vec_bins, vec_rcw, rc, wt, T, n, f,
                                   B, R, p, smem, out, s);
}

}  // extern "C"
