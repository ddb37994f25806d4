// K2: fused f32 KMeans partials for Hopper (sm_90a), on the bf16 tensor
// cores.
//
// Replaces harp_tpu/ops/kmeans_kernel.py::kmeans_partials (Pallas body
// _kernel).  One pass over points [n, d] (f32 or bf16) that reproduces the
// TPU kernel's numerics: points and centroids are rounded to bf16 for the
// dot, c2 comes from the bf16-rounded centroids (the wrapper passes both),
// score = c2 - 2 * dot, argmin with the lowest index winning ties, one-hot
// sums of the bf16-rounded points, counts, and inertia = sum |x|^2 (from the
// full-precision points) + sum of best scores.  bf16 x bf16 products are
// exact in f32, so the kernel differs from its plain version only in the
// order (and, inside the tensor cores, the rounding) of f32 additions.
//
// Bound on this card: memory.  At 1M x 300, k = 100 it must read 1.2 GB of
// f32 points (about 0.36 ms at 3.35 TB/s); the 2*n*k*d = 6e10 bf16
// operations take about 0.06 ms at the bf16 tensor-core rate (989 TFLOP/s).
// At k = 1000 the 6e11 operations take about 0.6 ms, over the bytes.
//
// What held the first design back: its dots were f32 FMAs on the CUDA cores
// (a floor near 0.9 ms at k = 100), one block of 8 warps filled an SM (the
// [k, d] accumulator took 120 KB) and loaded each tile synchronously, thread
// 0 alone added a tile's best scores, and at k = 1000 each block
// read-modify-wrote its own [k, d] slab in global memory (grid x 1.2 MB),
// summed over the grid by a second kernel.
//
// Design (kmeans_tiles.cuh holds the shared body):
//  - Scores on the tensor cores: the tile is rounded to bf16 as it is
//    re-strided into shared memory and scored with mma.sync m16n8k16 bf16 ->
//    f32 (both operands K-major, ldmatrix).  The argmin runs on the
//    accumulator fragments (quad shuffles, lowest index on ties).
//  - A persistent grid of one block a SM; each tile's f32 points (one
//    contiguous run, any base alignment) arrive by one bulk copy into a
//    staging buffer while the previous tile is scored and summed.  No 2-D
//    TMA: a tensor map needs 16-byte row strides, which bf16 rows of 300
//    lack.
//  - Deterministic sums, no float atomics: each thread owns a column pair of
//    the [k, d] f32 accumulator and adds the tile's rows in order (four at
//    once when their centroids differ).
//  - k * d * 4 bytes fit in shared memory (k = 100 at d = 300): with k <= 128
//    and at most 20 k-steps (d <= 320) each warp holds one centroid pair's
//    B fragments in registers for the whole kernel, which leaves room for
//    48-row tiles and their f32 staging; the block writes its accumulator
//    to its slab of a [grid, k, d] workspace (132 blocks x 120 KB = 15.8 MB
//    on an H100 at k = 100).
//  - Else (k = 1000): a pack kernel lays the centroids out as bf16 rows at
//    the tile's stride (zero-padded to whole k-steps and to 64 centroids);
//    the main kernel streams them in chunks of 64 through a double-buffered
//    cp.async ring (two M-tiles a warp) and writes each point's assignment
//    (n * 4 bytes); range_kernel gives each block (two a SM) one centroid
//    range whose accumulator fits in shared memory and one stripe of
//    points, fetches the stripe's rows assigned into its range in point
//    order by one bulk copy each, and writes its range of a [stripes, k, d]
//    workspace (16 stripes x 1.2 MB = 19.2 MB on an H100 at k = 1000, d =
//    300).
//  - reduce_kernel adds the slabs in order.  Counts are int32 atomics
//    (exact); inertia partials are summed in a fixed order per block.
//    Reruns on one card are bit-equal.
//  - Any n (ragged tile masked), any k (centroid pairs and chunks loop),
//    any d that one row tile fits.

#include "kmeans_tiles.cuh"

namespace {

// centroids [k, d] f32 (bf16-rounded values) -> bf16 [k_pad, sb / 2],
// zero-padded; c2 -> [k_pad], zero-padded
__global__ void pack_kernel(const float* __restrict__ c,
                            const float* __restrict__ c2, int k, int d,
                            int k_pad, int sb, uint16_t* __restrict__ cen,
                            float* __restrict__ c2p) {
  const long stride = (long)gridDim.x * blockDim.x;
  const int se = sb / 2;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (long)k_pad * se; i += stride) {
    const int row = (int)(i / se), col = (int)(i % se);
    cen[i] = (row < k && col < d)
                 ? (uint16_t)km::bf16_bits(c[(long)row * d + col])
                 : (uint16_t)0;
  }
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < k_pad;
       i += stride)
    c2p[i] = i < k ? c2[i] : 0.f;
}

// sums[i] = sum over slabs b, in order, of slabs[b][i]
__global__ void reduce_kernel(const float* __restrict__ slabs, int nslabs,
                              long kd, float* __restrict__ sums) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kd) return;
  float s = 0.f;
  for (int b = 0; b < nslabs; ++b) s += slabs[(long)b * kd + i];
  sums[i] = s;
}

template <class Tr>
int run(const km::Plan& P, const void* pts, const void* cen, const void* c2,
        int n, int d, int k, void* cen_pack, void* c2_pack, void* assign,
        void* slabs, void* counts, void* inertia_partial, void* sums,
        cudaStream_t s) {
  cudaError_t err;
  if (!P.fused) {
    pack_kernel<<<128, 256, 0, s>>>((const float*)cen, (const float*)c2, k,
                                    d, P.k_pad, P.sb, (uint16_t*)cen_pack,
                                    (float*)c2_pack);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  km::MainArgs M;
  km::RangeArgs R;
  km::fill_args(P, n, d, k, &M, &R);
  M.pts = pts;
  M.cen_raw = cen;
  M.c2_raw = (const float*)c2;
  M.cs_raw = nullptr;
  M.cen = (const unsigned char*)cen_pack;
  M.c2 = (const float*)c2_pack;
  M.cs = nullptr;
  M.sums = slabs;
  M.counts = (int*)counts;
  M.assign = (int*)assign;
  M.partial = (float*)inertia_partial;
  km::launch_main<Tr>(P, M, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!P.fused) {
    R.pts = pts;
    R.assign = (const int*)assign;
    R.sums = slabs;
    R.counts = (int*)counts;
    km::range_kernel<Tr><<<dim3(P.stripes, P.ranges), km::kThreads,
                           P.smem_range, s>>>(R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long kd = (long)k * d;
  reduce_kernel<<<(unsigned)((kd + 255) / 256), 256, 0, s>>>(
      (const float*)slabs, P.fused ? P.grid : P.stripes, kd, (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for (n, d, k) on the current device, made once: *handle
// for every launch of that shape, and out[] as km::export_plan gives it.
// out[0] fused (1: main and reduce launches; 0: pack, main, range and
// reduce), out[1] the main grid (inertia partials).  The [slabs, k, d]
// workspace has out[1] slabs when fused, else out[6] (point stripes).
int kmeans_partials_plan(int n, int d, int k, int pts_bf16, int* out,
                         void** handle) {
  return pts_bf16 ? km::export_plan<km::Bf16Traits<__nv_bfloat16>>(
                        n, d, k, out, handle)
                  : km::export_plan<km::Bf16Traits<float>>(n, d, k, out,
                                                           handle);
}

// plan: the handle kmeans_partials_plan gave for (n, d, k) and pts_bf16.
// pts: [n, d] f32 (pts_bf16 = 0) or bf16 (pts_bf16 = 1); cen: [k, d] f32
// holding bf16-rounded values; c2: [k] f32 from those.  Workspace: cen_pack
// k_pad * sb bytes, c2_pack k_pad floats, assign n int32 (unused when
// fused), slabs [slabs, k, d] f32 (no initialisation needed).  counts [k]
// int32 must be zeroed; inertia_partial holds `grid` floats; sums [k, d] f32
// is written.  Returns cudaGetLastError() after the launches (0 on success).
// The fused path reads the centroids as they are and leaves the pack
// buffers untouched.
int kmeans_partials(const void* plan, const void* pts, int pts_bf16,
                    const void* cen, const void* c2, int n, int d, int k,
                    void* cen_pack, void* c2_pack, void* assign, void* slabs,
                    void* counts, void* inertia_partial, void* sums,
                    void* stream) {
  const km::Plan* P = km::plan_of(plan, n, d, k);
  if (!P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (pts_bf16)
    return run<km::Bf16Traits<__nv_bfloat16>>(
        *P, pts, cen, c2, n, d, k, cen_pack, c2_pack, assign, slabs, counts,
        inertia_partial, sums, s);
  return run<km::Bf16Traits<float>>(*P, pts, cen, c2, n, d, k, cen_pack,
                                    c2_pack, assign, slabs, counts,
                                    inertia_partial, sums, s);
}

#ifdef KM_PHASES
// the phase clocks of the last launch (kmeans_tiles.cuh), one row a block
int kmeans_phases(unsigned long long* main_clk, unsigned long long* range_clk) {
  cudaError_t err = cudaMemcpyFromSymbol(main_clk, km::km_main_clk,
                                         sizeof(km::km_main_clk));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(range_clk, km::km_range_clk,
                               sizeof(km::km_range_clk));
  return (int)err;
}
#endif

}  // extern "C"
