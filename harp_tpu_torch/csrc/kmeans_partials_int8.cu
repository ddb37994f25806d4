// K1: fused int8 KMeans partials for Hopper (sm_90a), on the int8 tensor
// cores.
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
// operations take about 30 us at the int8 tensor-core rate (1,979 TOP/s).
// At k = 1000, 6e11 operations: about 0.3 ms, over the 0.09 ms of bytes.
//
// What held the first design back: its dots ran on the CUDA cores (__dp4a),
// one block of 8 warps filled an SM (the [k, d] accumulator took 120 KB) and
// loaded each tile synchronously, thread 0 alone added a tile's best
// scores, its one-hot sums walked the tile's rows one after another, and at
// k = 1000 they fell back to one global atomic per (point, feature), 3e8 a
// call.
//
// Design (kmeans_tiles.cuh holds the shared body):
//  - Scores on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, both
//    operands K-major in shared memory and loaded with ldmatrix.  Integer
//    accumulation is exact, so the dots equal __dp4a's bit for bit, and the
//    score keeps its rounding: __fmul_rn((float)dot, c_scale), then
//    __fsub_rn(c2, 2 * prod), never contracted into an FMA ((float)dot
//    rounds an exact int32 as the plain version's .to(float32) does; it is
//    exact for d <= 1040).  Sums and counts stay bit-equal to the plain
//    version's.
//  - A persistent grid of one block a SM.  Each tile's points (64 rows: 300
//    * 64 contiguous bytes, from any base alignment) arrive by one bulk copy
//    into a staging buffer while the previous tile is scored, and are
//    re-strided into the tile.  A warp scores two M-tiles against its
//    centroid pairs; the argmin runs on the accumulator fragments.
//  - k * d * 4 bytes fit in shared memory beside the resident centroids (k =
//    100 at d = 300: 120 KB): one launch does everything.  The one-hot sums
//    are int32 adds in shared memory, each thread owning a column pair of
//    the accumulator (exact, no atomics, no transpose of the int8 tile);
//    each block adds its accumulator into the output with int32 atomics
//    once at the end (k * d a block).
//  - Else (k = 1000): a pack kernel lays the centroids out at the tile's
//    row stride (zero-padded to whole k-steps and to 64 centroids); the main
//    kernel takes 128-row tiles, streams the centroids in chunks of 128
//    through a double-buffered cp.async ring and writes each point's
//    assignment (workspace: n * 4 bytes); range_kernel then gives each
//    block (two a SM) one centroid range whose accumulator fits in shared
//    memory and one stripe of points, fetches the rows assigned into its
//    range by one bulk copy each and adds them as above.  The points are
//    read twice (0.09 ms a read) and no global atomic is taken per point.
//  - Any n (the ragged tile is masked), any k (centroid pairs and chunks
//    loop), any d that one row tile fits.

#include "kmeans_tiles.cuh"

namespace {

using Tr = km::Int8Traits;

// centroids [k, d] int8 -> [k_pad, sb] bytes, zero-padded; c2 and c_scale
// -> [k_pad], zero-padded
__global__ void pack_kernel(const int8_t* __restrict__ c,
                            const float* __restrict__ c2,
                            const float* __restrict__ cs, int k, int d,
                            int k_pad, int sb, uint8_t* __restrict__ cen,
                            float* __restrict__ c2p, float* __restrict__ csp) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (long)k_pad * sb; i += stride) {
    const int row = (int)(i / sb), col = (int)(i % sb);
    cen[i] = (row < k && col < d) ? (uint8_t)c[(long)row * d + col] : 0;
  }
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < k_pad;
       i += stride) {
    c2p[i] = i < k ? c2[i] : 0.f;
    csp[i] = i < k ? cs[i] : 0.f;
  }
}

}  // namespace

extern "C" {

// The launch plan for (n, d, k) on the current device, made once: *handle
// for every launch of that shape, and out[] as km::export_plan gives it.
// out[0] fused (1: one main launch; 0: pack, main and range launches),
// out[1] the main grid (the caller sizes best_partial with it).
int kmeans_partials_int8_plan(int n, int d, int k, int* out, void** handle) {
  return km::export_plan<Tr>(n, d, k, out, handle);
}

// plan: the handle kmeans_partials_int8_plan gave for (n, d, k).
// pts_q [n, d] int8 (any base alignment); c_q [k, d] int8, c_scale and c2
// [k] f32.  Workspace: cen_pack k_pad * sb bytes, c2_pack and cs_pack k_pad
// floats, assign n int32 (unused when fused).  sums [k, d] and counts [k]
// int32 must be zeroed; best_partial holds `grid` floats.  Returns
// cudaGetLastError() after the launches (0 on success).  The fused path
// reads the centroids as they are and leaves the pack buffers untouched.
int kmeans_partials_int8(const void* plan, const void* pts_q,
                         const void* c_q, const void* c_scale, const void* c2,
                         int n, int d, int k, void* cen_pack, void* c2_pack,
                         void* cs_pack, void* assign, void* sums,
                         void* counts, void* best_partial, void* stream) {
  const km::Plan* Pp = km::plan_of(plan, n, d, k);
  if (!Pp) return (int)cudaErrorInvalidValue;
  const km::Plan& P = *Pp;
  cudaError_t err;
  cudaStream_t s = (cudaStream_t)stream;
  if (!P.fused) {
    pack_kernel<<<128, 256, 0, s>>>(
        (const int8_t*)c_q, (const float*)c2, (const float*)c_scale, k, d,
        P.k_pad, P.sb, (uint8_t*)cen_pack, (float*)c2_pack,
        (float*)cs_pack);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  km::MainArgs M;
  km::RangeArgs R;
  km::fill_args(P, n, d, k, &M, &R);
  M.pts = pts_q;
  M.cen_raw = c_q;
  M.c2_raw = (const float*)c2;
  M.cs_raw = (const float*)c_scale;
  M.cen = (const unsigned char*)cen_pack;
  M.c2 = (const float*)c2_pack;
  M.cs = (const float*)cs_pack;
  M.sums = sums;
  M.counts = (int*)counts;
  M.assign = (int*)assign;
  M.partial = (float*)best_partial;
  km::launch_main<Tr>(P, M, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || P.fused) return (int)err;
  R.pts = pts_q;
  R.assign = (const int*)assign;
  R.sums = sums;
  R.counts = (int*)counts;
  km::range_kernel<Tr><<<dim3(P.stripes, P.ranges), km::kThreads,
                         P.smem_range, s>>>(R);
  return (int)cudaGetLastError();
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
