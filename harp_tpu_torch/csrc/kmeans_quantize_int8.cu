// The streamed int8 chunk in one pass for Hopper (sm_90a): quantize an f32
// chunk x [n, d] by per-feature scales and take its sum of |x|^2 beside it.
//
// Replaces no TPU kernel.  The reference quantizes a chunk with XLA
// elementwise ops that it fuses by itself; in PyTorch the same expression
// was eight passes over the chunk (divide, round, clamp and cast, then the
// sum of squares' cast, scale, square and sum).  This kernel is their
// fusion on the streaming KMeans loop's int8 path: it writes
//   q = (int8) clamp(rintf(x / s_f), -127, 127)
// bit for bit as x.div(col_scale).round().clamp(-127, 127).to(torch.int8)
// gives it (IEEE division, never a reciprocal: NVCC_FLAGS have no fast math;
// rintf rounds half to even, as torch.round), and
//   x2 = sum_f s_f^2 * sum_rows q^2,
// the int8 chunk's sum of |x|^2 that K1's caller adds to the inertia.
//
// Bound on this card: bytes.  It must read x once (4 B an element) and
// write q once (1 B): 5 B an element, 393 MB at the streaming chunk
// [262,144, 300], 0.117 ms at 3.35 TB/s.  The division is the costliest
// arithmetic (~0.04 ms of the CUDA cores at that shape).
//
// Design:
//  - The chunk is read as a flat array of 16-byte groups of 4 floats.  A
//    tile is the lcm(d, 4) elements after which the columns repeat: P =
//    d / gcd(d, 4) groups (75 at d = 300: one row; 7 at d = 7: four rows).
//    A block of m * P threads takes m tiles at a time and walks the tiles
//    with a stride of the grid, so each thread owns one group position and
//    the same 4 columns for the whole call: it loads their scales once and
//    keeps their sums of q^2 in 4 int32 registers.  Neighbouring threads
//    read neighbouring 16-byte groups and store neighbouring char4s; a
//    thread issues kUnroll tiles' loads before it uses any, so enough bytes
//    are in flight to cover the device memory's latency.  The chunk is
//    read through the read-only path (__ldg).  On an H100 80GB HBM3 at
//    700 W, at [262,144, 300]: 0.1471 ms; 0.1590 with two tiles in flight
//    a thread, 0.1494 with three, 0.1963 with eight (an earlier build);
//    evict-first loads (__ldcs) took 0.1468 alone but 0.1634 right after
//    the generator's write of the chunk, against 0.1518.
//  - The last group of the chunk may run past its end (n * d % 4 != 0), and
//    a ragged last tile holds rows past n: those elements are masked, one at
//    a time.  A base that is not 16-byte aligned (or an int8 output that is
//    not 4-byte aligned) takes element loads and stores of the same groups.
//  - Wider tiles (P > kMaxThreads: d > 4096, or odd d > 1024) are walked
//    by a block a tile at a time, a thread a group after another, and their
//    q^2 go to the block's shared sums one element at a time.
//  - The sum of squares takes no float atomics.  q^2 <= 127^2 accumulates
//    exactly in int32 while a block covers at most kRowLimit = 133,144 rows
//    (133,144 * 127^2 < 2^31; the plan grows the grid to keep under it).
//    Each thread adds its sums into the block's [d] column sums in shared
//    memory, and the block adds those into [d] int64 column sums in device
//    memory (integer atomics: exact, so the same in any order).  The block
//    that draws the last ticket of a global counter forms
//    sum_f s_f^2 * Q_f in double in a fixed order, writes x2 as one f32
//    and zeroes the column sums and the counter for the next call.
//    Reruns are bit-equal, and x2 is the exact sum rounded about once,
//    against the f32 sum of the plain version.  The end takes ~4 us of the
//    call (0.1430 ms without it); a [grid, d] int32 workspace that the last
//    block added up took ~9 us.
//  - One launch a call; the wrapper allocates q and x2, and keeps the
//    column sums and the counter (zero between calls) for each stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 256;  // the plan's least block, where d allows
constexpr int kRowLimit = 133144;  // rows a block: 133,144 * 127^2 < 2^31
constexpr int kUnroll = 4;

struct Args {
  const float* x;
  const float* scale;
  long total;   // n * d elements
  long tiles;   // lcm(d, 4)-element tiles, the last one possibly ragged
  int d;
  int P;        // 16-byte groups a tile
  int m;        // tiles a block takes at a time (narrow tiles)
  int8_t* q;
  unsigned long long* sums;  // [d] column sums of q^2, zero between calls
  unsigned* counter;         // the blocks' tickets, zero between calls
  float* x2;
};

__device__ __forceinline__ int quantize(float v, float s) {
  const float r = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
  return (int)r;
}

// the 4 floats of group g (elements 4g .. 4g + 3), zero past the end
template <bool kVec>
__device__ __forceinline__ float4 load_group(const Args& a, long g) {
  const long e = 4 * g;
  if (kVec && e + 3 < a.total)
    return __ldg(reinterpret_cast<const float4*>(a.x) + g);
  float4 v;
  v.x = e < a.total ? __ldg(a.x + e) : 0.f;
  v.y = e + 1 < a.total ? __ldg(a.x + e + 1) : 0.f;
  v.z = e + 2 < a.total ? __ldg(a.x + e + 2) : 0.f;
  v.w = e + 3 < a.total ? __ldg(a.x + e + 3) : 0.f;
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_group(const Args& a, long g,
                                            const int (&qv)[4]) {
  const long e = 4 * g;
  if (kVec && e + 3 < a.total) {
    reinterpret_cast<char4*>(a.q)[g] =
        make_char4((signed char)qv[0], (signed char)qv[1],
                   (signed char)qv[2], (signed char)qv[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (e + i < a.total) a.q[e + i] = (int8_t)qv[i];
}

// The end of a call.  s_part: the block's [d] column sums.  Adds them to
// the column sums; the last block to finish forms x2 from them.
__device__ void finish(const Args& a, const int* s_part) {
  __shared__ bool s_last;
  __shared__ double s_x[kMaxThreads];
  const int t = threadIdx.x, T = blockDim.x;
  for (int c = t; c < a.d; c += T)
    if (s_part[c]) atomicAdd(a.sums + c, (unsigned long long)s_part[c]);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each thread's columns in order, then the threads in a fixed tree
  double mine = 0.0;
  for (int c = t; c < a.d; c += T) {
    const double s = (double)a.scale[c];
    mine += s * s * (double)__ldcg(a.sums + c);
    a.sums[c] = 0ull;  // ready for the next call on this stream
  }
  s_x[t] = mine;
  __syncthreads();
  for (int w = 1; w < T; w <<= 1) {
    if (t % (2 * w) == 0 && t + w < T) s_x[t] += s_x[t + w];
    __syncthreads();
  }
  if (t == 0) {
    *a.x2 = (float)s_x[0];
    *a.counter = 0u;
  }
}

// Narrow tiles: m * P threads, thread t on group position t % P of tile
// slot t / P.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
quantize_int8_kernel(Args a) {
  extern __shared__ int s_part[];  // [d]
  const int t = threadIdx.x, p = t % a.P, j = t / a.P;
  for (int c = t; c < a.d; c += blockDim.x) s_part[c] = 0;
  int col[4], acc[4] = {0, 0, 0, 0};
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    col[i] = (4 * p + i) % a.d;
    s[i] = a.scale[col[i]];
  }
  const long stride = (long)gridDim.x * a.m;
  long tile = (long)blockIdx.x * a.m + j;
  for (; tile + (kUnroll - 1) * stride < a.tiles; tile += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = load_group<kVec>(a, (tile + u * stride) * a.P + p);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long g = (tile + u * stride) * a.P + p;
      if (4 * g >= a.total) continue;
      const int qv[4] = {quantize(v[u].x, s[0]), quantize(v[u].y, s[1]),
                         quantize(v[u].z, s[2]), quantize(v[u].w, s[3])};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * g + i < a.total) acc[i] += qv[i] * qv[i];
      store_group<kVec>(a, g, qv);
    }
  }
  for (; tile < a.tiles; tile += stride) {
    const long g = tile * a.P + p;
    if (4 * g >= a.total) continue;
    const float4 v = load_group<kVec>(a, g);
    const int qv[4] = {quantize(v.x, s[0]), quantize(v.y, s[1]),
                       quantize(v.z, s[2]), quantize(v.w, s[3])};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * g + i < a.total) acc[i] += qv[i] * qv[i];
    store_group<kVec>(a, g, qv);
  }
  __syncthreads();  // s_part zeroed
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(&s_part[col[i]], acc[i]);
  __syncthreads();
  finish(a, s_part);
}

// Wide tiles (P > kMaxThreads): a block a tile, a thread a group after
// another, each element's q^2 into the block's column sums.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
quantize_int8_wide_kernel(Args a) {
  extern __shared__ int s_part[];  // [d]
  const int t = threadIdx.x;
  for (int c = t; c < a.d; c += blockDim.x) s_part[c] = 0;
  __syncthreads();
  for (long tile = blockIdx.x; tile < a.tiles; tile += gridDim.x)
    for (int p = t; p < a.P; p += blockDim.x) {
      const long g = tile * a.P + p;
      if (4 * g >= a.total) continue;
      const float4 v = load_group<kVec>(a, g);
      const float e[4] = {v.x, v.y, v.z, v.w};
      int qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (4 * p + i) % a.d;
        qv[i] = quantize(e[i], a.scale[c]);
        if (4 * g + i < a.total) atomicAdd(&s_part[c], qv[i] * qv[i]);
      }
      store_group<kVec>(a, g, qv);
    }
  __syncthreads();
  finish(a, s_part);
}

using Fn = void (*)(Args);

Fn kernel_of(int wide, int vec) {
  if (wide) return vec ? quantize_int8_wide_kernel<true>
                       : quantize_int8_wide_kernel<false>;
  return vec ? quantize_int8_kernel<true> : quantize_int8_kernel<false>;
}

int gcd4(int d) { return d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1; }

}  // namespace

extern "C" {

// The launch plan for (n, d) on the current device, as ints: out[0] the
// block's threads, out[1] m (tiles a block takes at a time; 1 when wide),
// out[2] P (16-byte groups a tile), out[3] the grid, out[4] the dynamic
// shared memory, and out[5] wide (1: P > kMaxThreads).  vec: x 16-byte and
// q 4-byte aligned.
int kmeans_quantize_int8_plan(int n, int d, int vec, int* out) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  int dev, sms, per_sm, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int P = d / gcd4(d);
  const int rows_p = 4 / gcd4(d);  // rows a tile
  const long tiles = ((long)n + rows_p - 1) / rows_p;
  const int wide = P > kMaxThreads;
  int m = 1, threads = kMaxThreads;
  if (!wide) {
    // the m that wastes the fewest lanes of the block's last warp, from
    // kMinThreads (or one tile) up to kMaxThreads
    int best = 32;
    for (int c = (kMinThreads + P - 1) / P; c * P <= kMaxThreads; ++c) {
      const int waste = (c * P + 31) / 32 * 32 - c * P;
      if (waste < best) {
        best = waste;
        m = c;
      }
    }
    threads = m * P;
  }
  const size_t smem = (size_t)d * sizeof(int);
  Fn fn = kernel_of(wide, vec);
  if (smem > 48 * 1024) {
    if (smem + 32 * 1024 > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // enough blocks to fill the card, at most one per m tiles, and at least
  // as many as keep a block's rows under kRowLimit
  const long units = (tiles + m - 1) / m;
  long grid = units < (long)sms * per_sm ? units : (long)sms * per_sm;
  const long per_slot = kRowLimit / ((long)m * rows_p);  // tiles a slot
  const long least = (tiles + per_slot * m - 1) / (per_slot * m);
  if (grid < least) grid = least;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  out[0] = threads;
  out[1] = m;
  out[2] = P;
  out[3] = (int)grid;
  out[4] = (int)smem;
  out[5] = wide;
  return 0;
}

// x [n, d] f32 and scale [d] f32 in; q [n, d] int8 and x2 [1] f32 out.  The
// plan fields come from kmeans_quantize_int8_plan for (n, d, vec) on this
// card.  acc holds d + 1 eight-byte words, zero before the first call and
// left zero by every call (one a stream and d): the column sums, then the
// counter.  One launch.  Returns cudaGetLastError() after it (0 on
// success).
int kmeans_quantize_int8(const void* x, const void* scale, int n, int d,
                         int vec, int threads, int m, int P, int grid,
                         int smem, int wide, void* q, void* acc, void* x2,
                         void* stream) {
  Args a;
  a.x = (const float*)x;
  a.scale = (const float*)scale;
  a.total = (long)n * d;
  a.d = d;
  a.P = P;
  a.m = m;
  a.tiles = (a.total + 4L * P - 1) / (4L * P);
  a.q = (int8_t*)q;
  a.sums = (unsigned long long*)acc;
  a.counter = (unsigned*)(a.sums + d);
  a.x2 = (float*)x2;
  kernel_of(wide, vec)<<<grid, threads, (size_t)smem,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
