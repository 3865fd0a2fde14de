// K1: fused multi-table embedding-bag forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` of
// src/repro/kernels/fused_embedding.py (launched by `_pallas_forward`, with
// its `_fill_stage`/`_drain_stage` double-buffered DMA staging).
//
// What it computes: out[b, t, :] = combine_j w[b, t, j] * row(enc[b, t, j]),
// where an encoded index v < 0 reads slot -v-1 of the hot-row cache (K, D),
// clamped to K-1, and v >= 0 reads pool row v (already translated to the
// padded store row under a padded layout), clamped to R-1. With no cache
// (K = 0) a negative v reads pool row 0, as the plain version and the
// reference's Pallas kernel (jnp.clip(v, 0, R - 1)) do. Combiners: sum,
// mean (sum / H), max. f32 in and f32 out; accumulation is f32.
//
// Bound on this card: bytes, and in practice latency. A full-width
// Wide&Deep batch (B=512, T=26, H=4) reads ~23,400 distinct cold rows of
// 64 B from the deep D=16 pool, the 64 hot rows, 213 KB of indices, and
// writes a (B, T, 16) output: 2.57 MB, 0.766 us at 3.35 TB/s, against
// ~0.85 MFLOP. Each output needs two dependent DRAM trips (the index, then
// the row) and a store, and a launch that loads one word and stops already
// takes ~5.3 us timed with events after an L2 eviction (PERF.md), so what
// the design can win is latency: every load of a bag in flight at once.
//
// Design. D and H are template parameters on the main path's shapes (every
// DLRM config has H = multi_hot = 4, the deep pool D = 16, the wide pool
// D = 1), so no thread divides by a runtime width or walks a runtime loop:
// * D=16, H=4 (vector route): 4 lanes own a bag, one float4 of its output
//   row each, 8 bags per warp. Each lane loads the bag's 4 indices as one
//   int4 (the 4 lanes read the same 16 bytes, so a warp's index load is one
//   128-byte line) and the 4 weights as one float4, then issues its 4 row
//   pieces as float4 loads, and only then combines, in order j = 0..3.
// * D=1, H=4 (wide route): a thread owns a bag: one int4 of indices, 4
//   scattered word loads, one float4 of weights; 64-thread blocks, so the
//   main path's 13,312 bags make 208 blocks and reach every SM. 4 lanes per
//   bag, one lookup each, combined by shuffles, measured the same or
//   0.1 us slower (commit 8a45165, PERF.md).
// * D=128, any bags (d128 route; DLRM-DCNv2's 26 tables of 1 to 100
//   lookups): a warp owns a bag, lane l a float4 of its row (32 x 4 =
//   128). The lanes load up to 32 of the bag's indices (and weights) at
//   once, one each, in one coalesced load; __shfl_sync hands them out 8 at
//   a time, and each lane issues those 8 row pieces before it combines
//   them in order. A 100-lookup bag is 13 such rounds of 8 rows in flight;
//   one thread walking 128 x 100 scalar loads (the generic route) would be
//   12,800 dependent round trips.
// * Any other (D, H), or arrays not on 16 bytes (generic route): a thread
//   owns a bag and walks its D outputs and H lookups with runtime bounds.
// Ragged bags (bag_start non-null): table t has H_t lookups, bag (b, t)
// reads lookups [b*L + bag_start[t], b*L + bag_start[t+1]) of the
// sample-major (B, L) indices, L = sum_t H_t; they take the d128 route or
// the generic one. With every H_t equal the caller passes H and no starts:
// the layout is then the (B, T, H) one.
// A row's address needs nothing but its index (a cache slot or a clamped
// pool row, never a load), so nvcc issues all of a bag's row loads before
// the first combine; `cuobjdump -sass` shows one index load, then the 4 row
// loads, then the adds (PERF.md). The wrapper picks the route
// (`bag_route` in kernels/fused_embedding.py, from D, H and the arrays'
// alignment) and the grid (`bag_plan`: the work, one block per 256 or 64
// threads); one launch per call. On Hopper the hot-row "cache" is the
// packed hot prefix, which stays resident in the 50 MB L2, so no shared
// memory staging is done; it holds bit-identical copies of pool rows, so
// output with the cache on equals output with it off bit for bit. The
// TPU's double-buffered DMA, its batch padding to block_b and its SMEM
// index blocks are not carried over.
//
// Numerics: the products and sums use __fmul_rn/__fadd_rn/__fdiv_rn, which
// nvcc never contracts into FMAs, in the order j = 0..H-1. The plain PyTorch
// version (`embedding_bag_plain`) performs the same operations in the same
// order, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kMax = 2;

// routes: _ROUTE_CODE in kernels/fused_embedding.py
constexpr int kGeneric = 0;
constexpr int kVector = 1;
constexpr int kWide = 2;
constexpr int kD128 = 3;

// threads per block: BAG_THREADS in kernels/fused_embedding.py
constexpr int kVecThreads = 256;
constexpr int kWideThreads = 64;
constexpr int kAnyThreads = 256;
constexpr int kD128Threads = 256;
constexpr int kD128Flight = 8;  // d128 route: rows a lane has in flight
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kH = 4;           // lookups per bag on the vector and wide routes

// The first element of the row that encoded index v reads (see the header).
__device__ __forceinline__ const float* lookup(
    const float* pool, long long R, const float* cache, long long K, int v,
    long long D) {
  const long long slot = min(-(long long)v - 1, K - 1);
  const long long row = min(max((long long)v, 0LL), R - 1);
  return (v < 0 && K > 0) ? cache + slot * D : pool + row * D;
}

template <int COMBINER>
__device__ __forceinline__ float combine(float acc, float x, int j) {
  if (COMBINER == kMax) return (j == 0 || x > acc) ? x : acc;
  return j == 0 ? x : __fadd_rn(acc, x);
}

template <int COMBINER>
__device__ __forceinline__ float4 combine(float4 acc, float4 x, int j) {
  return make_float4(combine<COMBINER>(acc.x, x.x, j),
                     combine<COMBINER>(acc.y, x.y, j),
                     combine<COMBINER>(acc.z, x.z, j),
                     combine<COMBINER>(acc.w, x.w, j));
}

template <int COMBINER>
__device__ __forceinline__ float finish(float acc, int H) {
  return COMBINER == kMean ? __fdiv_rn(acc, (float)H) : acc;
}

template <int COMBINER>
__device__ __forceinline__ float4 finish(float4 acc, int H) {
  return make_float4(finish<COMBINER>(acc.x, H), finish<COMBINER>(acc.y, H),
                     finish<COMBINER>(acc.z, H), finish<COMBINER>(acc.w, H));
}

__device__ __forceinline__ float scale(float x, float w) {
  return __fmul_rn(x, w);
}

__device__ __forceinline__ float4 scale(float4 x, float w) {
  return make_float4(__fmul_rn(x.x, w), __fmul_rn(x.y, w), __fmul_rn(x.z, w),
                     __fmul_rn(x.w, w));
}

// Combine the H = 4 loaded lookups of a bag in order, weighted first.
template <int COMBINER, class T>
__device__ __forceinline__ T combine4(const T (&x)[kH], bool weighted,
                                      float4 w) {
  const float ws[kH] = {w.x, w.y, w.z, w.w};
  T acc = x[0];
#pragma unroll
  for (int j = 0; j < kH; ++j)
    acc = combine<COMBINER>(acc, weighted ? scale(x[j], ws[j]) : x[j], j);
  return finish<COMBINER>(acc, kH);
}

// ---------------------------------------------------------------------------
// D=16, H=4, vector route: 4 lanes per bag, one float4 of the row each
// ---------------------------------------------------------------------------
template <int COMBINER>
__global__ void __launch_bounds__(kVecThreads) bag_vec16_kernel(
    const float* __restrict__ pool, long long R,
    const int32_t* __restrict__ enc, const float* __restrict__ weights,
    const float* __restrict__ cache, long long K, float* __restrict__ out,
    long long n_bags) {
  constexpr int D = 16;
  constexpr int kLanes = D / 4;               // float4s per row
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bag = i >> 2;
  if (bag >= n_bags) return;
  const int c = (int)(i & (kLanes - 1));
  const int4 v = __ldg(reinterpret_cast<const int4*>(enc) + bag);
  const bool weighted = weights != nullptr;
  const float4 w = weighted
      ? __ldg(reinterpret_cast<const float4*>(weights) + bag)
      : make_float4(1.f, 1.f, 1.f, 1.f);
  const int vs[kH] = {v.x, v.y, v.z, v.w};
  float4 x[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j)
    x[j] = __ldg(reinterpret_cast<const float4*>(
                     lookup(pool, R, cache, K, vs[j], D)) + c);
  reinterpret_cast<float4*>(out)[i] = combine4<COMBINER>(x, weighted, w);
}

// ---------------------------------------------------------------------------
// D=1, H=4, wide route: a bag per thread, one int4 of indices
// ---------------------------------------------------------------------------
template <int COMBINER>
__global__ void __launch_bounds__(kWideThreads) bag_wide_kernel(
    const float* __restrict__ pool, long long R,
    const int32_t* __restrict__ enc, const float* __restrict__ weights,
    const float* __restrict__ cache, long long K, float* __restrict__ out,
    long long n_bags) {
  const long long bag = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bag >= n_bags) return;
  const int4 v = __ldg(reinterpret_cast<const int4*>(enc) + bag);
  const bool weighted = weights != nullptr;
  const float4 w = weighted
      ? __ldg(reinterpret_cast<const float4*>(weights) + bag)
      : make_float4(1.f, 1.f, 1.f, 1.f);
  const int vs[kH] = {v.x, v.y, v.z, v.w};
  float x[kH];
#pragma unroll
  for (int j = 0; j < kH; ++j)
    x[j] = __ldg(lookup(pool, R, cache, K, vs[j], 1));
  out[bag] = combine4<COMBINER>(x, weighted, w);
}

// The first lookup of a bag and its length: bag * H and H, or for ragged
// bags (starts non-null) b * L + starts[t] and starts[t+1] - starts[t].
struct BagSpan {
  long long first;
  int len;
};

__device__ __forceinline__ BagSpan bag_span(long long bag, int H,
                                            const int32_t* starts, int T,
                                            int L) {
  if (starts == nullptr) return {bag * H, H};
  const long long b = bag / T;
  const int t = (int)(bag - b * T);
  const int s = __ldg(starts + t);
  return {b * L + s, __ldg(starts + t + 1) - s};
}

// ---------------------------------------------------------------------------
// D=128, d128 route: a warp per bag, a float4 of the row per lane. The
// minimum of one block an SM lets ptxas (CUDA 12.9) take the 70 registers
// the 8 rows in flight need; without it it stops at 64 and spills 8 bytes
// (3 resident blocks an SM instead of 4: 0.254 ms instead of 0.238 ms on a
// DCNv2 batch on the H100, no spill kept on the main path).
// ---------------------------------------------------------------------------
template <int COMBINER>
__global__ void __launch_bounds__(kD128Threads, 1) bag_d128_kernel(
    const float* __restrict__ pool, long long R,
    const int32_t* __restrict__ enc, const float* __restrict__ weights,
    const float* __restrict__ cache, long long K, float* __restrict__ out,
    long long n_bags, int H, const int32_t* __restrict__ starts, int T,
    int L) {
  constexpr int D = 128;
  const long long bag =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (bag >= n_bags) return;                  // the whole warp leaves
  const int lane = threadIdx.x & 31;
  const BagSpan span = bag_span(bag, H, starts, T, L);
  const bool weighted = weights != nullptr;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < span.len; j0 += 32) {
    const int n = min(32, span.len - j0);
    const long long at = span.first + j0 + lane;
    const int my_v = lane < n ? __ldg(enc + at) : 0;
    const float my_w = weighted && lane < n ? __ldg(weights + at) : 1.f;
    for (int u0 = 0; u0 < n; u0 += kD128Flight) {
      float4 x[kD128Flight];
#pragma unroll
      for (int u = 0; u < kD128Flight; ++u) {
        const int v = __shfl_sync(kFullMask, my_v, (u0 + u) & 31);
        x[u] = u0 + u < n
                   ? __ldg(reinterpret_cast<const float4*>(
                               lookup(pool, R, cache, K, v, D)) + lane)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kD128Flight; ++u) {
        const float w = __shfl_sync(kFullMask, my_w, (u0 + u) & 31);
        if (u0 + u < n)
          acc = combine<COMBINER>(acc, weighted ? scale(x[u], w) : x[u],
                                  j0 + u0 + u);
      }
    }
  }
  reinterpret_cast<float4*>(out)[bag * (D / 4) + lane] =
      finish<COMBINER>(acc, span.len);
}

// ---------------------------------------------------------------------------
// any other (D, H), generic route: a bag per thread, runtime bounds
// ---------------------------------------------------------------------------
template <int COMBINER>
__global__ void __launch_bounds__(kAnyThreads) bag_any_kernel(
    const float* __restrict__ pool, long long R,
    const int32_t* __restrict__ enc, const float* __restrict__ weights,
    const float* __restrict__ cache, long long K, float* __restrict__ out,
    long long n_bags, int H, int D, const int32_t* __restrict__ starts,
    int T, int L) {
  const long long bag = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (bag >= n_bags) return;
  const BagSpan span = bag_span(bag, H, starts, T, L);
  const int32_t* bag_idx = enc + span.first;
  const float* bag_w = weights == nullptr ? nullptr : weights + span.first;
  float* bag_out = out + bag * D;
  H = span.len;
  for (int d = 0; d < D; ++d) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j) {
      float x = __ldg(lookup(pool, R, cache, K, __ldg(bag_idx + j), D) + d);
      if (bag_w != nullptr) x = scale(x, __ldg(bag_w + j));
      acc = combine<COMBINER>(acc, x, j);
    }
    bag_out[d] = finish<COMBINER>(acc, H);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int COMBINER>
int launch(int route, int blocks, cudaStream_t s, const float* pool,
           long long R, const int32_t* enc, const float* w, const float* c,
           long long K, float* o, long long n_bags, int H, int D,
           const int32_t* starts, int T, int L) {
  switch (route) {
    case kVector:
      bag_vec16_kernel<COMBINER><<<blocks, kVecThreads, 0, s>>>(
          pool, R, enc, w, c, K, o, n_bags);
      break;
    case kWide:
      bag_wide_kernel<COMBINER><<<blocks, kWideThreads, 0, s>>>(
          pool, R, enc, w, c, K, o, n_bags);
      break;
    case kD128:
      bag_d128_kernel<COMBINER><<<blocks, kD128Threads, 0, s>>>(
          pool, R, enc, w, c, K, o, n_bags, H, starts, T, L);
      break;
    default:
      bag_any_kernel<COMBINER><<<blocks, kAnyThreads, 0, s>>>(
          pool, R, enc, w, c, K, o, n_bags, H, D, starts, T, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `route` and `blocks` come from `bag_route`/`bag_plan`; a vector, wide or
// d128 route whose shape or alignment does not hold is refused here.
// Ragged bags pass `starts` (T + 1 int32 on the device), T and L (the
// lookups of a sample), and H = 0; the vector and wide routes take none.
extern "C" int repro_fused_embedding_bag_f32(
    const void* pool, long long R, const void* enc, const void* weights,
    const void* cache, long long K, void* out, long long n_bags, int H,
    int D, int combiner, int route, int blocks, const void* starts, int T,
    int L, void* stream) {
  if (n_bags * D == 0) return 0;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  if (route < kGeneric || route > kD128 ||
      combiner < kSum || combiner > kMax)
    return (int)cudaErrorInvalidValue;
  if ((starts == nullptr) != (H > 0) || (starts != nullptr && T <= 0))
    return (int)cudaErrorInvalidValue;
  if (route != kGeneric) {
    const bool shape =
        route == kD128 ? D == 128
                       : starts == nullptr && H == kH &&
                             D == (route == kVector ? 16 : 1);
    const bool aligned = aligned16(pool) && aligned16(enc) &&
                         aligned16(out) && aligned16(weights) &&
                         aligned16(cache);    // null is aligned
    if (!shape) return (int)cudaErrorInvalidValue;
    if (!aligned) return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pool);
  const int32_t* e = static_cast<const int32_t*>(enc);
  const float* w = static_cast<const float*>(weights);
  const float* c = static_cast<const float*>(cache);
  const int32_t* st = static_cast<const int32_t*>(starts);
  float* o = static_cast<float*>(out);
  switch (combiner) {
    case kSum:
      return launch<kSum>(route, blocks, s, p, R, e, w, c, K, o, n_bags, H, D,
                          st, T, L);
    case kMean:
      return launch<kMean>(route, blocks, s, p, R, e, w, c, K, o, n_bags, H,
                           D, st, T, L);
    default:
      return launch<kMax>(route, blocks, s, p, R, e, w, c, K, o, n_bags, H, D,
                          st, T, L);
  }
}
