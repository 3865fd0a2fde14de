// The sparse backward's segment sum, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference sums the dedupe's sorted
// segments in XLA (`jax.ops.segment_sum` in `dedupe_rows` of
// src/repro/kernels/fused_embedding.py). It was added because PyTorch's
// `torch.segment_reduce`, which the port called there, sums each
// (segment, column) in one thread, so its time follows the longest segment:
// Criteo Kaggle's tables of 3 to 27 rows put up to ~146 k of a full-width
// Wide&Deep step's 262,144 lookups of a table on one row, and the sum with
// the sorted gather before it took 29 of the step's 37.6 device ms.
//
// What it computes: for each segment j < n_uniq, entries [ends[j-1],
// ends[j]) of the stable sort's permutation `order`, row j of `vals` is
// 0.f + src[order[k0] / H] + src[order[k1] / H] + ... in sorted-entry
// order, each add an uncontracted __fadd_rn: the order and rounding of
// `segment_reduce`'s sum (a zero initial value, then one element after
// another in f32), so the result is bit-identical to it. H = 1 reads
// per-lookup cotangents (the rows route: max and weighted bags); H > 1
// reads the (B*T, D) bag cotangent, which every lookup of an unweighted
// sum or mean bag shares (the bags route), so neither the (N, D) copy of
// the expanded cotangent nor the sorted gather of it exists. Ragged bags
// (DLRM-DCNv2: table t has H_t lookups a sample, sample-major, L = sum_t
// H_t) read bag (o / L) * T + cols[o % L] for lookup o, through the
// plan's (L,) column-to-table map `cols`.
//
// Bound on this card: the longest segment's chain of dependent adds, then
// bytes. Wide&Deep's longest segment is ~146 k adds in each column, ~0.3 ms
// at ~4 cycles an add and 1.98 GHz; its deep store moves ~0.6 GB (the
// order, the bag cotangents, the zeroed (N, 16) output), ~0.2 ms at
// 3.35 TB/s.
//
// Design, two launches on the caller's stream and no host sync:
// * first pass: a thread owns one (segment, 4-column piece) at D % 4 == 0
//   (one float4 a lookup), or one (segment, column); it loads 8 of its
//   segment's entries, then their 8 cotangents, then adds them, so its
//   loads are in flight together. A segment longer than kShortMax is not
//   summed there: its id goes to a device-side list (atomicAdd), those of
//   at least kFirstLong entries at the front, the others at the back.
// * second pass, a fixed grid (one wave): a block takes one listed segment
//   at a time (atomicAdd; the front of the list first, so the longest
//   chains start at once) and walks it in tiles through a two-stage ring
//   in shared memory. In each step, 15 warps load the next tile's entries
//   of `order` and gather the tile after that's cotangents, all loads of a
//   thread in flight together, while the lanes of warp 0, one column each,
//   add the tile before in order from shared memory, with the next 16
//   values loaded ahead of the adds. A column's sum stays in a register
//   (D <= 32) or goes through `vals` between tiles (any wider D).
// kShortMax = 64 and kC = 16 timed fastest at Wide&Deep's shapes among
// kShortMax 32, 64, 256 and kC 8, 16; ring stages of 8,192 floats or
// 256-thread blocks were slower (PERF.md, the segment sum's findings).
// A segment is one chain wherever it is summed, so the list's order and
// the pass that sums it change no bit. The caller zeroes `vals` (the
// sentinel tail stays zero) and `work`; the kernels allocate nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShortMax = 64;       // the longest segment the first pass sums
constexpr int kFirstLong = 16384;   // listed at the front, handed out first
constexpr int kShortThreads = 256;
constexpr int kLongThreads = 512;   // warp 0 adds, the other 15 load
constexpr int kLoaders = kLongThreads - 32;
constexpr int kTileFloats = 16384;  // floats of one stage of the ring
constexpr int kMaxTile = 2048;      // entries of one stage
constexpr int kU = 8;               // first pass: entries in flight a thread
constexpr int kA = (kMaxTile + kLoaders - 1) / kLoaders;  // order loads
constexpr int kB = 9;               // cotangent loads a loader has in flight
constexpr int kC = 16;              // values warp 0 loads ahead of its adds

// a thread's piece of a row: one float, or a float4 at D % 4 == 0
template <bool kVec> struct Piece {
  using T = float;
  static constexpr int W = 1;
};
template <> struct Piece<true> {
  using T = float4;
  static constexpr int W = 4;
};

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float load(const float* p, float) {
  return __ldg(p);
}
__device__ __forceinline__ float4 load(const float* p, float4) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// which row of `src` lookup o reads: o / H, or for ragged bags (cols
// non-null) (o / L) * T + cols[o % L]
struct BagMap {
  unsigned H;
  const int* cols;
  unsigned L, T;
};

__device__ __forceinline__ unsigned bag_of(unsigned o, const BagMap& m) {
  if (m.cols != nullptr) return (o / m.L) * m.T + __ldg(m.cols + o % m.L);
  return m.H == 1 ? o : o / m.H;
}

// the row of `src` that sorted entry k reads (order[k] < 2^31: the wrapper
// checks N)
__device__ __forceinline__ unsigned src_row(const long long* order,
                                            long long k, const BagMap& m) {
  return bag_of(static_cast<unsigned>(__ldg(order + k)), m);
}

__device__ __forceinline__ long long seg_begin(const long long* ends,
                                               long long j) {
  return j ? __ldg(ends + j - 1) : 0;
}

// ---------------------------------------------------------------------------
// first pass: short segments, a thread per (segment, piece)
// ---------------------------------------------------------------------------
template <int kD, bool kVec>
__global__ void __launch_bounds__(kShortThreads) segment_sum_short_kernel(
    const long long* __restrict__ order, const long long* __restrict__ ends,
    const float* __restrict__ src, long long n_uniq, int d_rt, BagMap H,
    float* __restrict__ vals, int* work, int* long_ids) {
  using T = typename Piece<kVec>::T;
  constexpr int W = Piece<kVec>::W;
  const int D = kD ? kD : d_rt;
  const int P = D / W;                           // threads a segment
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_uniq * P) return;
  const long long j = t / P;
  const int col = (int)(t - j * P) * W;
  const long long beg = seg_begin(ends, j);
  const long long end = __ldg(ends + j);
  if (end - beg > kShortMax) {
    if (col == 0) {
      if (end - beg >= kFirstLong)
        long_ids[atomicAdd(work, 1)] = (int)j;
      else
        long_ids[n_uniq - 1 - atomicAdd(work + 1, 1)] = (int)j;
    }
    return;
  }
  T acc = zero(T{});
  for (long long k = beg; k < end; k += kU) {
    unsigned r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      r[u] = k + u < end ? src_row(order, k + u, H) : 0;
    T v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      v[u] = k + u < end ? load(src + (long long)r[u] * D + col, T{})
                         : zero(T{});
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (k + u < end) acc = add(acc, v[u]);
  }
  store(vals + j * D + col, acc);
}

// ---------------------------------------------------------------------------
// second pass: listed segments, a block each, through a ring of two tiles
// ---------------------------------------------------------------------------

// a = a + p[0] + p[D] + ... + p[(n-1) D], in order, with the next kC values
// loaded before the current kC are added
template <int kD>
__device__ __forceinline__ float chain(const float* p, int n, int d_rt,
                                       float a) {
  const int D = kD ? kD : d_rt;
  int e = 0;
  if (n >= 2 * kC) {
    float x[kC];
#pragma unroll
    for (int u = 0; u < kC; ++u) x[u] = p[u * D];
    for (e = kC; e + kC <= n; e += kC) {
      float y[kC];
#pragma unroll
      for (int u = 0; u < kC; ++u) y[u] = p[(e + u) * D];
#pragma unroll
      for (int u = 0; u < kC; ++u) a = __fadd_rn(a, x[u]);
#pragma unroll
      for (int u = 0; u < kC; ++u) x[u] = y[u];
    }
#pragma unroll
    for (int u = 0; u < kC; ++u) a = __fadd_rn(a, x[u]);
  }
  for (; e < n; ++e) a = __fadd_rn(a, p[e * D]);
  return a;
}

template <int kD, bool kVec>
__global__ void __launch_bounds__(kLongThreads) segment_sum_long_kernel(
    const long long* __restrict__ order, const long long* __restrict__ ends,
    const float* __restrict__ src, long long n_uniq, int d_rt, BagMap H,
    int tile, float* __restrict__ vals, int* work,
    const int* __restrict__ long_ids) {
  using T = typename Piece<kVec>::T;
  constexpr int W = Piece<kVec>::W;
  extern __shared__ float4 ring4[];
  const int D = kD ? kD : d_rt;
  const int Q = D / W;                           // pieces a row
  float* ring = reinterpret_cast<float*>(ring4);             // 2 x tile x D
  unsigned* rows = reinterpret_cast<unsigned*>(ring + 2 * tile * D);  // 2 tiles
  __shared__ int s_seg;
  const int n_first = work[0];
  const int n_long = n_first + work[1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (;;) {
    if (threadIdx.x == 0) {
      const int k = atomicAdd(work + 2, 1);
      s_seg = k >= n_long ? -1
              : k < n_first ? long_ids[k]
                            : long_ids[n_uniq - 1 - (k - n_first)];
    }
    __syncthreads();
    const long long j = s_seg;     // rewritten only after the steps' syncs
    if (j < 0) return;
    const long long beg = seg_begin(ends, j);
    const long long len = __ldg(ends + j) - beg;
    const int nt = (int)((len + tile - 1) / tile);
    float acc = 0.f;
    // step i: load tile i's rows, gather tile i-1, add tile i-2
    for (int i = 0; i < nt + 2; ++i) {
      if (warp > 0) {
        const int p = threadIdx.x - 32;
        long long o[kA];
        const long long a0 = (long long)i * tile;
        const int na = i < nt ? (int)min((long long)tile, len - a0) : 0;
#pragma unroll
        for (int u = 0; u < kA; ++u) {
          const int e = p + u * kLoaders;
          o[u] = e < na ? __ldg(order + beg + a0 + e) : 0;
        }
        if (i >= 1 && i <= nt) {
          const long long b0 = (long long)(i - 1) * tile;
          const int nb = (int)min((long long)tile, len - b0) * Q;
          const unsigned* rb = rows + ((i - 1) & 1) * tile;
          float* vb = ring + ((i - 1) & 1) * tile * D;
          for (int f0 = p; f0 < nb; f0 += kB * kLoaders) {
            T v[kB];
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              const int f = f0 + u * kLoaders;
              const int e = f / Q, q = f - e * Q;
              v[u] = f < nb ? load(src + (long long)rb[e] * D + q * W, T{})
                            : zero(T{});
            }
#pragma unroll
            for (int u = 0; u < kB; ++u) {
              const int f = f0 + u * kLoaders;
              if (f < nb) store(vb + f * W, v[u]);
            }
          }
        }
        unsigned* ra = rows + (i & 1) * tile;
#pragma unroll
        for (int u = 0; u < kA; ++u) {
          const int e = p + u * kLoaders;
          if (e < na) {
            const unsigned r = static_cast<unsigned>(o[u]);
            ra[e] = bag_of(r, H);
          }
        }
      } else if (i >= 2) {
        const long long c0 = (long long)(i - 2) * tile;
        const int nc = (int)min((long long)tile, len - c0);
        const float* cb = ring + ((i - 2) & 1) * tile * D;
        if (D <= 32) {
          if (lane < D) acc = chain<kD>(cb + lane, nc, D, acc);
        } else {
          for (int c = lane; c < D; c += 32) {
            const float a = i == 2 ? 0.f : vals[j * D + c];
            vals[j * D + c] = chain<kD>(cb + c, nc, D, a);
          }
        }
      }
      __syncthreads();
    }
    if (warp == 0 && D <= 32 && lane < D) vals[j * D + lane] = acc;
  }
}

// entries of one stage of the ring for a width D
int tile_entries(int D) {
  const int t = kTileFloats / D;
  return t < 1 ? 1 : t > kMaxTile ? kMaxTile : t;
}

template <int kD, bool kVec>
int launch(const long long* order, const long long* ends, const float* src,
           long long n_uniq, int D, BagMap H, float* vals, int* work,
           int* long_ids, cudaStream_t stream) {
  constexpr int W = Piece<kVec>::W;
  const long long threads = n_uniq * (D / W);
  segment_sum_short_kernel<kD, kVec>
      <<<(unsigned)((threads + kShortThreads - 1) / kShortThreads),
         kShortThreads, 0, stream>>>(order, ends, src, n_uniq, D, H, vals,
                                     work, long_ids);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tile = tile_entries(D);
  const size_t smem = 2 * (size_t)tile * D * sizeof(float) +
                      2 * (size_t)tile * sizeof(unsigned);
  auto kernel = segment_sum_long_kernel<kD, kVec>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kLongThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<sms * per_sm, kLongThreads, smem, stream>>>(
      order, ends, src, n_uniq, D, H, tile, vals, work, long_ids);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// order: (N,) int64 stable-sort permutation, N < 2^31; ends: (n_uniq,)
// int64 inclusive cumsum of the segment lengths; src: (rows, D) f32, row
// order[k] / H read for sorted entry k (for ragged bags, cols non-null:
// (order[k] / L) * T + cols[order[k] % L]), D <= 16384 (one ring stage
// holds a row); vals: (>= n_uniq, D) f32, rows
// [0, n_uniq) written; work: 3 int32 zeros; long_ids: n_uniq int32
// scratch. `vec` selects the float4 pieces (the caller checked D % 4 == 0
// and the alignment of src and vals; refused here otherwise). Two launches
// on `stream`; nothing for n_uniq = 0 or D = 0.
extern "C" int repro_segment_sum_f32(
    const void* order, const void* ends, const void* src, long long n_uniq,
    int D, int H, const void* cols, int L, int T, void* vals, void* work,
    void* long_ids, int vec, void* stream) {
  if (n_uniq == 0 || D == 0) return 0;
  if (H < 1 || D < 0 || D > kTileFloats) return (int)cudaErrorInvalidValue;
  if (cols != nullptr && (L < 1 || T < 1)) return (int)cudaErrorInvalidValue;
  if (vec && (D % 4 != 0 || !aligned16(src) || !aligned16(vals)))
    return (int)cudaErrorMisalignedAddress;
  const auto* o = static_cast<const long long*>(order);
  const auto* e = static_cast<const long long*>(ends);
  const auto* s = static_cast<const float*>(src);
  auto* v = static_cast<float*>(vals);
  auto* w = static_cast<int*>(work);
  auto* l = static_cast<int*>(long_ids);
  auto st = static_cast<cudaStream_t>(stream);
  const BagMap h{static_cast<unsigned>(H), static_cast<const int*>(cols),
                 static_cast<unsigned>(L), static_cast<unsigned>(T)};
  if (vec && D == 16)
    return launch<16, true>(o, e, s, n_uniq, D, h, v, w, l, st);
  if (!vec && D == 1)
    return launch<1, false>(o, e, s, n_uniq, D, h, v, w, l, st);
  if (vec && D == 128)
    return launch<128, true>(o, e, s, n_uniq, D, h, v, w, l, st);
  if (vec) return launch<0, true>(o, e, s, n_uniq, D, h, v, w, l, st);
  return launch<0, false>(o, e, s, n_uniq, D, h, v, w, l, st);
}
