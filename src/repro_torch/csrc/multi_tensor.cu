// The optimizer layer's multi-tensor kernels, for Hopper (sm_90a): the
// squared global norm of a gradient tree and the dense adagrad update, each
// one launch over every leaf of a tree.
//
// They replace no Pallas kernel: the reference computes the global norm and
// the dense adagrad update in XLA (`global_norm` and `adagrad` of
// src/repro/train/optim.py), which fuses them under `jit`. The port ran
// them op by op: a square and a sum a leaf for the norm, then the Python
// chain of adds and a sqrt; seven aten ops a leaf for adagrad (square, add,
// mul, sqrt, add, div, and the add of `apply_updates`). A DLRM-DCNv2 step
// launched 266 of them over its 26 dense leaves, after the dedupe's sync,
// so the card waited on the host's launches; and the norm read the
// (1,753,088, 128) padded row gradients of the sparse step whole, three
// quarters of them padding (PERF.md).
//
// What they compute:
// * grad_sq_norm: over every leaf, each element converted to f32 and
//   squared in f32 (`torch.sum(torch.square(l.float()))`), the squares
//   added in double and the total rounded to f32 once; `out` gets the
//   squared norm and its square root. A sparse leaf is the (N, D) values of
//   a `SparseRowGrad` with its (N,) int32 row ids, which the dedupe leaves
//   ascending: the distinct rows first, then the sentinel tail, whose
//   values are zero. It is read up to the first entry of its last row id
//   (a warp's 32-way search over the ids), so the padding is never read
//   and the sum is the same: the tail adds +0.
// * dense_adagrad: per element, with g, acc, p of one leaf,
//     g' = g * scale          (only with a clip scale; rounded to g's type)
//     a' = acc + g'*g'
//     u  = (-lr*g') / (sqrt(a') + eps)   (rounded to p's type)
//     out = p + u (apply), or u (update)
//   into fresh `out` and `acc_out`: the state passed in is not written.
//   Every operation is a _rn intrinsic, which nvcc never contracts into an
//   FMA, in the plain version's order (`optim.adagrad`: the clip's multiply,
//   square, add, multiply, sqrt, add, divide, then the add of
//   `apply_updates`), so the results equal the op-by-op path's bit for bit.
//   The clip scale is read from device memory, so nothing waits on the host.
//
// Bound on this card: bytes. The dense update reads g, acc and p and writes
// acc and p: 20 B an f32 element, 320 MB (96 us at 3.35 TB/s) for
// DLRM-DCNv2's 16.05 M dense parameters. The norm reads every dense
// gradient and the live rows of the sparse ones: 64 MB + 448 k rows x 512 B
// at the DCNv2 cell (~0.29 GB, ~87 us).
//
// Design:
// * One launch takes up to kMaxLeaves leaves. Their pointers, element
//   counts and type flags are the kernel's argument struct, passed by value
//   (no host-to-device copy), with each leaf's first work item. A work item
//   is a chunk of one leaf: kNormChunk or kAdagradChunk elements. A tree of
//   more leaves takes one launch per kMaxLeaves.
// * A fixed grid (kBlocksPerSm blocks an SM, fewer for less work) walks the
//   work items in a grid-stride loop. A thread takes pieces of 4 elements
//   (a float4, or 8 bytes of bf16) kNormU or kAdagradU at a time, all their
//   loads in flight together, with a scalar tail where a leaf's size is no
//   multiple of 4; a leaf whose arrays do not all start on a piece's
//   alignment is walked element by element.
// * The norm reduces without atomics: each thread adds in a fixed order,
//   each block in a fixed tree into one partial, and one finishing block
//   adds the partials in a fixed order. The grid follows the shapes and the
//   SM count alone, so two identical calls give identical bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_convert.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;          // per block, both kernels
constexpr int kBlocksPerSm = 4;        // the grid's cap: SMs x this
constexpr int kMaxLeaves = 64;         // leaves of one launch
constexpr int kNormU = 4;              // pieces in flight a thread: norm
constexpr int kAdagradU = 2;           // and update (3 arrays a piece)
constexpr long long kNormChunk = kThreads * kNormU * 4;
constexpr long long kAdagradChunk = kThreads * kAdagradU * 4;
constexpr unsigned kFullMask = 0xffffffffu;

// the wrapper's record of a leaf, in 64-bit words (kernels/multi_tensor.py)
constexpr int kNormWords = 5;          // x, rows (0: dense), n, D, bf16
constexpr int kAdagradWords = 7;       // g, acc, p, acc_out, out, n, types
constexpr int kGBf16 = 1;              // type flags
constexpr int kPBf16 = 2;
constexpr int kVec = 4;

struct NormLeaves {
  const void* x[kMaxLeaves];
  const int* rows[kMaxLeaves];         // a sparse leaf's row ids, else null
  long long n[kMaxLeaves];             // elements (N x D for a sparse leaf)
  int D[kMaxLeaves];                   // a sparse leaf's row width
  int first[kMaxLeaves + 1];           // first work item; [count] = all
  unsigned char flags[kMaxLeaves];     // kGBf16 (the leaf's type) | kVec
  int count;
};

struct AdagradLeaves {
  const void* g[kMaxLeaves];
  const float* acc[kMaxLeaves];
  const void* p[kMaxLeaves];           // read only when applying
  float* acc_out[kMaxLeaves];
  void* out[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  unsigned char flags[kMaxLeaves];     // kGBf16 | kPBf16 | kVec
  int count;
};

struct Hyper {
  float neg_lr, eps;
  const float* scale;                  // the clip scale, or null
  int apply;
};

static_assert(sizeof(NormLeaves) + sizeof(double*) <= 4096,
              "the norm's arguments exceed 4 KB");
static_assert(sizeof(AdagradLeaves) + sizeof(Hyper) <= 4096,
              "the update's arguments exceed 4 KB");

// ---------------------------------------------------------------------------
// f32 and bf16 storage, 1 or 4 elements at a time
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return to_f32(from_f32<bf16>(x));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) { return to_f32(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = from_f32<bf16>(v);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
// bf16 element k is the high half of a float: bits << 16 (little-endian)
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bits16(float v) {
  return __bfloat16_as_ushort(from_f32<bf16>(v));
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 x;
  x.x = bits16(v[0]) | (bits16(v[1]) << 16);
  x.y = bits16(v[2]) | (bits16(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = x;
}

// ---------------------------------------------------------------------------
// the norm
// ---------------------------------------------------------------------------
// The first entry of the last row id of ascending `rows` (N > 0): the
// number of entries to read, less one. Every lane of a warp calls it; each
// step tests 32 evenly spaced entries at once and keeps the span between
// the last below the key and the first at or above it.
__device__ long long first_of_last(const int* rows, long long N) {
  const int key = __ldg(rows + N - 1);
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = N - 1;        // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long i = lo + lane * step;
    const bool at = i >= hi || __ldg(rows + i) >= key;
    const unsigned ballot = __ballot_sync(kFullMask, at);
    if (ballot == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(ballot) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        const long long below = lo + (long long)(f - 1) * step;
        hi = min(lo + (long long)f * step, hi);
        lo = below + 1;
      }
    }
  }
  return lo;
}

// a thread's squares of one chunk [e0, end) of a leaf, added in a fixed
// order
template <typename T>
__device__ __forceinline__ double chunk_sq(const void* xv, long long e0,
                                           long long end, bool vec) {
  const T* x = static_cast<const T*>(xv);
  double s = 0.0;
  if (vec) {
    float v[kNormU][4];
#pragma unroll
    for (int k = 0; k < kNormU; ++k) {
      const long long e = e0 + 4ll * (threadIdx.x + k * kThreads);
      if (e + 4 <= end) load4(x + e, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kNormU; ++k) {
      const long long e = e0 + 4ll * (threadIdx.x + k * kThreads);
      if (e + 4 <= end) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s += (double)__fmul_rn(v[k][q], v[k][q]);
      } else {
        for (long long i = e; i < end; ++i) {
          const float y = load1(x + i);
          s += (double)__fmul_rn(y, y);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < (int)(kNormChunk / kThreads); ++k) {
      const long long i = e0 + threadIdx.x + (long long)k * kThreads;
      if (i < end) {
        const float y = load1(x + i);
        s += (double)__fmul_rn(y, y);
      }
    }
  }
  return s;
}

// a block's sum of one double a thread, in a fixed tree; thread 0 has it
__device__ __forceinline__ double block_sum(double s) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFullMask, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x < 32) {
    t = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(kFullMask, t, o);
  }
  return t;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
grad_sq_norm_kernel(const __grid_constant__ NormLeaves a,
                    double* __restrict__ partials) {
  __shared__ long long limit[kMaxLeaves];    // elements to read a leaf
  if (threadIdx.x < 32) {
    for (int l = 0; l < a.count; ++l) {
      long long lim = a.n[l];
      if (a.rows[l] != nullptr && lim > 0)
        lim = (first_of_last(a.rows[l], lim / a.D[l]) + 1) * a.D[l];
      if (threadIdx.x == 0) limit[l] = lim;
    }
  }
  __syncthreads();
  double s = 0.0;
  const int total = a.first[a.count];
  int l = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    while (a.first[l + 1] <= w) ++l;
    const long long e0 = (long long)(w - a.first[l]) * kNormChunk;
    const long long end = min(e0 + kNormChunk, limit[l]);
    if (e0 >= end) continue;
    const bool vec = a.flags[l] & kVec;
    s += (a.flags[l] & kGBf16) ? chunk_sq<bf16>(a.x[l], e0, end, vec)
                               : chunk_sq<float>(a.x[l], e0, end, vec);
  }
  const double t = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads)
grad_sq_norm_finish(const double* __restrict__ partials, int count,
                    float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) s += partials[i];
  const double t = block_sum(s);
  if (threadIdx.x == 0) {
    const float sq = __double2float_rn(t);
    out[0] = sq;
    out[1] = __fsqrt_rn(sq);
  }
}

// ---------------------------------------------------------------------------
// the dense adagrad update
// ---------------------------------------------------------------------------
// one element, in the plain version's order; `scale` is the clip scale
// rounded to G (read only when h.scale is set)
template <typename G, typename P>
__device__ __forceinline__ void adagrad_elem(float g, float& a, float& p,
                                             const Hyper& h, float scale) {
  if (h.scale != nullptr) g = round_to<G>(__fmul_rn(g, scale));
  const float an = __fadd_rn(a, __fmul_rn(g, g));
  const float u = round_to<P>(__fdiv_rn(__fmul_rn(h.neg_lr, g),
                                        __fadd_rn(__fsqrt_rn(an), h.eps)));
  a = an;
  p = h.apply ? round_to<P>(__fadd_rn(p, u)) : u;
}

template <typename G, typename P>
__device__ __forceinline__ void adagrad_one(const AdagradLeaves& a, int l,
                                            long long i, const Hyper& h,
                                            float scale) {
  float acc = a.acc[l][i];
  float p = h.apply ? load1(static_cast<const P*>(a.p[l]) + i) : 0.f;
  adagrad_elem<G, P>(load1(static_cast<const G*>(a.g[l]) + i), acc, p, h,
                     scale);
  a.acc_out[l][i] = acc;
  store1(static_cast<P*>(a.out[l]) + i, p);
}

template <typename G, typename P>
__device__ __forceinline__ void adagrad_chunk(const AdagradLeaves& a, int l,
                                              long long e0, long long end,
                                              const Hyper& h, float scale) {
  if (a.flags[l] & kVec) {
    const G* g = static_cast<const G*>(a.g[l]);
    const P* p = static_cast<const P*>(a.p[l]);
    float gv[kAdagradU][4], av[kAdagradU][4], pv[kAdagradU][4];
#pragma unroll
    for (int k = 0; k < kAdagradU; ++k) {
      const long long e = e0 + 4ll * (threadIdx.x + k * kThreads);
      if (e + 4 <= end) {
        load4(g + e, gv[k]);
        load4(a.acc[l] + e, av[k]);
        if (h.apply) {
          load4(p + e, pv[k]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) pv[k][q] = 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAdagradU; ++k) {
      const long long e = e0 + 4ll * (threadIdx.x + k * kThreads);
      if (e + 4 <= end) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          adagrad_elem<G, P>(gv[k][q], av[k][q], pv[k][q], h, scale);
        store4(a.acc_out[l] + e, av[k]);
        store4(static_cast<P*>(a.out[l]) + e, pv[k]);
      } else {
        for (long long i = e; i < end; ++i) adagrad_one<G, P>(a, l, i, h, scale);
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < (int)(kAdagradChunk / kThreads); ++k) {
      const long long i = e0 + threadIdx.x + (long long)k * kThreads;
      if (i < end) adagrad_one<G, P>(a, l, i, h, scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dense_adagrad_kernel(const __grid_constant__ AdagradLeaves a,
                     const __grid_constant__ Hyper h) {
  const float s = h.scale != nullptr ? __ldg(h.scale) : 1.f;
  const float s_f32 = s, s_bf16 = round_to<bf16>(s);
  const int total = a.first[a.count];
  int l = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    while (a.first[l + 1] <= w) ++l;
    const long long e0 = (long long)(w - a.first[l]) * kAdagradChunk;
    const long long end = min(e0 + kAdagradChunk, a.n[l]);
    switch (a.flags[l] & (kGBf16 | kPBf16)) {
      case 0:
        adagrad_chunk<float, float>(a, l, e0, end, h, s_f32);
        break;
      case kGBf16:
        adagrad_chunk<bf16, float>(a, l, e0, end, h, s_bf16);
        break;
      case kPBf16:
        adagrad_chunk<float, bf16>(a, l, e0, end, h, s_f32);
        break;
      default:
        adagrad_chunk<bf16, bf16>(a, l, e0, end, h, s_bf16);
        break;
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int grid(long long work, int sm_count) {
  const long long cap = (long long)sm_count * kBlocksPerSm;
  return (int)(work < cap ? work : cap);
}

int group_size(int n_leaves, int base) {
  return n_leaves - base < kMaxLeaves ? n_leaves - base : kMaxLeaves;
}

}  // namespace

// The squared global norm of `n_leaves` leaves (records of kNormWords
// words: data pointer, row-id pointer or 0, elements, row width, 1 for
// bf16) into out[0], its square root into out[1]. `partials` holds at
// least ceil(n_leaves / kMaxLeaves) x sm_count x kBlocksPerSm doubles.
// One launch per kMaxLeaves leaves with work, then the finishing one.
extern "C" int repro_grad_sq_norm(const long long* leaves, int n_leaves,
                                  void* partials, void* out, int sm_count,
                                  void* stream) {
  if (sm_count <= 0 || n_leaves < 0)
    return (int)cudaErrorInvalidConfiguration;
  auto* part = static_cast<double*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  int written = 0;
  for (int base = 0; base < n_leaves; base += kMaxLeaves) {
    NormLeaves a;
    a.count = group_size(n_leaves, base);
    long long work = 0;
    for (int j = 0; j < a.count; ++j) {
      const long long* r = leaves + (long long)(base + j) * kNormWords;
      a.x[j] = reinterpret_cast<const void*>(r[0]);
      a.rows[j] = reinterpret_cast<const int*>(r[1]);
      a.n[j] = r[2];
      a.D[j] = (int)r[3];
      const bool b16 = r[4] != 0;
      if (a.n[j] < 0 || (a.rows[j] != nullptr && a.D[j] <= 0))
        return (int)cudaErrorInvalidValue;
      a.flags[j] = (b16 ? kGBf16 : 0) |
                   (aligned(a.x[j], b16 ? 8 : 16) ? kVec : 0);
      a.first[j] = (int)work;
      work += (a.n[j] + kNormChunk - 1) / kNormChunk;
      if (work > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    }
    a.first[a.count] = (int)work;
    if (work == 0) continue;
    const int blocks = grid(work, sm_count);
    grad_sq_norm_kernel<<<blocks, kThreads, 0, s>>>(a, part + written);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    written += blocks;
  }
  grad_sq_norm_finish<<<1, kThreads, 0, s>>>(part, written,
                                             static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The dense adagrad update of `n_leaves` leaves (records of kAdagradWords
// words: g, acc, p (0 when not applying), acc_out, out pointers, elements,
// kGBf16 | kPBf16). `scale` is the clip scale on the device, or null.
// One launch per kMaxLeaves leaves with work.
extern "C" int repro_dense_adagrad(const long long* leaves, int n_leaves,
                                   float neg_lr, float eps, const void* scale,
                                   int apply, int sm_count, void* stream) {
  if (sm_count <= 0 || n_leaves < 0)
    return (int)cudaErrorInvalidConfiguration;
  const Hyper h{neg_lr, eps, static_cast<const float*>(scale), apply};
  for (int base = 0; base < n_leaves; base += kMaxLeaves) {
    AdagradLeaves a;
    a.count = group_size(n_leaves, base);
    long long work = 0;
    for (int j = 0; j < a.count; ++j) {
      const long long* r = leaves + (long long)(base + j) * kAdagradWords;
      a.g[j] = reinterpret_cast<const void*>(r[0]);
      a.acc[j] = reinterpret_cast<const float*>(r[1]);
      a.p[j] = reinterpret_cast<const void*>(r[2]);
      a.acc_out[j] = reinterpret_cast<float*>(r[3]);
      a.out[j] = reinterpret_cast<void*>(r[4]);
      a.n[j] = r[5];
      const int types = (int)r[6] & (kGBf16 | kPBf16);
      if (a.n[j] < 0 || (apply && a.p[j] == nullptr))
        return (int)cudaErrorInvalidValue;
      const int gb = types & kGBf16 ? 8 : 16, pb = types & kPBf16 ? 8 : 16;
      const bool vec = aligned(a.g[j], gb) && aligned(a.acc[j], 16) &&
                       aligned(a.acc_out[j], 16) && aligned(a.out[j], pb) &&
                       (!apply || aligned(a.p[j], pb));
      a.flags[j] = (unsigned char)(types | (vec ? kVec : 0));
      a.first[j] = (int)work;
      work += (a.n[j] + kAdagradChunk - 1) / kAdagradChunk;
      if (work > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    }
    a.first[a.count] = (int)work;
    if (work == 0) continue;
    dense_adagrad_kernel<<<grid(work, sm_count), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, h);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}
