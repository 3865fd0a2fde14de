// K2/K3: row-wise adagrad and lazy row-wise adam on deduped COO row grads,
// in place, for Hopper (sm_90a).
//
// K2 replaces the TPU kernel `_adagrad_kernel` (launched by
// `_adagrad_pallas`) and K3 replaces `_adam_kernel` (launched by
// `_adam_pallas`), both in src/repro/kernels/fused_update.py.
//
// What they compute, for each entry e with 0 <= rows[e] < R (any other
// entry is padding, as the dedupe's row R is, and is skipped wherever it
// stands):
//   K2: a = acc[r] + g*g;  p[r] += -lr*g / (sqrt(a) + eps);  acc[r] = a
//   K3: m = b1*m[r] + (1-b1)*g;  v = b2*v[r] + (1-b2)*g*g;
//       p[r] += -lr * ((m/bias[0]) / (sqrt(v/bias[1]) + eps) + wd*p[r])
// with the bias pair [1-b1^t, 1-b2^t] read from device memory (computed
// once, in f32, by the caller) once per thread.
//
// Bound on this card: bytes. A live row moves 5 x D x 4 B for K2 (param
// and accumulator read and written, gradient read) and 7 x D x 4 B for K3,
// plus 4 B of row id per entry. A full-width Wide&Deep step dedupes its
// 53,248 lookups to about 23,400 live rows of D=16 (the rest is padding):
// 7.7 MB (K2) and 10.7 MB (K3), 2.30 / 3.20 us at 3.35 TB/s. What the card
// really pays is latency: a launch that loads one row id and stops takes
// 5.3 us timed with events after an L2 eviction, and the pool rows are
// 64-byte pieces scattered over 211 MB pools (PERF.md).
//
// Design. A thread's row id, then every pool and gradient load of its row,
// are in flight at once, and no thread is spent on nothing:
// * D is a template parameter, so no thread divides by a runtime width:
//   - D=16, the deep pool (vector route): 4 lanes of a warp own a row, one
//     float4 each, so a warp takes 8 rows per step. Lane l < 8 loads the
//     step's l-th row id (one coalesced load) and __shfl_sync hands it to
//     the row's lanes.
//   - D=1, the wide pool (scalar route): a thread takes one entry, then one
//     scattered word per pool.
//   - D=128, DLRM-DCNv2's pool (vector route): a warp owns a row, lane l
//     its float4 l. The lanes load 32 row ids at once (one coalesced load)
//     and the warp walks the live ones (a ballot), two rows at a time, so
//     a lane has 6 float4 loads in flight and a padding entry costs a
//     thirty-second of a load. One thread walking a row's 32 float4s one
//     after another (the generic route below) took 3.44 ms for the 447,794
//     rows of the DCNv2 cell's batch, 10 % of their bytes' bound
//     (PERF.md).
//   - Any other width: one thread per entry walks its row, in float4s when
//     D % 4 == 0 and every array starts on 16 bytes (vector route), else in
//     floats.
// * Every kernel runs 256 threads per block. The wrapper (`update_plan` in
//   kernels/fused_update.py) sizes the grid to the work, capped at one wave
//   of the SMs' 2,048 resident threads; the kernels walk anything beyond in
//   a grid-stride loop.
// * A padding entry costs its row-id load and nothing else: its gradient
//   and pool words are never read.
// More rows in flight per thread (2 or 4 at D=16) and 4-entry groups at D=1
// (one int4 of row ids, one float4 of gradients) were measured slower:
// more threads, each waiting on one row, hide the scattered loads' latency
// better than fewer threads with more rows (PERF.md). The dedupe makes rows
// unique, so no two threads write the same element and no atomics are
// needed.
//
// Numerics: left to itself nvcc contracts the multiply-adds here (for
// example p + neg_lr * s) into FMAs, which round once instead of twice;
// next to a cancellation that moves a result by far more than a few ULP of
// itself. The kernels therefore spell every operation with the _rn
// intrinsics, which are never contracted, in the plain versions' order:
// they agree with `adagrad_rows_plain`/`adam_rows_plain` bit for bit.
// Vectorising changes which thread updates an element, not its arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // per block; THREADS in fused_update.py
constexpr unsigned kFullMask = 0xffffffffu;

template <int K>
struct Pools {
  float* p[K];    // params first, then the moment pools
};

// ---------------------------------------------------------------------------
// the two updates, one element at a time, in the plain versions' order
// ---------------------------------------------------------------------------
struct AdagradOp {
  static constexpr int kPools = 2;    // params, acc
  float neg_lr, eps;

  __device__ __forceinline__ AdagradOp ready() const { return *this; }

  __device__ __forceinline__ void operator()(float g, float (&s)[2]) const {
    const float a = __fadd_rn(s[1], __fmul_rn(g, g));
    const float upd =
        __fdiv_rn(__fmul_rn(neg_lr, g), __fadd_rn(__fsqrt_rn(a), eps));
    s[0] = __fadd_rn(s[0], upd);
    s[1] = a;
  }
};

struct AdamOp {
  static constexpr int kPools = 3;    // params, m, v
  float neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  const float* bias;                  // [1 - b1^t, 1 - b2^t] on the device
  float bias0, bias1;                 // filled by ready()

  // the bias pair, read once per thread
  __device__ __forceinline__ AdamOp ready() const {
    AdamOp o = *this;
    o.bias0 = __ldg(bias);
    o.bias1 = __ldg(bias + 1);
    return o;
  }

  __device__ __forceinline__ void operator()(float g, float (&s)[3]) const {
    const float m_row =
        __fadd_rn(__fmul_rn(b1, s[1]), __fmul_rn(one_minus_b1, g));
    const float v_row = __fadd_rn(__fmul_rn(b2, s[2]),
                                  __fmul_rn(one_minus_b2, __fmul_rn(g, g)));
    const float mh = __fdiv_rn(m_row, bias0);
    const float vh = __fdiv_rn(v_row, bias1);
    const float step = __fadd_rn(
        __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps)), __fmul_rn(wd, s[0]));
    s[0] = __fadd_rn(s[0], __fmul_rn(neg_lr, step));
    s[1] = m_row;
    s[2] = v_row;
  }
};

__device__ __forceinline__ float& lane_of(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <class Op, int K>
__device__ __forceinline__ void apply(const Op& op, float g, float (&s)[K]) {
  op(g, s);
}

template <class Op, int K>
__device__ __forceinline__ void apply(const Op& op, float4 g,
                                      float4 (&s)[K]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = lane_of(s[k], i);
    op(lane_of(g, i), t);
#pragma unroll
    for (int k = 0; k < K; ++k) lane_of(s[k], i) = t[k];
  }
}

// An empty asm that reads x: every load feeding it is issued by this point.
// Left alone, nvcc sinks the D=1 kernel's params load to its use, past the
// sqrt and division that ptxas expands into branches, and it becomes a
// second DRAM round trip after the others (PERF.md).
__device__ __forceinline__ void issued(float& x) {
  asm volatile("" : "+f"(x));
}

__device__ __forceinline__ bool live(int row, long long R) {
  return row >= 0 && row < R;
}

// every kernel has this signature, so one pointer type serves the launch
template <class Op>
using RowsKernel = void (*)(Op, Pools<Op::kPools>, const int32_t*,
                            const float*, long long, long long, int);

// ---------------------------------------------------------------------------
// D=16, vector route: 4 lanes per row, 8 rows per warp and step
// ---------------------------------------------------------------------------
template <class Op>
__global__ void __launch_bounds__(kThreads) rows_vec16_kernel(
    Op op, Pools<Op::kPools> pools, const int32_t* __restrict__ rows,
    const float* __restrict__ vals, long long N, long long R, int) {
  constexpr int K = Op::kPools;
  constexpr int kLanes = 4;                     // float4s per row
  constexpr int kRowsPerStep = 32 / kLanes;     // rows per warp and step
  const Op o = op.ready();
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanes;
  const int c = lane % kLanes;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float4* g4 = reinterpret_cast<const float4*>(vals);
  for (long long base = warp * kRowsPerStep; base < N;
       base += n_warps * kRowsPerStep) {
    // one coalesced load of the step's row ids
    int mine = -1;
    if (lane < kRowsPerStep && base + lane < N)
      mine = __ldg(rows + base + lane);
    const int row = __shfl_sync(kFullMask, mine, sub);
    if (!live(row, R)) continue;
    const long long o4 = (long long)row * kLanes + c;
    const float4 g = __ldg(g4 + (base + sub) * kLanes + c);
    float4 s[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      s[k] = reinterpret_cast<const float4*>(pools.p[k])[o4];
    apply(o, g, s);
#pragma unroll
    for (int k = 0; k < K; ++k)
      reinterpret_cast<float4*>(pools.p[k])[o4] = s[k];
  }
}

// ---------------------------------------------------------------------------
// D=1, scalar route: one entry per thread, one scattered word per pool
// ---------------------------------------------------------------------------
template <class Op>
__global__ void __launch_bounds__(kThreads) rows_wide_kernel(
    Op op, Pools<Op::kPools> pools, const int32_t* __restrict__ rows,
    const float* __restrict__ vals, long long N, long long R, int) {
  constexpr int K = Op::kPools;
  const Op o = op.ready();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += stride) {
    const int row = __ldg(rows + e);
    if (!live(row, R)) continue;
    float g = __ldg(vals + e);
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = pools.p[k][row];
    issued(g);
#pragma unroll
    for (int k = 0; k < K; ++k) issued(s[k]);
    apply(o, g, s);
#pragma unroll
    for (int k = 0; k < K; ++k) pools.p[k][row] = s[k];
  }
}

// ---------------------------------------------------------------------------
// D=128, vector route: a warp per row, a float4 a lane, two rows at a time
// ---------------------------------------------------------------------------
template <class Op>
__global__ void __launch_bounds__(kThreads) rows_vec128_kernel(
    Op op, Pools<Op::kPools> pools, const int32_t* __restrict__ rows,
    const float* __restrict__ vals, long long N, long long R, int) {
  constexpr int K = Op::kPools;
  constexpr int kPieces = 128 / 4;              // float4s per row: a lane each
  const Op o = op.ready();
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const float4* g4 = reinterpret_cast<const float4*>(vals);
  for (long long base = warp * 32; base < N; base += n_warps * 32) {
    const int mine = base + lane < N ? __ldg(rows + base + lane) : -1;
    unsigned todo = __ballot_sync(kFullMask, live(mine, R));
    while (todo) {                     // the same on every lane of the warp
      const int i0 = __ffs(todo) - 1;
      todo &= todo - 1;
      const int i1 = todo ? __ffs(todo) - 1 : -1;
      if (i1 >= 0) todo &= todo - 1;
      const int r0 = __shfl_sync(kFullMask, mine, i0);
      const int r1 = __shfl_sync(kFullMask, mine, i1 < 0 ? i0 : i1);
      const long long o0 = (long long)r0 * kPieces + lane;
      const long long o1 = (long long)r1 * kPieces + lane;
      const float4 g0 = __ldg(g4 + (base + i0) * kPieces + lane);
      float4 s0[K], s1[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        s0[k] = reinterpret_cast<const float4*>(pools.p[k])[o0];
      float4 g1 = g0;
      if (i1 >= 0) {
        g1 = __ldg(g4 + (base + i1) * kPieces + lane);
#pragma unroll
        for (int k = 0; k < K; ++k)
          s1[k] = reinterpret_cast<const float4*>(pools.p[k])[o1];
      }
      apply(o, g0, s0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        reinterpret_cast<float4*>(pools.p[k])[o0] = s0[k];
      if (i1 >= 0) {
        apply(o, g1, s1);
#pragma unroll
        for (int k = 0; k < K; ++k)
          reinterpret_cast<float4*>(pools.p[k])[o1] = s1[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// any other width: one thread per entry walks its row in W-float pieces
// ---------------------------------------------------------------------------
template <int W> struct Piece;
template <> struct Piece<1> { using T = float; };
template <> struct Piece<4> { using T = float4; };

template <class Op, int W>
__global__ void __launch_bounds__(kThreads) rows_any_kernel(
    Op op, Pools<Op::kPools> pools, const int32_t* __restrict__ rows,
    const float* __restrict__ vals, long long N, long long R, int D) {
  using T = typename Piece<W>::T;
  constexpr int K = Op::kPools;
  const Op o = op.ready();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < N;
       e += stride) {
    const int row = __ldg(rows + e);
    if (!live(row, R)) continue;
    const long long po = (long long)row * D;
    const long long vo = e * D;
    for (int d = 0; d < D; d += W) {
      const T g = *reinterpret_cast<const T*>(vals + vo + d);
      T s[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        s[k] = *reinterpret_cast<const T*>(pools.p[k] + po + d);
      apply(o, g, s);
#pragma unroll
      for (int k = 0; k < K; ++k)
        *reinterpret_cast<T*>(pools.p[k] + po + d) = s[k];
    }
  }
}

// the kernel for a width and route
template <class Op>
RowsKernel<Op> pick(int D, int vec) {
  if (vec && D == 16) return rows_vec16_kernel<Op>;
  if (vec && D == 128) return rows_vec128_kernel<Op>;
  if (!vec && D == 1) return rows_wide_kernel<Op>;
  return vec ? rows_any_kernel<Op, 4> : rows_any_kernel<Op, 1>;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Op>
int launch_rows(const Op& op, const Pools<Op::kPools>& pools, long long R,
                int D, const void* rows_v, const void* vals_v, long long N,
                int vec, int blocks, void* stream) {
  if (N * D == 0) return 0;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const auto* vals = static_cast<const float*>(vals_v);
  if (vec) {
    bool ok = D % 4 == 0 && aligned16(vals);
    for (int k = 0; k < Op::kPools; ++k) ok = ok && aligned16(pools.p[k]);
    if (!ok) return (int)cudaErrorMisalignedAddress;
  }
  pick<Op>(D, vec)<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      op, pools, static_cast<const int32_t*>(rows_v), vals, N, R, D);
  return (int)cudaGetLastError();
}

}  // namespace

// `vec` selects the vector route (the caller checked D % 4 == 0 and the
// alignment of the pools and vals; refused here otherwise); `blocks` comes
// from `update_plan`.
extern "C" int repro_adagrad_rows_f32(
    void* params, void* acc, long long R, int D, const void* rows,
    const void* vals, long long N, float neg_lr, float eps, int vec,
    int blocks, void* stream) {
  const AdagradOp op{neg_lr, eps};
  const Pools<2> pools{{static_cast<float*>(params),
                        static_cast<float*>(acc)}};
  return launch_rows(op, pools, R, D, rows, vals, N, vec, blocks, stream);
}

extern "C" int repro_adam_rows_f32(
    void* params, void* m, void* v, long long R, int D, const void* rows,
    const void* vals, const void* bias, long long N, float neg_lr, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float eps, float wd,
    int vec, int blocks, void* stream) {
  const AdamOp op{neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
                  static_cast<const float*>(bias), 0.0f, 0.0f};
  const Pools<3> pools{{static_cast<float*>(params), static_cast<float*>(m),
                        static_cast<float*>(v)}};
  return launch_rows(op, pools, R, D, rows, vals, N, vec, blocks, stream);
}
