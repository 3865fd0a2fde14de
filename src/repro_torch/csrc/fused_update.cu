// K2/K3: row-wise adagrad and lazy row-wise adam on deduped COO row grads,
// in place, for Hopper (sm_90a).
//
// K2 replaces the TPU kernel `_adagrad_kernel` (launched by
// `_adagrad_pallas`) and K3 replaces `_adam_kernel` (launched by
// `_adam_pallas`), both in src/repro/kernels/fused_update.py.
//
// What they compute, for each entry e with rows[e] < R (entries >= R are
// the sentinel tail of the dedupe and are skipped):
//   K2: a = acc[r] + g*g;  p[r] += -lr*g / (sqrt(a) + eps);  acc[r] = a
//   K3: m = b1*m[r] + (1-b1)*g;  v = b2*v[r] + (1-b2)*g*g;
//       p[r] += -lr * ((m/bias[0]) / (sqrt(v/bias[1]) + eps) + wd*p[r])
// with the bias pair [1-b1^t, 1-b2^t] read from device memory (computed
// once, in f32, by the caller).
//
// Bound on this card: bytes. A row moves 5 x D x 4 B for K2 (param and
// accumulator read and written, gradient read) and 7 x D x 4 B for K3; at
// the full Wide&Deep width a step has at most 53,248 live rows of D=16:
// about 17 MB (K2) and 24 MB (K3), 5-7 us at 3.35 TB/s.
//
// Design: one thread per (entry, d), so the D lanes of a row are
// neighbouring threads and every access is one contiguous 64 B row segment
// for D=16 (the wide pool has D=1). The dedupe makes rows unique, so no two
// threads write the same element and no atomics are needed. The TPU
// kernel's per-row DMA staging and its padding to whole row blocks are not
// carried over.
//
// Numerics: left to itself nvcc contracts the multiply-adds here (for
// example p + neg_lr * s) into FMAs, which round once instead of twice;
// next to a cancellation that moves a result by far more than a few ULP of
// itself. The kernels therefore spell every operation with the _rn
// intrinsics, which are never contracted, in the plain versions' order:
// they agree with `adagrad_rows_plain`/`adam_rows_plain` bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void adagrad_rows_kernel(
    float* __restrict__ params, float* __restrict__ acc, long long R, int D,
    const int32_t* __restrict__ rows, const float* __restrict__ vals,
    long long N, float neg_lr, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * D) return;
  const long long e = i / D;
  const long long row = rows[e];
  if (row < 0 || row >= R) return;      // sentinel tail of the dedupe
  const long long o = row * D + (i - e * D);
  const float g = vals[i];
  const float a = __fadd_rn(acc[o], __fmul_rn(g, g));
  const float upd =
      __fdiv_rn(__fmul_rn(neg_lr, g), __fadd_rn(__fsqrt_rn(a), eps));
  params[o] = __fadd_rn(params[o], upd);
  acc[o] = a;
}

__global__ void adam_rows_kernel(
    float* __restrict__ params, float* __restrict__ m, float* __restrict__ v,
    long long R, int D, const int32_t* __restrict__ rows,
    const float* __restrict__ vals, const float* __restrict__ bias,
    long long N, float neg_lr, float b1, float one_minus_b1, float b2,
    float one_minus_b2, float eps, float wd) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * D) return;
  const long long e = i / D;
  const long long row = rows[e];
  if (row < 0 || row >= R) return;      // sentinel tail of the dedupe
  const long long o = row * D + (i - e * D);
  const float g = vals[i];
  const float m_row = __fadd_rn(__fmul_rn(b1, m[o]), __fmul_rn(one_minus_b1, g));
  const float v_row =
      __fadd_rn(__fmul_rn(b2, v[o]), __fmul_rn(one_minus_b2, __fmul_rn(g, g)));
  const float mh = __fdiv_rn(m_row, bias[0]);
  const float vh = __fdiv_rn(v_row, bias[1]);
  const float p = params[o];
  const float step = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps)),
                               __fmul_rn(wd, p));
  params[o] = __fadd_rn(p, __fmul_rn(neg_lr, step));
  m[o] = m_row;
  v[o] = v_row;
}

unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int repro_adagrad_rows_f32(
    void* params, void* acc, long long R, int D, const void* rows,
    const void* vals, long long N, float neg_lr, float eps, void* stream) {
  if (N * D == 0) return 0;
  const int threads = 256;
  adagrad_rows_kernel<<<blocks_for(N * D, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(params), static_cast<float*>(acc), R, D,
      static_cast<const int32_t*>(rows), static_cast<const float*>(vals), N,
      neg_lr, eps);
  return (int)cudaGetLastError();
}

extern "C" int repro_adam_rows_f32(
    void* params, void* m, void* v, long long R, int D, const void* rows,
    const void* vals, const void* bias, long long N, float neg_lr, float b1,
    float one_minus_b1, float b2, float one_minus_b2, float eps, float wd,
    void* stream) {
  if (N * D == 0) return 0;
  const int threads = 256;
  adam_rows_kernel<<<blocks_for(N * D, threads), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(params), static_cast<float*>(m),
      static_cast<float*>(v), R, D, static_cast<const int32_t*>(rows),
      static_cast<const float*>(vals), static_cast<const float*>(bias), N,
      neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd);
  return (int)cudaGetLastError();
}
