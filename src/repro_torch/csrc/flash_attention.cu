// K4: block-wise flash attention forward (causal / sliding window / GQA /
// tanh softcap) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (launched by `flash_attention`)
// of src/repro/kernels/flash_attention.py.
//
// What it computes, for q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) in the
// model's layout (float32 or bfloat16, output in the same dtype), q-head h
// reading kv-head h / (Hq / Hkv):
//   s = (q . k) * scale;  s = softcap ? tanh(s / softcap) * softcap : s
//   valid = kpos < Skv && (!causal || qpos >= kpos)
//           && (window < 0 || qpos - kpos < window),  qpos = q_offset + row
//   o = sum_k softmax(s)[k] v[k]   (running f32 m, l, acc; l >= 1e-30, so a
//                                   row with no valid key gives 0)
// The plain version, `flash_attention_plain` in
// src/repro_torch/kernels/flash_attention.py, does the same steps on the
// same 64 x 64 tiles.
//
// Bound on this card: operations. 4*D flops per reachable (query, key)
// pair and q-head; at B=1, S=2048, 24 heads, D=128, causal, that is 25.8
// GFLOP against 34 MB of q, k, v and o.
//
// Design: one block of 256 threads per (64-query block, q-head, batch
// row). The Q tile and each K/V tile are converted to f32 in shared memory
// (rows padded by one float so the score loop reads no bank twice): 64 x
// 64 tiles at every head dim, in dynamic shared memory past the 48 KB
// default (cudaFuncSetAttribute), 115 KB at D=128 and 209 KB of the 227 KB
// a block may have at D=256, so one block per SM there. Each thread owns 4
// query rows (ty + 16 i) and computes a 4 x 4 micro-tile of scores, then
// keeps the running m and l of its 4 rows and a 4 x NC micro-tile of the
// output in registers (NC = 8 columns for D <= 128, 16 for D <= 256, two
// instances); row maxima and sums are reduced over the 16 threads of a
// half-warp with shuffles. The k-block loop only
// visits tiles that some query of the block can reach (the Pallas
// kernel's `pl.when(live)` guard). The products run on the f32 cores.
// This is the route for float32 at every head dim and for bfloat16 at head
// dims other than 64, 128 and 256; bfloat16 at those takes the tensor-core
// kernel (flash_attention_tc.cu, `tc_route` in
// src/repro_torch/kernels/flash_attention.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_convert.cuh"

namespace {

using repro::MASK_VALUE;
using repro::from_f32;
using repro::to_f32;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int MAX_D = 256;

template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv, int Hq,
    int Hkv, int D, int q_offset, int causal, int window, float softcap,
    float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;                 // BQ x DP
  float* Ks = Qs + BQ * DP;         // BK x DP
  float* Vs = Ks + BK * DP;         // BK x D
  float* Ps = Vs + BK * D;          // BQ x (BK + 1)

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_start = qb * BQ;
  const long long q_stride = (long long)Hq * D;     // one sequence step
  const long long kv_stride = (long long)Hkv * D;
  const T* qbase = q + (long long)b * Sq * q_stride + (long long)h * D;
  const T* kbase = k + (long long)b * Skv * kv_stride + (long long)hk * D;
  const T* vbase = v + (long long)b * Skv * kv_stride + (long long)hk * D;
  T* obase = o + (long long)b * Sq * q_stride + (long long)h * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D, s = q_start + r;
    Qs[r * DP + c] = s < Sq ? to_f32(qbase[s * q_stride + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // k blocks some query of this block can reach (the Pallas live guard)
  const int q_abs = q_offset + q_start;
  int kb_end = (Skv + BK - 1) / BK;
  if (causal) kb_end = min(kb_end, (q_abs + BQ - 1) / BK + 1);
  int kb_begin = 0;
  if (window >= 0) {
    const int lo = q_abs - window + 2 - BK;   // k_start + BK - 1 >= q_abs - window + 1
    if (lo > 0) kb_begin = (lo + BK - 1) / BK;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();                // the previous tile's reads are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i - r * D, s = k_start + r;
      float kv = 0.f, vv = 0.f;
      if (s < Skv) {
        kv = to_f32(kbase[s * kv_stride + c]);
        vv = to_f32(vbase[s * kv_stride + c]);
      }
      Ks[r * DP + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_abs + ty + 16 * i;
      bool ok[4];
      float row_max = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = kpos < Skv && (!causal || qpos >= kpos) &&
                (window < 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? x : MASK_VALUE;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        p_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      l[i] = l[i] * alpha + p_sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();                // P complete before P . V

    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? Vs[kk * D + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q_start + ty + 16 * i;
    if (s >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) obase[s * q_stride + col] = from_f32<T>(acc[i][c] / li);
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int Hq, int Hkv, int D, int q_offset,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (D + 1) + (size_t)BK * D +
                       (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D,
      q_offset, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// NC output columns per thread: 8 cover D <= 128, 16 cover D <= 256
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int q_offset, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  if (D <= 128)
    return launch_nc<T, 8>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, q_offset,
                           causal, window, softcap, scale, stream);
  return launch_nc<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, q_offset,
                          causal, window, softcap, scale, stream);
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int q_offset, int causal, int window,
    float softcap, float scale, int bf16, void* stream) {
  if (D > MAX_D || D <= 0 || Hkv <= 0 || Hq % Hkv != 0) return 1;  // cudaErrorInvalidValue
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, q_offset,
                                 causal, window, softcap, scale, s);
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, q_offset, causal,
                       window, softcap, scale, s);
}
