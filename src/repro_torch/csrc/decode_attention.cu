// K5: single-token (decode) attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` (launched by `decode_attention`)
// of src/repro/kernels/decode_attention.py.
//
// What it computes, for q (B, 1, Hq, D), caches (B, L, Hkv, D), cache_pos
// (B, L) int32 and pos (B,) int32, with G = Hq / Hkv q-heads per kv-head:
//   slot j of row b is valid when cache_pos[b,j] >= 0 (padded slots hold
//   -1), cache_pos[b,j] <= pos[b] and, with a window, cache_pos[b,j] >
//   pos[b] - window;
//   s = (q . k_j) * scale, tanh softcap, invalid slots masked;
//   o = sum_j softmax(s)_j v_j, in f32, l clamped to 1e-30 (a row with no
//   valid slot gives 0).
// q is float32 or bfloat16 (the output's dtype); the caches float32 (the
// serving engine holds them so) or bfloat16. The plain version is
// `decode_attention_plain` in src/repro_torch/kernels/decode_attention.py.
//
// Bound on this card: bytes. Every valid slot's K and V rows are read once
// (2 x D x 4 B per kv-head in f32) for about 4 x G x D flops.
//
// Design: one block of 8 warps per (kv-head, batch row) takes the G
// q-heads of that kv-head together over the whole cache, as the Pallas
// kernel does. Lane l of a warp owns the elements d = l + 32 i of a row, so
// a warp reads each K/V row as contiguous 128-byte segments. The warps
// take groups of 4 slots in turn (warp w: slots 32 t + 4 w .. +3), load
// the 4 rows before using them, reduce each dot product with shuffles and
// keep their own running m, l and acc; no row of an invalid slot is
// loaded. At the end the 8 partial softmaxes are merged through shared
// memory. The grid has only B x Hkv blocks: a split over the cache across
// blocks (flash decoding with a combine pass) is left for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_convert.cuh"

namespace {

using repro::MASK_VALUE;
using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 8;
constexpr int U = 4;              // slots a warp loads before using them
constexpr int MAX_G = 8;
constexpr int MAX_DPL = 4;        // row elements per lane: D <= 128

template <typename TQ, typename TC>
__global__ void __launch_bounds__(WARPS * 32) decode_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, const int* __restrict__ cache_pos,
    const int* __restrict__ pos, TQ* __restrict__ o, int L, int Hkv, int G,
    int D, int window, float softcap, float scale) {
  __shared__ float m_s[WARPS][MAX_G];
  __shared__ float l_s[WARPS][MAX_G];
  __shared__ float acc_s[WARPS][MAX_G][MAX_DPL * 32];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int Hq = Hkv * G;
  const int now = pos[b];
  const long long row_stride = (long long)Hkv * D;   // one cache slot
  const TC* kb = kc + (long long)b * L * row_stride + (long long)hk * D;
  const TC* vb = vc + (long long)b * L * row_stride + (long long)hk * D;
  const int* cp = cache_pos + (long long)b * L;
  const long long q_off = ((long long)b * Hq + (long long)hk * G) * D;

  float qr[MAX_G][MAX_DPL], m[MAX_G], l[MAX_G], acc[MAX_G][MAX_DPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = MASK_VALUE;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < D) ? to_f32(q[q_off + (long long)g * D + d])
                                  : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int base = w * U; base < L; base += WARPS * U) {
    bool ok[U];
    float kr[U][MAX_DPL], vr[U][MAX_DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u;
      ok[u] = false;
      if (j < L) {
        const int c = cp[j];
        ok[u] = c >= 0 && c <= now && (window < 0 || c > now - window);
      }
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok[u] && d < D;
        kr[u][i] = in ? to_f32(kb[j * row_stride + d]) : 0.f;
        vr[u][i] = in ? to_f32(vb[j * row_stride + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float s[U];
      float s_max = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < MAX_DPL; ++i) part = fmaf(qr[g][i], kr[u][i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        float x = part * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        s[u] = ok[u] ? x : MASK_VALUE;
        s_max = fmaxf(s_max, s[u]);
      }
      const float alpha = expf(m[g] - s_max);
      float p[U], p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? expf(s[u] - s_max) : 0.f;
        p_sum += p[u];
      }
      l[g] = l[g] * alpha + p_sum;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][i], a);
        acc[g][i] = a;
      }
      m[g] = s_max;
    }
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_s[w][g] = m[g];
      l_s[w][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc_s[w][g][d] = acc[g][i];
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < G * D; t += WARPS * 32) {
    const int g = t / D, d = t - g * D;
    float mx = MASK_VALUE;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, m_s[ww][g]);
    float l_sum = 0.f, a = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float f = expf(m_s[ww][g] - mx);
      l_sum += l_s[ww][g] * f;
      a += acc_s[ww][g][d] * f;
    }
    o[q_off + t] = from_f32<TQ>(a / fmaxf(l_sum, 1e-30f));
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc,
           const void* cache_pos, const void* pos, void* o, int B, int L,
           int Hkv, int G, int D, int window, float softcap, float scale,
           cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  decode_kernel<TQ, TC><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const int*>(cache_pos),
      static_cast<const int*>(pos), static_cast<TQ*>(o), L, Hkv, G, D,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* kc, const void* vc, const void* cache_pos,
    const void* pos, void* o, int B, int L, int Hkv, int G, int D,
    int window, float softcap, float scale, int q_bf16, int cache_bf16,
    void* stream) {
  if (D > MAX_DPL * 32 || D <= 0 || G > MAX_G || G <= 0) return 1;  // cudaErrorInvalidValue
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (q_bf16 && cache_bf16)
    return launch<bf, bf>(q, kc, vc, cache_pos, pos, o, B, L, Hkv, G, D,
                          window, softcap, scale, s);
  if (q_bf16)
    return launch<bf, float>(q, kc, vc, cache_pos, pos, o, B, L, Hkv, G, D,
                             window, softcap, scale, s);
  if (cache_bf16)
    return launch<float, bf>(q, kc, vc, cache_pos, pos, o, B, L, Hkv, G, D,
                             window, softcap, scale, s);
  return launch<float, float>(q, kc, vc, cache_pos, pos, o, B, L, Hkv, G, D,
                              window, softcap, scale, s);
}
