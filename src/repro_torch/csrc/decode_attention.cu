// K5: single-token (decode) attention over a KV cache, for Hopper (sm_90a),
// split across the cache ("flash decoding") with a combine pass.
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
// `decode_attention_plain` in src/repro_torch/kernels/decode_attention.py;
// it runs the same split and combine, from the same `split_plan`.
//
// Bound on this card: bytes. Every valid slot's K and V rows are read once
// (2 x D x 4 B per kv-head in f32) for about 4 x G x D flops.
//
// Design: the grid is (n_split, Hkv x n_chunk, B). Split s of a (kv-head,
// batch row) walks the contiguous slots [s c, s c + c), c = ceil(L /
// n_split), with the q-heads of that kv-head together, as the Pallas kernel
// does; a block holds at most MAX_G q-heads in registers, so the G q-heads
// of a kv-head are taken in n_chunk = ceil(G / MAX_G) chunks of at most
// ceil(G / n_chunk) heads, each chunk a block over the same slots (the
// second chunk's K/V rows mostly come from L2). Lane l of a warp owns the
// row elements VEC l .. VEC l + VEC - 1 and reads them as 16-byte (f32) or
// 8/16-byte (bf16) vector loads: VEC = 4 for D <= 128 (a D=128 f32 row is
// one 512-byte warp access), VEC = 8 for 128 < D <= 256. The 8 warps take
// groups of U slots in turn and load the U rows before using them; each
// keeps its own running m, l and acc; no row of an invalid slot is loaded.
// Registers bound the instances: (VEC, MAX_G, U) = (4, 8, 8) for D <= 128,
// (8, 4, 4) for D <= 256, whose q, acc and U staged K/V rows take 4 x 32
// registers each; at D <= 128 with G <= 8 one block holds every q-head of
// its kv-head and the chunk arithmetic compiles away. The block merges its 8 warps through shared memory. With
// one split it writes the output; with more it writes its partial m, l
// (B, Hkv, n_split, G) and unnormalised acc (B, Hkv, n_split, G, D) in f32
// to scratch, and a combine kernel, one block per (kv-head, batch row),
// merges the splits in split order (deterministic, no atomics). A split
// with no valid slot has m = -1e30, l = 0 and adds nothing; a row with
// none at all gives exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "f32_convert.cuh"

namespace {

using repro::MASK_VALUE;
using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 8;
constexpr int COMBINE_THREADS = 256;
// (elements per lane, q-heads per block, slots a warp loads before using
// them) of the two instances
constexpr int VEC_NARROW = 4, G_NARROW = 8, U_NARROW = 8;   // D <= 128
constexpr int VEC_WIDE = 8, G_WIDE = 4, U_WIDE = 4;         // D <= 256

// 4 consecutive elements of a row as one vector load
__device__ __forceinline__ void load4(const float* p, float* r) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  r[0] = x.x;
  r[1] = x.y;
  r[2] = x.z;
  r[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* r) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  r[0] = a.x;
  r[1] = a.y;
  r[2] = b.x;
  r[3] = b.y;
}

// the VEC elements of a row a lane owns: one 16-byte load per 4 f32, one
// 8-byte (VEC 4) or 16-byte (VEC 8) load for bf16
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; e += 4) load4(p + e, r + e);
}
template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    load4(p, r);
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pair[e]);
      r[2 * e] = f.x;
      r[2 * e + 1] = f.y;
    }
  }
}

// CHUNKED instances take G > MAX_G in chunks; the others hold all G q-heads
template <int VEC, int MAX_G, int U, bool CHUNKED, typename TQ, typename TC>
__global__ void __launch_bounds__(WARPS * 32) decode_split_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ kc,
    const TC* __restrict__ vc, const int* __restrict__ cache_pos,
    const int* __restrict__ pos, TQ* __restrict__ o,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int L, int Hkv, int G, int D, int n_split,
    int n_chunk, int window, float softcap, float scale) {
  __shared__ float m_s[WARPS][MAX_G];
  __shared__ float l_s[WARPS][MAX_G];
  __shared__ float acc_s[WARPS][MAX_G][VEC * 32];

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = CHUNKED ? blockIdx.y / n_chunk : blockIdx.y;
  // this block's q-heads of the kv-head: g0 .. g0 + gn - 1
  int g0 = 0, gn = G;
  if (CHUNKED) {
    const int g_per = (G + n_chunk - 1) / n_chunk;
    g0 = (blockIdx.y - hk * n_chunk) * g_per;
    gn = min(g_per, G - g0);
    if (gn <= 0) return;                      // uniform over the block
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int chunk = (L + n_split - 1) / n_split;
  const int j0 = split * chunk, j1 = min(L, j0 + chunk);
  const int Hq = Hkv * G;
  const int now = pos[b];
  const bool lane_on = VEC * lane < D;
  const long long row_stride = (long long)Hkv * D;   // one cache slot
  // this lane's elements of slot 0
  const long long lane_off =
      (long long)b * L * row_stride + (long long)hk * D + VEC * lane;
  const TC* kb = kc + lane_off;
  const TC* vb = vc + lane_off;
  const int* cp = cache_pos + (long long)b * L;
  const long long q_off =
      ((long long)b * Hq + (long long)hk * G + g0) * D;

  float qr[MAX_G][VEC], m[MAX_G], l[MAX_G], acc[MAX_G][VEC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = MASK_VALUE;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] = (g < gn && lane_on)
                     ? to_f32(q[q_off + (long long)g * D + VEC * lane + e])
                     : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int base = j0 + w * U; base < j1; base += WARPS * U) {
    bool ok[U];
    float kr[U][VEC], vr[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u;
      ok[u] = false;
      if (j < j1) {
        const int c = cp[j];
        ok[u] = c >= 0 && c <= now && (window < 0 || c > now - window);
      }
      if (ok[u] && lane_on) {
        load_row<VEC>(kb + j * row_stride, kr[u]);
        load_row<VEC>(vb + j * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= gn) break;
      float s[U];
      float s_max = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part = fmaf(qr[g][e], kr[u][e], part);
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
      for (int e = 0; e < VEC; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][e], a);
        acc[g][e] = a;
      }
      m[g] = s_max;
    }
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= gn) break;
    if (lane == 0) {
      m_s[w][g] = m[g];
      l_s[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (lane_on) acc_s[w][g][VEC * lane + e] = acc[g][e];
  }
  __syncthreads();

  // merge the warps; one split writes the output, more write partials
  const long long part = ((long long)b * Hkv + hk) * n_split + split;
  for (int t = threadIdx.x; t < gn * D; t += WARPS * 32) {
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
    if (n_split == 1) {
      o[q_off + t] = from_f32<TQ>(a / fmaxf(l_sum, 1e-30f));
    } else {
      part_acc[part * G * D + g0 * D + t] = a;
      if (d == 0) {
        part_m[part * G + g0 + g] = mx;
        part_l[part * G + g0 + g] = l_sum;
      }
    }
  }
}

// merges the n_split partials of one (kv-head, batch row) in split order
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, TQ* __restrict__ o, int Hkv, int G,
    int D, int n_split) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long first = ((long long)b * Hkv + hk) * n_split;
  const long long q_off = ((long long)b * Hkv + hk) * G * D;
  for (int t = threadIdx.x; t < G * D; t += COMBINE_THREADS) {
    const int g = t / D;
    float mx = MASK_VALUE;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, part_m[(first + s) * G + g]);
    float l_sum = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(part_m[(first + s) * G + g] - mx);
      l_sum += part_l[(first + s) * G + g] * f;
      a += part_acc[(first + s) * G * D + t] * f;
    }
    o[q_off + t] = from_f32<TQ>(a / fmaxf(l_sum, 1e-30f));
  }
}

template <int VEC, int MAX_G, int U, bool CHUNKED, typename TQ, typename TC>
int launch_split(const void* q, const void* kc, const void* vc,
                 const void* cache_pos, const void* pos, void* o,
                 void* part_m, void* part_l, void* part_acc, int B, int L,
                 int Hkv, int G, int D, int n_split, int window,
                 float softcap, float scale, cudaStream_t stream) {
  const int n_chunk = (G + MAX_G - 1) / MAX_G;
  const dim3 grid(n_split, Hkv * n_chunk, B);
  decode_split_kernel<VEC, MAX_G, U, CHUNKED, TQ, TC>
      <<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), static_cast<const int*>(cache_pos),
      static_cast<const int*>(pos), static_cast<TQ*>(o),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), L, Hkv, G, D, n_split, n_chunk, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch(const void* q, const void* kc, const void* vc,
           const void* cache_pos, const void* pos, void* o, void* part_m,
           void* part_l, void* part_acc, int B, int L, int Hkv, int G, int D,
           int n_split, int window, float softcap, float scale,
           cudaStream_t stream) {
  int status;
  if (D > VEC_NARROW * 32)
    status = launch_split<VEC_WIDE, G_WIDE, U_WIDE, true, TQ, TC>(
        q, kc, vc, cache_pos, pos, o, part_m, part_l, part_acc, B, L, Hkv, G,
        D, n_split, window, softcap, scale, stream);
  else if (G > G_NARROW)
    status = launch_split<VEC_NARROW, G_NARROW, U_NARROW, true, TQ, TC>(
        q, kc, vc, cache_pos, pos, o, part_m, part_l, part_acc, B, L, Hkv, G,
        D, n_split, window, softcap, scale, stream);
  else
    status = launch_split<VEC_NARROW, G_NARROW, U_NARROW, false, TQ, TC>(
        q, kc, vc, cache_pos, pos, o, part_m, part_l, part_acc, B, L, Hkv, G,
        D, n_split, window, softcap, scale, stream);
  const cudaError_t err = (cudaError_t)status;
  if (err != cudaSuccess || n_split == 1) return (int)err;
  decode_combine_kernel<TQ><<<dim3(Hkv, B), COMBINE_THREADS, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<TQ*>(o), Hkv, G, D,
      n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// part_m, part_l (B, Hkv, n_split, G) and part_acc (B, Hkv, n_split, G, D)
// are f32 scratch, read only when n_split > 1; D a multiple of 4 up to 128
// or a multiple of 8 up to 256, any G, the caches 16-byte aligned
extern "C" int repro_decode_attention(
    const void* q, const void* kc, const void* vc, const void* cache_pos,
    const void* pos, void* o, void* part_m, void* part_l, void* part_acc,
    int B, int L, int Hkv, int G, int D, int n_split, int window,
    float softcap, float scale, int q_bf16, int cache_bf16, void* stream) {
  const int vec = D <= VEC_NARROW * 32 ? VEC_NARROW : VEC_WIDE;
  const int max_g = D <= VEC_NARROW * 32 ? G_NARROW : G_WIDE;
  if (D > VEC_WIDE * 32 || D <= 0 || D % vec != 0 || G <= 0 ||
      n_split < 1 || n_split > 65535 || B > 65535 ||
      (long long)Hkv * ((G + max_g - 1) / max_g) > 65535 ||
      (n_split > 1 && (part_m == nullptr || part_l == nullptr ||
                       part_acc == nullptr)))
    return 1;                                  // cudaErrorInvalidValue
  if (B == 0 || Hkv == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (q_bf16 && cache_bf16)
    return launch<bf, bf>(q, kc, vc, cache_pos, pos, o, part_m, part_l,
                          part_acc, B, L, Hkv, G, D, n_split, window, softcap,
                          scale, s);
  if (q_bf16)
    return launch<bf, float>(q, kc, vc, cache_pos, pos, o, part_m, part_l,
                             part_acc, B, L, Hkv, G, D, n_split, window,
                             softcap, scale, s);
  if (cache_bf16)
    return launch<float, bf>(q, kc, vc, cache_pos, pos, o, part_m, part_l,
                             part_acc, B, L, Hkv, G, D, n_split, window,
                             softcap, scale, s);
  return launch<float, float>(q, kc, vc, cache_pos, pos, o, part_m, part_l,
                              part_acc, B, L, Hkv, G, D, n_split, window,
                              softcap, scale, s);
}
