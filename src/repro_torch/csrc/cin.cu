// xDeepFM's Compressed Interaction Network (CIN), for Hopper (sm_90a): the
// outer products of a layer's feature maps with the input fields, laid out
// as the operand of the layer's matrix product, and the contraction of that
// operand's cotangent back onto both factors.
//
// Replaces no Pallas kernel: the reference computes the CIN in XLA (two
// `jnp.einsum`s a layer in `dlrm_forward` of src/repro/models/dlrm.py). The
// port ran the same einsums eagerly, which on the card materialised the
// (B, H, m, D) product, copied it into the permuted (B*D, H*m) operand of
// the layer's GEMM, and in the backward ran the permuted copy, two
// broadcast products and two reductions over the same 1.75 GB: 13.7 of the
// xDeepFM step's 23.8 device ms, around 9.4 ms of GEMMs (PERF.md).
//
// What they compute, for a layer with H input maps, m fields, D coordinates:
// * cin_product: z[b*D + d, h*m + j] = xk[b, h, d] * x0[b, j, d], one
//   __fmul_rn each, so z equals the eager broadcast product bit for bit.
//   z is the row-major (B*D, H*m) operand of torch.mm(z, W.reshape(H*m, n)).
// * cin_contract: from gz, the (B*D, H*m) cotangent of z,
//     gxk[b, d, h] = sum_j gz[b*D + d, h*m + j] * x0[b, j, d]
//     gx0[b, j, d] = sum_h gz[b*D + d, h*m + j] * xk[b, h, d]
//   gxk is written (B, D, H) row-major, the layout of the previous layer's
//   torch.mm output; gx0 (B, m, D) row-major. Each product is rounded
//   (__fmul_rn) and the sums run in the order of ATen's CUDA sum over the
//   same products, which autograd ran before (eager_sum below), so for
//   1 < m < 128 both equal the eager `(gz_view * x0).sum(2)` and
//   `(gz_view * xk).sum(1)` bit for bit: a step's gradients are the eager
//   path's, not a rounding away (on a step that amplifies roundings, a
//   rounding in the first gradient moved the third loss by 2e-5). No
//   atomics: two calls give the same bits.
// xk and x0 are read through their strides (the layer's input maps are a
// permuted view of the previous torch.mm output, (B, D, n) in memory).
//
// Bound on this card: bytes. At the xDeepFM cell (B 8,192, m 26, D 16, maps
// 128-128) layer 1's operand is 131,072 x 3,328 f32, 1.745 GB (0.52 ms at
// 3.35 TB/s), layer 0's 131,072 x 676, 0.354 GB: the product writes it, the
// contraction reads its cotangent once. The arithmetic is one multiply an
// element (product) or two multiplies and two adds (contraction): far
// below the card's rate.
//
// Design: one block a sample b. It stages xk[b] and x0[b] in shared memory,
// transposed to [d][h] and [d][j] so that neighbouring lanes read
// neighbouring banks. The product then streams out the sample's D*H*m
// contiguous elements as 16-byte stores, each thread stepping its (d, h, j)
// by carries rather than divisions. The contraction walks the sample's D
// rows of gz, as many a pass as its threads serve (4 at layer 0, 1 at
// layer 1): the block loads them into shared memory with 16-byte loads,
// the next pass's already in flight into registers during this pass's
// sums, then a thread, or 4 adjacent ones, takes each output, gxk's over m and
// gx0's over H. A thread holds up to 16 of the output's lanes of ATen's
// sum in registers, so the sum's order costs adds in registers and, where
// the output spans 4 threads, two shuffle steps, not one instruction chain
// per lane; gx0 leaves through shared memory in its memory order. Shapes
// whose rows are no multiple of 4 floats, or unaligned arrays, take the
// same kernels with scalar loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;   // static limit, no opt-in needed
constexpr int kAhead = 4;    // float4s a thread holds of the contraction's
                             // next rows

// a (B, R, D) f32 tensor read through its element strides
struct Maps {
  const float* p;
  long long sb, sr, sd;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// x[b] into s as [d][r]; the index of the smaller stride runs fastest, so
// a warp reads contiguous memory in both layouts the CIN passes
__device__ __forceinline__ void stage(const Maps& x, int b, int R, int D,
                                      float* s) {
  const float* base = x.p + b * x.sb;
  const int n = R * D;
  if (x.sr <= x.sd) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int d = i / R, r = i - d * R;
      s[d * R + r] = base[r * x.sr + d * x.sd];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      s[d * R + r] = base[r * x.sr + d * x.sd];
    }
  }
}

// (d, h, j) advanced by a step of (sd, sh, sj), each part below its range
__device__ __forceinline__ void advance(int& d, int& h, int& j, int sd,
                                        int sh, int sj, int H, int m) {
  j += sj;
  if (j >= m) { j -= m; ++h; }
  h += sh;
  if (h >= H) { h -= H; ++d; }
  d += sd;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cin_product_kernel(Maps xk, Maps x0, int H, int m, int D,
                   float* __restrict__ z) {
  extern __shared__ float smem_p[];
  float* xk_s = smem_p;                // [d][h]
  float* x0_s = smem_p + H * D;        // [d][j]
  const int b = blockIdx.x;
  stage(xk, b, H, D, xk_s);
  stage(x0, b, m, D, x0_s);
  __syncthreads();
  const int HM = H * m;
  const int n = D * HM;                // the sample's elements
  float* out = z + static_cast<long long>(b) * n;
  constexpr int kW = kVec ? 4 : 1;     // elements a store
  const int first = kW * threadIdx.x, step = kW * blockDim.x;
  int d = first / HM, r = first - d * HM;
  int h = r / m, j = r - h * m;
  const int sd = step / HM, sr = step - sd * HM;
  const int sh = sr / m, sj = sr - sh * m;
  for (int e = first; e < n; e += step) {
    float v[kW];
    int dd = d, hh = h, jj = j;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      v[i] = __fmul_rn(xk_s[dd * H + hh], x0_s[dd * m + jj]);
      advance(dd, hh, jj, 0, 0, 1, H, m);
    }
    if constexpr (kVec)
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    else
      out[e] = v[0];
    advance(d, h, j, sd, sh, sj, H, m);
  }
}

__host__ __device__ __forceinline__ int round32(int n) {
  return (n + 31) / 32 * 32;
}

// The lanes ATen's CUDA sum gives one output of n terms, along the
// fastest-striding dimension: the largest power of two up to n, at most a
// warp (Reduce.cuh's block width)
__host__ __device__ __forceinline__ int sum_lanes(int n) {
  int w = 1;
  while (2 * w <= n && w < 32) w *= 2;
  return w;
}

// Of those W lanes, the lanes one thread takes here: a thread holds L
// lanes, and W / L adjacent threads an output
__host__ __device__ __forceinline__ int lanes_per_thread(int W) {
  return W == 32 ? 8 : W;
}

// One output of ATen's CUDA sum over the n products prod(0..n-1), in its
// order (Reduce.cuh: thread_reduce_impl with vt0 = 4, then block_x_reduce):
// lane x of W = sum_lanes(n) adds the products e = x, x + W, x + 2W, ...
// into four accumulators in turn, from zero, then the accumulators in
// order; the lanes are added by shfl_down steps of W/2, ..., 1. Thread q of
// the output's W / L holds lanes qL .. qL + L - 1: the steps of L lanes or
// more are shuffles between the threads, the rest adds in registers. Every
// thread of the warp calls it with the same n and W, with an index that
// prod may read (a thread whose output is past the end reads a valid one
// and its sum is never stored). Thread q = 0 returns the sum.
//
// A product past n is read at a valid index and replaced by +0, which adds
// nothing: an accumulator starts at +0 and can never be -0. So the loads
// carry no branches and a thread issues all of them together.
template <int L, typename Prod>
__device__ __forceinline__ float eager_sum(int n, int W, int q, Prod prod) {
  float s[L];
  bool general = false;
  if constexpr (L == 8) general = n > 2 * W;   // W = 32, n > 64
  if (!general) {                    // a lane has one term or two
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int e = q * L + l;       // below W, so below n
      const bool two = e + W < n;
      const float t0 = prod(e), t1 = prod(two ? e + W : e);
      const float a0 = __fadd_rn(0.f, t0);
      const float a1 = __fadd_rn(0.f, two ? t1 : 0.f);
      s[l] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), 0.f), 0.f);
    }
  } else if constexpr (L == 8) {
    float a[L][4];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[l][i] = 0.f;
    for (int base = 0; base < n; base += 4 * W) {
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = base + q * L + l + i * W;
          const float t = prod(e < n ? e : 0);
          a[l][i] = __fadd_rn(a[l][i], e < n ? t : 0.f);
        }
    }
#pragma unroll
    for (int l = 0; l < L; ++l)
      s[l] = __fadd_rn(__fadd_rn(__fadd_rn(a[l][0], a[l][1]), a[l][2]),
                       a[l][3]);
  }
  for (int off = W >> 1; off >= L; off >>= 1) {
#pragma unroll
    for (int l = 0; l < L; ++l)
      s[l] = __fadd_rn(s[l], __shfl_down_sync(0xffffffffu, s[l], off / L));
  }
  // the steps below L lanes, spelled out so that s stays in registers
  if constexpr (L >= 16) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = __fadd_rn(s[l], s[l + 8]);
  }
  if constexpr (L >= 8) {
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = __fadd_rn(s[l], s[l + 4]);
  }
  if constexpr (L >= 4) {
    s[0] = __fadd_rn(s[0], s[2]);
    s[1] = __fadd_rn(s[1], s[3]);
  }
  if constexpr (L >= 2) s[0] = __fadd_rn(s[0], s[1]);
  return s[0];
}

template <typename Prod>
__device__ __forceinline__ float eager_sum_of(int n, int W, int q,
                                              Prod prod) {
  switch (lanes_per_thread(W)) {
    case 16: return eager_sum<16>(n, W, q, prod);
    case 8: return eager_sum<8>(n, W, q, prod);
    case 4: return eager_sum<4>(n, W, q, prod);
    case 2: return eager_sum<2>(n, W, q, prod);
    default: return eager_sum<1>(n, W, q, prod);
  }
}

// A row's tasks: gxk's H outputs (qk threads each) from task 0, gx0's m
// outputs (q0 threads each) from the next multiple of 32, so that a warp
// serves one of the two; per_row tasks a row, a multiple of 32.
struct Tasks {
  int wk, w0, qk, q0, k_end, o_start, o_end, per_row;
};

__host__ __device__ __forceinline__ Tasks row_tasks(int H, int m) {
  Tasks t;
  t.wk = sum_lanes(m);
  t.w0 = sum_lanes(H);
  t.qk = t.wk / lanes_per_thread(t.wk);
  t.q0 = t.w0 / lanes_per_thread(t.w0);
  t.k_end = H * t.qk;
  t.o_start = round32(t.k_end);
  t.o_end = t.o_start + m * t.q0;
  t.per_row = round32(t.o_end);
  return t;
}

// R rows of gz a pass (contiguous in gz: one sample's rows d0 .. d0+R-1)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cin_contract_kernel(const float* __restrict__ gz, Maps xk, Maps x0, int H,
                    int m, int D, int R, float* __restrict__ gxk,
                    float* __restrict__ gx0) {
  extern __shared__ float4 smem4[];   // 16-byte aligned
  float* row_s = reinterpret_cast<float*>(smem4);   // R rows, [r][h][j]
  const int HM = H * m;
  float* xk_s = row_s + R * HM;        // [d][h]
  float* x0_s = xk_s + H * D;          // [d][j]
  float* g0_s = x0_s + m * D;          // gx0 of the sample, [d][j]
  const int b = blockIdx.x;
  stage(xk, b, H, D, xk_s);
  stage(x0, b, m, D, x0_s);
  const Tasks tk = row_tasks(H, m);
  const float* g = gz + static_cast<long long>(b) * D * HM;
  // the rows of a pass held in registers between passes: the next pass's
  // loads are issued before this pass's sums, which then hide them
  float4 ahead[kAhead];
  const bool hold =
      kVec && R * HM / 4 <= kAhead * static_cast<int>(blockDim.x);
  auto fetch = [&](int d0) {
    const int n4 = min(R, D - d0) * HM / 4;
    const float4* src = reinterpret_cast<const float4*>(
        g + static_cast<long long>(d0) * HM);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int q = threadIdx.x + i * blockDim.x;
      if (q < n4) ahead[i] = __ldcs(src + q);
    }
  };
  if (hold) fetch(0);
  for (int d0 = 0; d0 < D; d0 += R) {
    const int rows = min(R, D - d0);
    const float* src = g + static_cast<long long>(d0) * HM;
    if (hold) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int q = threadIdx.x + i * blockDim.x;
        if (q < rows * HM / 4)
          reinterpret_cast<float4*>(row_s)[q] = ahead[i];
      }
    } else if constexpr (kVec) {
      for (int q = threadIdx.x; q < rows * HM / 4; q += blockDim.x)
        reinterpret_cast<float4*>(row_s)[q] =
            __ldcs(reinterpret_cast<const float4*>(src) + q);
    } else {
      for (int i = threadIdx.x; i < rows * HM; i += blockDim.x)
        row_s[i] = __ldcs(src + i);
    }
    __syncthreads();                   // the staging and these rows' loads
    if (hold && d0 + R < D) fetch(d0 + R);
    for (int task = threadIdx.x; task < R * tk.per_row;
         task += blockDim.x) {
      const int r = task / tk.per_row, t = task - r * tk.per_row;
      // a task past the rows or the outputs reads row 0, output 0
      const int rr = r < rows ? r : 0, dd = d0 + rr;
      const float* row = row_s + rr * HM;
      if (t < tk.o_start) {            // gxk[b, d, h], over j
        const bool live = r < rows && t < tk.k_end;
        const int h = live ? t / tk.qk : 0, q = t % tk.qk;
        const float* gr = row + h * m;
        const float* x0d = x0_s + dd * m;
        const float s = eager_sum_of(m, tk.wk, q, [&](int j) {
          return __fmul_rn(gr[j], x0d[j]);
        });
        if (live && q == 0)
          gxk[(static_cast<long long>(b) * D + dd) * H + h] = s;
      } else {                         // gx0[b, j, d], over h
        const bool live = r < rows && t < tk.o_end;
        const int j = live ? (t - tk.o_start) / tk.q0 : 0;
        const int q = (t - tk.o_start) % tk.q0;
        const float* col = row + j;
        const float* xkd = xk_s + dd * H;
        const float s = eager_sum_of(H, tk.w0, q, [&](int h) {
          return __fmul_rn(col[h * m], xkd[h]);
        });
        if (live && q == 0) g0_s[dd * m + j] = s;
      }
    }
    __syncthreads();                   // before the next rows overwrite them
  }
  float* out = gx0 + static_cast<long long>(b) * m * D;
  for (int i = threadIdx.x; i < m * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D;
    out[i] = g0_s[d * m + j];
  }
}

Maps maps(const void* p, long long sb, long long sr, long long sd) {
  return Maps{static_cast<const float*>(p), sb, sr, sd};
}

// a launch's shared memory in bytes; the contraction's with R rows of gz
// (kernels/cin.py's smem_bytes: R = 1)
long long smem_bytes(bool contract, int H, int m, int D, int R) {
  const long long maps = static_cast<long long>(H + m) * D;
  if (!contract) return maps * 4;
  return (maps + static_cast<long long>(R) * H * m
          + static_cast<long long>(m) * D) * 4;
}

// the contraction's rows a pass: as many as the block has threads for
// (a row's tasks rounded to warps) and shared memory holds
int rows_a_pass(int H, int m, int D) {
  int R = std::max(1, std::min(D, kThreads / row_tasks(H, m).per_row));
  while (R > 1 && smem_bytes(true, H, m, D, R) > kMaxSmemBytes) --R;
  return R;
}

}  // namespace

extern "C" int repro_cin_product_f32(
    const void* xk, long long xk_sb, long long xk_sh, long long xk_sd,
    const void* x0, long long x0_sb, long long x0_sj, long long x0_sd,
    int B, int H, int m, int D, void* z, int vec, void* stream) {
  if (B == 0 || H == 0 || m == 0 || D == 0) return 0;
  if (B < 0 || H < 0 || m < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(false, H, m, D, 0);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (vec && ((static_cast<long long>(D) * H * m) % 4 != 0 || !aligned16(z)))
    return (int)cudaErrorMisalignedAddress;
  auto st = static_cast<cudaStream_t>(stream);
  const Maps a = maps(xk, xk_sb, xk_sh, xk_sd), c = maps(x0, x0_sb, x0_sj,
                                                          x0_sd);
  auto* out = static_cast<float*>(z);
  if (vec)
    cin_product_kernel<true><<<B, kThreads, smem, st>>>(a, c, H, m, D, out);
  else
    cin_product_kernel<false><<<B, kThreads, smem, st>>>(a, c, H, m, D, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_cin_contract_f32(
    const void* gz, const void* xk, long long xk_sb, long long xk_sh,
    long long xk_sd, const void* x0, long long x0_sb, long long x0_sj,
    long long x0_sd, int B, int H, int m, int D, void* gxk, void* gx0,
    int vec, void* stream) {
  if (B == 0 || H == 0 || m == 0 || D == 0) return 0;
  if (B < 0 || H < 0 || m < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int R = rows_a_pass(H, m, D);
  const long long smem = smem_bytes(true, H, m, D, R);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  if (vec && ((H * m) % 4 != 0 || !aligned16(gz)))
    return (int)cudaErrorMisalignedAddress;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gz);
  const Maps a = maps(xk, xk_sb, xk_sh, xk_sd), c = maps(x0, x0_sb, x0_sj,
                                                          x0_sd);
  auto* ok = static_cast<float*>(gxk);
  auto* o0 = static_cast<float*>(gx0);
  if (vec)
    cin_contract_kernel<true><<<B, kThreads, smem, st>>>(g, a, c, H, m, D, R,
                                                         ok, o0);
  else
    cin_contract_kernel<false><<<B, kThreads, smem, st>>>(g, a, c, H, m, D,
                                                          R, ok, o0);
  return (int)cudaGetLastError();
}
