// Conversions between the storage dtypes of the attention kernels (float32,
// bfloat16) and the float32 they compute in. Shared by flash_attention.cu
// (K4) and decode_attention.cu (K5).
#pragma once
#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);     // round to nearest even, as torch's .to()
}

// additive score mask of the attention kernels (MASK_VALUE of
// repro_torch/kernels/common.py): exp(MASK_VALUE - m) underflows to 0
constexpr float MASK_VALUE = -1e30f;

}  // namespace repro
