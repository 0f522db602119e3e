// Shared helpers of the hand-written Hopper kernels (built for sm_90a).
//
// Every kernel takes its activations in one working type T (float or
// __nv_bfloat16), computes in fp32, and rounds to T exactly where the Pallas
// kernels it replaces round (``.astype(x.dtype)`` in
// clip_gp_tpu/ops/flash_attention.py): round_to<T>() marks those points.
#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgt {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value after a round trip through T (identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// int8 quantization of the int8 kernels (K5/K6), as the JAX package's
// quantize_rows: scale = max(absmax / 127, kQuantEps) per row, code =
// clip(rint(v / scale), ±127). IEEE division, and rintf (round half to even,
// as jnp.round); roundf would round half away from zero.
constexpr float kQuantEps = 1e-12f;

__device__ __forceinline__ int8_t quantize_code(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace cgt
