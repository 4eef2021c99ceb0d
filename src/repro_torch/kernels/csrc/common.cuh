// Helpers shared by the kernels: 16-byte vector loads converted to f32,
// and the f32 -> storage-type conversion.  T is float or __nv_bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's mask value

// 16 bytes of T held in registers, converted to 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void cvt16(const uint4& raw, float* dst);

template <>
__device__ __forceinline__ void cvt16<float>(const uint4& raw, float* dst) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void cvt16<__nv_bfloat16>(const uint4& raw,
                                                     float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One 16-byte read-only load; `src` must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 ld16(const T* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// One element of T widened to f32 (scalar loads of ragged tiles).
template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

}  // namespace repro
