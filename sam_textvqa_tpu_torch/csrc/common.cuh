// Shared helpers for the port's CUDA kernels: element conversion between
// the storage type (float or __nv_bfloat16) and the f32 math type, and the
// error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SAM_EXPORT extern "C" __attribute__((visibility("default")))

namespace sam {

constexpr float kMaskBias = -10000.0f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to the storage type and back: where the reference
// path rounds to its compute dtype, the kernels round at the same place.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace sam

SAM_EXPORT const char* sam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
