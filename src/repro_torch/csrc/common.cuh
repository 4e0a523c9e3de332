// Shared helpers of the port's CUDA kernels: f32/bf16 load and store,
// warp reductions, and the error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace repro

// dtype codes passed from Python: 0 = float32, 1 = bfloat16
#define REPRO_DISPATCH_DTYPE(code, T, ...)        \
  if ((code) == 0) {                              \
    using T = float;                              \
    __VA_ARGS__;                                  \
  } else if ((code) == 1) {                       \
    using T = __nv_bfloat16;                      \
    __VA_ARGS__;                                  \
  } else {                                        \
    return (int)cudaErrorInvalidValue;            \
  }

extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
