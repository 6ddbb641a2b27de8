// Device helpers shared by the port's CUDA kernels (K1 ar_stack*.cu, K2
// masked_conv*.cu): f32 <-> T conversion for T = float or __nv_bfloat16,
// and the ELU that K1's forward and backward must compute bit for bit
// alike. The tensor-core primitives are masked_conv.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// ELU as the Pallas kernel computes it, exp(min(v, 0)) - 1 on the negative
// side (within 1e-7 of expm1 near 0), with the fast exponential.
__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __expf(fminf(v, 0.f)) - 1.f;
}
