// Device helpers shared by the port's CUDA kernels (K1 ar_stack*.cu, K2
// masked_conv*.cu): f32 <-> T conversion for T = float or __nv_bfloat16,
// the ELU that K1's forward and backward must compute bit for bit alike,
// and the tensor-core primitives of the bf16 paths.

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

// D += A * B on the tensor cores, m16n8k16, bf16 in, f32 accumulate. Lane
// g*4+tig holds A rows g and g+8 at k = 2tig, 2tig+1 (a[0], a[1]) and
// 2tig+8, 2tig+9 (a[2], a[3]); B column g at the same k (b0, b1); and C
// rows g, g+8 at columns 2tig, 2tig+1 (c[0..1], c[2..3]).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
