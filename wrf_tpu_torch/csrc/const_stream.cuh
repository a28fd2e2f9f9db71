// Loads of the constant streams: the read-only 3-D operands that K1, K2
// and K3 accept as float or as __nv_bfloat16 (one element type CT per
// launch).  A bf16 element is widened to float on load, which is exact;
// all arithmetic stays float.

#pragma once

#include <cuda_bf16.h>

#include <cstddef>

__device__ __forceinline__ float ldf(const float* p, size_t x) { return p[x]; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p, size_t x) {
  return __bfloat162float(p[x]);
}

// An operand no thread of the launch writes, loaded as it is stored (ldr)
// and widened where it is used (f32): a float through the read-only data
// path (ld.global.nc), a bf16 element by a plain load (the read-only path
// measured no faster for it on an H100).  A load whose value is widened at
// once stalls on its latency there, so K1 keeps the loads it issues levels
// ahead in their stored type.
__device__ __forceinline__ float ldr(const float* p, size_t x) {
  return __ldg(p + x);
}
__device__ __forceinline__ __nv_bfloat16 ldr(const __nv_bfloat16* p,
                                             size_t x) {
  return p[x];
}
__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
