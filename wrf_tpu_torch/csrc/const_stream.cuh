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
