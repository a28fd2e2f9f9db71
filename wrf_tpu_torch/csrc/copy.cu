// K6 — the bare copy kernel that sets the card's bandwidth ceiling, on
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel in bench.py::measure_copy_gbps (the Pallas body
// ``o_ref[:] = x_ref[:]`` / ``o_ref[:] = x_ref[:] + 1.0``).  It moves a
// contiguous float32 array once: every element read once and written once,
// nothing else, so its rate is the most a streaming kernel of the port can
// reach on the same card.  Three probes share it: ``ab`` (out = x, fresh
// output), ``ab_plus1`` (out = x + 1) and ``aliased`` (x += 1 in place,
// out == x).  The plain PyTorch versions are ``out.copy_(x)`` and ``x + 1``
// (wrf_tpu_torch/utils/copy_ceiling.py).
//
// Geometry: a grid-stride loop of 16-byte loads and stores (float4) over
// the part of the array that 16-byte alignment allows, one float4 per
// thread per trip, neighbouring threads on neighbouring float4s; then a
// scalar tail of at most 3 elements.  When either pointer is not 16-byte
// aligned the whole array goes through the scalar loop.
//
// Bound: memory; no arithmetic but the optional add.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

template <bool PLUS1>
__global__ void __launch_bounds__(256)
copy_kernel(const float* x, float* out, size_t n4, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (size_t q = tid; q < n4; q += stride) {
    float4 v = x4[q];
    if (PLUS1) {
      v.x += 1.0f;
      v.y += 1.0f;
      v.z += 1.0f;
      v.w += 1.0f;
    }
    o4[q] = v;
  }
  for (size_t e = 4 * n4 + tid; e < n; e += stride) {
    out[e] = PLUS1 ? x[e] + 1.0f : x[e];
  }
}

}  // namespace

// Plain C entry for ctypes: out[e] = x[e] (+ 1 when plus1) for e < n; out
// may equal x.  Launches ``blocks`` blocks of 256 threads on ``stream`` and
// returns cudaGetLastError() of the launch; it neither allocates nor
// synchronises.
extern "C" int wrf_tpu_torch_copy_probe(const float* x, float* out,
                                        long long n, int plus1, int blocks,
                                        void* stream) {
  if (n < 0 || blocks < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const size_t n4 = aligned ? (size_t)n / 4 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plus1) {
    copy_kernel<true><<<blocks, 256, 0, s>>>(x, out, n4, (size_t)n);
  } else {
    copy_kernel<false><<<blocks, 256, 0, s>>>(x, out, n4, (size_t)n);
  }
  return static_cast<int>(cudaGetLastError());
}
