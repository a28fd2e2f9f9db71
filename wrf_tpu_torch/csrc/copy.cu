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
// Bound: memory; no arithmetic but the optional add.  What keeps a copy
// from the memory rate is the number of loads in flight: a thread that
// stores each 16-byte word right after loading it has one load in flight,
// because the next load may alias the store.  So each thread issues all
// its loads before any of its stores.
//
// Geometry: block b copies one contiguous chunk of kWords * 256 16-byte
// words (float4); thread t loads words t, t + 256, t + 512, t + 768 of it,
// then stores them (neighbouring threads on neighbouring words), so the
// grid is the chunk count and no thread loops.  Loads and stores are
// streaming (ld/st.global.cs: evict first).  Blocks past the word chunks
// copy what 16-byte alignment leaves (at most 3 floats, or the whole array
// when a pointer is not 16-byte aligned) in chunks of kWords * 256 floats,
// the same way.  In place stays right because every element is loaded and
// stored by one thread, its load first.
//
// The wrapper (copy_ceiling.py::launch_plan) sizes the grid.  The other
// forms timed on an H100 (8 words a thread, plain or read-only-path hints,
// a TMA bulk copy) were at most 2 % faster at one shape and slower at the
// ceiling's (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // 16-byte words a thread loads before it stores

template <bool PLUS1>
__device__ __forceinline__ float4 bump(float4 v) {
  if (PLUS1) {
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
  }
  return v;
}

// Blocks [0, vec_blocks) copy the float4 words [0, n4), one chunk of
// kWords * kThreads words each; blocks [vec_blocks, gridDim.x) copy the
// floats [4 * n4, n), one chunk of kWords * kThreads floats each.
template <bool PLUS1>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const float* x, float* out, size_t n4, size_t n,
            unsigned vec_blocks) {
  constexpr size_t kChunk = (size_t)kWords * kThreads;
  if (blockIdx.x < vec_blocks) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    const size_t q0 = blockIdx.x * kChunk + threadIdx.x;
    float4 v[kWords];
    if (q0 + (kWords - 1) * kThreads < n4) {  // a full chunk: no guards
#pragma unroll
      for (int u = 0; u < kWords; ++u) v[u] = __ldcs(x4 + q0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        __stcs(o4 + q0 + u * kThreads, bump<PLUS1>(v[u]));
    } else {
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (q0 + u * kThreads < n4) v[u] = __ldcs(x4 + q0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (q0 + u * kThreads < n4)
          __stcs(o4 + q0 + u * kThreads, bump<PLUS1>(v[u]));
    }
    return;
  }
  const size_t e0 = 4 * n4 + (blockIdx.x - vec_blocks) * kChunk + threadIdx.x;
  float v[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u)
    if (e0 + u * kThreads < n) v[u] = x[e0 + u * kThreads];
#pragma unroll
  for (int u = 0; u < kWords; ++u)
    if (e0 + u * kThreads < n)
      out[e0 + u * kThreads] = PLUS1 ? v[u] + 1.0f : v[u];
}

}  // namespace

// Plain C entry for ctypes: out[e] = x[e] (+ 1 when plus1) for e < n; out
// may equal x.  The caller's plan: the first ``n4`` float4 words are copied
// as words (both pointers 16-byte aligned) by ``vec_blocks`` blocks, the
// rest as floats by ``blocks - vec_blocks`` more.  Launches on ``stream``
// and returns cudaGetLastError() of the launch; it neither allocates nor
// synchronises.
extern "C" int wrf_tpu_torch_copy_probe(const float* x, float* out,
                                        long long n, long long n4,
                                        int vec_blocks, int blocks,
                                        int plus1, void* stream) {
  if (n < 0 || n4 < 0 || 4 * n4 > n || vec_blocks < 0 || vec_blocks > blocks)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;  // the plan has no block then
  if (blocks < 1) return cudaErrorInvalidValue;
  if (n4 > 0 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plus1)
    copy_kernel<true><<<blocks, kThreads, 0, s>>>(x, out, (size_t)n4,
                                                  (size_t)n, vec_blocks);
  else
    copy_kernel<false><<<blocks, kThreads, 0, s>>>(x, out, (size_t)n4,
                                                   (size_t)n, vec_blocks);
  return static_cast<int>(cudaGetLastError());
}
