// K5 — the ring-neighbour row exchange ("rdma" halo backend) on NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel wrf_tpu/parallel/halo.py::_rdma_rows (used by
// remote_refresh_axis and remote_refresh_multi): every shard of a ring
// sends its last interior rows to the NEXT shard's low halo and its first
// interior rows to the PREVIOUS shard's high halo.  On the TPU that is a
// pair of remote DMAs of a staged, lane-padded 2-slot buffer under a
// barrier semaphore; here it is one launch per device and exchange, on
// that device's stream, that moves a table of contiguous row segments (every
// sender of every ring whose rows lie on the device) straight from the
// senders' blocks into the neighbours' blocks through plain device pointers
// (peer pointers when the neighbour sits on another card): gather, put and
// scatter in one pass, no staging buffer, no padding.  Four shards on one
// card exchange with one launch.  The plain PyTorch version is indexing and
// Tensor.copy_ between the blocks (wrf_tpu_torch/ops/halo_rdma_cuda.py).
//
// Geometry: blockIdx.y picks the segment, blockIdx.x strides over it; 16-byte
// loads and stores (float4) over a segment whose two pointers are 16-byte
// aligned, with a scalar tail of at most 3 elements, else a scalar loop
// over the whole segment (a row of an odd-width block starts unaligned).
//
// Ordering is the caller's: launches on one stream are ordered by the
// stream, so every put of a substep is enqueued before any kernel that
// reads the halo rows; between devices the wrapper orders the streams with
// events.  A segment never writes a cell that any segment reads (sources
// are owned rows, destinations halo rows), so the segments of one exchange
// may run in any order.
//
// Bound: a segment is one row (about 100 KB at 512x512x50 on a 4x1 mesh),
// an exchange a few hundred KB, tens of nanoseconds at the memory rate, so
// the launch is what it costs, and the host's work to submit it: the wrapper
// launches from a plan cached by its pointers.  Times on the card are in
// PERF.md.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSegs = 64;  // 1.5 KB of by-value parameters

struct Seg {
  const float* src;
  float* dst;
  long long n;
};

struct Segs {
  Seg s[kMaxSegs];
};

__global__ void __launch_bounds__(256) put_kernel(const Segs segs) {
  const Seg sg = segs.s[blockIdx.y];
  const size_t n = (size_t)sg.n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(sg.src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(sg.dst) % 16 == 0);
  const size_t n4 = aligned ? n / 4 : 0;
  const float4* s4 = reinterpret_cast<const float4*>(sg.src);
  float4* d4 = reinterpret_cast<float4*>(sg.dst);
  for (size_t q = tid; q < n4; q += stride) d4[q] = s4[q];
  for (size_t e = 4 * n4 + tid; e < n; e += stride) sg.dst[e] = sg.src[e];
}

}  // namespace

// Plain C entry for ctypes: for q < count, dst[q][e] = src[q][e] for
// e < n[q].  One launch of ``blocks`` x ``count`` blocks of 256 threads on
// ``stream`` (a stream of the current device); returns cudaGetLastError()
// of the launch.  It neither allocates nor synchronises.
extern "C" int wrf_tpu_torch_halo_put(const void* const* src,
                                      void* const* dst, const long long* n,
                                      int count, int blocks, void* stream) {
  if (count < 1 || count > kMaxSegs || blocks < 1)
    return cudaErrorInvalidValue;
  Segs segs;
  for (int q = 0; q < kMaxSegs; ++q) {
    const bool live = q < count;
    if (live && (n[q] < 0 || src[q] == nullptr || dst[q] == nullptr))
      return cudaErrorInvalidValue;
    segs.s[q] = Seg{live ? static_cast<const float*>(src[q]) : nullptr,
                    live ? static_cast<float*>(dst[q]) : nullptr,
                    live ? n[q] : 0};
  }
  put_kernel<<<dim3(blocks, count), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// Let kernels running on device ``dev`` dereference pointers into device
// ``peer``'s memory.  Returns 0 when access is (or already was) enabled.
extern "C" int wrf_tpu_torch_halo_enable_peer(int dev, int peer) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: not a failure
    err = cudaSuccess;
  }
  cudaSetDevice(cur);
  return static_cast<int>(err);
}
