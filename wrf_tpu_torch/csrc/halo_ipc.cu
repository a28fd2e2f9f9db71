// K5 across processes: the signalled put into a neighbour's mailbox and the
// wait on this rank's own, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrf_tpu/parallel/halo.py::_rdma_rows where the
// ring neighbour sits in another process on the same host.  The TPU kernel
// waits on a barrier semaphore until the neighbour's receive buffer is free,
// starts a remote copy into it and waits on the recv semaphore until the
// neighbour's rows have landed.  Here a rank cannot write into a
// neighbour's blocks (they are fresh tensors every exchange), so every rank
// owns one persistent mailbox per exchange shape, mapped into its
// neighbours' processes through CUDA IPC, holding two slots (by the
// exchange's parity) per incoming message and 32-bit counters:
//
//   data[q]  in the receiver's mailbox: blocks of the senders' put launches
//            that have finished writing message q (every block adds one);
//   free[k]  in the sender's mailbox: exchanges whose slot of outgoing
//            message k the receiver has finished reading (one a release);
//   err      a rank's first timeout, which every later launch reads first
//            and then does nothing.
//
// mailbox_put: blockIdx.y picks a segment (a row or a slab of one field of
// one message), blockIdx.x strides over it.  Thread 0 waits until the free
// counter of the segment's message shows the slot released (the barrier
// semaphore), the block copies the segment into the receiver's slot with
// 16-byte accesses (as csrc/halo_rdma.cu), every thread fences its stores at
// system scope, and thread 0 adds one to the receiver's data counter with a
// system-scope atomic (the recv semaphore).  No block needs to know whether
// it finished last: the receiver knows how many blocks write each message.
//
// mailbox_wait: block (0,0) first releases the previous exchange's slots
// (one system-scope add to each sender's free counter: the kernels that read
// them, this launch's scatter or the K1/K3 launch that read the rows in
// place, are done by stream order).  Then thread 0 of every block waits with
// ld.acquire.sys and __nanosleep backoff until every data counter reaches the
// target the plan predicts, and the blocks copy the mailbox rows into the
// halo rows (the rdma backend), or copy nothing (rdma_overlap: the substep
// kernel reads the rows in the mailbox).
//
// Every wait is bounded: after 10 s on %globaltimer the kernel writes the
// error word and returns, so a wrong plan fails at the wrapper's next check
// (ops/halo_rdma_cuda.py, where the loop reads back) instead of hanging.
//
// Bound: an exchange moves a few rows (about 100 KB at 512x512x50 on a (2,2)
// mesh): tens of nanoseconds at the memory rate.  What an exchange costs is
// the two launches and the latency of the signals between the processes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSegs = 64;
constexpr int kMaxMsgs = 32;
constexpr unsigned long long kTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;

// error codes (low byte) of the err word; the message index sits above
constexpr unsigned kPutTimedOut = 1;
constexpr unsigned kWaitTimedOut = 2;

struct Seg {
  const float* src;
  float* dst;
  long long n;
  int msg;
  int pad;
};

struct PutTable {
  Seg s[kMaxSegs];
  unsigned* data[kMaxMsgs];         // the receiver's data counter
  const unsigned* free_[kMaxMsgs];  // this rank's free counter
  unsigned free_target[kMaxMsgs];
  unsigned* err;
};

struct WaitTable {
  Seg s[kMaxSegs];                  // mailbox rows -> halo rows
  const unsigned* data[kMaxMsgs];   // this rank's data counters
  unsigned target[kMaxMsgs];
  unsigned* release[kMaxMsgs];      // the senders' free counters
  int n_msgs;
  int n_release;
  unsigned* err;
};

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p has reached target (the counters wrap: compared as a signed
// difference); false after the time limit.
__device__ bool reach(const unsigned* p, unsigned target,
                      unsigned long long t0) {
  unsigned ns = 32;
  while (static_cast<int>(load_acquire_sys(p) - target) < 0) {
    if (global_ns() - t0 > kTimeoutNs) return false;
    __nanosleep(ns);
    if (ns < 2048) ns *= 2;
  }
  return true;
}

// dst[e] = src[e] for e < n by the threads of one block row of the grid;
// 16-byte accesses where both pointers allow them.  ``cg``: the source was
// written by another process (read past L1).
template <bool kCg>
__device__ __forceinline__ void copy_segment(const Seg& sg) {
  const size_t n = (size_t)sg.n;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(sg.src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(sg.dst) % 16 == 0);
  const size_t n4 = aligned ? n / 4 : 0;
  const float4* s4 = reinterpret_cast<const float4*>(sg.src);
  float4* d4 = reinterpret_cast<float4*>(sg.dst);
  for (size_t q = tid; q < n4; q += stride)
    d4[q] = kCg ? __ldcg(s4 + q) : s4[q];
  for (size_t e = 4 * n4 + tid; e < n; e += stride)
    sg.dst[e] = kCg ? __ldcg(sg.src + e) : sg.src[e];
}

__global__ void __launch_bounds__(256) mailbox_put(const PutTable t) {
  __shared__ int go;
  const Seg sg = t.s[blockIdx.y];
  if (threadIdx.x == 0) {
    go = 0;
    if (load_volatile(t.err) == 0) {
      if (reach(t.free_[sg.msg], t.free_target[sg.msg], global_ns()))
        go = 1;
      else
        atomicCAS(t.err, 0u, kPutTimedOut | (unsigned(sg.msg) << 8));
    }
  }
  __syncthreads();
  if (!go) return;
  copy_segment<false>(sg);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd_system(t.data[sg.msg], 1u);
}

__global__ void __launch_bounds__(256) mailbox_wait(const WaitTable t) {
  __shared__ int go;
  if (blockIdx.x == 0 && blockIdx.y == 0 &&
      static_cast<int>(threadIdx.x) < t.n_release)
    atomicAdd_system(t.release[threadIdx.x], 1u);
  if (threadIdx.x == 0) {
    go = 0;
    if (load_volatile(t.err) == 0) {
      const unsigned long long t0 = global_ns();
      int m = 0;
      while (m < t.n_msgs && reach(t.data[m], t.target[m], t0)) ++m;
      if (m == t.n_msgs)
        go = 1;
      else
        atomicCAS(t.err, 0u, kWaitTimedOut | (unsigned(m) << 8));
    }
  }
  __syncthreads();
  if (!go) return;
  const Seg sg = t.s[blockIdx.y];
  if (sg.n > 0) copy_segment<true>(sg);
}

bool fill_segs(Seg* s, const void* const* src, void* const* dst,
               const long long* n, const int* msg, int count, int n_msgs) {
  for (int q = 0; q < kMaxSegs; ++q) {
    const bool live = q < count;
    if (live && (n[q] < 0 || src[q] == nullptr || dst[q] == nullptr ||
                 (msg != nullptr && (msg[q] < 0 || msg[q] >= n_msgs))))
      return false;
    s[q] = Seg{live ? static_cast<const float*>(src[q]) : nullptr,
               live ? static_cast<float*>(dst[q]) : nullptr,
               live ? n[q] : 0, live && msg != nullptr ? msg[q] : 0, 0};
  }
  return true;
}

}  // namespace

// Plain C entry for ctypes: the signalled put.  For q < count, copies n[q]
// floats from src[q] into dst[q] (a slot of a neighbour's mailbox) once this
// rank's free counter free_[msg[q]] has reached free_target[msg[q]], then
// adds one per block to the receiver's data counter data[msg[q]].  One
// launch of ``blocks`` x ``count`` blocks of 256 threads on ``stream``;
// returns cudaGetLastError() of the launch.  It neither allocates nor
// synchronises.
extern "C" int wrf_tpu_torch_ipc_put(const void* const* src, void* const* dst,
                                     const long long* n, const int* msg,
                                     int count, void* const* data,
                                     const void* const* free_,
                                     const unsigned* free_target, int n_msgs,
                                     void* err, int blocks, void* stream) {
  if (count < 1 || count > kMaxSegs || n_msgs < 1 || n_msgs > kMaxMsgs ||
      blocks < 1 || err == nullptr)
    return cudaErrorInvalidValue;
  PutTable t;
  if (!fill_segs(t.s, src, dst, n, msg, count, n_msgs))
    return cudaErrorInvalidValue;
  for (int m = 0; m < kMaxMsgs; ++m) {
    const bool live = m < n_msgs;
    if (live && (data[m] == nullptr || free_[m] == nullptr))
      return cudaErrorInvalidValue;
    t.data[m] = live ? static_cast<unsigned*>(data[m]) : nullptr;
    t.free_[m] = live ? static_cast<const unsigned*>(free_[m]) : nullptr;
    t.free_target[m] = live ? free_target[m] : 0u;
  }
  t.err = static_cast<unsigned*>(err);
  mailbox_put<<<dim3(blocks, count), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry for ctypes: the wait.  Adds one to each of the n_release
// counters release[] (the previous exchange's slots are free), waits until
// every data[m] (m < n_msgs) has reached target[m], then, for q < count,
// copies n[q] floats from src[q] (a mailbox row) into dst[q] (a halo row);
// count 0 copies nothing.  One launch of ``blocks`` x max(count, 1) blocks
// of 256 threads on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int wrf_tpu_torch_ipc_wait(const void* const* src,
                                      void* const* dst, const long long* n,
                                      int count, const void* const* data,
                                      const unsigned* target, int n_msgs,
                                      void* const* release, int n_release,
                                      void* err, int blocks, void* stream) {
  if (count < 0 || count > kMaxSegs || n_msgs < 0 || n_msgs > kMaxMsgs ||
      n_release < 0 || n_release > kMaxMsgs || blocks < 1 || err == nullptr)
    return cudaErrorInvalidValue;
  WaitTable t;
  if (!fill_segs(t.s, src, dst, n, nullptr, count, 0))
    return cudaErrorInvalidValue;
  for (int m = 0; m < kMaxMsgs; ++m) {
    const bool live = m < n_msgs;
    if (live && data[m] == nullptr) return cudaErrorInvalidValue;
    t.data[m] = live ? static_cast<const unsigned*>(data[m]) : nullptr;
    t.target[m] = live ? target[m] : 0u;
    const bool rel = m < n_release;
    if (rel && release[m] == nullptr) return cudaErrorInvalidValue;
    t.release[m] = rel ? static_cast<unsigned*>(release[m]) : nullptr;
  }
  t.n_msgs = n_msgs;
  t.n_release = n_release;
  t.err = static_cast<unsigned*>(err);
  mailbox_wait<<<dim3(count > 0 ? blocks : 1, count > 0 ? count : 1), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
