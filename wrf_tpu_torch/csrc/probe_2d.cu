// K7 — the tiling probe: one thread per column against (j, i) tiles staged
// asynchronously in shared memory, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels tools/probe_2d.py::kernel_1d (:54) and
// ::kernel_2d (:58).  Both compute the probe's representative per-column
// work (``_body``, :41) on a float32 (J, K, I) array, i contiguous:
//
//   st[k]  = ((x[k][i] + x[k][i-1]) + x[k][i-1] * 0.5) + x[k][i+1]
//   y      = st, then for d = 1, 2, 4, ... < K:  y[k] += y[k-d] (k >= d),
//            every k of a pass from the previous pass's values
//
// an inclusive prefix sum over k by DOUBLING.  A sequential cumsum gives
// other bits; the doubling order is kept: one pass per d, k = K-1 down to
// d, and ``+ 0.0f`` on the levels below d as the TPU's ``where(k >= d,
// roll, 0)`` does (it turns -0 into +0).
//
// Rows written: 1 .. 1 + tj*((J-2)/tj), as the TPU grid's row bands.  Nothing
// outside the written region is touched.
//
// What bounds both forms on this card is memory (about 10-16 float32
// operations per cell against 8 bytes moved), and what held them below half
// of that bound was how few loads each SM kept in flight: a column walked
// its levels one load at a time into shared memory (1-D), and a tile was
// staged one short line per barrier (2-D).  The design now:
//
// * ``probe_1d_regs<KT, V>`` (kernel_1d at K = KT: 50, 16, 8): a thread owns
//   V adjacent lanes of a row and holds their K values in registers.  The k
//   loop is unrolled, so the levels' loads go out ahead of their use (97 of
//   the 150 LDGs of the K = 50 instance before its first FADD in the SASS);
//   the lane neighbours come from the next threads of the warp by shuffle,
//   and only the warp's two edge lanes (and the array's wrap: lane 0 takes
//   lane I-1, lane I-1 takes lane 0) load them from global memory (L1).  The
//   scan runs on registers and the K results are stored after it.  V = 4
//   lanes at K = 8 (one float4 a level where the pitch allows), V = 1 at 16
//   and 50: two lanes spilled at K = 50 under four blocks an SM, and were
//   slower than one at K = 16; each depth also has V = 1 for pitches that
//   four lanes do not divide.
// * ``probe_1d_smem`` (kernel_1d at any other K): the column in shared
//   memory, one column per thread, its loads four levels at a time.
// * ``probe_2d_staged<KT>`` (kernel_2d; KT = 0: K at run time): one block per
//   (tj-row band, ti-lane tile).  Each row's (K, ti + 2) slab (the tile and
//   ONE lane of halo each side) is copied into shared memory asynchronously,
//   two slabs in flight: row jj+1 lands while row jj computes.  Where the row
//   pitch I*4 and x are 16-byte aligned, warp 0 starts one bulk copy (the
//   TMA unit: ``cp.async.bulk``) per level over a 16-byte-aligned span that
//   covers the halo lanes; elsewhere every thread starts 4-byte ``cp.async``
//   copies.  Both complete on an mbarrier per slab, so a row costs one wait
//   and one block barrier (before its slab is refilled), not one barrier per
//   level.  The stencil reads its neighbours from the slab, the scan runs on
//   registers (KT > 0) or on a shared column per thread (KT = 0).  The
//   TPU's 128-lane window and alignment are not carried over: the stencil
//   reads lanes one away, so one lane of halo gives the same values, and ti
//   need not be a multiple of 128.  ``halo`` stays the input layout's
//   parameter, so the same arrays give the same written region.
//
// The launch geometry (instance, lanes a thread, threads, stages, shared
// bytes, staging path) is chosen in Python (wrf_tpu_torch/tools/probe_2d.py,
// ``plan_1d`` / ``plan_2d``); the entries below refuse a plan that does not
// match their kernels.  The plain PyTorch versions are
// wrf_tpu_torch/tools/probe_2d.py::run_1d_plain / run_2d_plain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads1d = 128;
constexpr int kMinBlocks1d = 4;    // at most 128 registers a thread
constexpr int kMaxThreads2d = 256;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;
constexpr int kBarrierBytes = 16;  // two mbarriers ahead of the slabs
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float stencil(float x, float xl, float xr) {
  return ((x + xl) + xl * 0.5f) + xr;
}

// In-place doubling prefix sum over the K values s[0], s[stride], ...
// (loops kept rolled: unrolled, they made ptxas spill in the 2-D form)
__device__ __forceinline__ void doubling_scan(float* s, int K, int stride) {
  for (int d = 1; d < K; d *= 2) {
#pragma unroll 1
    for (int k = K - 1; k >= d; --k) s[k * stride] += s[(k - d) * stride];
#pragma unroll 1
    for (int k = 0; k < d; ++k) s[k * stride] += 0.0f;
  }
}

// The same scan on registers, y[k][m] for V columns m; every index is a
// compile-time constant, so nothing goes to local memory.
template <int D, int KT, int V>
__device__ __forceinline__ void doubling_regs(float (&y)[KT][V]) {
  if constexpr (D < KT) {
#pragma unroll
    for (int k = KT - 1; k >= D; --k) {
#pragma unroll
      for (int m = 0; m < V; ++m) y[k][m] += y[k - D][m];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int m = 0; m < V; ++m) y[k][m] += 0.0f;
    }
    doubling_regs<2 * D>(y);
  }
}

// V = 1 or 4 lanes, the 4 as one 16-byte access
template <int V>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// kernel_1d at K = KT: V lanes a thread, the column in registers.  Every
// thread of a warp runs the shuffles; a thread past the row's end loads
// the row's last V lanes and stores nothing.
template <int KT, int V>
__global__ void __launch_bounds__(kThreads1d, kMinBlocks1d)
probe_1d_regs(const float* __restrict__ x, float* __restrict__ out, int I) {
  const int lane = threadIdx.x & 31;
  const int i = (blockIdx.x * kThreads1d + threadIdx.x) * V;
  const bool active = i < I;
  const int ic = active ? i : I - V;
  const int il = ic == 0 ? I - 1 : ic - 1;     // the wrap at the array edge
  const int ir = ic + V >= I ? 0 : ic + V;
  const bool edge_l = lane == 0;               // neighbours not in the warp
  const bool edge_r = lane == 31 || ic + V >= I;
  const size_t row = (size_t)(1 + blockIdx.y) * KT * I;
  float y[KT][V];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const float* xk = x + row + (size_t)k * I;
    float v[V];
    load_lanes<V>(xk + ic, v);
    float el = 0.0f, er = 0.0f;
    if (edge_l) el = xk[il];
    if (edge_r) er = xk[ir];
    float left = __shfl_up_sync(kFull, v[V - 1], 1);
    float right = __shfl_down_sync(kFull, v[0], 1);
    if (edge_l) left = el;
    if (edge_r) right = er;
#pragma unroll
    for (int m = 0; m < V; ++m)
      y[k][m] = stencil(v[m], m == 0 ? left : v[m - 1],
                        m == V - 1 ? right : v[m + 1]);
  }
  doubling_regs<1>(y);
  if (!active) return;
#pragma unroll
  for (int k = 0; k < KT; ++k)
    store_lanes<V>(out + row + (size_t)k * I + i, y[k]);
}

// kernel_1d at a run-time K: one column per thread in shared memory.
__global__ void __launch_bounds__(kThreads1d)
probe_1d_smem(const float* __restrict__ x, float* __restrict__ out, int K,
              int I) {
  extern __shared__ float cols[];  // K x blockDim.x
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;              // no barrier below
  const int j = 1 + blockIdx.y;
  const int il = (i == 0) ? I - 1 : i - 1;
  const int ir = (i == I - 1) ? 0 : i + 1;
  const int B = blockDim.x;
  float* col = cols + threadIdx.x;
  const size_t row = (size_t)j * K * I;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* xk = x + row + (size_t)k * I;
    col[k * B] = stencil(xk[i], xk[il], xk[ir]);
  }
  doubling_scan(col, K, B);
  for (int k = 0; k < K; ++k) out[row + (size_t)k * I + i] = col[k * B];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity ``parity`` to complete; a copy that never
// lands traps (a launch error) rather than spinning for ever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// One bulk copy (the TMA unit) of ``bytes`` (a multiple of 16, both ends
// 16-byte aligned), completing on ``bar``'s transaction count.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// ``bar`` counts this thread's arrival once its earlier cp.async copies
// have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Starts one row's copies into ``slab`` (every thread of the block calls
// this): K lines of ``n`` floats from ``src`` (the row's level 0 at lane
// a0), line k at slab + k*W, completing on ``bar``.
__device__ __forceinline__ void stage_row(const float* src, float* slab,
                                          uint64_t* bar, int K, int I, int W,
                                          int n, int bulk) {
  if (bulk) {
    if (threadIdx.x < 32) {
      // the slab was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (threadIdx.x == 0) mbar_expect_tx(bar, (unsigned)(K * n * 4));
      __syncwarp();
      for (int k = threadIdx.x; k < K; k += 32)
        bulk_copy(slab + k * W, src + (size_t)k * I, (unsigned)(n * 4), bar);
    }
  } else {
    for (int q = threadIdx.x; q < K * n; q += blockDim.x) {
      const int k = q / n;
      const int c = q - k * n;
      cp_async4(slab + k * W + c, src + (size_t)k * I + c);
    }
    cp_async_arrive(bar);
  }
}

// kernel_2d: one block per (tj-row band, ti-lane tile), the rows' slabs
// staged asynchronously, ``stages`` (1 or 2) in flight.  Slab s holds row
// jj (jj % stages == s) as K lines of W floats; line k's float c is lane
// a0 + c, where a0 is i0 - 1 rounded down to 16 bytes on the bulk path.
template <int KT>
__global__ void __launch_bounds__(kMaxThreads2d)
probe_2d_staged(const float* __restrict__ x, float* __restrict__ out, int Kr,
                int I, int tj, int ti, int halo, int W, int stages,
                int bulk) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(staged_smem);
  float* slabs = reinterpret_cast<float*>(staged_smem + kBarrierBytes);
  const int K = KT ? KT : Kr;
  float* cols = slabs + (size_t)stages * K * W;  // KT = 0: K x blockDim.x
  const int i0 = halo + blockIdx.x * ti;         // first lane written
  const int a0 = bulk ? ((i0 - 1) & ~3) : i0 - 1;
  const int off = (i0 - 1) - a0;
  const int n = bulk ? ((off + ti + 2 + 3) & ~3) : ti + 2;  // floats a line
  const int j0 = 1 + blockIdx.y * tj;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar + s, bulk ? 1 : blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int jj = 0; jj < tj && jj < stages; ++jj)
    stage_row(x + (size_t)(j0 + jj) * K * I + a0, slabs + (size_t)jj * K * W,
              bar + jj, K, I, W, n, bulk);
  for (int jj = 0; jj < tj; ++jj) {
    const int s = jj % stages;
    mbar_wait(bar + s, (unsigned)((jj / stages) & 1));
    const float* sl = slabs + (size_t)s * K * W + off;  // sl[c]: lane i0-1+c
    const size_t row = (size_t)(j0 + jj) * K * I + i0;
    for (int t = threadIdx.x; t < ti; t += blockDim.x) {
      if constexpr (KT > 0) {
        float y[KT][1];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const float* l = sl + k * W + t;
          y[k][0] = stencil(l[1], l[0], l[2]);
        }
        doubling_regs<1>(y);
#pragma unroll
        for (int k = 0; k < KT; ++k) out[row + (size_t)k * I + t] = y[k][0];
      } else {
        const int B = blockDim.x;
        float* col = cols + threadIdx.x;
#pragma unroll 1
        for (int k = 0; k < K; ++k) {
          const float* l = sl + k * W + t;
          col[k * B] = stencil(l[1], l[0], l[2]);
        }
        doubling_scan(col, K, B);
#pragma unroll 1
        for (int k = 0; k < K; ++k) out[row + (size_t)k * I + t] = col[k * B];
      }
    }
    __syncthreads();  // every thread is done with slab s
    if (jj + stages < tj)
      stage_row(x + (size_t)(j0 + jj + stages) * K * I + a0,
                slabs + (size_t)s * K * W, bar + s, K, I, W, n, bulk);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int KT, int V>
cudaError_t launch_1d(const float* x, float* out, int I, int rows,
                      cudaStream_t s) {
  dim3 grid((I / V + kThreads1d - 1) / kThreads1d, rows);
  probe_1d_regs<KT, V><<<grid, kThreads1d, 0, s>>>(x, out, I);
  return cudaGetLastError();
}

template <int KT>
cudaError_t launch_2d(const float* x, float* out, int K, int I, int tj,
                      int ti, int halo, int W, int stages, int bulk,
                      int threads, int smem, dim3 grid, cudaStream_t s) {
  cudaError_t err = allow_smem(probe_2d_staged<KT>, smem);
  if (err != cudaSuccess) return err;
  probe_2d_staged<KT><<<grid, threads, smem, s>>>(x, out, K, I, tj, ti, halo,
                                                  W, stages, bulk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes.  Each launches on ``stream`` and returns
// cudaGetLastError() of the launch (or of the shared-memory opt-in), or
// cudaErrorInvalidValue for a plan its kernels do not take; it neither
// allocates nor synchronises.  ``out`` must not overlap ``x``.

// kernel_1d: rows 1 .. 1 + tj*((J-2)/tj), all lanes.  ``kt`` is the
// compile-time depth (K itself) or 0 for the run-time instance, ``vec``
// the lanes a thread, ``smem`` the dynamic shared bytes.
extern "C" int wrf_tpu_torch_probe_2d_1d(const float* x, float* out, int J,
                                         int K, int I, int tj, int kt,
                                         int vec, int threads, int smem,
                                         void* stream) {
  if (J < 2 || K < 1 || I < 1 || tj < 1) return cudaErrorInvalidValue;
  if (threads != kThreads1d || (kt != 0 && kt != K) || vec < 1 ||
      I % vec != 0 || I < vec)
    return cudaErrorInvalidValue;
  if (smem != (kt ? 0 : (int)sizeof(float) * K * kThreads1d))
    return cudaErrorInvalidValue;
  const int rows = tj * ((J - 2) / tj);
  if (rows == 0) return cudaSuccess;
  if (rows > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kt * 8 + vec) {
    case 0 * 8 + 1: {
      err = allow_smem(probe_1d_smem, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      dim3 grid((I + kThreads1d - 1) / kThreads1d, rows);
      probe_1d_smem<<<grid, kThreads1d, smem, s>>>(x, out, K, I);
      err = cudaGetLastError();
      break;
    }
    case 50 * 8 + 1: err = launch_1d<50, 1>(x, out, I, rows, s); break;
    case 16 * 8 + 1: err = launch_1d<16, 1>(x, out, I, rows, s); break;
    case 8 * 8 + 1: err = launch_1d<8, 1>(x, out, I, rows, s); break;
    case 8 * 8 + 4: err = launch_1d<8, 4>(x, out, I, rows, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// kernel_2d: the same rows, lanes [halo, halo + ti*((I-2*halo)/ti)).  ``kt``
// as above; ``bulk`` 1 for the bulk-copy path (x and the pitch I*4 16-byte
// aligned), 0 for 4-byte cp.async; ``stages`` slabs of K x W floats, W =
// (ti + 8) rounded down to 4; ``smem`` must equal what those take.
extern "C" int wrf_tpu_torch_probe_2d_2d(const float* x, float* out, int J,
                                         int K, int I, int tj, int ti,
                                         int halo, int kt, int bulk,
                                         int threads, int stages, int smem,
                                         void* stream) {
  if (J < 2 || K < 1 || tj < 1 || ti < 1 || halo < 1 || I < 2 * halo)
    return cudaErrorInvalidValue;
  const int W = (ti + 8) & ~3;
  const long want = kBarrierBytes +
                    (long)sizeof(float) * ((long)stages * K * W +
                                           (kt ? 0 : (long)K * threads));
  if ((kt != 0 && kt != K) || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads2d || stages < 1 || stages > 2 || smem != want ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  if (bulk && (I % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return cudaErrorInvalidValue;
  const int bands = (J - 2) / tj;
  const int tiles = (I - 2 * halo) / ti;
  if (bands == 0 || tiles == 0) return cudaSuccess;
  if (bands > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tiles, bands);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kt) {
    case 0:
      err = launch_2d<0>(x, out, K, I, tj, ti, halo, W, stages, bulk, threads,
                         smem, grid, s);
      break;
    case 50:
      err = launch_2d<50>(x, out, K, I, tj, ti, halo, W, stages, bulk,
                          threads, smem, grid, s);
      break;
    case 16:
      err = launch_2d<16>(x, out, K, I, tj, ti, halo, W, stages, bulk,
                          threads, smem, grid, s);
      break;
    case 8:
      err = launch_2d<8>(x, out, K, I, tj, ti, halo, W, stages, bulk,
                         threads, smem, grid, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
