// K7 — the tiling probe: one thread per column against shared-memory-staged
// (j, i) tiles, on NVIDIA Hopper (sm_90a).
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
// other bits; the doubling order is kept.  One pass per d runs over the
// column from k = K-1 down to k = d, so y[k-d] is still the previous
// pass's value when y[k] reads it; the levels below d take ``+ 0.0f`` as
// the TPU's ``where(k >= d, roll, 0)`` does (it turns -0 into +0).
//
// Rows written: 1 .. 1 + tj*((J-2)/tj), as the TPU grid's row bands.  Nothing
// outside the written region is touched.
//
// * ``probe_1d`` (kernel_1d): all I lanes of those rows, one thread per
//   (j, i) column.  The lane neighbours come straight from global memory
//   (L1), and wrap at the array edge: lane 0 takes lane I-1, lane I-1 takes
//   lane 0 (the TPU rolls over the full-lane block).
// * ``probe_2d`` (kernel_2d): lanes [halo, halo + ti*((I-2*halo)/ti)), one
//   block per (tj-row band, ti-lane tile).  Each (row, level) line of the
//   tile plus ONE lane of halo on each side is staged in shared memory (two
//   line buffers, one barrier per level); the stencil reads its neighbours
//   there.  The TPU's 128-lane window and alignment are not carried over:
//   the stencil reads lanes one away, so one lane of halo gives the same
//   values, and ti need not be a multiple of 128.  ``halo`` stays the input
//   layout's parameter, so the same arrays give the same written region.
//
// The column's K values live in shared memory (K is a run-time value: 50,
// 16, 8, 7 ...), one column per thread, so the scan itself needs no
// barrier.  Bound: memory (about 10-16 float32 operations per cell against
// 8 bytes moved).  The plain PyTorch versions are
// wrf_tpu_torch/tools/probe_2d.py::run_1d_plain / run_2d_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads1d = 128;
constexpr int kMaxThreads2d = 256;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float stencil(float x, float xl, float xr) {
  return ((x + xl) + xl * 0.5f) + xr;
}

// In-place doubling prefix sum over the K values s[0], s[stride], ...
__device__ __forceinline__ void doubling_scan(float* s, int K, int stride) {
  for (int d = 1; d < K; d *= 2) {
    for (int k = K - 1; k >= d; --k) s[k * stride] += s[(k - d) * stride];
    for (int k = 0; k < d; ++k) s[k * stride] += 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads1d)
probe_1d_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
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
  for (int k = 0; k < K; ++k) {
    const float* xk = x + row + (size_t)k * I;
    col[k * B] = stencil(xk[i], xk[il], xk[ir]);
  }
  doubling_scan(col, K, B);
  for (int k = 0; k < K; ++k) out[row + (size_t)k * I + i] = col[k * B];
}

__global__ void __launch_bounds__(kMaxThreads2d)
probe_2d_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
                int I, int tj, int ti, int halo) {
  extern __shared__ float smem[];
  float* scan = smem;               // K x ti: one column per lane
  float* lines = smem + K * ti;     // 2 x (ti + 2): a line and its halo
  const int i0 = halo + blockIdx.x * ti;  // first lane written
  const int B = blockDim.x;
  for (int jj = 0; jj < tj; ++jj) {
    const size_t row = (size_t)(1 + blockIdx.y * tj + jj) * K * I;
    for (int k = 0; k < K; ++k) {
      float* ln = lines + (k & 1) * (ti + 2);
      const float* xk = x + row + (size_t)k * I + (i0 - 1);
      for (int t = threadIdx.x; t < ti + 2; t += B) ln[t] = xk[t];
      __syncthreads();
      for (int t = threadIdx.x; t < ti; t += B)
        scan[k * ti + t] = stencil(ln[t + 1], ln[t], ln[t + 2]);
    }
    for (int t = threadIdx.x; t < ti; t += B) {
      doubling_scan(scan + t, K, ti);
      for (int k = 0; k < K; ++k)
        out[row + (size_t)k * I + i0 + t] = scan[k * ti + t];
    }
    __syncthreads();  // the next row's first line reuses a line buffer
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Plain C entries for ctypes.  Each launches on ``stream`` and returns
// cudaGetLastError() of the launch (or of the shared-memory opt-in); it
// neither allocates nor synchronises.  ``out`` must not overlap ``x``.

// kernel_1d: rows 1 .. 1 + tj*((J-2)/tj), all lanes.
extern "C" int wrf_tpu_torch_probe_2d_1d(const float* x, float* out, int J,
                                         int K, int I, int tj, void* stream) {
  if (J < 2 || K < 1 || I < 1 || tj < 1) return cudaErrorInvalidValue;
  const int rows = tj * ((J - 2) / tj);
  if (rows == 0) return cudaSuccess;
  if (rows > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)K * kThreads1d;
  cudaError_t err = allow_smem(probe_1d_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((I + kThreads1d - 1) / kThreads1d, rows);
  probe_1d_kernel<<<grid, kThreads1d, smem,
                    static_cast<cudaStream_t>(stream)>>>(x, out, K, I);
  return static_cast<int>(cudaGetLastError());
}

// kernel_2d: the same rows, lanes [halo, halo + ti*((I-2*halo)/ti)).
extern "C" int wrf_tpu_torch_probe_2d_2d(const float* x, float* out, int J,
                                         int K, int I, int tj, int ti,
                                         int halo, void* stream) {
  if (J < 2 || K < 1 || tj < 1 || ti < 1 || halo < 1 || I < 2 * halo)
    return cudaErrorInvalidValue;
  const int bands = (J - 2) / tj;
  const int tiles = (I - 2 * halo) / ti;
  if (bands == 0 || tiles == 0) return cudaSuccess;
  if (bands > 65535) return cudaErrorInvalidValue;
  const int threads = ti < kMaxThreads2d ? ((ti + 31) / 32) * 32
                                         : kMaxThreads2d;
  const size_t smem = sizeof(float) * ((size_t)K * ti + 2 * (size_t)(ti + 2));
  cudaError_t err = allow_smem(probe_2d_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles, bands);
  probe_2d_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, K, I, tj, ti, halo);
  return static_cast<int>(cudaGetLastError());
}
