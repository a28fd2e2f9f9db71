// K8 — the feature ladder from K7's stencil to K3's tile shape, on NVIDIA
// Hopper (sm_90a).
//
// Replaces the nine TPU rungs of tools/probe_2d_bisect.py (rung_a :45,
// rung_b :59, rung_c :73, rung_d :90, rung_e :112, rung_f :144, rung_h :178,
// rung_i :211, rung_j :239), which bisected a Mosaic compile fault feature by
// feature.  Here each rung is its own launch, so a timed ladder gives the
// cost of each feature on this card.  Every rung computes the TPU rung's
// ``_compute`` (:40) on a float32 (J, K, I) array, i contiguous:
//
//   y[k]   = x[k][i] + x[k][i-1] * 0.5
//   c[k]   = y[k] + y[(k-1) mod K] * 0.25      (k = 0 takes y[K-1])
//
// over rows 1 .. 1 + tj*((J-2)/tj) (the TPU grid's row bands), and leaves
// everything outside its region untouched.  What the rungs add:
//
//   a  all lanes, the lane roll wraps at the array edge; a flat 1-D grid,
//      one thread per (j, i) column
//   b  the same values on a 2-D grid (row bands, 1): one block per tj-row
//      band of full-lane rows, its threads striding over the band
//   c  a 2-D grid (row bands, lane tiles) of exact ti-lane windows at
//      RING + gi*ti; the roll wraps INSIDE each window (a window's first
//      lane takes its last); written lanes [RING, RING + ti*((I-2*RING)/ti))
//   d  c's tiles, the wide input window: the centre lanes read their
//      neighbours one lane out, so no wrap reaches them and d equals a there
//   e  d, times a scalar operand s (a 1-element tensor, SMEM on the TPU),
//      plus a second centre-window operand x_c: out0 = c*s + x_c, and a
//      second output out1 = 2*x_c
//   f  d * thin + vec: thin a (J, 1, I) operand read at the lane, vec a
//      (1, K) operand read at the level
//   h  d, then a SEQUENTIAL prefix sum over k (scan[k] = scan[k-1] +
//      scan[k]) in a K x ti shared-memory scratch, k a run-time loop
//   i  d, plus t = t + 1 written IN PLACE into the aliased operand t over the
//      centre window (the wrapper passes a clone of x: other blocks still
//      read their windows of x)
//   j  h with the k loops unrolled at compile time (K a template parameter:
//      16 and 50, the probes' depths); the same operations in the same order
//
// Every product is by 0.5, 0.25, 1.0 or 2.0, so contraction could not change
// a bit; the library builds with -fmad=false all the same.  Each thread owns
// whole columns (the lane neighbours come from global memory through L1, and
// h's and j's scratch column is the thread's own), so no rung needs a
// barrier.  Bound: memory (a few float32 operations per cell).  The plain
// PyTorch versions are wrf_tpu_torch/tools/probe_2d_bisect.py::rung_*_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kRing = 128;
constexpr int kThreadsFlat = 256;
constexpr int kMaxThreadsTile = 256;
constexpr int kDefaultSmem = 48 * 1024;

struct Args {
  const float* x;
  float* out;
  float* out1;        // e: 2 * x_c
  const float* s;     // e: the 1-element scalar operand
  const float* xc;    // e: the centre-window operand
  const float* thin;  // f: (J, 1, I)
  const float* vec;   // f: (1, K)
  float* t;           // i: the aliased operand, updated in place
  int K, I, tj, ti;
};

// c[k] of one column, k = 0 .. K-1, handed to ``emit(k, c)``.  ``base``
// points at the column's level 0, ``dl`` is the lane offset of its left
// neighbour and ``KT`` a compile-time K (0: ``K`` at run time).
template <int KT, typename Emit>
__device__ __forceinline__ void column(const float* base, int dl, int K, int I,
                                       Emit emit) {
  const int nk = KT ? KT : K;
  const float* last = base + (size_t)(nk - 1) * I;
  float y_prev = last[0] + last[dl] * 0.5f;
  auto level = [&](int k) {
    const float* xk = base + (size_t)k * I;
    const float y = xk[0] + xk[dl] * 0.5f;
    emit(k, y + y_prev * 0.25f);
    y_prev = y;
  };
  if constexpr (KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; ++k) level(k);
  } else {
    for (int k = 0; k < K; ++k) level(k);
  }
}

// rung a: one thread per (j, i) column of the written rows, a flat grid
__global__ void __launch_bounds__(kThreadsFlat)
rung_a_kernel(Args a, int rows) {
  const size_t n = (size_t)rows * a.I;
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int j = 1 + (int)(q / a.I);
  const int i = (int)(q % a.I);
  const size_t at = (size_t)j * a.K * a.I + i;
  column<0>(a.x + at, i == 0 ? a.I - 1 : -1, a.K, a.I,
            [&](int k, float c) { a.out[at + (size_t)k * a.I] = c; });
}

// rung b: one block per tj-row band (gridDim.y == 1), threads striding over
// the band's tj x I columns
__global__ void __launch_bounds__(kThreadsFlat)
rung_b_kernel(Args a) {
  const int n = a.tj * a.I;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int j = 1 + blockIdx.x * a.tj + q / a.I;
    const int i = q % a.I;
    const size_t at = (size_t)j * a.K * a.I + i;
    column<0>(a.x + at, i == 0 ? a.I - 1 : -1, a.K, a.I,
              [&](int k, float c) { a.out[at + (size_t)k * a.I] = c; });
  }
}

// rungs c .. j: one block per (tj-row band, ti-lane tile), one thread per
// lane of the tile (striding when ti exceeds the block), looping the rows
enum Rung { kC, kD, kE, kF, kH, kI, kJ };

template <int R, int KT>
__global__ void __launch_bounds__(kMaxThreadsTile)
rung_tile_kernel(Args a) {
  extern __shared__ float scratch[];  // h, j: K x ti, a column per lane
  const int K = KT ? KT : a.K;
  const int I = a.I;
  const int ti = a.ti;
  const int i0 = kRing + blockIdx.y * ti;  // the tile's first lane
  for (int jj = 0; jj < a.tj; ++jj) {
    const int j = 1 + blockIdx.x * a.tj + jj;
    for (int t = threadIdx.x; t < ti; t += blockDim.x) {
      const int i = i0 + t;
      const size_t at = (size_t)j * K * I + i;
      // c: the roll wraps inside the window; d ..: the lane one out
      const int dl = (R == kC && t == 0) ? ti - 1 : -1;
      float* col = scratch + t;
      column<KT>(a.x + at, dl, K, I, [&](int k, float c) {
        const size_t o = at + (size_t)k * I;
        if constexpr (R == kC || R == kD) {
          a.out[o] = c;
        } else if constexpr (R == kE) {
          const float xc = a.xc[o];
          a.out[o] = c * a.s[0] + xc;
          a.out1[o] = xc * 2.0f;
        } else if constexpr (R == kF) {
          a.out[o] = c * a.thin[(size_t)j * I + i] + a.vec[k];
        } else if constexpr (R == kH || R == kJ) {
          col[k * ti] = c;
        } else {  // kI
          a.out[o] = c;
          a.t[o] = a.t[o] + 1.0f;
        }
      });
      if constexpr (R == kH) {
        for (int k = 1; k < K; ++k)
          col[k * ti] = col[(k - 1) * ti] + col[k * ti];
        for (int k = 0; k < K; ++k) a.out[at + (size_t)k * I] = col[k * ti];
      } else if constexpr (R == kJ) {
#pragma unroll
        for (int k = 1; k < KT; ++k)
          col[k * ti] = col[(k - 1) * ti] + col[k * ti];
#pragma unroll
        for (int k = 0; k < KT; ++k) a.out[at + (size_t)k * I] = col[k * ti];
      }
    }
  }
}

template <int R, int KT>
cudaError_t launch_tile(const Args& a, int bands, int tiles, cudaStream_t s) {
  const int threads = a.ti < kMaxThreadsTile ? ((a.ti + 31) / 32) * 32
                                             : kMaxThreadsTile;
  const size_t smem = (R == kH || R == kJ)
                          ? sizeof(float) * (size_t)a.K * a.ti : 0;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        rung_tile_kernel<R, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rung_tile_kernel<R, KT><<<dim3(bands, tiles), threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: launches rung ``rung`` (one of "abcdefhij") on
// ``stream`` and returns cudaGetLastError() of the launch; it neither
// allocates nor synchronises.  ``x`` is (J, K, I) float32; ``out`` (and
// ``out1`` for e) must not overlap it; e reads ``s`` and ``xc``, f ``thin``
// and ``vec``, i updates ``t`` in place (not ``x``); the pointers a rung does
// not use may be null.  Rung j runs at K = 16 or 50 only.
extern "C" int wrf_tpu_torch_probe_2d_bisect(
    int rung, const float* x, float* out, float* out1, const float* s,
    const float* xc, const float* thin, const float* vec, float* t, int J,
    int K, int I, int tj, int ti, void* stream) {
  if (J < 2 || K < 1 || I < 1 || tj < 1) return cudaErrorInvalidValue;
  Args a{x, out, out1, s, xc, thin, vec, t, K, I, tj, 0};
  const int bands = (J - 2) / tj;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bands == 0) return cudaSuccess;
  if (rung == 'a') {
    const size_t n = (size_t)bands * tj * I;
    const size_t blocks = (n + kThreadsFlat - 1) / kThreadsFlat;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    rung_a_kernel<<<(unsigned)blocks, kThreadsFlat, 0, st>>>(a, bands * tj);
    return static_cast<int>(cudaGetLastError());
  }
  if (rung == 'b') {
    rung_b_kernel<<<dim3(bands, 1), kThreadsFlat, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (ti < 1 || I < 2 * kRing) return cudaErrorInvalidValue;
  a.ti = ti;
  const int tiles = (I - 2 * kRing) / ti;
  if (tiles == 0) return cudaSuccess;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (rung) {
    case 'c': err = launch_tile<kC, 0>(a, bands, tiles, st); break;
    case 'd': err = launch_tile<kD, 0>(a, bands, tiles, st); break;
    case 'e': err = launch_tile<kE, 0>(a, bands, tiles, st); break;
    case 'f': err = launch_tile<kF, 0>(a, bands, tiles, st); break;
    case 'h': err = launch_tile<kH, 0>(a, bands, tiles, st); break;
    case 'i': err = launch_tile<kI, 0>(a, bands, tiles, st); break;
    case 'j':
      if (K == 16) {
        err = launch_tile<kJ, 16>(a, bands, tiles, st);
      } else if (K == 50) {
        err = launch_tile<kJ, 50>(a, bands, tiles, st);
      } else {
        err = cudaErrorInvalidValue;
      }
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
