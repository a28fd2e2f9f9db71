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
//      band of full-lane rows, its 1024 threads striding over the band
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
//      scan[k]) in a shared-memory scratch column, k a run-time loop
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
// barrier.
//
// Bound: memory (a few float32 operations per cell).  One H100 skeleton sits
// under every rung, so that the ladder prices the features and not a stall:
// * the pointers are ``__restrict__`` kernel parameters, and a column's
//   loads run ``kAhead`` levels (rung b: ``kAheadBand``) ahead of its
//   stores in a register ring, so a store never holds the next level's
//   loads behind it (rung j's unrolled loop gets the same from the compiler:
//   its stores go to shared memory);
// * rungs c .. j cover a (tj, ti) tile with a block of (ti, tj) threads
//   (fewer rows when tj * ti exceeds kMaxThreadsTile; a thread then takes
//   several rows), so a tile's rows run side by side rather than in turn;
// * rung b keeps one block per band (its feature) with 1024 threads, several
//   columns a thread; with 64 bands it holds at most 64 of the 132 SMs.
// The launch geometry is chosen in Python (wrf_tpu_torch/tools/
// probe_2d_bisect.py::plan); the entry refuses a plan its kernels do not
// take.  The plain PyTorch versions are probe_2d_bisect.py::rung_*_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kRing = 128;
constexpr int kThreadsFlat = 256;      // rung a
constexpr int kThreadsBand = 1024;     // rung b
constexpr int kMaxThreadsTile = 512;   // rungs c .. j
constexpr int kAhead = 8;
constexpr int kAheadBand = 8;
constexpr int kDefaultSmem = 48 * 1024;

// One level's loads: the centre lane, its left neighbour and the rung's
// extra operand (e: x_c, f: vec, i: t; 0 elsewhere).
struct Level {
  float c, l, e;
};

// c[k] of one column, k = 0 .. K-1, handed to ``emit(k, c, level)``;
// ``load(k)`` gives level k's loads.  ``KT`` a compile-time K (0: ``K`` at
// run time, the loads ``A`` levels ahead in a ring of registers).
template <int KT, int A, typename Load, typename Emit>
__device__ __forceinline__ void column(int K, Load load, Emit emit) {
  const int nk = KT ? KT : K;
  const Level last = load(nk - 1);
  float y_prev = last.c + last.l * 0.5f;
  if constexpr (KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const Level v = load(k);
      const float y = v.c + v.l * 0.5f;
      emit(k, y + y_prev * 0.25f, v);
      y_prev = y;
    }
  } else {
    Level ring[A];
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < K) ring[a] = load(a);
    for (int k = 0; k < K; ++k) {
      const Level v = ring[0];
#pragma unroll
      for (int a = 0; a + 1 < A; ++a) ring[a] = ring[a + 1];
      if (k + A < K) ring[A - 1] = load(k + A);
      const float y = v.c + v.l * 0.5f;
      emit(k, y + y_prev * 0.25f, v);
      y_prev = y;
    }
  }
}

// rung a: one thread per (j, i) column of the written rows, a flat grid
__global__ void __launch_bounds__(kThreadsFlat)
rung_a_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
              int I, int rows) {
  const size_t n = (size_t)rows * I;
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int i = (int)(q % I);
  const size_t at = (size_t)(1 + q / I) * K * I + i;
  const int dl = i == 0 ? I - 1 : -1;
  column<0, kAhead>(
      K,
      [&](int k) {
        const float* xk = x + at + (size_t)k * I;
        return Level{xk[0], xk[dl], 0.0f};
      },
      [&](int k, float c, const Level&) { out[at + (size_t)k * I] = c; });
}

// rung b: one block per tj-row band (gridDim.y == 1), threads striding over
// the band's tj x I columns
__global__ void __launch_bounds__(kThreadsBand)
rung_b_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
              int I, int tj) {
  const int n = tj * I;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int i = q % I;
    const size_t at = (size_t)(1 + blockIdx.x * tj + q / I) * K * I + i;
    const int dl = i == 0 ? I - 1 : -1;
    column<0, kAheadBand>(
        K,
        [&](int k) {
          const float* xk = x + at + (size_t)k * I;
          return Level{xk[0], xk[dl], 0.0f};
        },
        [&](int k, float c, const Level&) { out[at + (size_t)k * I] = c; });
  }
}

// rungs c .. j (R the rung's letter): one block per (tj-row band, ti-lane
// tile) of (blockDim.x, blockDim.y) threads, lanes and rows striding
// (two blocks an SM, at most 64 registers a thread; rung j's 50 unrolled
// levels take one block's worth)
template <int R, int KT>
__global__ void __launch_bounds__(kMaxThreadsTile, KT > 16 ? 1 : 2)
rung_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ out1, const float* __restrict__ s,
                 const float* __restrict__ xc, const float* __restrict__ thin,
                 const float* __restrict__ vec, float* __restrict__ t, int Kr,
                 int I, int tj, int ti) {
  // h, j: K x (blockDim.y * ti), a column per (row slot, lane)
  extern __shared__ float scratch[];
  const int K = KT ? KT : Kr;
  const int stride = blockDim.y * ti;
  const int i0 = kRing + blockIdx.y * ti;  // the tile's first lane
  float sv = 0.0f;
  if constexpr (R == 'e') sv = s[0];
  for (int jj = threadIdx.y; jj < tj; jj += blockDim.y) {
    const int j = 1 + blockIdx.x * tj + jj;
    for (int tl = threadIdx.x; tl < ti; tl += blockDim.x) {
      const int i = i0 + tl;
      const size_t at = (size_t)j * K * I + i;
      // c: the roll wraps inside the window; d ..: the lane one out
      const int dl = (R == 'c' && tl == 0) ? ti - 1 : -1;
      float* col = scratch + threadIdx.y * ti + tl;
      float th = 0.0f;
      if constexpr (R == 'f') th = thin[(size_t)j * I + i];
      column<KT, kAhead>(
          K,
          [&](int k) {
            const size_t o = at + (size_t)k * I;
            const float* xo = x + o;
            float e = 0.0f;
            if constexpr (R == 'e') {
              e = xc[o];
            } else if constexpr (R == 'f') {
              e = vec[k];
            } else if constexpr (R == 'i') {
              e = t[o];
            }
            return Level{xo[0], xo[dl], e};
          },
          [&](int k, float c, const Level& v) {
            const size_t o = at + (size_t)k * I;
            if constexpr (R == 'c' || R == 'd') {
              out[o] = c;
            } else if constexpr (R == 'e') {
              out[o] = c * sv + v.e;
              out1[o] = v.e * 2.0f;
            } else if constexpr (R == 'f') {
              out[o] = c * th + v.e;
            } else if constexpr (R == 'h' || R == 'j') {
              col[k * stride] = c;
            } else {  // 'i': t's own read (loaded ahead) and write
              out[o] = c;
              t[o] = v.e + 1.0f;
            }
          });
      if constexpr (R == 'h') {
        // scan[k] = scan[k-1] + scan[k] in the scratch, scan[k-1] carried
        // in a register and stored from there (as the compiler does in j's
        // unrolled loops)
        float run = col[0];
        out[at] = run;
        for (int k = 1; k < K; ++k) {
          run = run + col[k * stride];
          col[k * stride] = run;
          out[at + (size_t)k * I] = run;
        }
      } else if constexpr (R == 'j') {
#pragma unroll
        for (int k = 1; k < KT; ++k)
          col[k * stride] = col[(k - 1) * stride] + col[k * stride];
#pragma unroll
        for (int k = 0; k < KT; ++k) out[at + (size_t)k * I] = col[k * stride];
      }
    }
  }
}

struct Operands {
  const float* x;
  float* out;
  float* out1;
  const float* s;
  const float* xc;
  const float* thin;
  const float* vec;
  float* t;
};

// a tile rung's launch: its sizes, grid, block, shared bytes and stream
struct Shape {
  int K, I, tj, ti;
  dim3 grid, block;
  int smem;
  cudaStream_t stream;
};

template <int R, int KT>
cudaError_t launch_tile(const Operands& p, const Shape& sh) {
  if (sh.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        rung_tile_kernel<R, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sh.smem);
    if (err != cudaSuccess) return err;
  }
  rung_tile_kernel<R, KT><<<sh.grid, sh.block, sh.smem, sh.stream>>>(
      p.x, p.out, p.out1, p.s, p.xc, p.thin, p.vec, p.t, sh.K, sh.I, sh.tj,
      sh.ti);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes: launches rung ``rung`` (one of "abcdefhij") on
// ``stream`` and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a plan its kernels do not take; it neither
// allocates nor synchronises.  ``x`` is (J, K, I) float32; ``out`` (and
// ``out1`` for e) must not overlap it; e reads ``s`` and ``xc``, f ``thin``
// and ``vec``, i updates ``t`` in place (not ``x``); the pointers a rung does
// not use may be null.  (tx, ty) are the block's threads and ``smem`` its
// dynamic shared bytes (h, j: 4 * K * ty * ti).  Rung j runs at K = 16 or
// 50 only.
extern "C" int wrf_tpu_torch_probe_2d_bisect(
    int rung, const float* x, float* out, float* out1, const float* s,
    const float* xc, const float* thin, const float* vec, float* t, int J,
    int K, int I, int tj, int ti, int tx, int ty, int smem, void* stream) {
  if (J < 2 || K < 1 || I < 1 || tj < 1) return cudaErrorInvalidValue;
  const int bands = (J - 2) / tj;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rung == 'a') {
    if (tx != kThreadsFlat || ty != 1 || smem != 0)
      return cudaErrorInvalidValue;
    const size_t n = (size_t)bands * tj * I;
    if (n == 0) return cudaSuccess;
    const size_t blocks = (n + kThreadsFlat - 1) / kThreadsFlat;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    rung_a_kernel<<<(unsigned)blocks, kThreadsFlat, 0, st>>>(x, out, K, I,
                                                            bands * tj);
    return static_cast<int>(cudaGetLastError());
  }
  if (rung == 'b') {
    if (tx != kThreadsBand || ty != 1 || smem != 0)
      return cudaErrorInvalidValue;
    if (bands == 0) return cudaSuccess;
    rung_b_kernel<<<dim3(bands, 1), kThreadsBand, 0, st>>>(x, out, K, I, tj);
    return static_cast<int>(cudaGetLastError());
  }
  if (ti < 1 || I < 2 * kRing) return cudaErrorInvalidValue;
  const bool scratch = rung == 'h' || rung == 'j';
  if (tx < 32 || tx % 32 != 0 || ty < 1 || ty > tj ||
      tx * ty > kMaxThreadsTile ||
      smem != (scratch ? (int)sizeof(float) * K * ty * ti : 0))
    return cudaErrorInvalidValue;
  const int tiles = (I - 2 * kRing) / ti;
  if (bands == 0 || tiles == 0) return cudaSuccess;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const Operands p{x, out, out1, s, xc, thin, vec, t};
  const Shape sh{K, I, tj, ti, dim3(bands, tiles), dim3(tx, ty), smem, st};
  cudaError_t err;
  switch (rung) {
    case 'c': err = launch_tile<'c', 0>(p, sh); break;
    case 'd': err = launch_tile<'d', 0>(p, sh); break;
    case 'e': err = launch_tile<'e', 0>(p, sh); break;
    case 'f': err = launch_tile<'f', 0>(p, sh); break;
    case 'h': err = launch_tile<'h', 0>(p, sh); break;
    case 'i': err = launch_tile<'i', 0>(p, sh); break;
    case 'j':
      if (K == 16) {
        err = launch_tile<'j', 16>(p, sh);
      } else if (K == 50) {
        err = launch_tile<'j', 50>(p, sh);
      } else {
        err = cudaErrorInvalidValue;
      }
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
