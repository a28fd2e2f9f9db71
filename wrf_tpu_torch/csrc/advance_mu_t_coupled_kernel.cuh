// K3 — S coupled acoustic substeps per launch (the depth-S trapezoid) on
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrf_tpu/ops/advance_mu_t_msteps.py::
// _coupled_ms_kernel (wrapper coupled_multistep_pallas), and at S=2 its
// hand-unrolled pair _coupled2_kernel (wrapper coupled_two_step_pallas).
// Each substep is K1's fused scan substep (fuse_uv + lean + lite): the wind
// update from p = cs2*mu, dvdxi and the dmdt column sum, the mu update, the
// seeded ww scan and theta; under FUSE_W also the vertically-implicit w/pp
// substep on that substep's new theta (csrc/w_solve.cuh).  The plain
// PyTorch version is coupled_multistep_plain in
// wrf_tpu_torch/ops/advance_mu_t_coupled_cuda.py.
//
// Arrays are in the ring-S layout: rows [0, S) and [J-S, J) are ring rows,
// never computed; local row S is global ring row j_off + 1; i wraps
// modulo I (the window masks make wrapped values unused).
//
// Geometry: a block owns a tile of TJ x TI columns and runs all S
// substeps on it.  Substep s reads mu one cell around every cell it
// updates, and u/v one cell east/north, so the block also computes the
// winds and mu on a ring of S-1-s extra cells around its tile, in j AND
// in i (a GPU block holds no whole rows, unlike the TPU tile): a
// trapezoid in both axes.  Theta and ww run on the tile's own columns.
//
// The substeps couple only through 2-D fields.  The wind increment of
// substep q is 2-D, du_q = cu*(p_q - p_q(i-1)), dv_q = cv*(p_q -
// p_q(j-1)), masked, so u after s substeps is ((u0 + du_0) + du_1) + ...
// + du_s at every level, in the plain version's association.  The block
// keeps mu and the S increments of u and v as 2-D planes in shared memory
// over its tile plus S cells on each side, (TJ+2S)(TI+2S) floats each,
// (2S+1) planes; it rebuilds any wind from u0/v0 in device memory and the
// increments (held in registers per column).  No 3-D tile lives in
// shared memory.
//
// Per substep: phase A forms du_s and dv_s from mu_s on the current
// extent (a barrier); phase B runs, per column of the extent, pass 1
// over k (rebuild the winds, dvdxi, dmdt in k order, mu update in shared
// memory) and, for the tile's own columns, pass 2 over k (the ww scan
// from the seed and theta with one level of look-ahead, since vert(k)
// needs wdtn(k+1); dvdxi is recomputed from the same winds rather than
// kept; under FUSE_W the w solve's forward elimination rides this loop and
// a descending loop back-substitutes and updates pp, on own columns only).
// A barrier ends the substep.  Every thread reaches every
// barrier.  After S substeps the tile's u, v (all K levels) and mu go to
// fresh output buffers; the blocks of the first and last tile rows copy
// the ring rows through.
//
// Buffers: u, v and mu are read at other blocks' cells, so their results
// go to fresh buffers (the caller swaps pointers); t and ww_row are read
// only at the thread's own column, so they are updated in place; so are w
// and pp.  The w solve's K-long sweep state dpw of a column is kept in that
// column of u_out: the block writes its tile's u_out only in its last
// phase, after a barrier, and no other block touches it, so until then it
// is free scratch (one more field written and read per substep, 2 x
// J*K*I*4 bytes, mostly through L2; no allocation).
//
// Bound: memory traffic per substep, not bytes per launch.  Pass 1 reads
// u0, v0 and dvdxi_const over the extended columns, pass 2 re-reads them
// with t_1, tconst and t and writes t, every substep: a simple first
// kernel that leaves the re-reads to L1/L2.  Times on the card are in
// PERF.md.
//
// OVERLAP: the j leg of the width-S ring exchange inside the kernel.  The
// ring rows of mu, u and v in memory are stale; every read of a ring row of
// those three goes to the ring neighbours' blocks instead (a get through
// device pointers): rows [0, S) are the previous shard's last S interior
// rows (mu_lo, u_lo, v_lo), rows [J-S, J) the next shard's first S (mu_hi,
// u_hi, v_hi).  They are inputs of the block of substeps, complete once the
// previous block's launches are, so no thread waits on another and nothing
// is staged.  The ring rows of the outputs pass the stale memory rows
// through; the next launch does not read them either.
//
// CT, the element type of the constant streams t_1, tconst and dvdxi_const
// (float or __nv_bfloat16): widened to float on load (exact); u, v, t, mu
// and all arithmetic stay float.
//
// This header holds the kernel and its dispatch; the instances are compiled
// in four sources so that they build in parallel:
// csrc/advance_mu_t_coupled.cu (float streams, with the C entry),
// advance_mu_t_coupled_overlap.cu, advance_mu_t_coupled_bf16.cu and
// advance_mu_t_coupled_bf16_overlap.cu.
//
// Fast mode: the TPU kernel's log-depth cumsums (the ww scan and, under
// fuse_w, both Thomas sweeps) are a vector-unit device; a thread that owns
// a column runs them sequentially anyway, so this kernel has one mode (the
// exact one), and its fast mode is its exact mode.
//
// Numerics: built with -fmad=false and IEEE division; every expression
// and the k order of the dmdt column sum follow the plain version.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "const_stream.cuh"
#include "w_solve.cuh"

namespace k3 {

constexpr int kThreads = 256;
constexpr int kMaxInner = 8;

struct Args {
  // 3-D fields (J, K, I); the void pointers are the constant streams (CT)
  const float* u;
  const float* v;
  float* t;
  const void* t_1;
  const void* tconst;
  const void* dvdxi_const;
  // 2-D fields (J, I)
  const float* ww1_k0;
  float* ww_row;
  const float* mu;
  const float* mu_tend;
  const float* msftx;
  const float* msfty;
  const float* cu;
  const float* cv;
  const float* msft2;
  // vertical vectors (K)
  const float* dnw;
  const float* fnm;
  const float* fnp;
  const float* rdnw;
  // the w/pp solve (FUSE_W): state, updated in place, and K-vectors
  float* w;
  float* pp;
  const float* aw;
  const float* cpv;
  const float* denv;
  const float* crdn;
  const float* erdn;
  // fresh outputs
  float* u_out;
  float* v_out;
  float* mu_out;
  // OVERLAP: the ring neighbours' S interior rows nearest to this block,
  // (S, I) for mu and (S, K, I) for u and v
  const float* mu_lo;
  const float* mu_hi;
  const float* u_lo;
  const float* u_hi;
  const float* v_lo;
  const float* v_hi;
  float rdx, rdy, dts, cs2;
  float c_w, g_t, beta, alfa;  // FUSE_W scalars
  int J, K, I;
  int i0, i1, j0, j1;  // compute window, global coordinates
  int j_off, i_off;    // local row S is global row j_off + 1; column 0 is i_off
  int k0, k1;
  int tj, ti;          // the block's own tile
};

__device__ __forceinline__ int wrap(int c, int n) {
  c %= n;
  return c < 0 ? c + n : c;
}

// Row ``row`` of mu, u or v (``n`` elements a row): the block's own memory,
// or under OVERLAP, for a ring row, the neighbour's interior row it mirrors.
template <int S, bool OVERLAP>
__device__ __forceinline__ const float* ring_row(const float* mem,
                                                 const float* lo,
                                                 const float* hi, int row,
                                                 int J, size_t n) {
  if (OVERLAP) {
    if (row < S) return lo + (size_t)row * n;
    if (row >= J - S) return hi + (size_t)(row - (J - S)) * n;
  }
  return mem + (size_t)row * n;
}

// A wind after s+1 substeps from its start-of-launch value x0 and the
// increments d[0..s], in the plain version's order ((x0 + d0) + d1) + ...
template <int S>
__device__ __forceinline__ float rebuild(float x0, const float (&d)[S],
                                         int s) {
  float x = x0;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    if (q <= s) x = x + d[q];
  }
  return x;
}

// The block's tile and its shared-memory planes.  Plane cell (lj, li) is
// global row rj0 + lj and column ri0 + li (before wrapping).
struct Tile {
  int cj0, cj1, ci0, ci1;  // own rows [cj0, cj1), columns [ci0, ci1)
  int rj0, ri0;            // cj0 - S, ci0 - S
  int pw, plane;           // plane row pitch and size
};

// Pass 1 and pass 2 of one column at substep s (see the file comment).
template <int S, bool FUSE_W, bool OVERLAP, typename CT>
__device__ void column(const Args& a, const Tile& tl, float* s_mu,
                       const float* s_du, const float* s_dv, int s, int row,
                       int col) {
  const int I = a.I, K = a.K;
  const CT* const a_t_1 = static_cast<const CT*>(a.t_1);
  const CT* const a_tconst = static_cast<const CT*>(a.tconst);
  const CT* const a_dvdxi_const = static_cast<const CT*>(a.dvdxi_const);
  const int lj = row - tl.rj0, li = col - tl.ri0;
  const int pc = lj * tl.pw + li;
  const int cw = wrap(col, I);
  const int ce = (cw + 1 == I) ? 0 : cw + 1;
  const int c2 = row * I + cw;
  const int ig = cw + a.i_off, jg = row - S + a.j_off + 1;
  const bool in_win = ig >= a.i0 && ig <= a.i1 && jg >= a.j0 && jg <= a.j1;

  // this column's wind increments at u(i), u(i+1), v(j), v(j+1)
  float du_c[S], du_e[S], dv_c[S], dv_n[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const bool live = q <= s;
    du_c[q] = live ? s_du[q * tl.plane + pc] : 0.f;
    du_e[q] = live ? s_du[q * tl.plane + pc + 1] : 0.f;
    dv_c[q] = live ? s_dv[q * tl.plane + pc] : 0.f;
    dv_n[q] = live ? s_dv[q * tl.plane + pc + tl.pw] : 0.f;
  }

  const size_t row3 = (size_t)K * I;
  const size_t x_c = (size_t)row * row3 + cw;  // (row, k=0, col); +k*I
  const size_t x_e = (size_t)row * row3 + ce;
  const size_t x_n = x_c + row3;
  // OVERLAP: the rows of u and v this column reads (level 0, column 0);
  // the instances without it index the block's memory as they always did
  // (row pointers of their own cost them registers and address arithmetic)
  const float* const u_r = ring_row<S, OVERLAP>(a.u, a.u_lo, a.u_hi, row,
                                                a.J, row3);
  const float* const v_r = ring_row<S, OVERLAP>(a.v, a.v_lo, a.v_hi, row,
                                                a.J, row3);
  const float* const v_rn = ring_row<S, OVERLAP>(a.v, a.v_lo, a.v_hi,
                                                 row + 1, a.J, row3);
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float msft2 = a.msft2[c2];
  const int k0 = a.k0, k1 = a.k1;

  // ---- pass 1: dvdxi, dmdt in k order, mu ------------------------------
  float dmdt = 0.f;
  for (int k = k0; k <= k1; ++k) {
    const size_t o = (size_t)k * I;
    const float uc =
        rebuild<S>(OVERLAP ? u_r[cw + o] : a.u[x_c + o], du_c, s);
    const float ue =
        rebuild<S>(OVERLAP ? u_r[ce + o] : a.u[x_e + o], du_e, s);
    const float vc =
        rebuild<S>(OVERLAP ? v_r[cw + o] : a.v[x_c + o], dv_c, s);
    const float vn =
        rebuild<S>(OVERLAP ? v_rn[cw + o] : a.v[x_n + o], dv_n, s);
    const float dvdxi = ldf(a_dvdxi_const, x_c + o) +
                        msft2 * (rdy * (vn - vc) + rdx * (ue - uc));
    dmdt += a.dnw[k] * dvdxi;
  }
  const float mt = a.mu_tend[c2];
  const float mu_s = s_mu[pc];
  s_mu[pc] = in_win ? mu_s + dts * (dmdt + mt) : mu_s;

  const bool own = row >= tl.cj0 && row < tl.cj1 && col >= tl.ci0 &&
                   col < tl.ci1;
  if (!own || !in_win) return;  // outside the window: t and ww_row pass

  // ---- pass 2: ww scan and theta, k ascending ---------------------------
  const float msfty_c = a.msfty[c2];
  const float rmsfty = 1.0f / msfty_c;
  const float dts_msfty = dts * msfty_c;
  const float msftx_c = a.msftx[c2];
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const int cwm = (cw == 0) ? I - 1 : cw - 1;
  const size_t x_w = (size_t)row * row3 + cwm;
  const size_t x_s = x_c - row3;
  const float seed = a.ww_row[c2];
  a.ww_row[c2] = seed - a.ww1_k0[c2];  // the next substep's seed
  float scan = seed;                   // raw scan value at level k
  float wdtn = 0.f;                    // wdtn(k0): no flux through the surface
  float t1_k = ldf(a_t_1, x_c + (size_t)k0 * I);
  const wsolve::Coef wc{a.rdnw, a.aw,  a.cpv, a.denv, a.crdn,
                        a.erdn, a.c_w, a.g_t, a.beta, a.alfa};
  wsolve::Fwd wf;
  float* dpw = a.u_out + x_c;  // this column of u_out: free until the end
  for (int k = k0; k <= k1; ++k) {
    const size_t o = (size_t)k * I;
    const float uc =
        rebuild<S>(OVERLAP ? u_r[cw + o] : a.u[x_c + o], du_c, s);
    const float ue =
        rebuild<S>(OVERLAP ? u_r[ce + o] : a.u[x_e + o], du_e, s);
    const float vc =
        rebuild<S>(OVERLAP ? v_r[cw + o] : a.v[x_c + o], dv_c, s);
    const float vn =
        rebuild<S>(OVERLAP ? v_rn[cw + o] : a.v[x_n + o], dv_n, s);
    const float dvdxi = ldf(a_dvdxi_const, x_c + o) +
                        msft2 * (rdy * (vn - vc) + rdx * (ue - uc));
    float scan_up = 0.f, t1_up = 0.f, wdtn_up = 0.f;  // level k+1 (0 above k1)
    if (k < k1) {
      scan_up = scan + (-a.dnw[k] * ((dmdt + dvdxi) + mt)) * rmsfty;
      t1_up = ldf(a_t_1, x_c + o + I);
      wdtn_up = scan_up * (a.fnm[k + 1] * t1_up + a.fnp[k + 1] * t1_k);
    }
    const float vert = a.rdnw[k] * (wdtn_up - wdtn);
    const float t_half = a.t[x_c + o] + ldf(a_tconst, x_c + o);
    const float fy = vn * (ldf(a_t_1, x_n + o) + t1_k) -
                     vc * (t1_k + ldf(a_t_1, x_s + o));
    const float fx = ue * (ldf(a_t_1, x_e + o) + t1_k) -
                     uc * (t1_k + ldf(a_t_1, x_w + o));
    const float horiz = msftx_c * (hrdy * fy + hrdx * fx);
    const float t_new = t_half - dts_msfty * (horiz + vert);
    a.t[x_c + o] = t_new;
    if (FUSE_W) {
      wsolve::w_forward_level(wc, wf, a.w + x_c, a.pp + x_c, I, k, k0, k1,
                              t_new, dpw, I);
    }
    scan = scan_up;
    wdtn = wdtn_up;
    t1_k = t1_up;
  }
  if (FUSE_W) wsolve::w_backward(wc, a.w + x_c, a.pp + x_c, I, k0, k1, dpw, I);
}

template <int S, bool FUSE_W, bool OVERLAP, typename CT>
__global__ void __launch_bounds__(kThreads) coupled_kernel(const Args a) {
  extern __shared__ float smem[];
  const int I = a.I, K = a.K;
  Tile tl;
  tl.cj0 = S + blockIdx.y * a.tj;
  tl.cj1 = min(tl.cj0 + a.tj, a.J - S);
  tl.ci0 = blockIdx.x * a.ti;
  tl.ci1 = min(tl.ci0 + a.ti, I);
  tl.rj0 = tl.cj0 - S;
  tl.ri0 = tl.ci0 - S;
  tl.pw = a.ti + 2 * S;
  tl.plane = (a.tj + 2 * S) * tl.pw;
  float* s_mu = smem;                    // mu_s
  float* s_du = smem + tl.plane;         // du_q, q = 0..S-1
  float* s_dv = smem + (S + 1) * tl.plane;  // dv_q
  const int nj = tl.cj1 - tl.cj0, ni = tl.ci1 - tl.ci0;
  const float cs2 = a.cs2;

  // mu on the tile and S cells around it
  {
    const int h = nj + 2 * S, w = ni + 2 * S;
    for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
      const int lj = idx / w, li = idx % w;
      s_mu[lj * tl.pw + li] =
          OVERLAP ? ring_row<S, OVERLAP>(a.mu, a.mu_lo, a.mu_hi, tl.rj0 + lj,
                                         a.J, I)[wrap(tl.ri0 + li, I)]
                  : a.mu[(tl.rj0 + lj) * I + wrap(tl.ri0 + li, I)];
    }
  }
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int r = S - 1 - s;  // extra cells this substep updates

    // ---- phase A: du_s on rows +-r, columns [-r, +r+1]; dv_s on rows
    // [-r, +r+1], columns +-r (computed on the union: the extra corner
    // cells read valid mu and are never used) ------------------------------
    {
      const int h = nj + 2 * r + 1, w = ni + 2 * r + 1;
      float* du = s_du + s * tl.plane;
      float* dv = s_dv + s * tl.plane;
      for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
        const int row = tl.cj0 - r + idx / w, col = tl.ci0 - r + idx % w;
        const int pc = (row - tl.rj0) * tl.pw + (col - tl.ri0);
        const int cw = wrap(col, I);
        const int ig = cw + a.i_off, jg = row - S + a.j_off + 1;
        const bool i_in = ig >= a.i0 && ig <= a.i1;
        const bool j_in = jg >= a.j0 && jg <= a.j1;
        const float p_c = cs2 * s_mu[pc];
        float du_v = 0.f, dv_v = 0.f;
        if (ig >= a.i0 + 1 && ig <= a.i1 && j_in)
          du_v = a.cu[row * I + cw] * (p_c - cs2 * s_mu[pc - 1]);
        if (i_in && jg >= a.j0 + 1 && jg <= a.j1)
          dv_v = a.cv[row * I + cw] * (p_c - cs2 * s_mu[pc - tl.pw]);
        du[pc] = du_v;
        dv[pc] = dv_v;
      }
    }
    __syncthreads();

    // ---- phase B: every column of the extent, rows and columns +-r -------
    {
      const int h = nj + 2 * r, w = ni + 2 * r;
      for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
        column<S, FUSE_W, OVERLAP, CT>(a, tl, s_mu, s_du, s_dv, s,
                                       tl.cj0 - r + idx / w,
                                       tl.ci0 - r + idx % w);
      }
    }
    __syncthreads();
  }

  // ---- outputs: the tile's u, v (all levels) and mu ----------------------
  const size_t row3 = (size_t)K * I;
  for (int idx = threadIdx.x; idx < nj * ni; idx += blockDim.x) {
    const int row = tl.cj0 + idx / ni, col = tl.ci0 + idx % ni;
    const int pc = (row - tl.rj0) * tl.pw + (col - tl.ri0);
    const int c2 = row * I + col;
    a.mu_out[c2] = s_mu[pc];
    float du[S], dv[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      du[q] = s_du[q * tl.plane + pc];
      dv[q] = s_dv[q * tl.plane + pc];
    }
    const size_t x = (size_t)row * row3 + col;
    for (int k = 0; k < K; ++k) {
      const size_t o = x + (size_t)k * I;
      float uo = a.u[o], vo = a.v[o];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        uo = uo + du[q];
        vo = vo + dv[q];
      }
      a.u_out[o] = uo;
      a.v_out[o] = vo;
    }
  }
  // the ring rows pass through
  const int n_lo = blockIdx.y == 0 ? S : 0;
  const int n_hi = blockIdx.y + 1 == gridDim.y ? S : 0;
  if (n_lo + n_hi) {
    for (int idx = threadIdx.x; idx < (n_lo + n_hi) * ni;
         idx += blockDim.x) {
      const int q = idx / ni;
      const int row = q < n_lo ? q : a.J - S + (q - n_lo);
      const int col = tl.ci0 + idx % ni;
      const int c2 = row * I + col;
      a.mu_out[c2] = a.mu[c2];
      const size_t x = (size_t)row * row3 + col;
      for (int k = 0; k < K; ++k) {
        const size_t o = x + (size_t)k * I;
        a.u_out[o] = a.u[o];
        a.v_out[o] = a.v[o];
      }
    }
  }
}

template <int S, bool FUSE_W, bool OVERLAP, typename CT>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * S + 1) * (a.tj + 2 * S) * (a.ti + 2 * S) * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        coupled_kernel<S, FUSE_W, OVERLAP, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.I + a.ti - 1) / a.ti, (a.J - 2 * S + a.tj - 1) / a.tj);
  coupled_kernel<S, FUSE_W, OVERLAP, CT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int S, bool OVERLAP, typename CT>
cudaError_t launch(const Args& a, bool fuse_w, cudaStream_t stream) {
  return fuse_w ? launch_one<S, true, OVERLAP, CT>(a, stream)
                : launch_one<S, false, OVERLAP, CT>(a, stream);
}

// What one source file instantiates: every depth of one (OVERLAP, CT).
template <bool OVERLAP, typename CT>
cudaError_t dispatch_group(const Args& a, int n_inner, bool fuse_w,
                           cudaStream_t s) {
  switch (n_inner) {
    case 2: return launch<2, OVERLAP, CT>(a, fuse_w, s);
    case 3: return launch<3, OVERLAP, CT>(a, fuse_w, s);
    case 4: return launch<4, OVERLAP, CT>(a, fuse_w, s);
    case 5: return launch<5, OVERLAP, CT>(a, fuse_w, s);
    case 6: return launch<6, OVERLAP, CT>(a, fuse_w, s);
    case 7: return launch<7, OVERLAP, CT>(a, fuse_w, s);
    case 8: return launch<8, OVERLAP, CT>(a, fuse_w, s);
    default: return cudaErrorInvalidValue;
  }
}

// The four groups, one per source file (see the file comment).
cudaError_t launch_f32(const Args& a, int n_inner, bool fuse_w,
                       cudaStream_t s);
cudaError_t launch_f32_overlap(const Args& a, int n_inner, bool fuse_w,
                               cudaStream_t s);
cudaError_t launch_bf16(const Args& a, int n_inner, bool fuse_w,
                        cudaStream_t s);
cudaError_t launch_bf16_overlap(const Args& a, int n_inner, bool fuse_w,
                                cudaStream_t s);

}  // namespace k3
