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
// The substeps couple only through 2-D fields: the wind increment of
// substep q is 2-D, du_q = cu*(p_q - p_q(i-1)), dv_q = cv*(p_q -
// p_q(j-1)), masked, so u after s substeps is ((u0 + du_0) + du_1) + ...
// + du_s at every level, in the plain version's association.
//
// Two forms; the wrapper's plan (ops/advance_mu_t_coupled_cuda.py::plan, a
// pure function of S, K, fuse_w and the stream type) picks the form and
// the tile, and the tests pin it.
//
// THE STAGED FORM (staged_kernel; S=2..5 at K=50, float32 or bf16, without
// FUSE_W): the tile's 3-D operands come from device memory into shared
// memory ONCE per launch and all S substeps run from there; t goes back
// once.  The budget, 232,448 bytes a block, one block of 512 threads per
// SM, holds at K levels:
//   u      (tj+2S-2) rows x (ti+2S-1) cols   pass 1's extent at s=0, +east
//   v      (tj+2S-1) x (ti+2S-2)             the extent, +north
//   dvdxi_const (tj+2S-2) x (ti+2S-2)        CT
//   t_1    (tj+2) x (ti+2)                   CT, the own columns +-1
//   tconst, t                                tj x ti
//   sd     (tj+2S-2) x (ti+2S-2) floats      dvdxi, then the ww scan
//   six 2-D planes (tj+2S)(ti+2S): mu, du and dv of two substeps, msft2.
// Every box row starts and ends on 16 bytes (its columns widened to 4
// floats or 8 bf16), so cp.async moves 16 bytes a thread (as two or four
// copies where a row of memory is aligned to 8 or 4 only); the chunks that
// wrap in i go element by element.  The boxes cost shared memory, not
// DRAM: the widening stays inside sectors the needed columns touch
// anyway.  u and v are kept as u_s, v_s
// (the increments added in place, in order) and read as u_s + du_s.  At
// K=50 the plan's tiles are 6x16 (S=2), 9x8 (S=3), 7x8 (S=4), 5x8 (S=5).
// S=6..8 at K=50 fit only tiles of fewer than MIN_OWN columns; they
// stream.  So does every FUSE_W launch: a staged form with w and pp in
// shared memory (rhs level-parallel, the two sweeps down each column) was
// built and lost to the streaming form at S=2, 4 and 5 (PERF.md, §6).
//
// Per substep, every phase across all 512 threads, a barrier between:
//   A  du_s, dv_s from mu_s on the extent (+1), and u_s-1 += du_s-1 where
//      this substep reads (two plane buffers, so the two never clash);
//   D  dvdxi at every (column, level) of the extent into sd;
//   C  one thread a column: dmdt = sum dnw*dvdxi in k order, the mu
//      update; on the own columns the seeded ww scan in k order, whose
//      values replace dvdxi in sd (loads chunked ahead of the stores);
//   T  theta at every (own column, level), from the scan in sd.
// Level-parallel phases give a thread one column and every G-th level
// (G = threads / columns), so the index arithmetic is per column.  The
// first substep's phases A, D and C run while t_1, tconst and t are still
// landing (a second cp.async group).  What bounds it: the staged
// bytes (559 MB a launch at S=2, K=50, against the 9 x 53 MB the launch
// must move) and, above all at S=4, the issue of the phases' shared-memory
// loads (PERF.md).
//
// THE STREAMING FORM (coupled_kernel; where the plan stages nothing): per
// column, pass 1 over k (rebuild the winds from u0/v0 in device memory and
// the 2S increment planes in shared memory, dvdxi, dmdt in k order, mu)
// and, on own columns, pass 2 (the ww scan and theta, each level's
// operands loaded before the previous level's store to t; under FUSE_W the
// w solve rides it, dpw kept in the column's u_out, free scratch until
// the last phase).  Shared memory holds (2S+1) 2-D planes only; every
// substep streams every 3-D operand again.
//
// Buffers (both forms): u, v and mu are read at other blocks' cells, so
// their results go to fresh buffers (the caller swaps pointers); t,
// ww_row, w and pp are read only at their own column, so they are updated
// in place.  After S substeps the tile's u, v (all K levels) and mu go
// out; the blocks of the first and last tile rows copy the ring rows
// through.
//
// OVERLAP: the j leg of the width-S ring exchange inside the kernel.  The
// ring rows of mu, u and v in memory are stale; every read of a ring row of
// those three goes to the ring neighbours' blocks instead (a get through
// device pointers): rows [0, S) are the previous shard's last S interior
// rows (mu_lo, u_lo, v_lo), rows [J-S, J) the next shard's first S (mu_hi,
// u_hi, v_hi).  They are inputs of the block of substeps, complete once the
// previous block's launches are, so no thread waits on another; the staged
// form reads them while staging (and never again).  The ring rows of the
// outputs pass the stale memory rows through; the next launch does not
// read them either.
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
#include <cstdint>

#include "const_stream.cuh"
#include "w_solve.cuh"

namespace k3 {

constexpr int kThreads = 256;
constexpr int kStagedThreads = 512;
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
  int form;            // kStreaming or kStaged (the wrapper's plan)
};

constexpr int kStreaming = 0;
constexpr int kStaged = 1;

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
  // the level's operands as loaded (constant streams kept narrow until
  // used), each level's issued before the previous level's store to t
  struct Raw {
    float u, ue, v, vn, t;
    CT dc, tc, tn, ts, te, tw, tup;
  };
  const auto load = [&](int k, Raw& r) {
    const size_t o = (size_t)k * I;
    r.u = OVERLAP ? u_r[cw + o] : a.u[x_c + o];
    r.ue = OVERLAP ? u_r[ce + o] : a.u[x_e + o];
    r.v = OVERLAP ? v_r[cw + o] : a.v[x_c + o];
    r.vn = OVERLAP ? v_rn[cw + o] : a.v[x_n + o];
    r.t = a.t[x_c + o];
    r.dc = ldr(a_dvdxi_const, x_c + o);
    r.tc = ldr(a_tconst, x_c + o);
    r.tn = ldr(a_t_1, x_n + o);
    r.ts = ldr(a_t_1, x_s + o);
    r.te = ldr(a_t_1, x_e + o);
    r.tw = ldr(a_t_1, x_w + o);
    r.tup = ldr(a_t_1, k < k1 ? x_c + o + I : x_c + o);
  };
  Raw cur;
  load(k0, cur);
  for (int k = k0; k <= k1; ++k) {
    const size_t o = (size_t)k * I;
    Raw nxt = cur;
    if (k < k1) load(k + 1, nxt);
    const float uc = rebuild<S>(cur.u, du_c, s);
    const float ue = rebuild<S>(cur.ue, du_e, s);
    const float vc = rebuild<S>(cur.v, dv_c, s);
    const float vn = rebuild<S>(cur.vn, dv_n, s);
    const float dvdxi = f32(cur.dc) +
                        msft2 * (rdy * (vn - vc) + rdx * (ue - uc));
    float scan_up = 0.f, t1_up = 0.f, wdtn_up = 0.f;  // level k+1 (0 above k1)
    if (k < k1) {
      scan_up = scan + (-a.dnw[k] * ((dmdt + dvdxi) + mt)) * rmsfty;
      t1_up = f32(cur.tup);
      wdtn_up = scan_up * (a.fnm[k + 1] * t1_up + a.fnp[k + 1] * t1_k);
    }
    const float vert = a.rdnw[k] * (wdtn_up - wdtn);
    const float t_half = cur.t + f32(cur.tc);
    const float fy = vn * (f32(cur.tn) + t1_k) - vc * (t1_k + f32(cur.ts));
    const float fx = ue * (f32(cur.te) + t1_k) - uc * (t1_k + f32(cur.tw));
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
    cur = nxt;
  }
  if (FUSE_W) wsolve::w_backward(wc, a.w + x_c, a.pp + x_c, I, k0, k1, dpw, I);
}

// The ring rows of u, v and mu pass through to the fresh outputs (the
// blocks of the first and last tile rows copy them).
template <int S>
__device__ void pass_ring_rows(const Args& a, int ci0, int ni) {
  const int n_lo = blockIdx.y == 0 ? S : 0;
  const int n_hi = blockIdx.y + 1 == gridDim.y ? S : 0;
  if (n_lo + n_hi == 0) return;
  const size_t row3 = (size_t)a.K * a.I;
  for (int idx = threadIdx.x; idx < (n_lo + n_hi) * ni; idx += blockDim.x) {
    const int q = idx / ni;
    const int row = q < n_lo ? q : a.J - S + (q - n_lo);
    const int col = ci0 + idx % ni;
    const int c2 = row * a.I + col;
    a.mu_out[c2] = a.mu[c2];
    const size_t x = (size_t)row * row3 + col;
    for (int k = 0; k < a.K; ++k) {
      const size_t o = x + (size_t)k * a.I;
      a.u_out[o] = a.u[o];
      a.v_out[o] = a.v[o];
    }
  }
}

template <int S, bool FUSE_W, bool OVERLAP, typename CT>
__global__ void __launch_bounds__(kThreads, 2) coupled_kernel(const Args a) {
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
  pass_ring_rows<S>(a, tl.ci0, ni);
}

// ===========================================================================
// The staged form (see the file comment)
// ===========================================================================

__host__ __device__ constexpr int align_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One staged 3-D box in shared memory: ``rows`` rows from ``top`` rows above
// the tile's first own row, and ``width`` columns from ``lo`` before its
// first own column, at every level.  ``lo`` and ``width`` are multiples of
// 16 bytes of elements, so a box row starts on a 16-byte boundary in shared
// memory and (ti being a multiple of 8) at a 16-byte multiple of elements
// in the field's row.  Element (k, rr, cc) is at byte
// off + ((k*rows + rr)*width + cc)*sizeof(element).
struct Box {
  int top, rows, lo, width;
  unsigned off;
};

struct Layout {
  Box u, v, dc, t1, tc, t;
  unsigned d;       // dvdxi, then the ww scan: pass 1's extent, K levels
  int dw, dk;       // its row pitch and level stride, in floats
  unsigned vec;     // dnw, fnm, fnp, rdnw: 4 K-vectors of float
  unsigned planes;  // mu, du (two), dv (two), msft2: (tj+2S) x (ti+2S)
  int pw, plane;    // plane row pitch and size, in floats
  unsigned bytes;   // the block's dynamic shared memory
};

constexpr int kPlanes = 6;

__host__ __device__ inline Box make_box(unsigned& off, int K, int ti, int top,
                                        int rows, int lo, int hi,
                                        int esize) {
  const int m = 16 / esize;
  Box b;
  b.top = top;
  b.rows = rows;
  b.lo = align_up(lo, m);
  b.width = b.lo + align_up(ti + hi, m);
  b.off = off;
  off += (unsigned)K * rows * b.width * esize;
  return b;
}

// The boxes a tile of tj x ti own columns stages at depth S (cbytes: the
// constant streams' element size).  The wrapper's plan
// (ops/advance_mu_t_coupled_cuda.py::staged_layout) computes the same.
__host__ __device__ inline Layout staged_layout(int S, int K, int tj, int ti,
                                                int cbytes) {
  Layout L;
  unsigned off = 0;
  // u: pass 1's extent at s=0 (+-(S-1)) and the east neighbour
  L.u = make_box(off, K, ti, S - 1, tj + 2 * S - 2, S - 1, S, 4);
  // v: the extent and the north neighbour
  L.v = make_box(off, K, ti, S - 1, tj + 2 * S - 1, S - 1, S - 1, 4);
  L.dc = make_box(off, K, ti, S - 1, tj + 2 * S - 2, S - 1, S - 1, cbytes);
  // t_1: the own columns and one cell around them; tconst and t: own
  L.t1 = make_box(off, K, ti, 1, tj + 2, 1, 1, cbytes);
  L.tc = make_box(off, K, ti, 0, tj, 0, 0, cbytes);
  L.t = make_box(off, K, ti, 0, tj, 0, 0, 4);
  L.d = off;
  L.dw = ti + 2 * S - 2;
  L.dk = (tj + 2 * S - 2) * L.dw;
  off += (unsigned)align_up(K * L.dk, 4) * 4;
  L.vec = off;
  off += (unsigned)align_up(4 * K, 4) * 4;
  L.planes = off;
  L.pw = ti + 2 * S;
  L.plane = (tj + 2 * S) * L.pw;
  L.bytes = off + (unsigned)kPlanes * L.plane * 4;
  return L;
}

// x / d for 0 <= x < 2^21 and d >= 1, from rd = 1.0f / d: (x + 0.5)/d lies
// at least 0.5/d inside its integer interval and the two roundings err by
// less than (x + 0.5) * 2^-23 each, so truncation gives the quotient.  A
// few instructions where an integer division takes some twenty.
__device__ __forceinline__ int fdiv(int x, float rd) {
  return __float2int_rz(((float)x + 0.5f) * rd);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 16 bytes as two 8-byte or four 4-byte copies, for a source aligned only
// that far (a bf16 row of an I that is not a multiple of 8)
template <int G>
__device__ __forceinline__ void cp_async16_by(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const char* const s = static_cast<const char*>(src);
#pragma unroll
  for (int q = 0; q < 16; q += G) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d + q),
                 "l"(s + q), "n"(G)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy box b of a (J, K, I) field into shared memory: its first n_rows
// rows, every level, every column (wrapped modulo I); rows [0, ring) and
// [J-ring, J) come from the slabs lo and hi (OVERLAP's neighbour rows).
// A 16-byte chunk inside [0, I) goes by cp.async, in one copy, or in two
// or four where the row's alignment allows only 8 or 4 bytes (bf16 rows
// of 516 elements start on 8); the chunks that wrap in i at the two edges
// go element by element.  The caller commits, waits (cp_async_wait) and
// syncs.
template <typename T>
__device__ void stage_box(unsigned char* smem, const Box& b, const T* mem,
                          const T* lo, const T* hi, int ring, int J,
                          int n_rows, int cj0, int ci0, int K, int I) {
  const size_t n = (size_t)K * I;
  constexpr int m = 16 / sizeof(T);
  T* const dst = reinterpret_cast<T*>(smem + b.off);
  const int nch = b.width / m;
  const int per_k = n_rows * nch;
  const int c_org = ci0 - b.lo;
  const float r_per_k = 1.0f / per_k, r_nch = 1.0f / nch;
  for (int idx = threadIdx.x; idx < K * per_k; idx += blockDim.x) {
    const int k = fdiv(idx, r_per_k);
    const int rem = idx - k * per_k;
    const int rr = fdiv(rem, r_nch);
    const int ch = rem - rr * nch;
    const int row = cj0 - b.top + rr;
    const T* const src =
        (row < ring ? lo + (size_t)row * n
                    : row >= J - ring ? hi + (size_t)(row - (J - ring)) * n
                                      : mem + (size_t)row * n) +
        (size_t)k * I;
    T* const d = dst + ((size_t)k * b.rows + rr) * b.width + ch * m;
    const int c0 = c_org + ch * m;
    const uintptr_t at = reinterpret_cast<uintptr_t>(src + c0);
    if (c0 < 0 || c0 + m > I) {
      for (int e = 0; e < m; ++e) d[e] = src[wrap(c0 + e, I)];
    } else if ((at & 15) == 0) {
      cp_async16(d, src + c0);
    } else if ((at & 7) == 0) {
      cp_async16_by<8>(d, src + c0);
    } else if ((at & 3) == 0) {
      cp_async16_by<4>(d, src + c0);
    } else {
      for (int e = 0; e < m; ++e) d[e] = src[c0 + e];
    }
  }
}

// x += the increment plane at every level of box b, on rows [r_lo, r_hi)
// and columns [c_lo, c_hi) (the cells the next pass reads).
__device__ inline void add_increment(float* box, const Box& b, const float* inc,
                              int pw, int rj0, int ri0, int cj0, int ci0,
                              int r_lo, int r_hi, int c_lo, int c_hi, int K) {
  const int h = r_hi - r_lo, w = c_hi - c_lo, hw = h * w;
  const float r_hw = 1.0f / hw, r_w = 1.0f / w;
  for (int idx = threadIdx.x; idx < K * hw; idx += blockDim.x) {
    const int k = fdiv(idx, r_hw);
    const int rem = idx - k * hw;
    const int lj = fdiv(rem, r_w);
    const int row = r_lo + lj, col = c_lo + rem - lj * w;
    float& x = box[(k * b.rows + (row - cj0 + b.top)) * b.width +
                   (col - ci0 + b.lo)];
    x = x + inc[(row - rj0) * pw + (col - ri0)];
  }
}

template <int S, bool OVERLAP, typename CT>
__global__ void __launch_bounds__(kStagedThreads, 1)
    staged_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  unsigned char* const smem = staged_smem;
  const int I = a.I, K = a.K, J = a.J;
  const Layout L = staged_layout(S, K, a.tj, a.ti, (int)sizeof(CT));
  const int cj0 = S + blockIdx.y * a.tj, cj1 = min(cj0 + a.tj, J - S);
  const int ci0 = blockIdx.x * a.ti, ci1 = min(ci0 + a.ti, I);
  const int nj = cj1 - cj0, ni = ci1 - ci0;
  const int rj0 = cj0 - S, ri0 = ci0 - S;  // plane cell (0, 0)
  const size_t row3 = (size_t)K * I;
  float* const su = reinterpret_cast<float*>(smem + L.u.off);
  float* const sv = reinterpret_cast<float*>(smem + L.v.off);
  float* const st = reinterpret_cast<float*>(smem + L.t.off);
  float* const s_mu = reinterpret_cast<float*>(smem + L.planes);
  float* const s_ms = s_mu + 5 * L.plane;  // msft2
  float* const sd = reinterpret_cast<float*>(smem + L.d);
  const float* const dnw = reinterpret_cast<const float*>(smem + L.vec);
  const float* const fnm = dnw + K;
  const float* const fnp = dnw + 2 * K;
  const float* const rdnw = dnw + 3 * K;
  const CT* const sdc = reinterpret_cast<const CT*>(smem + L.dc.off);
  const CT* const st1 = reinterpret_cast<const CT*>(smem + L.t1.off);
  const CT* const stc = reinterpret_cast<const CT*>(smem + L.tc.off);
  const int ku = L.u.rows * L.u.width, kv = L.v.rows * L.v.width;
  const int kd = L.dc.rows * L.dc.width, w1 = L.t1.width;
  const int k1s = L.t1.rows * w1, kt = L.t.rows * L.t.width;
  const int ktc = L.tc.rows * L.tc.width;
  const int k0 = a.k0, k1 = a.k1, nk = k1 - k0 + 1;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts, cs2 = a.cs2;

  // ---- stage the tile's operands, once --------------------------------
  constexpr int ring = OVERLAP ? S : 0;
  stage_box<float>(smem, L.u, a.u, a.u_lo, a.u_hi, ring, J, nj + 2 * S - 2,
                   cj0, ci0, K, I);
  stage_box<float>(smem, L.v, a.v, a.v_lo, a.v_hi, ring, J, nj + 2 * S - 1,
                   cj0, ci0, K, I);
  const CT* const dc = static_cast<const CT*>(a.dvdxi_const);
  const CT* const t_1 = static_cast<const CT*>(a.t_1);
  const CT* const tc = static_cast<const CT*>(a.tconst);
  stage_box<CT>(smem, L.dc, dc, dc, dc, 0, J, nj + 2 * S - 2, cj0, ci0, K,
                I);
  cp_async_commit();  // what the first substep's phases A, D and C read
  stage_box<CT>(smem, L.t1, t_1, t_1, t_1, 0, J, nj + 2, cj0, ci0, K, I);
  stage_box<CT>(smem, L.tc, tc, tc, tc, 0, J, nj, cj0, ci0, K, I);
  stage_box<float>(smem, L.t, a.t, a.t, a.t, 0, J, nj, cj0, ci0, K, I);
  cp_async_commit();  // what phase T reads: in flight behind them
  {
    float* const vec = reinterpret_cast<float*>(smem + L.vec);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      vec[k] = a.dnw[k];
      vec[K + k] = a.fnm[k];
      vec[2 * K + k] = a.fnp[k];
      vec[3 * K + k] = a.rdnw[k];
    }
    const int h = nj + 2 * S, w = ni + 2 * S;
    for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
      const int lj = idx / w, li = idx % w;
      s_mu[lj * L.pw + li] =
          ring_row<S, OVERLAP>(a.mu, a.mu_lo, a.mu_hi, rj0 + lj, J,
                               I)[wrap(ri0 + li, I)];
      s_ms[lj * L.pw + li] = a.msft2[(rj0 + lj) * I + wrap(ri0 + li, I)];
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const int r = S - 1 - s;
    float* const du = s_mu + (1 + (s & 1)) * L.plane;
    float* const dv = s_mu + (3 + (s & 1)) * L.plane;

    // ---- phase A: du_s and dv_s (as the streaming form) ----------------
    {
      const int h = nj + 2 * r + 1, w = ni + 2 * r + 1;
      for (int idx = threadIdx.x; idx < h * w; idx += blockDim.x) {
        const int row = cj0 - r + idx / w, col = ci0 - r + idx % w;
        const int pc = (row - rj0) * L.pw + (col - ri0);
        const int cw = wrap(col, I);
        const int ig = cw + a.i_off, jg = row - S + a.j_off + 1;
        const bool i_in = ig >= a.i0 && ig <= a.i1;
        const bool j_in = jg >= a.j0 && jg <= a.j1;
        const float p_c = cs2 * s_mu[pc];
        float du_v = 0.f, dv_v = 0.f;
        if (ig >= a.i0 + 1 && ig <= a.i1 && j_in)
          du_v = a.cu[row * I + cw] * (p_c - cs2 * s_mu[pc - 1]);
        if (i_in && jg >= a.j0 + 1 && jg <= a.j1)
          dv_v = a.cv[row * I + cw] * (p_c - cs2 * s_mu[pc - L.pw]);
        du[pc] = du_v;
        dv[pc] = dv_v;
      }
    }
    // ---- and the previous substep's increments into the staged winds,
    // on the cells this substep reads (u east, v north of the extent) ----
    if (s > 0) {
      const float* const dup = s_mu + (1 + ((s - 1) & 1)) * L.plane;
      const float* const dvp = s_mu + (3 + ((s - 1) & 1)) * L.plane;
      add_increment(su, L.u, dup, L.pw, rj0, ri0, cj0, ci0, cj0 - r,
                    cj1 + r, ci0 - r, ci1 + r + 1, K);
      add_increment(sv, L.v, dvp, L.pw, rj0, ri0, cj0, ci0, cj0 - r,
                    cj1 + r + 1, ci0 - r, ci1 + r, K);
    }
    __syncthreads();

    // ---- phase D: dvdxi at every level of every column of the extent.
    // Level-parallel phases give thread t the cell t % hw and the levels
    // k0 + t / hw, k0 + t / hw + G, ... (G = threads / cells) ----------
    {
      const int w = ni + 2 * r, hw = (nj + 2 * r) * w;
      const int G = max(1, (int)blockDim.x / hw);
      const float r_hw = 1.0f / hw, r_w = 1.0f / w;
      for (int t = threadIdx.x; t < G * hw; t += blockDim.x) {
        const int g = fdiv(t, r_hw);
        const int cell = t - g * hw;
        const int q = fdiv(cell, r_w);
        const int lj = q - r, li = cell - q * w - r;  // from the tile
        const int pc = (lj + S) * L.pw + (li + S);
        const float du_c = du[pc], du_e = du[pc + 1];
        const float dv_c = dv[pc], dv_n = dv[pc + L.pw];
        const float msft2 = s_ms[pc];
        const float* const pu = su + (lj + L.u.top) * L.u.width + li + L.u.lo;
        const float* const pv = sv + (lj + L.v.top) * L.v.width + li + L.v.lo;
        const CT* const pd = sdc + (lj + L.dc.top) * L.dc.width + li + L.dc.lo;
        float* const out = sd + (lj + S - 1) * L.dw + li + S - 1;
        for (int k = k0 + g; k <= k1; k += G) {
          const float uc = pu[k * ku] + du_c;
          const float ue = pu[k * ku + 1] + du_e;
          const float vc = pv[k * kv] + dv_c;
          const float vn = pv[k * kv + L.v.width] + dv_n;
          out[k * L.dk] = f32(pd[k * kd]) +
                          msft2 * (rdy * (vn - vc) + rdx * (ue - uc));
        }
      }
    }
    __syncthreads();

    // ---- phase C: per column of the extent, dmdt in k order and mu; on
    // the own columns in the window, the seeded ww scan, whose values
    // replace dvdxi in sd -------------------------------------------------
    {
      const int w = ni + 2 * r, hw = (nj + 2 * r) * w;
      const float r_w = 1.0f / w;
      for (int idx = threadIdx.x; idx < hw; idx += blockDim.x) {
        const int q = fdiv(idx, r_w);
        const int lj = q - r, li = idx - q * w - r;
        const int row = cj0 + lj, col = ci0 + li;
        const int pc = (lj + S) * L.pw + (li + S);
        const int cw = wrap(col, I);
        const int c2 = row * I + cw;
        const int ig = cw + a.i_off, jg = row - S + a.j_off + 1;
        const bool in_win =
            ig >= a.i0 && ig <= a.i1 && jg >= a.j0 && jg <= a.j1;
        float* const dcol = sd + (lj + S - 1) * L.dw + li + S - 1;
        float dmdt = 0.f;
#pragma unroll 8
        for (int k = k0; k <= k1; ++k) dmdt += dnw[k] * dcol[k * L.dk];
        const float mt = a.mu_tend[c2];
        const float mu_s = s_mu[pc];
        s_mu[pc] = in_win ? mu_s + dts * (dmdt + mt) : mu_s;
        const bool own = lj >= 0 && lj < nj && li >= 0 && li < ni;
        if (!own || !in_win) continue;  // t and ww_row pass
        const float rmsfty = 1.0f / a.msfty[c2];
        const float seed = a.ww_row[c2];
        a.ww_row[c2] = seed - a.ww1_k0[c2];  // the next substep's seed
        float scan = seed;                   // raw scan value at level k
        constexpr int U = 8;  // levels loaded before their stores
        for (int kb = k0; kb <= k1; kb += U) {
          float dvdxi[U];
#pragma unroll
          for (int q = 0; q < U; ++q)
            dvdxi[q] = kb + q <= k1 ? dcol[(kb + q) * L.dk] : 0.f;
#pragma unroll
          for (int q = 0; q < U; ++q) {
            const int k = kb + q;
            if (k > k1) break;
            dcol[k * L.dk] = scan;
            if (k < k1)
              scan = scan + (-dnw[k] * ((dmdt + dvdxi[q]) + mt)) * rmsfty;
          }
        }
      }
    }
    if (s == 0) cp_async_wait<0>();  // t_1, tconst and t have landed
    __syncthreads();

    // ---- phase T: theta at every level of every own column in the window
    {
      const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
      const int hw = nj * ni;
      const int G = max(1, (int)blockDim.x / hw);
      const float r_hw = 1.0f / hw, r_ni = 1.0f / ni;
      for (int t = threadIdx.x; t < G * hw; t += blockDim.x) {
        const int g = fdiv(t, r_hw);
        const int cell = t - g * hw;
        const int lj = fdiv(cell, r_ni), li = cell - lj * ni;
        const int row = cj0 + lj, col = ci0 + li;
        const int ig = col + a.i_off, jg = row - S + a.j_off + 1;
        if (!(ig >= a.i0 && ig <= a.i1 && jg >= a.j0 && jg <= a.j1)) continue;
        const int c2 = row * I + col;
        const float dts_msfty = dts * a.msfty[c2];
        const float msftx_c = a.msftx[c2];
        const int pc = (lj + S) * L.pw + (li + S);
        const float du_c = du[pc], du_e = du[pc + 1];
        const float dv_c = dv[pc], dv_n = dv[pc + L.pw];
        const float* const pu = su + (lj + L.u.top) * L.u.width + li + L.u.lo;
        const float* const pv = sv + (lj + L.v.top) * L.v.width + li + L.v.lo;
        const float* const dcol = sd + (lj + S - 1) * L.dw + li + S - 1;
        const CT* const p1 = st1 + (lj + 1) * w1 + li + L.t1.lo;
        const CT* const pcn = stc + lj * L.tc.width + li;
        float* const pt = st + lj * L.t.width + li;
        for (int k = k0 + g; k <= k1; k += G) {
          const float uc = pu[k * ku] + du_c;
          const float ue = pu[k * ku + 1] + du_e;
          const float vc = pv[k * kv] + dv_c;
          const float vn = pv[k * kv + L.v.width] + dv_n;
          const CT* const x1 = p1 + k * k1s;
          const float t1_k = f32(*x1);
          float wdtn = 0.f, wdtn_up = 0.f;  // 0 at the surface and above k1
          if (k > k0)
            wdtn = dcol[k * L.dk] * (fnm[k] * t1_k + fnp[k] * f32(x1[-k1s]));
          if (k < k1)
            wdtn_up = dcol[(k + 1) * L.dk] *
                      (fnm[k + 1] * f32(x1[k1s]) + fnp[k + 1] * t1_k);
          const float vert = rdnw[k] * (wdtn_up - wdtn);
          const float t_half = pt[k * kt] + f32(pcn[k * ktc]);
          const float fy = vn * (f32(x1[w1]) + t1_k) -
                           vc * (t1_k + f32(x1[-w1]));
          const float fx = ue * (f32(x1[1]) + t1_k) -
                           uc * (t1_k + f32(x1[-1]));
          const float horiz = msftx_c * (hrdy * fy + hrdx * fx);
          pt[k * kt] = t_half - dts_msfty * (horiz + vert);
        }
      }
    }
    __syncthreads();
  }

  // ---- outputs, once: t, u, v (the last increment added), mu -----------
  {
    const float* const du = s_mu + (1 + ((S - 1) & 1)) * L.plane;
    const float* const dv = s_mu + (3 + ((S - 1) & 1)) * L.plane;
    const int hw = nj * ni;
    const float r_hw = 1.0f / hw, r_ni = 1.0f / ni;
    for (int idx = threadIdx.x; idx < K * hw; idx += blockDim.x) {
      const int k = fdiv(idx, r_hw);
      const int rem = idx - k * hw;
      const int lj = fdiv(rem, r_ni), li = rem - lj * ni;
      const int pc = (lj + S) * L.pw + (li + S);
      const size_t o = (size_t)(cj0 + lj) * row3 + (size_t)k * I + ci0 + li;
      a.u_out[o] = su[(k * L.u.rows + lj + L.u.top) * L.u.width + li +
                      L.u.lo] + du[pc];
      a.v_out[o] = sv[(k * L.v.rows + lj + L.v.top) * L.v.width + li +
                      L.v.lo] + dv[pc];
      a.t[o] = st[(k * L.t.rows + lj) * L.t.width + li];
    }
    for (int idx = threadIdx.x; idx < hw; idx += blockDim.x) {
      const int lj = idx / ni, li = idx % ni;
      a.mu_out[(cj0 + lj) * I + ci0 + li] = s_mu[(lj + S) * L.pw + li + S];
    }
  }
  pass_ring_rows<S>(a, ci0, ni);
}

// A launch's dynamic shared memory in its form: the staged layout, or the
// streaming form's 2S+1 planes.  The wrapper's plan carries the same number
// (Plan.smem) and the C entry refuses a plan that disagrees.
inline size_t form_smem(int form, int S, int K, int tj, int ti, int cbytes) {
  if (form == kStaged) return staged_layout(S, K, tj, ti, cbytes).bytes;
  return (size_t)(2 * S + 1) * (tj + 2 * S) * (ti + 2 * S) * sizeof(float);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel* kernel, dim3 grid, int threads, size_t smem,
                          const Args& a, cudaStream_t stream) {
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int S, bool FUSE_W, bool OVERLAP, typename CT>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.I + a.ti - 1) / a.ti, (a.J - 2 * S + a.tj - 1) / a.tj);
  if (a.form == kStaged) {
    if (FUSE_W) return cudaErrorInvalidValue;  // the plan streams fuse_w
    return launch_kernel(staged_kernel<S, OVERLAP, CT>, grid, kStagedThreads,
                         form_smem(kStaged, S, a.K, a.tj, a.ti, sizeof(CT)),
                         a, stream);
  }
  return launch_kernel(
      coupled_kernel<S, FUSE_W, OVERLAP, CT>, grid, kThreads,
      form_smem(kStreaming, S, a.K, a.tj, a.ti, sizeof(CT)), a, stream);
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
