// K1 — one fused acoustic substep (advance_mu_t) on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrf_tpu/ops/advance_mu_t_pallas.py::_kernel,
// launched there by advance_mu_t_pallas.  It computes what that kernel
// computes, in the modes the port's main path uses:
//   * optional fused wind update (FUSE_UV): p = cs2*mu,
//     u += dts*(muu/msfuy)*(-rdx)*(p - p(i-1)),
//     v += dts*(muv*msfvx_inv)*(-rdy)*(p - p(j-1));
//     otherwise the read-only winds are multiplied by wind_scale on load,
//     before any differencing (the TPU kernel's association; 1 is exact);
//   * divergence damping (a non-null mudf_in, under FUSE_UV): the previous
//     substep's mass-divergence tendency stiffens the pressure,
//     p = cs2*mu + dampc*mudf_in with dampc = cs2*smdiv rounded to float32
//     by the caller, at all five points the wind update reads;
//   * mass-flux divergence dvdxi and its column sum dmdt;
//   * mu, mudf, muts and muave with epssm off-centering;
//   * the seeded k-ascending ww scan (WW_MODE full / lite / final);
//   * the theta update, and t_ave when WITH_TAVE;
//   * LEAN: the u_1/v_1 static fluxes and the ft / ww_1 theta terms arrive
//     folded into two precomputed fields (dvdxi_const, tconst);
//   * FUSE_W: the vertically-implicit w/pp substep, a per-column Thomas
//     solve on this substep's new theta (csrc/w_solve.cuh);
//   * capture (non-null cap_* pointers, WW_MODE full): the phase-A state
//     between the mu/ww pass and the theta pass, written to five buffers of
//     their own (muave, mu, mudf, muts, ww "before theta");
//   * OVERLAP (under FUSE_UV): the j halo exchange inside the kernel.  The
//     block's halo rows 0 and J-1 in memory are stale; the two edge rows
//     1 and J-2 load what they read there straight from the ring
//     neighbours' blocks instead (a get through device pointers): mu_lo and
//     mudf_lo are the previous shard's last interior row, mu_hi, mudf_hi and
//     v_hi the next shard's first interior row.  These are inputs of the
//     substep, complete once the previous substep's launches are, so no
//     thread waits on another and nothing is staged;
//   * CT, the element type of the constant streams (float or
//     __nv_bfloat16): t_1, tconst, dvdxi_const, ww_1, u_1, v_1, ft and,
//     without FUSE_UV, the read-only winds u and v arrive in CT and are
//     widened to float on load (exact); all arithmetic, all state and all
//     outputs stay float.
// The plain PyTorch version of the same arithmetic is
// advance_mu_t_fused_plain in wrf_tpu_torch/ops/advance_mu_t_cuda.py.
//
// This header holds the kernel and its dispatch; the instances are compiled
// in four sources so that they build in parallel: csrc/advance_mu_t.cu
// (float streams, with the C entry), advance_mu_t_overlap.cu,
// advance_mu_t_bf16.cu and advance_mu_t_bf16_overlap.cu.
//
// Geometry: one thread per (j, i) column of the padded local block.
// threadIdx.x runs along i, the contiguous axis, so a warp's loads at one
// level k are 32 neighbouring floats; each thread runs its column's k loops
// itself (the reference CUDA kernel's geometry).  Two k passes per column:
//   pass 1 forms dvdxi(k) for k0..k1, keeps it in shared memory (a K-long
//          slice per thread, laid out [k][threadIdx.x] so a warp hits 32
//          banks; kept rather than recomputed in pass 2), sums dmdt in k
//          order (the oracle's order) and writes the updated winds;
//   pass 2 runs the ww scan from the seed and the theta update with one
//          level of look-ahead, since vert(k) needs wdtn(k+1).  Under
//          FUSE_W the solve's forward elimination rides this loop, level k
//          right after t(k) is final, and a third, descending loop
//          back-substitutes and updates pp.
// The solve's K-long sweep state dpw lives in the thread's shared-memory
// slice: pass 2 consumes dvdxi(k) at level k and the slot is dead from
// then on, so dpw(k) takes it.  No scratch in device memory; what the
// solve costs there is w and pp read twice and written once (6 field
// passes, 4 of them compulsory: csrc/w_solve.cuh).
//
// Buffers: u, v and mu are read at neighbour columns and rows, and GPU
// blocks run in no fixed order, so their updates go to fresh output
// buffers; the caller hands those back as the next substep's inputs
// (nothing is copied).  The same holds for mudf under damping: mudf_in is
// read at neighbour columns and rows while mudf is written, so the two are
// different buffers, and a loop hands each substep's mudf back as the next
// one's mudf_in.  t, t_ave, ww and ww_row are read only at the thread's own
// column, so they are updated in place; so are w and pp.
//
// Edges: rows 0 and J-1 are never computed.  There, and in every column
// outside the compute window, the state passes through and muave, muts
// and mudf are zero — the TPU kernel's contract.  The captures follow
// their outputs (ww and mu pass through outside the window and the k
// range), except that rows 0 and J-1 of all five are zero.  The i-1 / i+1
// neighbours wrap around the row as the TPU kernel's lane rolls do; the
// window masks make the wrapped values unused.
//
// Bound: memory.  The lean scan substep streams nine 3-D float32 field
// passes (reads u, v, t, t_1, tconst, dvdxi_const; writes u, v, t) and does
// a few dozen flops per cell; pass 2 re-reads u, v and the t_1 neighbours,
// which the design leaves to the L1/L2 caches.  Times on the card are in
// PERF.md.
//
// Numerics: built with -fmad=false (no multiply-add contraction) and IEEE
// division.  Every expression, and the k order of the dmdt column sum,
// follows the plain version, so the two agree bit for bit (measured on the
// card in all three modes: PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "const_stream.cuh"
#include "w_solve.cuh"

namespace k1 {

enum WwMode { kFull = 0, kLite = 1, kFinal = 2 };

struct Args {
  // 3-D fields (J, K, I); the void pointers are the constant streams, of
  // the kernel's CT (u and v: float under FUSE_UV)
  float* ww;
  const void* ww_1;
  const void* u;
  const void* u_1;
  const void* v;
  const void* v_1;
  float* t;
  const void* t_1;
  float* t_ave;
  const void* ft;
  const void* tconst;
  const void* dvdxi_const;
  // 2-D fields (J, I)
  const float* mu;
  const float* mudf_in;  // divergence damping (FUSE_UV); NULL: off
  const float* mut;
  const float* muu;
  const float* muv;
  const float* mu_tend;
  const float* msfuy;
  const float* msfvx_inv;
  const float* msftx;
  const float* msfty;
  float* ww_row;
  const float* ww1_k0;
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
  float* mu_out;
  float* muave;
  float* muts;
  float* mudf;
  float* u_out;
  float* v_out;
  // phase-A captures (WW_MODE full), all five or none; NULL: off
  float* cap_muave;
  float* cap_mu;
  float* cap_mudf;
  float* cap_muts;
  float* cap_ww;
  // OVERLAP: the ring neighbours' rows, (I,) each and (K, I) for v_hi;
  // the mudf rows only under DAMP
  const float* mu_lo;
  const float* mu_hi;
  const float* v_hi;
  const float* mudf_lo;
  const float* mudf_hi;
  float rdx, rdy, dts, epssm, cs2, dampc, wind_scale;
  float c_w, g_t, beta, alfa;  // FUSE_W scalars
  int J, K, I;
  int i0, i1, j0, j1;  // compute window, global coordinates
  int j_off, i_off;    // global index of local row / column 0
  int k0, k1;
};

// DAMP, CAPTURE, OVERLAP and CT are template parameters, not tests of the
// pointers, so that the instances without them compile to what they were
// before the forms existed (a run-time branch cost the FUSE_W scan substep
// 9 %).
template <bool FUSE_UV, bool LEAN, int WW_MODE, bool WITH_TAVE, bool FUSE_W,
          bool DAMP, bool CAPTURE, bool OVERLAP, typename CT>
__global__ void __launch_bounds__(128)
advance_mu_t_kernel(const Args a) {
  extern __shared__ float s_dvdxi[];  // [K][blockDim.x]
  // the winds are state under FUSE_UV and a constant stream otherwise
  using WT = typename std::conditional<FUSE_UV, float, CT>::type;
  const WT* const a_u = static_cast<const WT*>(a.u);
  const WT* const a_v = static_cast<const WT*>(a.v);
  const CT* const a_u_1 = static_cast<const CT*>(a.u_1);
  const CT* const a_v_1 = static_cast<const CT*>(a.v_1);
  const CT* const a_ww_1 = static_cast<const CT*>(a.ww_1);
  const CT* const a_t_1 = static_cast<const CT*>(a.t_1);
  const CT* const a_ft = static_cast<const CT*>(a.ft);
  const CT* const a_tconst = static_cast<const CT*>(a.tconst);
  const CT* const a_dvdxi_const = static_cast<const CT*>(a.dvdxi_const);
  const int tx = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tx;
  const int j = blockIdx.y;
  const int I = a.I, K = a.K;
  if (i >= I) return;  // no block-wide barrier below

  const size_t row = (size_t)K * I;            // one j row of a 3-D field
  const size_t col = (size_t)j * row + i;      // (j, k=0, i); level k adds k*I
  const int c = j * I + i;                     // (j, i) of a 2-D field
  const int ig = i + a.i_off, jg = j + a.j_off;
  const bool i_in = ig >= a.i0 && ig <= a.i1;
  const bool j_in = jg >= a.j0 && jg <= a.j1;

  if (!(j >= 1 && j <= a.J - 2 && i_in && j_in)) {
    // edge row or outside the window: pass-through / zero
    a.mu_out[c] = a.mu[c];
    a.muave[c] = 0.f;
    a.muts[c] = 0.f;
    a.mudf[c] = 0.f;
    if (FUSE_UV) {
      for (int k = 0; k < K; ++k) {
        const size_t x = col + (size_t)k * I;
        a.u_out[x] = ldf(a_u, x);
        a.v_out[x] = ldf(a_v, x);
      }
    }
    if (CAPTURE) {  // the outputs' values; all zero on rows 0 and J-1
      const bool edge = j < 1 || j > a.J - 2;
      a.cap_muave[c] = 0.f;
      a.cap_mu[c] = edge ? 0.f : a.mu[c];
      a.cap_mudf[c] = 0.f;
      a.cap_muts[c] = 0.f;
      for (int k = 0; k < K; ++k) {
        const size_t x = col + (size_t)k * I;
        a.cap_ww[x] = edge ? 0.f : a.ww[x];
      }
    }
    return;
  }

  const int ip = (i + 1 == I) ? 0 : i + 1;  // east neighbour, wrapping
  const int im = (i == 0) ? I - 1 : i - 1;  // west neighbour, wrapping
  const int ce = j * I + ip, cw = j * I + im;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float ws = a.wind_scale;  // 1 under FUSE_UV (the wrapper checks)
  // OVERLAP: this column of the row one to the north of v, level k at
  // v_north[k * I]: the block's own row j+1, or for the last interior row
  // the next shard's first interior row in place of the stale halo row.
  // One pointer picked here, so that the k loops hold no branch.
  const float* const v_north =
      !OVERLAP ? nullptr
               : (j == a.J - 2 ? a.v_hi + i
                               : static_cast<const float*>(a.v) + col + row);
  const float msft2 = a.msftx[c] * a.msfty[c];
  const float muu_msfuy_c = a.muu[c] / a.msfuy[c];
  const float muu_msfuy_e = a.muu[ce] / a.msfuy[ce];
  const float muv_msfvxi_c = a.muv[c] * a.msfvx_inv[c];
  const float muv_msfvxi_n = a.muv[c + I] * a.msfvx_inv[c + I];

  // Wind increments of this column's u(i), u(i+1), v(j), v(j+1): each
  // thread recomputes its neighbours' updated winds instead of reading
  // them, with the u/v window evaluated at the neighbour.
  float du_c = 0.f, du_e = 0.f, dv_c = 0.f, dv_n = 0.f;
  if (FUSE_UV) {
    const float cs2 = a.cs2;
    float p_c = cs2 * a.mu[c];
    float p_w = cs2 * a.mu[cw];
    float p_e = cs2 * a.mu[ce];
    // OVERLAP: the edge rows take the halo rows from the ring neighbours
    const bool lo_edge = OVERLAP && j == 1;
    const bool hi_edge = OVERLAP && j == a.J - 2;
    float p_s = cs2 * (lo_edge ? a.mu_lo[i] : a.mu[c - I]);
    float p_n = cs2 * (hi_edge ? a.mu_hi[i] : a.mu[c + I]);
    if (DAMP) {  // divergence damping: two roundings and a sum each
      const float dampc = a.dampc;
      p_c = p_c + dampc * a.mudf_in[c];
      p_w = p_w + dampc * a.mudf_in[cw];
      p_e = p_e + dampc * a.mudf_in[ce];
      p_s = p_s + dampc * (lo_edge ? a.mudf_lo[i] : a.mudf_in[c - I]);
      p_n = p_n + dampc * (hi_edge ? a.mudf_hi[i] : a.mudf_in[c + I]);
    }
    const int ige = ip + a.i_off;
    const int jgn = jg + 1;
    if (ig >= a.i0 + 1 && ig <= a.i1)
      du_c = ((dts * muu_msfuy_c) * (-rdx)) * (p_c - p_w);
    if (ige >= a.i0 + 1 && ige <= a.i1)
      du_e = ((dts * muu_msfuy_e) * (-rdx)) * (p_e - p_c);
    if (jg >= a.j0 + 1)
      dv_c = ((dts * muv_msfvxi_c) * (-rdy)) * (p_c - p_s);
    if (jgn >= a.j0 + 1 && jgn <= a.j1)
      dv_n = ((dts * muv_msfvxi_n) * (-rdy)) * (p_n - p_c);
  }

  // ---- pass 1: winds out, dvdxi(k) to shared memory, dmdt -------------
  const int bdx = blockDim.x;
  float* s = s_dvdxi + tx;  // level k at s[k * bdx]
  const int k0 = a.k0, k1 = a.k1;
  float dmdt = 0.f;
  for (int k = FUSE_UV ? 0 : k0; k < (FUSE_UV ? K : k1 + 1); ++k) {
    const size_t x = col + (size_t)k * I;
    const float u_c = FUSE_UV ? ldf(a_u, x) + du_c : ldf(a_u, x) * ws;
    const float v_c = FUSE_UV ? ldf(a_v, x) + dv_c : ldf(a_v, x) * ws;
    if (FUSE_UV) {
      a.u_out[x] = u_c;
      a.v_out[x] = v_c;
      if (k < k0 || k > k1) continue;
    }
    const size_t xe = x - i + ip, xn = x + row;
    const float u_e = FUSE_UV ? ldf(a_u, xe) + du_e : ldf(a_u, xe) * ws;
    const float v_n =
        FUSE_UV ? (OVERLAP ? v_north[(size_t)k * I] : ldf(a_v, xn)) + dv_n
                : ldf(a_v, xn) * ws;
    float dvdxi;
    if (LEAN) {
      dvdxi = ldf(a_dvdxi_const, x) +
              msft2 * (rdy * (v_n - v_c) + rdx * (u_e - u_c));
    } else {
      const float vflux = v_c + muv_msfvxi_c * ldf(a_v_1, x);
      const float vflux_n = v_n + muv_msfvxi_n * ldf(a_v_1, xn);
      const float uflux = u_c + muu_msfuy_c * ldf(a_u_1, x);
      const float uflux_e = u_e + muu_msfuy_e * ldf(a_u_1, xe);
      dvdxi = msft2 * (rdy * (vflux_n - vflux) + rdx * (uflux_e - uflux));
    }
    s[k * bdx] = dvdxi;
    dmdt += a.dnw[k] * dvdxi;
  }

  // ---- column mass -------------------------------------------------------
  const float mu_c = a.mu[c];
  const float mt = a.mu_tend[c];
  const float tend = dmdt + mt;
  const float mu_new = mu_c + dts * tend;
  a.mu_out[c] = mu_new;
  a.mudf[c] = tend;
  const float muts_new = a.mut[c] + mu_new;
  a.muts[c] = muts_new;
  const float muave_new =
      0.5f * ((1.0f + a.epssm) * mu_new + (1.0f - a.epssm) * mu_c);
  a.muave[c] = muave_new;
  if (CAPTURE) {
    a.cap_muave[c] = muave_new;
    a.cap_mu[c] = mu_new;
    a.cap_mudf[c] = tend;
    a.cap_muts[c] = muts_new;
    for (int k = 0; k < K; ++k) {  // outside the k range ww passes through
      const size_t x = col + (size_t)k * I;
      if (k < k0 || k > k1) a.cap_ww[x] = a.ww[x];
    }
  }

  // ---- pass 2: ww scan and theta, k ascending ----------------------------
  const float msfty_c = a.msfty[c];
  const float rmsfty = 1.0f / msfty_c;
  const float dts_msfty = dts * msfty_c;
  const float msftx_c = a.msftx[c];
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const size_t x0 = col + (size_t)k0 * I;
  const float seed = (WW_MODE == kFull) ? a.ww[x0] : a.ww_row[c];
  if (WW_MODE == kLite) {
    // the next substep's seed; in lean mode ww_1 lives in tconst and
    // the scan below carries the raw value
    a.ww_row[c] = seed - (LEAN ? a.ww1_k0[c] : ldf(a_ww_1, x0));
  }
  float scan = seed;       // raw scan value at level k
  float wdtn = 0.f;        // wdtn(k0): no flux through the surface
  float t1_k = ldf(a_t_1, x0);
  const wsolve::Coef wc{a.rdnw, a.aw,  a.cpv, a.denv, a.crdn,
                        a.erdn, a.c_w, a.g_t, a.beta, a.alfa};
  wsolve::Fwd wf;
  for (int k = k0; k <= k1; ++k) {
    const size_t x = col + (size_t)k * I;
    if (WW_MODE != kLite) {
      const float ww_new = scan - ldf(a_ww_1, x);
      a.ww[x] = ww_new;
      if (CAPTURE) a.cap_ww[x] = ww_new;  // beside theta, to its own buffer
    }
    float scan_up = 0.f, t1_up = 0.f, wdtn_up = 0.f;  // level k+1 (0 above k1)
    if (k < k1) {
      scan_up = scan + (-a.dnw[k] * ((dmdt + s[k * bdx]) + mt)) * rmsfty;
      t1_up = ldf(a_t_1, x + I);
      const float ww_up =
          (WW_MODE == kLite && LEAN) ? scan_up : scan_up - ldf(a_ww_1, x + I);
      wdtn_up = ww_up * (a.fnm[k + 1] * t1_up + a.fnp[k + 1] * t1_k);
    }
    const float vert = a.rdnw[k] * (wdtn_up - wdtn);

    const float t_c = a.t[x];
    if (WITH_TAVE) a.t_ave[x] = t_c;
    const float t_half =
        LEAN ? t_c + ldf(a_tconst, x) : t_c + dts_msfty * ldf(a_ft, x);

    const size_t xe = x - i + ip, xw = x - i + im, xn = x + row, xs = x - row;
    const float u_c = FUSE_UV ? ldf(a_u, x) + du_c : ldf(a_u, x) * ws;
    const float u_e = FUSE_UV ? ldf(a_u, xe) + du_e : ldf(a_u, xe) * ws;
    const float v_c = FUSE_UV ? ldf(a_v, x) + dv_c : ldf(a_v, x) * ws;
    const float v_n =
        FUSE_UV ? (OVERLAP ? v_north[(size_t)k * I] : ldf(a_v, xn)) + dv_n
                : ldf(a_v, xn) * ws;
    const float fy =
        v_n * (ldf(a_t_1, xn) + t1_k) - v_c * (t1_k + ldf(a_t_1, xs));
    const float fx =
        u_e * (ldf(a_t_1, xe) + t1_k) - u_c * (t1_k + ldf(a_t_1, xw));
    const float horiz = msftx_c * (hrdy * fy + hrdx * fx);
    const float t_new = t_half - dts_msfty * (horiz + vert);
    a.t[x] = t_new;
    if (FUSE_W) {  // dvdxi(k) in s[k] is consumed: the slot takes dpw(k)
      wsolve::w_forward_level(wc, wf, a.w + col, a.pp + col, I, k, k0, k1,
                              t_new, s, bdx);
    }

    scan = scan_up;
    wdtn = wdtn_up;
    t1_k = t1_up;
  }
  if (FUSE_W) wsolve::w_backward(wc, a.w + col, a.pp + col, I, k0, k1, s, bdx);
}

template <bool FUSE_UV, bool LEAN, int WW_MODE, bool WITH_TAVE, bool FUSE_W,
          bool DAMP, bool OVERLAP, typename CT, bool CAPTURE = false>
cudaError_t launch(const Args& a, int block_x, cudaStream_t stream) {
  const dim3 block(block_x);
  const dim3 grid((a.I + block_x - 1) / block_x, a.J);
  const size_t smem = (size_t)a.K * block_x * sizeof(float);
  advance_mu_t_kernel<FUSE_UV, LEAN, WW_MODE, WITH_TAVE, FUSE_W, DAMP,
                      CAPTURE, OVERLAP, CT><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

// the full-ww path, the only one that can capture (the entry checks); a
// family built without CAPTURES refuses a capture
template <bool FUSE_UV, bool WITH_TAVE, bool FUSE_W, bool DAMP, bool OVERLAP,
          typename CT, bool CAPTURES>
cudaError_t launch_full(const Args& a, int block_x, cudaStream_t s) {
  if (a.cap_ww) {
    if constexpr (CAPTURES)
      return launch<FUSE_UV, false, kFull, WITH_TAVE, FUSE_W, DAMP, OVERLAP,
                    CT, true>(a, block_x, s);
    else
      return cudaErrorInvalidValue;
  }
  return launch<FUSE_UV, false, kFull, WITH_TAVE, FUSE_W, DAMP, OVERLAP, CT>(
      a, block_x, s);
}

// the modes of one (FUSE_UV, FUSE_W, DAMP, OVERLAP, CT) family
template <bool FUSE_UV, bool FUSE_W, bool DAMP, bool OVERLAP, typename CT,
          bool CAPTURES>
cudaError_t dispatch(const Args& a, int lean, int ww_mode, int with_tave,
                     int block_x, cudaStream_t s) {
  if (lean) {  // lean is a scan-substep mode: lite, no t_ave
    if (ww_mode != kLite || with_tave) return cudaErrorInvalidValue;
    return launch<FUSE_UV, true, kLite, false, FUSE_W, DAMP, OVERLAP, CT>(
        a, block_x, s);
  }
  switch (ww_mode * 2 + (with_tave ? 1 : 0)) {
    case kFull * 2:
      return launch_full<FUSE_UV, false, FUSE_W, DAMP, OVERLAP, CT, CAPTURES>(
          a, block_x, s);
    case kFull * 2 + 1:
      return launch_full<FUSE_UV, true, FUSE_W, DAMP, OVERLAP, CT, CAPTURES>(
          a, block_x, s);
    case kLite * 2:
      return launch<FUSE_UV, false, kLite, false, FUSE_W, DAMP, OVERLAP, CT>(
          a, block_x, s);
    case kLite * 2 + 1:
      return launch<FUSE_UV, false, kLite, true, FUSE_W, DAMP, OVERLAP, CT>(
          a, block_x, s);
    case kFinal * 2:
      return launch<FUSE_UV, false, kFinal, false, FUSE_W, DAMP, OVERLAP, CT>(
          a, block_x, s);
    case kFinal * 2 + 1:
      return launch<FUSE_UV, false, kFinal, true, FUSE_W, DAMP, OVERLAP, CT>(
          a, block_x, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// damping and the overlap exist only under the fused wind update (the
// entry checks)
template <bool FUSE_W, bool OVERLAP, typename CT, bool CAPTURES>
cudaError_t dispatch_uv(const Args& a, int fuse_uv, int lean, int ww_mode,
                        int with_tave, int block_x, cudaStream_t s) {
  if (!fuse_uv) {
    if constexpr (OVERLAP)
      return cudaErrorInvalidValue;
    else
      return dispatch<false, FUSE_W, false, false, CT, CAPTURES>(
          a, lean, ww_mode, with_tave, block_x, s);
  }
  return a.mudf_in ? dispatch<true, FUSE_W, true, OVERLAP, CT, CAPTURES>(
                         a, lean, ww_mode, with_tave, block_x, s)
                   : dispatch<true, FUSE_W, false, OVERLAP, CT, CAPTURES>(
                         a, lean, ww_mode, with_tave, block_x, s);
}

// What one source file instantiates: every mode of one (OVERLAP, CT).
template <bool OVERLAP, typename CT, bool CAPTURES>
cudaError_t dispatch_group(const Args& a, int fuse_uv, int lean, int ww_mode,
                           int with_tave, int fuse_w, int block_x,
                           cudaStream_t s) {
  return fuse_w ? dispatch_uv<true, OVERLAP, CT, CAPTURES>(
                      a, fuse_uv, lean, ww_mode, with_tave, block_x, s)
                : dispatch_uv<false, OVERLAP, CT, CAPTURES>(
                      a, fuse_uv, lean, ww_mode, with_tave, block_x, s);
}

// The four groups, one per source file (see the file comment).  The bf16
// groups build no capture instance: the wrapper widens a capture call's
// constant streams to float before the launch, which is exact.
cudaError_t launch_f32(const Args& a, int fuse_uv, int lean, int ww_mode,
                       int with_tave, int fuse_w, int block_x, cudaStream_t s);
cudaError_t launch_f32_overlap(const Args& a, int fuse_uv, int lean,
                               int ww_mode, int with_tave, int fuse_w,
                               int block_x, cudaStream_t s);
cudaError_t launch_bf16(const Args& a, int fuse_uv, int lean, int ww_mode,
                        int with_tave, int fuse_w, int block_x,
                        cudaStream_t s);
cudaError_t launch_bf16_overlap(const Args& a, int fuse_uv, int lean,
                                int ww_mode, int with_tave, int fuse_w,
                                int block_x, cudaStream_t s);

}  // namespace k1
