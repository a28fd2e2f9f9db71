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
// Geometry: one thread per (j, i) column of the padded local block, in
// blocks of 32 lanes along i (the contiguous axis, so a warp's loads at one
// level k are 32 neighbouring floats) by R rows along j (R = 1-4, chosen by
// the wrapper); the grid covers the block, so the ragged i edge wastes at
// most one warp per row and a row's north and south neighbours sit in the
// same block's L1, plus one more column of blocks for the pass-through of
// the columns outside the window (Edges).  No barrier: each thread runs
// its column's k loops itself (the reference CUDA kernel's geometry).  Two
// k passes per column:
//   pass 1 forms dvdxi(k) for k0..k1, sums dmdt in k order (the oracle's
//          order) and writes the updated winds;
//   pass 2 runs the ww scan from the seed and the theta update, with one
//          level of look-ahead, since vert(k) needs wdtn(k+1).  It loads
//          u and v at the same four points as pass 1, so it recomputes
//          dvdxi(k) there with the same expression (bit-equal) instead of
//          keeping pass 1's in memory.  Under FUSE_W the solve's forward
//          elimination rides this loop, level k right after t(k) is final,
//          and a third, descending loop back-substitutes and updates pp.
// Both k loops are software-pipelined in the source: the operands of level
// k + kAhead (1 or 2) are loaded into registers before level k's stores,
// because the compiler cannot move a load above a store it cannot prove
// distinct, and every store here goes through an Args member (see
// Buffers).  The constant streams and the 2-D operands are read with ldr /
// __ldg (const_stream.cuh) and the streams kept in their stored type until
// they are used; t, ww, w and pp with plain loads.
// The solve's K-long sweep state dpw lives in shared memory, a K-long slice
// per thread laid out [k][thread] so a warp hits 32 banks: FUSE_W instances
// launch with K * 4 bytes a thread of dynamic shared memory, the others with
// none, which leaves the SM's shared-memory carve-out to L1.  What the solve
// costs in device memory is w and pp read twice and written once (6 field
// passes, 4 of them compulsory: csrc/w_solve.cuh).
//
// Buffers, and the contract that makes loading ahead of stores safe: the
// kernel writes no operand.  Every field it updates goes to a fresh output
// buffer: u_out, v_out and mu_out (u, v and mu are read at neighbour
// columns and rows, and GPU blocks run in no fixed order), t_out, ww_out
// (full / final), ww_row_out (lite), t_ave_out (WITH_TAVE), w_out and pp_out
// (FUSE_W); also muave, muts, mudf and the captures.  The caller hands the
// outputs back as the next substep's inputs (nothing is copied), so the
// blocks a substep started from stay as they were: a memo keyed on them
// (models/stage_memo.py) outlives the launch.  Under damping mudf_in is the
// previous substep's mudf.  Which outputs a launch writes follows from the
// template flags (WW_MODE, WITH_TAVE, FUSE_W), never from a pointer.  The
// wrapper allocates the outputs, so none overlaps an input, and every load
// of a level may be issued before the stores of an earlier one.
//
// Edges: rows 0 and J-1 are never computed.  There, and in every column
// outside the compute window, the state passes through and muave, muts
// and mudf are zero — the TPU kernel's contract.  In a computed column the
// levels the k loops leave (t, t_ave, ww and pp outside k0..k1, w outside
// k0+1..k1) pass through too, into the fresh outputs.  In the rows that
// are computed, the columns outside the window are passed by the lanes of
// the grid's last column of blocks, not by their own: a lane of a warp that
// computes would hold the warp for its pass-through of every level of
// every field (on an H100 that made the final substep with fuse_w 17 %
// slower at 1205x35x1505, PERF.md).  The captures follow their outputs (ww
// and mu pass through outside the window and the k range), except that
// rows 0 and J-1 of all five are zero.  The i-1 / i+1
// neighbours wrap around the row as the TPU kernel's lane rolls do; the
// window masks make the wrapped values unused.
//
// Bound: memory.  The lean scan substep streams nine 3-D float32 field
// passes (reads u, v, t, t_1, tconst, dvdxi_const; writes u, v, t) and does
// a few dozen flops per cell; pass 2 re-reads u, v, dvdxi_const and the t_1
// neighbours, which the design leaves to the L1/L2 caches.  Times on the
// card are in PERF.md.
//
// Numerics: built with -fmad=false (no multiply-add contraction) and IEEE
// division.  Every expression, and the k order of the dmdt column sum,
// follows the plain version, so the two agree bit for bit (measured on the
// card in every mode: PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "const_stream.cuh"
#include "w_solve.cuh"

namespace k1 {

enum WwMode { kFull = 0, kLite = 1, kFinal = 2 };

constexpr int kLanes = 32;       // threads of a block along i
constexpr int kMaxRows = 4;      // rows of a block along j, at most

struct Args {
  // 3-D fields (J, K, I); the void pointers are the constant streams, of
  // the kernel's CT (u and v: float under FUSE_UV)
  const float* ww;
  const void* ww_1;
  const void* u;
  const void* u_1;
  const void* v;
  const void* v_1;
  const float* t;
  const void* t_1;
  const float* t_ave;
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
  const float* ww_row;
  const float* ww1_k0;
  // vertical vectors (K)
  const float* dnw;
  const float* fnm;
  const float* fnp;
  const float* rdnw;
  // the w/pp solve (FUSE_W): state and K-vectors
  const float* w;
  const float* pp;
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
  float* t_out;
  float* ww_out;      // WW_MODE full / final
  float* t_ave_out;   // WITH_TAVE
  float* ww_row_out;  // WW_MODE lite
  float* w_out;       // FUSE_W
  float* pp_out;      // FUSE_W
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
__global__ void __launch_bounds__(kLanes * kMaxRows)
advance_mu_t_kernel(const Args a) {
  extern __shared__ float s_dpw[];  // FUSE_W: [K][threads of the block]
  // Levels loaded ahead of the stores, measured on an H100 (PERF.md): one
  // for the lite substeps without the w solve and for the full and final
  // ones with it but without the wind update (as fast as two, and two make
  // ptxas spill there), two for the rest.
  constexpr int kAhead =
      (WW_MODE == kLite ? !FUSE_W : (FUSE_W && !FUSE_UV)) ? 1 : 2;
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
  const int I = a.I, K = a.K;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= a.J) return;  // no block-wide barrier below
  const size_t row = (size_t)K * I;  // one j row of a 3-D field
  const int jg = j + a.j_off;
  const bool j_in = jg >= a.j0 && jg <= a.j1;
  // a row whose columns in the window are computed
  const bool row_in = j >= 1 && j <= a.J - 2 && j_in;
  // the columns outside the window: local 0..lo-1 and hi..I-1
  const int lo = min(max(a.i0 - a.i_off, 0), I);
  const int hi = max(lo, min(a.i1 - a.i_off + 1, I));

  // The state's pass-through: levels kb..ke-1 of the column at col (its
  // level 0) of every field the launch carries (t; ww under full / final;
  // t_ave; w and pp under FUSE_W) and, with winds, of u and v under
  // FUSE_UV, into the outputs; with cap also into the capture of ww
  // (zero_cap: zero there).  kEdgeChunk levels of all of them are loaded
  // before any is stored: 4, measured on an H100 (more raise the
  // registers of every instance, fewer add round trips), and 2 in the
  // bf16 instances, at which ptxas spills none of them.
  constexpr int kEdgeChunk = std::is_same<CT, float>::value ? 4 : 2;
  auto pass = [&](size_t col, int kb, int ke, bool winds, bool cap,
                  bool zero_cap) {
    for (; kb < ke; kb += kEdgeChunk) {
      float uu[kEdgeChunk], vv[kEdgeChunk], tt[kEdgeChunk], ww[kEdgeChunk],
          ta[kEdgeChunk], w[kEdgeChunk], pp[kEdgeChunk];
#pragma unroll
      for (int q = 0; q < kEdgeChunk; ++q) {
        const size_t x = col + (size_t)(kb + q) * I;
        if (kb + q < ke) {
          if (FUSE_UV && winds) {
            uu[q] = f32(ldr(a_u, x));
            vv[q] = f32(ldr(a_v, x));
          }
          tt[q] = a.t[x];
          if (WW_MODE != kLite) ww[q] = a.ww[x];
          if (WITH_TAVE) ta[q] = a.t_ave[x];
          if (FUSE_W) {
            w[q] = a.w[x];
            pp[q] = a.pp[x];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kEdgeChunk; ++q) {
        const size_t x = col + (size_t)(kb + q) * I;
        if (kb + q < ke) {
          if (FUSE_UV && winds) {
            a.u_out[x] = uu[q];
            a.v_out[x] = vv[q];
          }
          a.t_out[x] = tt[q];
          if (WW_MODE != kLite) a.ww_out[x] = ww[q];
          if (WITH_TAVE) a.t_ave_out[x] = ta[q];
          if (FUSE_W) {
            a.w_out[x] = w[q];
            a.pp_out[x] = pp[q];
          }
          if (CAPTURE && cap) a.cap_ww[x] = zero_cap ? 0.f : ww[q];
        }
      }
    }
  };
  // a column never computed (rows 0 and J-1, and outside the window): the
  // state passes through, muave, muts and mudf are zero
  auto pass_column = [&](int i) {
    const int c = j * I + i;
    a.mu_out[c] = __ldg(a.mu + c);
    if (WW_MODE == kLite) a.ww_row_out[c] = a.ww_row[c];
    a.muave[c] = 0.f;
    a.muts[c] = 0.f;
    a.mudf[c] = 0.f;
    const bool edge = j < 1 || j > a.J - 2;
    pass((size_t)j * row + i, 0, K, true, true, edge);
    if (CAPTURE) {  // the outputs' values; all zero on rows 0 and J-1
      a.cap_muave[c] = 0.f;
      a.cap_mu[c] = edge ? 0.f : __ldg(a.mu + c);
      a.cap_mudf[c] = 0.f;
      a.cap_muts[c] = 0.f;
    }
  };

  if (blockIdx.x == gridDim.x - 1) {
    // The last column of blocks takes the columns outside the window of
    // the rows that are computed, its lanes in turn, so that the warps that
    // compute never wait on a lane's pass-through.
    if (row_in)
      for (int e = threadIdx.x; e < lo + I - hi; e += blockDim.x)
        pass_column(e < lo ? e : hi + e - lo);
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I) return;
  if (!row_in) {
    pass_column(i);
    return;
  }
  if (i < lo || i >= hi) return;  // the last column of blocks passes it
  const size_t col = (size_t)j * row + i;  // (j, k=0, i); level k adds k*I
  const int c = j * I + i;                 // (j, i) of a 2-D field
  const int ig = i + a.i_off;

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
  // every 2-D operand is read here, before the first store
  const float msftx_c = __ldg(a.msftx + c);
  const float msfty_c = __ldg(a.msfty + c);
  const float msft2 = msftx_c * msfty_c;
  const float muu_msfuy_c = __ldg(a.muu + c) / __ldg(a.msfuy + c);
  const float muu_msfuy_e = __ldg(a.muu + ce) / __ldg(a.msfuy + ce);
  const float muv_msfvxi_c = __ldg(a.muv + c) * __ldg(a.msfvx_inv + c);
  const float muv_msfvxi_n =
      __ldg(a.muv + c + I) * __ldg(a.msfvx_inv + c + I);
  const float mu_c = __ldg(a.mu + c);
  const float mt = __ldg(a.mu_tend + c);
  const float mut_c = __ldg(a.mut + c);

  // Wind increments of this column's u(i), u(i+1), v(j), v(j+1): each
  // thread recomputes its neighbours' updated winds instead of reading
  // them, with the u/v window evaluated at the neighbour.
  float du_c = 0.f, du_e = 0.f, dv_c = 0.f, dv_n = 0.f;
  if (FUSE_UV) {
    const float cs2 = a.cs2;
    float p_c = cs2 * mu_c;
    float p_w = cs2 * __ldg(a.mu + cw);
    float p_e = cs2 * __ldg(a.mu + ce);
    // OVERLAP: the edge rows take the halo rows from the ring neighbours
    const bool lo_edge = OVERLAP && j == 1;
    const bool hi_edge = OVERLAP && j == a.J - 2;
    float p_s = cs2 * (lo_edge ? __ldg(a.mu_lo + i) : __ldg(a.mu + c - I));
    float p_n = cs2 * (hi_edge ? __ldg(a.mu_hi + i) : __ldg(a.mu + c + I));
    if (DAMP) {  // divergence damping: two roundings and a sum each
      const float dampc = a.dampc;
      p_c = p_c + dampc * __ldg(a.mudf_in + c);
      p_w = p_w + dampc * __ldg(a.mudf_in + cw);
      p_e = p_e + dampc * __ldg(a.mudf_in + ce);
      p_s = p_s + dampc * (lo_edge ? __ldg(a.mudf_lo + i)
                                   : __ldg(a.mudf_in + c - I));
      p_n = p_n + dampc * (hi_edge ? __ldg(a.mudf_hi + i)
                                   : __ldg(a.mudf_in + c + I));
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

  // ---- what a level loads, and the arithmetic both passes share ----------
  // The constant streams stay in their stored type CT (the winds in WT)
  // from the load to the use, where f32 widens them.
  struct RawWind {  // u, v at x and at the east / north neighbours
    WT u_c, u_e, v_c, v_n;
  };
  struct Wind {  // the same as the substep uses them
    float u_c, u_e, v_c, v_n;
  };
  struct Flux {  // the static-flux operands of dvdxi(k)
    CT dc;                  // LEAN: dvdxi_const(x)
    CT v1c, v1n, u1c, u1e;  // otherwise: v_1, u_1 at x, xn, x, xe
  };
  // the winds at level k at x (whole: also at xe and xn)
  auto load_wind = [&](size_t x, int k, bool whole) {
    RawWind w{};
    w.u_c = ldr(a_u, x);
    w.v_c = ldr(a_v, x);
    if (whole) {
      w.u_e = ldr(a_u, x - i + ip);
      if constexpr (OVERLAP)
        w.v_n = __ldg(v_north + (size_t)k * I);
      else
        w.v_n = ldr(a_v, x + row);
    }
    return w;
  };
  auto load_flux = [&](size_t x) {
    Flux f{};
    if (LEAN) {
      f.dc = ldr(a_dvdxi_const, x);
    } else {
      const size_t xe = x - i + ip, xn = x + row;
      f.v1c = ldr(a_v_1, x);
      f.v1n = ldr(a_v_1, xn);
      f.u1c = ldr(a_u_1, x);
      f.u1e = ldr(a_u_1, xe);
    }
    return f;
  };
  // the winds as the substep uses them: updated (FUSE_UV) or scaled
  auto winds = [&](const RawWind& w) {
    Wind o;
    o.u_c = FUSE_UV ? f32(w.u_c) + du_c : f32(w.u_c) * ws;
    o.u_e = FUSE_UV ? f32(w.u_e) + du_e : f32(w.u_e) * ws;
    o.v_c = FUSE_UV ? f32(w.v_c) + dv_c : f32(w.v_c) * ws;
    o.v_n = FUSE_UV ? f32(w.v_n) + dv_n : f32(w.v_n) * ws;
    return o;
  };
  auto dvdxi_of = [&](const Wind& w, const Flux& f) {
    if (LEAN)
      return f32(f.dc) +
             msft2 * (rdy * (w.v_n - w.v_c) + rdx * (w.u_e - w.u_c));
    const float vflux = w.v_c + muv_msfvxi_c * f32(f.v1c);
    const float vflux_n = w.v_n + muv_msfvxi_n * f32(f.v1n);
    const float uflux = w.u_c + muu_msfuy_c * f32(f.u1c);
    const float uflux_e = w.u_e + muu_msfuy_e * f32(f.u1e);
    return msft2 * (rdy * (vflux_n - vflux) + rdx * (uflux_e - uflux));
  };

  // ---- pass 1: winds out, dmdt -----------------------------------------
  const int k0 = a.k0, k1 = a.k1;
  // the levels the k loops leave pass through, w's level k0 too
  pass(col, 0, k0, false, false, false);
  pass(col, k1 + 1, K, false, false, false);
  if (FUSE_W) a.w_out[col + (size_t)k0 * I] = a.w[col + (size_t)k0 * I];
  struct L1 {
    RawWind w;
    Flux f;
    float dnw;
  };
  auto load_l1 = [&](int k) {
    L1 l{};
    const size_t x = col + (size_t)k * I;
    const bool in = k >= k0 && k <= k1;  // FUSE_UV moves the winds at all k
    l.w = load_wind(x, k, in);
    if (in) {
      l.f = load_flux(x);
      l.dnw = __ldg(a.dnw + k);
    }
    return l;
  };
  const int kb1 = FUSE_UV ? 0 : k0, ke1 = FUSE_UV ? K - 1 : k1;
  L1 q1[kAhead];
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    if (kb1 + d <= ke1) q1[d] = load_l1(kb1 + d);
  float dmdt = 0.f;
  for (int k = kb1; k <= ke1; ++k) {
    L1 nx{};
    if (k + kAhead <= ke1) nx = load_l1(k + kAhead);  // before the stores
    const L1 l = q1[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) q1[d] = q1[d + 1];
    q1[kAhead - 1] = nx;
    const Wind w = winds(l.w);
    if (FUSE_UV) {
      const size_t x = col + (size_t)k * I;
      a.u_out[x] = w.u_c;
      a.v_out[x] = w.v_c;
    }
    if (!FUSE_UV || (k >= k0 && k <= k1)) dmdt += l.dnw * dvdxi_of(w, l.f);
  }

  // ---- pass 2's first levels, loaded before the column's 2-D stores ------
  struct L2 {
    RawWind w;
    Flux f;                 // k < k1
    float t;                // t at x
    CT th;                  // tconst (LEAN) or ft at x
    CT t1n, t1s, t1e, t1w;  // t_1 at the four neighbours
    float dnw, rdnw;
    float w_up, pp;            // FUSE_W: w(k+1), pp(k)
  };
  struct Up {  // level k's values that level k-1 reads
    CT t1, ww1;
    float fnm, fnp;
  };
  // ww_1 is read unless the lean lite scan carries the raw value
  constexpr bool kWw1 = !(WW_MODE == kLite && LEAN);
  auto load_l2 = [&](int k) {
    L2 l{};
    const size_t x = col + (size_t)k * I;
    l.w = load_wind(x, k, true);
    if (k < k1) {
      l.f = load_flux(x);
      l.dnw = __ldg(a.dnw + k);
    }
    l.t = a.t[x];
    l.th = LEAN ? ldr(a_tconst, x) : ldr(a_ft, x);
    l.t1n = ldr(a_t_1, x + row);
    l.t1s = ldr(a_t_1, x - row);
    l.t1e = ldr(a_t_1, x - i + ip);
    l.t1w = ldr(a_t_1, x - i + im);
    l.rdnw = __ldg(a.rdnw + k);
    if (FUSE_W) {
      l.w_up = (k < k1) ? a.w[x + I] : 0.f;
      l.pp = a.pp[x];
    }
    return l;
  };
  auto load_up = [&](int k) {
    Up u{};
    const size_t x = col + (size_t)k * I;
    u.t1 = ldr(a_t_1, x);
    if (kWw1) u.ww1 = ldr(a_ww_1, x);
    u.fnm = __ldg(a.fnm + k);
    u.fnp = __ldg(a.fnp + k);
    return u;
  };
  const size_t x0 = col + (size_t)k0 * I;
  L2 q2[kAhead];
  Up up[kAhead];  // up[d]: level k + 1 + d
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
    if (k0 + d <= k1) q2[d] = load_l2(k0 + d);
    if (k0 + 1 + d <= k1) up[d] = load_up(k0 + 1 + d);
  }
  float t1_k = f32(ldr(a_t_1, x0));                 // t_1 at level k
  float ww1_k = kWw1 ? f32(ldr(a_ww_1, x0)) : 0.f;  // ww_1 at level k
  const float seed = (WW_MODE == kFull) ? a.ww[x0] : a.ww_row[c];

  // ---- column mass -------------------------------------------------------
  const float tend = dmdt + mt;
  const float mu_new = mu_c + dts * tend;
  a.mu_out[c] = mu_new;
  a.mudf[c] = tend;
  const float muts_new = mut_c + mu_new;
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
  const float rmsfty = 1.0f / msfty_c;
  const float dts_msfty = dts * msfty_c;
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  if (WW_MODE == kLite) {
    // the next substep's seed; in lean mode ww_1 lives in tconst and
    // the scan below carries the raw value
    a.ww_row_out[c] = seed - (LEAN ? __ldg(a.ww1_k0 + c) : ww1_k);
  }
  float scan = seed;       // raw scan value at level k
  float wdtn = 0.f;        // wdtn(k0): no flux through the surface
  const wsolve::Coef wc{a.rdnw, a.aw,  a.cpv, a.denv, a.crdn,
                        a.erdn, a.c_w, a.g_t, a.beta, a.alfa};
  wsolve::Fwd wf;
  const size_t nthreads = (size_t)blockDim.x * blockDim.y;
  float* const s = s_dpw + threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = k0; k <= k1; ++k) {
    L2 nx{};
    Up nu{};
    if (k + kAhead <= k1) nx = load_l2(k + kAhead);  // before the stores
    if (k + 1 + kAhead <= k1) nu = load_up(k + 1 + kAhead);
    const L2 l = q2[0];
    const Up u = up[0];
#pragma unroll
    for (int d = 0; d + 1 < kAhead; ++d) {
      q2[d] = q2[d + 1];
      up[d] = up[d + 1];
    }
    q2[kAhead - 1] = nx;
    up[kAhead - 1] = nu;

    const size_t x = col + (size_t)k * I;
    if (WW_MODE != kLite) {
      const float ww_new = scan - ww1_k;
      a.ww_out[x] = ww_new;
      if (CAPTURE) a.cap_ww[x] = ww_new;  // beside theta, to its own buffer
    }
    const Wind w = winds(l.w);
    float scan_up = 0.f, t1_up = 0.f, wdtn_up = 0.f;  // level k+1 (0 above k1)
    if (k < k1) {
      scan_up = scan + (-l.dnw * ((dmdt + dvdxi_of(w, l.f)) + mt)) * rmsfty;
      t1_up = f32(u.t1);
      const float ww_up =
          (WW_MODE == kLite && LEAN) ? scan_up : scan_up - f32(u.ww1);
      wdtn_up = ww_up * (u.fnm * t1_up + u.fnp * t1_k);
    }
    const float vert = l.rdnw * (wdtn_up - wdtn);

    const float t_c = l.t;
    if (WITH_TAVE) a.t_ave_out[x] = t_c;
    const float th = f32(l.th);
    const float t_half = LEAN ? t_c + th : t_c + dts_msfty * th;
    const float fy =
        w.v_n * (f32(l.t1n) + t1_k) - w.v_c * (t1_k + f32(l.t1s));
    const float fx =
        w.u_e * (f32(l.t1e) + t1_k) - w.u_c * (t1_k + f32(l.t1w));
    const float horiz = msftx_c * (hrdy * fy + hrdx * fx);
    const float t_new = t_half - dts_msfty * (horiz + vert);
    a.t_out[x] = t_new;
    if (FUSE_W)
      wsolve::w_forward_step(wc, wf, k, k0, t_new, l.w_up, l.pp, s, nthreads);

    scan = scan_up;
    wdtn = wdtn_up;
    t1_k = t1_up;
    ww1_k = f32(u.ww1);
  }
  if (FUSE_W)
    wsolve::w_backward(wc, a.w + col, a.pp + col, a.w_out + col,
                       a.pp_out + col, I, k0, k1, s, nthreads);
}

// The launch: blocks of kLanes x rows threads over the (J, I) columns, and
// under FUSE_W K floats of shared memory per thread (the wrapper's
// launch_shape computes the same).
template <bool FUSE_UV, bool LEAN, int WW_MODE, bool WITH_TAVE, bool FUSE_W,
          bool DAMP, bool OVERLAP, typename CT, bool CAPTURE = false>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  const dim3 block(kLanes, rows);
  // one more column of blocks for the columns outside the window
  const dim3 grid((a.I + kLanes - 1) / kLanes + 1, (a.J + rows - 1) / rows);
  const size_t smem = FUSE_W ? (size_t)a.K * kLanes * rows * sizeof(float) : 0;
  advance_mu_t_kernel<FUSE_UV, LEAN, WW_MODE, WITH_TAVE, FUSE_W, DAMP,
                      CAPTURE, OVERLAP, CT><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

// the full-ww path, the only one that can capture (the entry checks); a
// family built without CAPTURES refuses a capture
template <bool FUSE_UV, bool WITH_TAVE, bool FUSE_W, bool DAMP, bool OVERLAP,
          typename CT, bool CAPTURES>
cudaError_t launch_full(const Args& a, int rows, cudaStream_t s) {
  if (a.cap_ww) {
    if constexpr (CAPTURES)
      return launch<FUSE_UV, false, kFull, WITH_TAVE, FUSE_W, DAMP, OVERLAP,
                    CT, true>(a, rows, s);
    else
      return cudaErrorInvalidValue;
  }
  return launch<FUSE_UV, false, kFull, WITH_TAVE, FUSE_W, DAMP, OVERLAP, CT>(
      a, rows, s);
}

// the modes of one (FUSE_UV, FUSE_W, DAMP, OVERLAP, CT) family
template <bool FUSE_UV, bool FUSE_W, bool DAMP, bool OVERLAP, typename CT,
          bool CAPTURES>
cudaError_t dispatch(const Args& a, int lean, int ww_mode, int with_tave,
                     int rows, cudaStream_t s) {
  if (lean) {  // lean is a scan-substep mode: lite, no t_ave
    if (ww_mode != kLite || with_tave) return cudaErrorInvalidValue;
    return launch<FUSE_UV, true, kLite, false, FUSE_W, DAMP, OVERLAP, CT>(
        a, rows, s);
  }
  switch (ww_mode * 2 + (with_tave ? 1 : 0)) {
    case kFull * 2:
      return launch_full<FUSE_UV, false, FUSE_W, DAMP, OVERLAP, CT, CAPTURES>(
          a, rows, s);
    case kFull * 2 + 1:
      return launch_full<FUSE_UV, true, FUSE_W, DAMP, OVERLAP, CT, CAPTURES>(
          a, rows, s);
    case kLite * 2:
      return launch<FUSE_UV, false, kLite, false, FUSE_W, DAMP, OVERLAP, CT>(
          a, rows, s);
    case kLite * 2 + 1:
      return launch<FUSE_UV, false, kLite, true, FUSE_W, DAMP, OVERLAP, CT>(
          a, rows, s);
    case kFinal * 2:
      return launch<FUSE_UV, false, kFinal, false, FUSE_W, DAMP, OVERLAP, CT>(
          a, rows, s);
    case kFinal * 2 + 1:
      return launch<FUSE_UV, false, kFinal, true, FUSE_W, DAMP, OVERLAP, CT>(
          a, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// damping and the overlap exist only under the fused wind update (the
// entry checks)
template <bool FUSE_W, bool OVERLAP, typename CT, bool CAPTURES>
cudaError_t dispatch_uv(const Args& a, int fuse_uv, int lean, int ww_mode,
                        int with_tave, int rows, cudaStream_t s) {
  if (!fuse_uv) {
    if constexpr (OVERLAP)
      return cudaErrorInvalidValue;
    else
      return dispatch<false, FUSE_W, false, false, CT, CAPTURES>(
          a, lean, ww_mode, with_tave, rows, s);
  }
  return a.mudf_in ? dispatch<true, FUSE_W, true, OVERLAP, CT, CAPTURES>(
                         a, lean, ww_mode, with_tave, rows, s)
                   : dispatch<true, FUSE_W, false, OVERLAP, CT, CAPTURES>(
                         a, lean, ww_mode, with_tave, rows, s);
}

// What one source file instantiates: every mode of one (OVERLAP, CT).
template <bool OVERLAP, typename CT, bool CAPTURES>
cudaError_t dispatch_group(const Args& a, int fuse_uv, int lean, int ww_mode,
                           int with_tave, int fuse_w, int rows,
                           cudaStream_t s) {
  return fuse_w ? dispatch_uv<true, OVERLAP, CT, CAPTURES>(
                      a, fuse_uv, lean, ww_mode, with_tave, rows, s)
                : dispatch_uv<false, OVERLAP, CT, CAPTURES>(
                      a, fuse_uv, lean, ww_mode, with_tave, rows, s);
}

// The four groups, one per source file (see the file comment).  The bf16
// groups build no capture instance: the wrapper widens a capture call's
// constant streams to float before the launch, which is exact.
cudaError_t launch_f32(const Args& a, int fuse_uv, int lean, int ww_mode,
                       int with_tave, int fuse_w, int rows, cudaStream_t s);
cudaError_t launch_f32_overlap(const Args& a, int fuse_uv, int lean,
                               int ww_mode, int with_tave, int fuse_w,
                               int rows, cudaStream_t s);
cudaError_t launch_bf16(const Args& a, int fuse_uv, int lean, int ww_mode,
                        int with_tave, int fuse_w, int rows,
                        cudaStream_t s);
cudaError_t launch_bf16_overlap(const Args& a, int fuse_uv, int lean,
                                int ww_mode, int with_tave, int fuse_w,
                                int rows, cudaStream_t s);

}  // namespace k1
