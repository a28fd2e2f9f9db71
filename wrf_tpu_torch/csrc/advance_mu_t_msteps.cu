// K2 — S temporally-blocked lean/lite mu/t substeps on NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel wrf_tpu/ops/advance_mu_t_msteps.py::_kernel,
// launched there by advance_mu_t_multistep_pallas.  It runs S scan
// substeps of the mu/t loop (parallel/sharded.py ShardedAdvanceMuT) in one
// pass: each is K1's lean/lite substep (csrc/advance_mu_t_kernel.cuh, LEAN,
// WW_MODE lite, no FUSE_UV) with the winds scaled on load by the ramp
// ws(s) = 1 + (w0 + s)*dw.  The plain PyTorch version of the same
// arithmetic is advance_mu_t_multistep_plain in
// wrf_tpu_torch/ops/advance_mu_t_msteps_cuda.py.
//
// Why it can block in time: consecutive substeps of this loop couple only
// pointwise.  t feeds the next substep at its own (j, k, i) — every stencil
// neighbour the theta update reads is of the constant base t_1 — mu is
// updated from the winds alone, and ww enters the next substep only
// through its k0 seed row.  So a column can run all S substeps without
// any other column's results.
//
// Geometry: one thread per (j, i) column (K1's and the reference's);
// threadIdx.x runs along i, the contiguous axis, in 32-wide warps, and
// threadIdx.y over 4 rows, so only the last warp of a row is ragged.
// Rows 0 and J-1 are never computed; columns outside the compute window
// are left untouched (the TPU kernel's contract: state passes through).
//
// Loop order — the design's point.  K1 walks the column once per substep,
// so S substeps stream the constants (u, v, t_1, tconst, dvdxi_const) S
// times.  Here the level loop is outside and the substep loop inside, over
// a chunk of up to kChunk substeps whose per-substep state (wind scale,
// dmdt, the ww scan value and the vertical flux at the level below) lives
// in registers:
//   pass 1, k ascending: load the level's winds and dvdxi_const once and
//           add dnw(k)*dvdxi(s, k) to each substep's dmdt(s), in k order;
//   then mu and the scan seeds advance through the chunk's substeps;
//   pass 2, k ascending: load the level's winds, t_1 and its neighbours,
//           tconst and t once; for each substep in order run the ww scan
//           step, the vertical flux (one level of look-ahead, as K1) and
//           the theta update — t(k) is pointwise across substeps, so it
//           stays in a register through the chunk and is written once.
// Per chunk the constants are read twice (pass 2 re-reads the winds and
// dvdxi_const, which the design leaves to L1/L2, as K1 does) and t is read
// and written once, whatever the chunk's length.  Substeps past kChunk run
// as further chunks of the same pass (t re-read from this thread's own
// column).
//
// Loads ahead of the store.  Every level's operands are loaded kAhead levels
// before they are used: the loop keeps a ring of kAhead levels in registers
// and loads level k + kAhead before it stores t at level k, because the
// compiler cannot move a load above a store it cannot prove distinct, and
// the store to t goes through an Args member.  The operands that no thread
// writes (every input but t, mu and ww_row) are read with ldr
// (const_stream.cuh) and kept in their stored type until they are used.
// That is legal because no buffer the launch writes overlaps one it only
// reads: the wrapper raises otherwise (ops/advance_mu_t_msteps_cuda.py).
// Pass 1 stores nothing; its ring only keeps more loads in flight.
//
// FAST: the TPU kernel's closed form (msteps.py:481-568).  The substep is
// affine in (1, s, ws), so the S theta increments sum to
// S*G0 + S(S-1)/2*G1 + sum(ws)*G2 with G* from two column sums and two
// sequential k cumsums of the constant and the wind-proportional parts:
// one pass 1 and one pass 2 per launch, whatever S.  Held to a tolerance,
// not to bit-equality.  Its pass 2 reads and writes t at each level, with
// the same ring of loads ahead of the store.
//
// CT, the element type of the constant streams u, v, t_1, tconst and
// dvdxi_const (float or __nv_bfloat16): they are widened to float where
// they are used (exact), once per level and chunk, outside the substep
// loop; t, mu, ww_row and all arithmetic stay float.
//
// Bound: memory (a few dozen flops per level and substep against ~11 loads
// per level shared by the chunk).  On an H100 a launch takes nearly as long
// at S=2 as at S=8, and a form that skips pass 2's re-reads gains 1.5 % at
// S=8: what holds it is the rate at which one thread per column, walking its
// levels, moves bytes (as in K1), not the store to t, the re-reads or the
// arithmetic.  Times on the card are in PERF.md.
//
// Numerics: built with -fmad=false and IEEE division.  Every expression of
// the exact mode is K1's lean/lite expression in K1's order, the wind ramp
// is the TPU kernel's association (msteps.py:582), and the dmdt column sum
// runs in k order, so S substeps here equal S K1 launches bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "const_stream.cuh"

namespace {

constexpr int kChunk = 8;    // substeps whose state is held in registers
// Levels loaded ahead of their use, measured on an H100 (PERF.md): one for
// the exact kernel (two spilled and three cost it registers and residency
// at S=8), three for the fast kernel.
constexpr int kAhead = 1;
constexpr int kAheadFast = 3;
constexpr int kBlockX = 32;  // threads along i (one warp)
constexpr int kBlockY = 4;   // rows per block

struct Args {
  // 3-D fields (J, K, I); the void pointers are the constant streams (CT)
  const void* u;
  const void* v;
  float* t;  // updated in place
  const void* t_1;
  const void* tconst;
  const void* dvdxi_const;
  // 2-D fields (J, I)
  const float* ww1_k0;
  float* ww_row;  // updated in place
  float* mu;      // updated in place
  const float* mu_tend;
  const float* msftx;
  const float* msfty;
  // vertical vectors (K)
  const float* dnw;
  const float* fnm;
  const float* fnp;
  const float* rdnw;
  float rdx, rdy, dts;
  float w0, dw;  // wind ramp: ws(s) = 1 + (w0 + s)*dw
  int J, K, I;
  int i0, i1, j0, j1;  // compute window, global coordinates
  int j_off, i_off;    // global index of local row / column 0
  int k0, k1;
  int n_inner;  // S
};

// What a column thread needs besides the level loop: its indices and the
// 2-D coefficients of its column.
struct Column {
  size_t col;  // (j, k=0, i); level k adds k*I
  size_t row;  // one j row of a 3-D field
  int c2;      // (j, i) of a 2-D field
  int i, ip, im;
  float msft2, msftx, rmsfty, dts_msfty, mt;
};

// Sets up the thread's column; false for threads without one (past the
// row's end, edge rows, outside the window), which then do nothing.
__device__ bool column(const Args& a, Column& c) {
  const int i = blockIdx.x * kBlockX + threadIdx.x;
  const int j = 1 + blockIdx.y * kBlockY + threadIdx.y;  // rows 1..J-2
  if (i >= a.I || j > a.J - 2) return false;
  const int ig = i + a.i_off, jg = j + a.j_off;
  if (!(ig >= a.i0 && ig <= a.i1 && jg >= a.j0 && jg <= a.j1)) return false;
  const int I = a.I;
  const int c2 = j * I + i;
  c.c2 = c2;
  c.row = (size_t)a.K * I;
  c.col = (size_t)j * c.row + i;
  c.i = i;
  c.ip = (i + 1 == I) ? 0 : i + 1;  // east neighbour, wrapping
  c.im = (i == 0) ? I - 1 : i - 1;  // west neighbour, wrapping
  c.msft2 = a.msftx[c2] * a.msfty[c2];
  c.msftx = a.msftx[c2];
  const float msfty = a.msfty[c2];
  c.rmsfty = 1.0f / msfty;
  c.dts_msfty = a.dts * msfty;
  c.mt = a.mu_tend[c2];
  return true;
}

// A level's operands as pass 1 and pass 2 read them, in their stored type.
template <typename CT>
struct Winds {  // u, v at x and at the east / north neighbours; dvdxi_const
  CT u_c, u_e, v_c, v_n, dc;
};

template <typename CT>
struct Level2 {
  Winds<CT> w;
  CT t1n, t1s, t1e, t1w;  // t_1 at the four neighbours
  CT tc;                  // tconst
  CT t1up;                // t_1 at level k+1 (k < k1)
  float t;                // the state, at x
  float dn, rdnw;         // dnw(k), rdnw(k)
  float fnm, fnp;         // fnm(k+1), fnp(k+1) (k < k1)
};

template <typename CT>
__device__ __forceinline__ Winds<CT> load_winds(const CT* a_u, const CT* a_v,
                                                const CT* a_dc,
                                                const Column& c, size_t x,
                                                bool with_dc) {
  Winds<CT> w{};
  w.u_c = ldr(a_u, x);
  w.u_e = ldr(a_u, x - c.i + c.ip);
  w.v_c = ldr(a_v, x);
  w.v_n = ldr(a_v, x + c.row);
  if (with_dc) w.dc = ldr(a_dc, x);
  return w;
}

// Pass 2's operands of level k (k1: the top of the column).
template <typename CT>
__device__ __forceinline__ Level2<CT> load_level2(
    const Args& a, const CT* a_u, const CT* a_v, const CT* a_dc,
    const CT* a_t_1, const CT* a_tconst, const Column& c, int k, int k1) {
  Level2<CT> l{};
  const size_t x = c.col + (size_t)k * a.I;
  const bool up = k < k1;
  l.w = load_winds(a_u, a_v, a_dc, c, x, up);  // dvdxi_const: below k1
  l.t1n = ldr(a_t_1, x + c.row);
  l.t1s = ldr(a_t_1, x - c.row);
  l.t1e = ldr(a_t_1, x - c.i + c.ip);
  l.t1w = ldr(a_t_1, x - c.i + c.im);
  l.tc = ldr(a_tconst, x);
  l.t = a.t[x];
  l.dn = __ldg(a.dnw + k);
  l.rdnw = __ldg(a.rdnw + k);
  if (up) {
    l.t1up = ldr(a_t_1, x + a.I);
    l.fnm = __ldg(a.fnm + k + 1);
    l.fnp = __ldg(a.fnp + k + 1);
  }
  return l;
}

// A ring of N levels: r[0] is level k, r[d] level k + d.  shift() drops
// level k and takes the level loaded ahead.
template <typename T, int N>
struct Ring {
  T r[N];
  __device__ __forceinline__ void shift(const T& next) {
#pragma unroll
    for (int d = 0; d + 1 < N; ++d) r[d] = r[d + 1];
    r[N - 1] = next;
  }
};

// The exact kernel's body; its two entries below differ only in their launch
// bounds.
template <typename CT>
__device__ __forceinline__ void msteps_exact(const Args& a) {
  Column c;
  if (!column(a, c)) return;
  const CT* const a_u = static_cast<const CT*>(a.u);
  const CT* const a_v = static_cast<const CT*>(a.v);
  const CT* const a_t_1 = static_cast<const CT*>(a.t_1);
  const CT* const a_tconst = static_cast<const CT*>(a.tconst);
  const CT* const a_dc = static_cast<const CT*>(a.dvdxi_const);
  const int I = a.I;
  const int c2 = c.c2;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const float msft2 = c.msft2, rmsfty = c.rmsfty, mt = c.mt;
  const float ww1k0 = __ldg(a.ww1_k0 + c2);
  const int k0 = a.k0, k1 = a.k1;
  float mu = a.mu[c2];
  float seed = a.ww_row[c2];

  for (int s0 = 0; s0 < a.n_inner; s0 += kChunk) {
    const int ns = min(kChunk, a.n_inner - s0);
    float ws[kChunk], dmdt[kChunk], scan[kChunk], wdtn[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      ws[s] = 1.0f + (a.w0 + (float)(s0 + s)) * a.dw;
      dmdt[s] = 0.f;
    }

    // ---- pass 1: dmdt(s), the column sum in k order --------------------
    Ring<Winds<CT>, kAhead> q1;
    Ring<float, kAhead> dn1;
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      if (k0 + d <= k1) {
        q1.r[d] = load_winds(a_u, a_v, a_dc, c, c.col + (size_t)(k0 + d) * I,
                             true);
        dn1.r[d] = __ldg(a.dnw + k0 + d);
      }
    }
    for (int k = k0; k <= k1; ++k) {
      Winds<CT> nx{};
      float ndn = 0.f;
      if (k + kAhead <= k1) {
        nx = load_winds(a_u, a_v, a_dc, c, c.col + (size_t)(k + kAhead) * I,
                        true);
        ndn = __ldg(a.dnw + k + kAhead);
      }
      const Winds<CT> w = q1.r[0];
      const float dn = dn1.r[0];
      q1.shift(nx);
      dn1.shift(ndn);
      const float u_c = f32(w.u_c), u_e = f32(w.u_e);
      const float v_c = f32(w.v_c), v_n = f32(w.v_n);
      const float dc = f32(w.dc);
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        if (s < ns) {
          const float dvdxi =
              dc + msft2 * (rdy * (v_n * ws[s] - v_c * ws[s]) +
                            rdx * (u_e * ws[s] - u_c * ws[s]));
          dmdt[s] += dn * dvdxi;
        }
      }
    }

    // ---- pass 2's first levels, loaded before the substeps' mu update ----
    Ring<Level2<CT>, kAhead> q2;
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (k0 + d <= k1)
        q2.r[d] = load_level2(a, a_u, a_v, a_dc, a_t_1, a_tconst, c, k0 + d,
                              k1);
    float t1_k = f32(ldr(a_t_1, c.col + (size_t)k0 * I));

    // ---- column mass and the scan seeds, substep by substep -------------
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s < ns) {
        mu = mu + dts * (dmdt[s] + mt);
        scan[s] = seed;  // raw scan value at level k0
        seed = seed - ww1k0;
        wdtn[s] = 0.f;   // wdtn(k0): no flux through the surface
      }
    }

    // ---- pass 2: ww scan and theta, k ascending, substeps inside --------
    for (int k = k0; k <= k1; ++k) {
      Level2<CT> nx{};
      if (k + kAhead <= k1)  // before the store to t
        nx = load_level2(a, a_u, a_v, a_dc, a_t_1, a_tconst, c, k + kAhead,
                         k1);
      const Level2<CT> l = q2.r[0];
      q2.shift(nx);
      const float u_c = f32(l.w.u_c), u_e = f32(l.w.u_e);
      const float v_c = f32(l.w.v_c), v_n = f32(l.w.v_n);
      const float dc = f32(l.w.dc), dn = l.dn;
      const bool up = k < k1;  // level k+1 exists (0 above k1)
      float t1_up = 0.f, interp_up = 0.f;
      if (up) {
        t1_up = f32(l.t1up);
        interp_up = l.fnm * t1_up + l.fnp * t1_k;
      }
      const float rdnw = l.rdnw;
      const float ty_n = f32(l.t1n) + t1_k, ty_s = t1_k + f32(l.t1s);
      const float tx_e = f32(l.t1e) + t1_k, tx_w = t1_k + f32(l.t1w);
      const float tc = f32(l.tc);
      float t = l.t;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        if (s < ns) {
          const float uc = u_c * ws[s], ue = u_e * ws[s];
          const float vc = v_c * ws[s], vn = v_n * ws[s];
          float scan_up = 0.f, wdtn_up = 0.f;
          if (up) {
            const float dvdxi =
                dc + msft2 * (rdy * (vn - vc) + rdx * (ue - uc));
            scan_up = scan[s] + (-dn * ((dmdt[s] + dvdxi) + mt)) * rmsfty;
            wdtn_up = scan_up * interp_up;
          }
          const float vert = rdnw * (wdtn_up - wdtn[s]);
          const float fy = vn * ty_n - vc * ty_s;
          const float fx = ue * tx_e - uc * tx_w;
          const float horiz = c.msftx * (hrdy * fy + hrdx * fx);
          t = (t + tc) - c.dts_msfty * (horiz + vert);
          scan[s] = scan_up;
          wdtn[s] = wdtn_up;
        }
      }
      a.t[c.col + (size_t)k * I] = t;
      t1_k = t1_up;
    }
  }
  a.mu[c2] = mu;
  a.ww_row[c2] = seed;
}

// The float32 entry must fit six blocks an SM (ptxas caps its registers at
// 80), measured on an H100 (PERF.md): six beat the five that 96 registers
// allow by 5 % at S=8 and 12 % at S=2.  The bf16 entry spills at six, and a
// minimum of one block moved ptxas from 91 registers to 110 and cost it 2 %,
// so it names no minimum.
__global__ void __launch_bounds__(kBlockX * kBlockY, 6)
msteps_exact_f32_kernel(const Args a) {
  msteps_exact<float>(a);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
msteps_exact_bf16_kernel(const Args a) {
  msteps_exact<__nv_bfloat16>(a);
}

template <typename CT>
__global__ void __launch_bounds__(kBlockX * kBlockY)
msteps_fast_kernel(const Args a) {
  Column c;
  if (!column(a, c)) return;
  const CT* const a_u = static_cast<const CT*>(a.u);
  const CT* const a_v = static_cast<const CT*>(a.v);
  const CT* const a_t_1 = static_cast<const CT*>(a.t_1);
  const CT* const a_tconst = static_cast<const CT*>(a.tconst);
  const CT* const a_dc = static_cast<const CT*>(a.dvdxi_const);
  const int I = a.I;
  const int c2 = c.c2;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const float msft2 = c.msft2, rmsfty = c.rmsfty, mt = c.mt;
  const float dm = c.dts_msfty;
  const float ww1k0 = __ldg(a.ww1_k0 + c2);
  const int k0 = a.k0, k1 = a.k1;

  // ---- pass 1: the two column sums (constant and wind-proportional) ----
  Ring<Winds<CT>, kAheadFast> q1;
  Ring<float, kAheadFast> dn1;
#pragma unroll
  for (int d = 0; d < kAheadFast; ++d) {
    if (k0 + d <= k1) {
      q1.r[d] = load_winds(a_u, a_v, a_dc, c, c.col + (size_t)(k0 + d) * I,
                           true);
      dn1.r[d] = __ldg(a.dnw + k0 + d);
    }
  }
  float dmdt_c = 0.f, dmdt_d = 0.f;
  for (int k = k0; k <= k1; ++k) {
    Winds<CT> nx{};
    float ndn = 0.f;
    if (k + kAheadFast <= k1) {
      nx = load_winds(a_u, a_v, a_dc, c, c.col + (size_t)(k + kAheadFast) * I,
                      true);
      ndn = __ldg(a.dnw + k + kAheadFast);
    }
    const Winds<CT> w = q1.r[0];
    const float dn = dn1.r[0];
    q1.shift(nx);
    dn1.shift(ndn);
    const float u_c = f32(w.u_c), u_e = f32(w.u_e);
    const float v_c = f32(w.v_c), v_n = f32(w.v_n);
    const float dyn = msft2 * (rdy * (v_n - v_c) + rdx * (u_e - u_c));
    dmdt_c += dn * f32(w.dc);
    dmdt_d += dn * dyn;
  }

  // ---- pass 2's first levels, loaded before the column's 2-D stores ----
  Ring<Level2<CT>, kAheadFast> q2;
#pragma unroll
  for (int d = 0; d < kAheadFast; ++d)
    if (k0 + d <= k1)
      q2.r[d] = load_level2(a, a_u, a_v, a_dc, a_t_1, a_tconst, c, k0 + d,
                            k1);
  float t1_k = f32(ldr(a_t_1, c.col + (size_t)k0 * I));

  // S, S(S-1)/2 and sum_s ws(s) = S + (S*w0 + S(S-1)/2)*dw
  const int S = a.n_inner;
  const float sn = (float)S;
  const float ss = (float)(S * (S - 1) / 2);
  const float sws = sn + (sn * a.w0 + ss) * a.dw;
  const float mu = a.mu[c2];
  a.mu[c2] = mu + dts * (sn * (dmdt_c + mt) + sws * dmdt_d);
  const float seed = a.ww_row[c2];
  a.ww_row[c2] = seed - sn * ww1k0;

  // ---- pass 2: the ww cumsums, the G terms and the summed update -------
  float yc = 0.f, yd = 0.f;           // sum over m < k of steps(m), m >= k0
  float wa = 0.f, wb = 0.f, wc = 0.f;  // interp * (...) at level k (0 at k0)
  for (int k = k0; k <= k1; ++k) {
    Level2<CT> nx{};
    if (k + kAheadFast <= k1)  // before the store to t
      nx = load_level2(a, a_u, a_v, a_dc, a_t_1, a_tconst, c, k + kAheadFast,
                       k1);
    const Level2<CT> l = q2.r[0];
    q2.shift(nx);
    const float u_c = f32(l.w.u_c), u_e = f32(l.w.u_e);
    const float v_c = f32(l.w.v_c), v_n = f32(l.w.v_n);
    float t1_up = 0.f, wa_up = 0.f, wb_up = 0.f, wc_up = 0.f;
    if (k < k1) {
      const float dn = l.dn;
      const float dyn = msft2 * (rdy * (v_n - v_c) + rdx * (u_e - u_c));
      yc = yc + (-dn * ((dmdt_c + f32(l.w.dc)) + mt)) * rmsfty;
      yd = yd + (-dn * (dmdt_d + dyn)) * rmsfty;
      t1_up = f32(l.t1up);
      const float interp_up = l.fnm * t1_up + l.fnp * t1_k;
      wa_up = interp_up * (seed + yc);
      wb_up = -(interp_up * ww1k0);
      wc_up = interp_up * yd;
    }
    const float rdnw = l.rdnw;
    const float fy =
        v_n * (f32(l.t1n) + t1_k) - v_c * (t1_k + f32(l.t1s));
    const float fx =
        u_e * (f32(l.t1e) + t1_k) - u_c * (t1_k + f32(l.t1w));
    const float horiz = c.msftx * (hrdy * fy + hrdx * fx);
    const float g0 = f32(l.tc) - dm * (rdnw * (wa_up - wa));
    const float g1 = -(dm * (rdnw * (wb_up - wb)));
    const float g2 = -(dm * (horiz + rdnw * (wc_up - wc)));
    a.t[c.col + (size_t)k * I] = l.t + ((sn * g0 + ss * g1) + sws * g2);
    wa = wa_up;
    wb = wb_up;
    wc = wc_up;
    t1_k = t1_up;
  }
}

}  // namespace

// Plain C entry for ctypes.  t, mu and ww_row are updated in place.
// ``const_bf16``: u, v, t_1, tconst and dvdxi_const point at bf16 elements.
// Launches on ``stream`` and returns cudaGetLastError() of the launch
// (0 on success); it neither allocates nor synchronises.
extern "C" int wrf_tpu_torch_advance_mu_t_msteps(
    const void* u, const void* v, float* t, const void* t_1,
    const void* tconst, const void* dvdxi_const, const float* ww1_k0,
    float* ww_row, float* mu, const float* mu_tend, const float* msftx,
    const float* msfty, const float* dnw, const float* fnm, const float* fnp,
    const float* rdnw,
    float rdx, float rdy, float dts, float w0, float dw,
    int J, int K, int I, int i0, int i1, int j0, int j1, int j_off,
    int i_off, int k0, int k1, int n_inner, int fast, int const_bf16,
    void* stream) {
  if (J < 3 || K < 1 || I < 1 || k0 < 0 || k1 >= K || k0 > k1 ||
      n_inner < 1)
    return cudaErrorInvalidValue;
  const Args a{u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu,
               mu_tend, msftx, msfty, dnw, fnm, fnp, rdnw,
               rdx, rdy, dts, w0, dw,
               J, K, I, i0, i1, j0, j1, j_off, i_off, k0, k1, n_inner};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((I + kBlockX - 1) / kBlockX,
                  (J - 2 + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const_bf16) {
    if (fast)
      msteps_fast_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
    else
      msteps_exact_bf16_kernel<<<grid, block, 0, s>>>(a);
  } else {
    if (fast)
      msteps_fast_kernel<float><<<grid, block, 0, s>>>(a);
    else
      msteps_exact_f32_kernel<<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
