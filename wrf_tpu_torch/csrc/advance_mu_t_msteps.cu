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
// FAST: the TPU kernel's closed form (msteps.py:481-568).  The substep is
// affine in (1, s, ws), so the S theta increments sum to
// S*G0 + S(S-1)/2*G1 + sum(ws)*G2 with G* from two column sums and two
// sequential k cumsums of the constant and the wind-proportional parts:
// one pass 1 and one pass 2 per launch, whatever S.  Held to a tolerance,
// not to bit-equality.
//
// CT, the element type of the constant streams u, v, t_1, tconst and
// dvdxi_const (float or __nv_bfloat16): they are widened to float on load
// (exact), once per level and chunk, outside the substep loop; t, mu,
// ww_row and all arithmetic stay float.
//
// Bound: memory (a few dozen flops per level and substep against ~11 loads
// per level shared by the chunk).  Times on the card are in PERF.md.
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

template <typename CT>
__global__ void __launch_bounds__(kBlockX * kBlockY)
msteps_exact_kernel(const Args a) {
  Column c;
  if (!column(a, c)) return;
  const CT* const a_u = static_cast<const CT*>(a.u);
  const CT* const a_v = static_cast<const CT*>(a.v);
  const CT* const a_t_1 = static_cast<const CT*>(a.t_1);
  const CT* const a_tconst = static_cast<const CT*>(a.tconst);
  const CT* const a_dvdxi_const = static_cast<const CT*>(a.dvdxi_const);
  const int I = a.I;
  const int c2 = c.c2;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const float msft2 = c.msft2, rmsfty = c.rmsfty, mt = c.mt;
  const float ww1k0 = a.ww1_k0[c2];
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
    for (int k = k0; k <= k1; ++k) {
      const size_t x = c.col + (size_t)k * I;
      const float u_c = ldf(a_u, x), u_e = ldf(a_u, x - c.i + c.ip);
      const float v_c = ldf(a_v, x), v_n = ldf(a_v, x + c.row);
      const float dc = ldf(a_dvdxi_const, x), dn = a.dnw[k];
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
    float t1_k = ldf(a_t_1, c.col + (size_t)k0 * I);
    for (int k = k0; k <= k1; ++k) {
      const size_t x = c.col + (size_t)k * I;
      const size_t xe = x - c.i + c.ip, xw = x - c.i + c.im;
      const size_t xn = x + c.row, xs = x - c.row;
      const float u_c = ldf(a_u, x), u_e = ldf(a_u, xe);
      const float v_c = ldf(a_v, x), v_n = ldf(a_v, xn);
      const float dc = ldf(a_dvdxi_const, x), dn = a.dnw[k];
      const bool up = k < k1;  // level k+1 exists (0 above k1)
      float t1_up = 0.f, interp_up = 0.f;
      if (up) {
        t1_up = ldf(a_t_1, x + I);
        interp_up = a.fnm[k + 1] * t1_up + a.fnp[k + 1] * t1_k;
      }
      const float rdnw = a.rdnw[k];
      const float ty_n = ldf(a_t_1, xn) + t1_k, ty_s = t1_k + ldf(a_t_1, xs);
      const float tx_e = ldf(a_t_1, xe) + t1_k, tx_w = t1_k + ldf(a_t_1, xw);
      const float tc = ldf(a_tconst, x);
      float t = a.t[x];
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
      a.t[x] = t;
      t1_k = t1_up;
    }
  }
  a.mu[c2] = mu;
  a.ww_row[c2] = seed;
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
  const CT* const a_dvdxi_const = static_cast<const CT*>(a.dvdxi_const);
  const int I = a.I;
  const int c2 = c.c2;
  const float rdx = a.rdx, rdy = a.rdy, dts = a.dts;
  const float hrdx = 0.5f * rdx, hrdy = 0.5f * rdy;
  const float msft2 = c.msft2, rmsfty = c.rmsfty, mt = c.mt;
  const float dm = c.dts_msfty;
  const float ww1k0 = a.ww1_k0[c2];
  const int k0 = a.k0, k1 = a.k1;

  // ---- pass 1: the two column sums (constant and wind-proportional) ----
  float dmdt_c = 0.f, dmdt_d = 0.f;
  for (int k = k0; k <= k1; ++k) {
    const size_t x = c.col + (size_t)k * I;
    const float u_c = ldf(a_u, x), u_e = ldf(a_u, x - c.i + c.ip);
    const float v_c = ldf(a_v, x), v_n = ldf(a_v, x + c.row);
    const float dn = a.dnw[k];
    const float dyn = msft2 * (rdy * (v_n - v_c) + rdx * (u_e - u_c));
    dmdt_c += dn * ldf(a_dvdxi_const, x);
    dmdt_d += dn * dyn;
  }

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
  float t1_k = ldf(a_t_1, c.col + (size_t)k0 * I);
  for (int k = k0; k <= k1; ++k) {
    const size_t x = c.col + (size_t)k * I;
    const size_t xe = x - c.i + c.ip, xw = x - c.i + c.im;
    const size_t xn = x + c.row, xs = x - c.row;
    const float u_c = ldf(a_u, x), u_e = ldf(a_u, xe);
    const float v_c = ldf(a_v, x), v_n = ldf(a_v, xn);
    float t1_up = 0.f, wa_up = 0.f, wb_up = 0.f, wc_up = 0.f;
    if (k < k1) {
      const float dn = a.dnw[k];
      const float dyn = msft2 * (rdy * (v_n - v_c) + rdx * (u_e - u_c));
      yc = yc + (-dn * ((dmdt_c + ldf(a_dvdxi_const, x)) + mt)) * rmsfty;
      yd = yd + (-dn * (dmdt_d + dyn)) * rmsfty;
      t1_up = ldf(a_t_1, x + I);
      const float interp_up = a.fnm[k + 1] * t1_up + a.fnp[k + 1] * t1_k;
      wa_up = interp_up * (seed + yc);
      wb_up = -(interp_up * ww1k0);
      wc_up = interp_up * yd;
    }
    const float rdnw = a.rdnw[k];
    const float fy =
        v_n * (ldf(a_t_1, xn) + t1_k) - v_c * (t1_k + ldf(a_t_1, xs));
    const float fx =
        u_e * (ldf(a_t_1, xe) + t1_k) - u_c * (t1_k + ldf(a_t_1, xw));
    const float horiz = c.msftx * (hrdy * fy + hrdx * fx);
    const float g0 = ldf(a_tconst, x) - dm * (rdnw * (wa_up - wa));
    const float g1 = -(dm * (rdnw * (wb_up - wb)));
    const float g2 = -(dm * (horiz + rdnw * (wc_up - wc)));
    a.t[x] = a.t[x] + ((sn * g0 + ss * g1) + sws * g2);
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
      msteps_exact_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
  } else {
    if (fast)
      msteps_fast_kernel<float><<<grid, block, 0, s>>>(a);
    else
      msteps_exact_kernel<float><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
