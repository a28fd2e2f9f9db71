// The fused vertically-implicit w/pp substep of K1 and K3: one column's
// Thomas solve, shared by csrc/advance_mu_t_kernel.cuh and
// csrc/advance_mu_t_coupled_kernel.cuh.
//
// Replaces the fuse_w block of the TPU kernels
// (wrf_tpu/ops/advance_mu_t_pallas.py::_kernel and
// wrf_tpu/ops/advance_mu_t_msteps.py::_w_solver).  The plain PyTorch version
// is w_step_plain in wrf_tpu_torch/ops/advance_mu_t_cuda.py; the scheme is
// described in wrf_tpu_torch/ops/advance_w.py.
//
// The system's coefficients are the same in every column and substep, so
// the wrapper computes them once on the host (ops/thomas.py) and passes
// K-vectors: aw (sub-diagonal), cpv and denv (the hoisted forward-
// elimination recurrence), crdn and erdn (rhs row factors).
//
// One thread owns the column.  The solve reads only its own column of w, pp
// and the new t, so K3 updates w and pp in place; K1 writes them to fresh
// buffers (w_backward's wout / ppout), reading the old ones as they are:
//   * w_forward_level (w_forward_step on values the caller loaded) rides
//     the caller's ascending k loop (the theta pass), one call per level
//     k0..k1 right after t(k) is final.  It forms
//     dvz(k) = rdnw(k)*(w(k+1) - w(k)) with the rigid surface and lid,
//     rhs(k), and the eliminated dpw(k) = (rhs(k) + aw(k)*dpw(k-1))/denv(k),
//     and stores dpw(k) in the caller's K-long sweep buffer.  It reads w and
//     pp and writes neither.
//   * w_backward then runs k descending: w'(k) = dpw(k) - cpv(k)*w'(k+1),
//     the old and new dvz(k), pp(k) -= c_w*(beta*dvz'(k) + alfa*dvz(k)).
//     It re-reads the old w(k) and pp(k) before it writes the new ones (the
//     old w(k+1) it needs is kept in a register), so each field is read
//     twice and written once per solve.  It loads a few levels ahead of its
//     arithmetic (see w_backward).
// The sweep buffer is addressed as dpw[k*stride]: K1 passes its per-thread
// shared-memory slice, K3 a column of an output buffer that is dead until
// its last phase.
//
// The k-1 and k+1 neighbours are guarded, not wrapped: the TPU kernel's
// wrapped values are all masked (interior interfaces are k0 < k <= k1,
// centres k0 <= k <= k1).
//
// Numerics: -fmad=false and IEEE division; every expression follows the
// plain version's association, so the two agree bit for bit.

#pragma once

#include <cstddef>

namespace wsolve {

struct Coef {
  const float* rdnw;
  const float* aw;
  const float* cpv;
  const float* denv;
  const float* crdn;
  const float* erdn;
  float c_w, g_t, beta, alfa;
};

// What the forward sweep carries from level k-1 to level k.
struct Fwd {
  float w_act = 0.f;   // w(k) as the solve sees it: 0 at the surface k0
  float pp_dn = 0.f;   // pp(k-1)
  float dvz_dn = 0.f;  // dvz(k-1)
  float dpw_dn = 0.f;  // dpw(k-1); dpw(k0) = 0
};

// Level k of the forward sweep, k ascending from k0 to k1, on the values
// the caller loaded: w_up = w(k+1) (0 at k1) and pp_k = pp(k).  K1 loads
// them levels ahead of its stores.
__device__ __forceinline__ void w_forward_step(const Coef& c, Fwd& s, int k,
                                               int k0, float t_full,
                                               float w_up, float pp_k,
                                               float* dpw, size_t stride) {
  const float dvz = c.rdnw[k] * (w_up - s.w_act);
  float d = 0.f;
  if (k > k0) {
    const float rhs = ((s.w_act - c.crdn[k] * (pp_k - s.pp_dn)) +
                       c.erdn[k] * (dvz - s.dvz_dn)) +
                      c.g_t * t_full;
    d = (rhs + c.aw[k] * s.dpw_dn) / c.denv[k];
  }
  dpw[(size_t)k * stride] = d;
  s.w_act = w_up;
  s.pp_dn = pp_k;
  s.dvz_dn = dvz;
  s.dpw_dn = d;
}

// The same, loading w(k+1) and pp(k) itself.  wcol and ppcol point at level
// 0 of the thread's column; level k is at [k*I].
__device__ __forceinline__ void w_forward_level(
    const Coef& c, Fwd& s, const float* wcol, const float* ppcol, size_t I,
    int k, int k0, int k1, float t_full, float* dpw, size_t stride) {
  const float w_up = (k < k1) ? wcol[(size_t)(k + 1) * I] : 0.f;
  w_forward_step(c, s, k, k0, t_full, w_up, ppcol[(size_t)k * I], dpw,
                 stride);
}

// Levels the descending loop loads ahead of its arithmetic.
constexpr int kBackwardChunk = 4;

// Back-substitution and the pp update, k descending: reads the old w and pp
// at wcol / ppcol and writes the new ones at wout / ppout (the same column,
// or another buffer's).
// The loop is a chain of dependent steps with three loads each, and a store
// to w or pp may alias the next level's loads as far as the compiler can
// tell, so level by level every step waits out a full memory latency.  It
// therefore works in chunks: load dpw, w and pp of kBackwardChunk levels,
// then do their arithmetic and stores in order.  Same operations, same
// order, same bits; on an H100 it halves K1's time with the solve (PERF.md).
__device__ __forceinline__ void w_backward(const Coef& c, const float* wcol,
                                           const float* ppcol, float* wout,
                                           float* ppout, size_t I, int k0,
                                           int k1, const float* dpw,
                                           size_t stride) {
  constexpr int U = kBackwardChunk;
  float wn_up = 0.f;    // new w(k+1) as the solve sees it (0 above k1)
  float wold_up = 0.f;  // old w(k+1), likewise
  for (int kb = k1; kb >= k0; kb -= U) {
    float d[U], wo[U], pv[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int k = kb - q;
      d[q] = wo[q] = pv[q] = 0.f;
      if (k >= k0) {
        pv[q] = ppcol[(size_t)k * I];
        if (k > k0) {
          d[q] = dpw[(size_t)k * stride];
          wo[q] = wcol[(size_t)k * I];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int k = kb - q;
      if (k >= k0) {
        float wn = 0.f, wold = 0.f;
        if (k > k0) {
          wn = (k == k1) ? d[q] : d[q] - c.cpv[k] * wn_up;
          wold = wo[q];
          wout[(size_t)k * I] = wn;
        }
        const float dvz_new = c.rdnw[k] * (wn_up - wn);
        const float dvz = c.rdnw[k] * (wold_up - wold);
        ppout[(size_t)k * I] =
            pv[q] - c.c_w * (c.beta * dvz_new + c.alfa * dvz);
        wn_up = wn;
        wold_up = wold;
      }
    }
  }
}

// The same, in place: w and pp read and written at wcol / ppcol (K3).
__device__ __forceinline__ void w_backward(const Coef& c, float* wcol,
                                           float* ppcol, size_t I, int k0,
                                           int k1, const float* dpw,
                                           size_t stride) {
  w_backward(c, wcol, ppcol, wcol, ppcol, I, k0, k1, dpw, stride);
}

}  // namespace wsolve
