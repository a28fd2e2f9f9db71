// Native wind substep (advance_uv): linearized acoustic pressure-gradient
// update of the mass-coupled momenta.  Semantics identical to the Python
// golden path (wrf_tpu_torch/ops/advance_uv.py) — see that module for the scheme;
// FP association matches it term for term so the tiers stay bit-comparable.

#include "wrf_tpu_native.h"

extern "C" int32_t wrf_advance_uv(
    const wrf_window* w,
    float* u, float* v, const float* mu,
    const float* muu, const float* muv,
    const float* msfuy, const float* msfvx_inv,
    float rdx, float rdy, float dts, float cs2,
    const float* mudf, float smdiv) {
  const float dampc = cs2 * smdiv;
  const int64_t idim = w->idim;
  const int64_t kdim = w->kdim;
  // u update window: edge points strictly interior in i to the mass window
  const int ui0 = w->i0 + 1, ui1 = w->i1, uj0 = w->j0, uj1 = w->j1;
  // v update window: strictly interior in j
  const int vi0 = w->i0, vi1 = w->i1, vj0 = w->j0 + 1, vj1 = w->j1;

  for (int j = uj0; j <= uj1; ++j) {
    for (int i = ui0; i <= ui1; ++i) {
      const int64_t c2 = j * idim + i;
      float p = cs2 * mu[c2];
      float p_im = cs2 * mu[c2 - 1];
      if (mudf) {
        p = p + dampc * mudf[c2];
        p_im = p_im + dampc * mudf[c2 - 1];
      }
      const float coef = dts * (muu[c2] / msfuy[c2]) * (-rdx);
      const float du = coef * (p - p_im);
      float* col = u + (j * kdim) * idim + i;
      for (int k = 0; k < w->kdim; ++k) col[static_cast<int64_t>(k) * idim] += du;
    }
  }
  for (int j = vj0; j <= vj1; ++j) {
    for (int i = vi0; i <= vi1; ++i) {
      const int64_t c2 = j * idim + i;
      float p = cs2 * mu[c2];
      float p_jm = cs2 * mu[c2 - idim];
      if (mudf) {
        p = p + dampc * mudf[c2];
        p_jm = p_jm + dampc * mudf[c2 - idim];
      }
      const float coef = dts * (muv[c2] * msfvx_inv[c2]) * (-rdy);
      const float dv = coef * (p - p_jm);
      float* col = v + (j * kdim) * idim + i;
      for (int k = 0; k < w->kdim; ++k) col[static_cast<int64_t>(k) * idim] += dv;
    }
  }
  return 0;
}
