// Native vertically-implicit acoustic w/pressure substep (advance_w).
// Semantics identical to the Python golden path (wrf_tpu_torch/ops/advance_w.py)
// — see that module for the scheme (linearized vertical acoustics,
// epssm-off-centered, per-column tridiagonal Thomas solve, rigid surface
// and lid).  FP association matches it term for term so the tiers stay
// bit-comparable.

#include <vector>

#include "wrf_tpu_native.h"

extern "C" int32_t wrf_advance_w(
    const wrf_window* win,
    float* w, float* pp, const float* t,
    const float* rdn, const float* rdnw,
    float dts, float epssm, float cw, float gw) {
  const int64_t idim = win->idim;
  const int64_t kdim = win->kdim;
  const int k0 = win->k0, k1 = win->k1;

  const float beta = 0.5f * (1.0f + epssm);
  const float alfa = 1.0f - beta;
  const float c = cw * dts;
  const float cb = c * beta;
  const float e = (c * beta) * (c * alfa);  // explicit-divergence factor
  const float gt = dts * gw;

  std::vector<float> a(kdim, 0.0f), b(kdim, 0.0f);
  for (int k = k0 + 1; k <= k1; ++k) {
    a[k] = cb * cb * rdn[k] * rdnw[k - 1];
    b[k] = cb * cb * rdn[k] * rdnw[k];
  }

  std::vector<float> dv(kdim), rhs(kdim), cp(kdim), dp(kdim), wn(kdim);
  for (int j = win->j0; j <= win->j1; ++j) {
    for (int i = win->i0; i <= win->i1; ++i) {
      const int64_t col = (static_cast<int64_t>(j) * kdim) * idim + i;
      const auto W = [&](int k) -> float& { return w[col + static_cast<int64_t>(k) * idim]; };
      const auto PP = [&](int k) -> float& { return pp[col + static_cast<int64_t>(k) * idim]; };
      const auto T = [&](int k) -> float { return t[col + static_cast<int64_t>(k) * idim]; };

      // old-level center divergence; surface interface treated as 0
      dv[k0] = rdnw[k0] * (W(k0 + 1) - 0.0f);
      for (int k = k0 + 1; k < k1; ++k) dv[k] = rdnw[k] * (W(k + 1) - W(k));
      dv[k1] = rdnw[k1] * (0.0f - W(k1));

      for (int k = k0 + 1; k <= k1; ++k) {
        rhs[k] = W(k) - (c * rdn[k]) * (PP(k) - PP(k - 1)) +
                 (e * rdn[k]) * (dv[k] - dv[k - 1]) + gt * T(k);
      }

      // Thomas: sub=-a, diag=1+a+b, sup=-b
      for (int k = k0 + 1; k <= k1; ++k) {
        const float diag = 1.0f + a[k] + b[k];
        const float denom = (k == k0 + 1) ? diag : diag + a[k] * cp[k - 1];
        cp[k] = -b[k] / denom;
        dp[k] = (k == k0 + 1) ? rhs[k] / denom
                              : (rhs[k] + a[k] * dp[k - 1]) / denom;
      }
      wn[k1] = dp[k1];
      for (int k = k1 - 1; k > k0; --k) wn[k] = dp[k] - cp[k] * wn[k + 1];
      wn[k0] = 0.0f;  // rigid surface inside the substep

      // pp update from the off-centered divergence of the new w
      for (int k = k0; k <= k1; ++k) {
        const float up = (k < k1) ? wn[k + 1] : 0.0f;
        const float dvn = rdnw[k] * (up - wn[k]);
        PP(k) = PP(k) - c * (beta * dvn + alfa * dv[k]);
      }
      for (int k = k0 + 1; k <= k1; ++k) W(k) = wn[k];
    }
  }
  return 0;
}
