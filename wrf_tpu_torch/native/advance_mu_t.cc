// Native scalar golden kernel for the acoustic small-step mu/theta update.
//
// Numerics per the WRF advance_mu_t specification
// (reference: module_small_step_em.f90:7-252); see wrf_tpu_native.h for the
// design notes.  The implementation walks one j-row at a time with per-row
// scratch so the working set stays in cache; per-element FP ordering and the
// k-ascending order of the column reduction/scan match the reference and the
// numpy golden path (wrf_tpu_torch/ops/reference_numpy.py) exactly.

#include "wrf_tpu_native.h"

#include <cstdlib>
#include <cstring>
#include <vector>

namespace {
inline int64_t at3(const wrf_window* w, int64_t i, int64_t k, int64_t j) {
  return (j * w->kdim + k) * w->idim + i;
}
inline int64_t at2(const wrf_window* w, int64_t i, int64_t j) {
  return j * w->idim + i;
}
}  // namespace

extern "C" int32_t wrf_advance_mu_t_capture(
    const wrf_window* w,
    float* ww, const float* ww_1,
    const float* u, const float* u_1,
    const float* v, const float* v_1,
    float* mu, const float* mut, float* muave, float* muts,
    const float* muu, const float* muv,
    float* mudf, float* t, const float* t_1,
    float* t_ave, const float* ft, const float* mu_tend,
    float rdx, float rdy, float dts, float epssm,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    const float* msfuy, const float* msfvx_inv,
    const float* msftx, const float* msfty,
    float* cap_muave, float* cap_mu, float* cap_mudf, float* cap_muts,
    float* cap_ww) {
  const int i0 = w->i0, i1 = w->i1, j0 = w->j0, j1 = w->j1;
  const int k0 = w->k0, k1 = w->k1;
  const int64_t idim = w->idim;
  const int64_t kdim = w->kdim;

  // Per-j-row scratch: the horizontal mass-flux divergence at every level,
  // the column-integrated divergence, and the vertical-flux interpolant.
  std::vector<float> dvdxi(static_cast<size_t>(kdim) * idim);
  std::vector<float> dmdt(static_cast<size_t>(idim));
  std::vector<float> wdtn(static_cast<size_t>(kdim) * idim, 0.0f);

  // ---- Phase A: ww (d eta/dt) and column mass mu -----------------------
  for (int j = j0; j <= j1; ++j) {
    for (int i = i0; i <= i1; ++i) dmdt[i] = 0.0f;

    for (int k = k0; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        // Horizontal divergence of the (coupled) mass flux; forward
        // differences read the i+1 / j+1 staggered neighbors.
        const float vy_hi = v[at3(w, i, k, j + 1)] +
                            muv[at2(w, i, j + 1)] * v_1[at3(w, i, k, j + 1)] *
                                msfvx_inv[at2(w, i, j + 1)];
        const float vy_lo = v[at3(w, i, k, j)] +
                            muv[at2(w, i, j)] * v_1[at3(w, i, k, j)] *
                                msfvx_inv[at2(w, i, j)];
        const float ux_hi = u[at3(w, i + 1, k, j)] +
                            muu[at2(w, i + 1, j)] * u_1[at3(w, i + 1, k, j)] /
                                msfuy[at2(w, i + 1, j)];
        const float ux_lo = u[at3(w, i, k, j)] +
                            muu[at2(w, i, j)] * u_1[at3(w, i, k, j)] /
                                msfuy[at2(w, i, j)];
        const float d = msftx[at2(w, i, j)] * msfty[at2(w, i, j)] *
                        (rdy * (vy_hi - vy_lo) + rdx * (ux_hi - ux_lo));
        dvdxi[static_cast<size_t>(k) * idim + i] = d;
        dmdt[i] = dmdt[i] + dnw[k] * d;
      }
    }

    // mu update with epsilon off-centering; mudf saves the tendency for the
    // divergence-damping filter downstream.
    for (int i = i0; i <= i1; ++i) {
      const float mu_old = mu[at2(w, i, j)];
      const float mu_new = mu_old + dts * (dmdt[i] + mu_tend[at2(w, i, j)]);
      mu[at2(w, i, j)] = mu_new;
      mudf[at2(w, i, j)] = dmdt[i] + mu_tend[at2(w, i, j)];
      muts[at2(w, i, j)] = mut[at2(w, i, j)] + mu_new;
      muave[at2(w, i, j)] =
          0.5f * ((1.0f + epssm) * mu_new + (1.0f - epssm) * mu_old);
    }

    // Upward integration of ww from the input surface value, then removal of
    // the (already map-scale-coupled) large-timestep ww_1.
    for (int k = k0 + 1; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        ww[at3(w, i, k, j)] =
            ww[at3(w, i, k - 1, j)] -
            dnw[k - 1] *
                (dmdt[i] + dvdxi[static_cast<size_t>(k - 1) * idim + i] +
                 mu_tend[at2(w, i, j)]) /
                msfty[at2(w, i, j)];
      }
    }
    for (int k = k0; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        ww[at3(w, i, k, j)] = ww[at3(w, i, k, j)] - ww_1[at3(w, i, k, j)];
      }
    }
  }

  // Debug capture at the phase boundary — the analog of the reference's
  // mid-kernel "*_before_theta.bin" dumps (module_small_step_em.f90:175-189).
  // Full-array snapshots into caller-provided buffers (all-or-none).
  if (cap_muave && cap_mu && cap_mudf && cap_muts && cap_ww) {
    const size_t n2 = static_cast<size_t>(w->jdim) * w->idim;
    const size_t n3 = n2 * w->kdim;
    std::memcpy(cap_muave, muave, n2 * sizeof(float));
    std::memcpy(cap_mu, mu, n2 * sizeof(float));
    std::memcpy(cap_mudf, mudf, n2 * sizeof(float));
    std::memcpy(cap_muts, muts, n2 * sizeof(float));
    std::memcpy(cap_ww, ww, n3 * sizeof(float));
  }

  // ---- Phase B: perturbation theta -------------------------------------
  for (int j = j0; j <= j1; ++j) {
    for (int k = k0; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        t_ave[at3(w, i, k, j)] = t[at3(w, i, k, j)];
        t[at3(w, i, k, j)] =
            t[at3(w, i, k, j)] + msfty[at2(w, i, j)] * dts * ft[at3(w, i, k, j)];
      }
    }
  }

  for (int j = j0; j <= j1; ++j) {
    // Vertical flux interpolant on w levels; zero at the surface and at the
    // domain top.
    for (int i = i0; i <= i1; ++i) {
      wdtn[static_cast<size_t>(k0) * idim + i] = 0.0f;
      wdtn[static_cast<size_t>(w->kde) * idim + i] = 0.0f;
    }
    for (int k = k0 + 1; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        wdtn[static_cast<size_t>(k) * idim + i] =
            ww[at3(w, i, k, j)] * (fnm[k] * t_1[at3(w, i, k, j)] +
                                   fnp[k] * t_1[at3(w, i, k - 1, j)]);
      }
    }

    // Theta advection: centered horizontal fluxes (±1 stencil on t_1) plus
    // the vertical divergence of wdtn; msfty uncouples the result.
    for (int k = k0; k <= k1; ++k) {
      for (int i = i0; i <= i1; ++i) {
        const float fy =
            v[at3(w, i, k, j + 1)] *
                (t_1[at3(w, i, k, j + 1)] + t_1[at3(w, i, k, j)]) -
            v[at3(w, i, k, j)] *
                (t_1[at3(w, i, k, j)] + t_1[at3(w, i, k, j - 1)]);
        const float fx =
            u[at3(w, i + 1, k, j)] *
                (t_1[at3(w, i + 1, k, j)] + t_1[at3(w, i, k, j)]) -
            u[at3(w, i, k, j)] *
                (t_1[at3(w, i, k, j)] + t_1[at3(w, i - 1, k, j)]);
        const float vert = rdnw[k] * (wdtn[static_cast<size_t>(k + 1) * idim + i] -
                                      wdtn[static_cast<size_t>(k) * idim + i]);
        t[at3(w, i, k, j)] =
            t[at3(w, i, k, j)] -
            dts * msfty[at2(w, i, j)] *
                (msftx[at2(w, i, j)] * (0.5f * rdy * fy + 0.5f * rdx * fx) +
                 vert);
      }
    }
  }
  return 0;
}

// Plain entry point (no capture) — the ABI the drivers use.
extern "C" int32_t wrf_advance_mu_t(
    const wrf_window* w,
    float* ww, const float* ww_1,
    const float* u, const float* u_1,
    const float* v, const float* v_1,
    float* mu, const float* mut, float* muave, float* muts,
    const float* muu, const float* muv,
    float* mudf, float* t, const float* t_1,
    float* t_ave, const float* ft, const float* mu_tend,
    float rdx, float rdy, float dts, float epssm,
    const float* dnw, const float* fnm, const float* fnp, const float* rdnw,
    const float* msfuy, const float* msfvx_inv,
    const float* msftx, const float* msfty) {
  return wrf_advance_mu_t_capture(
      w, ww, ww_1, u, u_1, v, v_1, mu, mut, muave, muts, muu, muv, mudf, t,
      t_1, t_ave, ft, mu_tend, rdx, rdy, dts, epssm, dnw, fnm, fnp, rdnw,
      msfuy, msfvx_inv, msftx, msfty, nullptr, nullptr, nullptr, nullptr,
      nullptr);
}
