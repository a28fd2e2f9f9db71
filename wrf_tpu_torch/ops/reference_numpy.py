"""Scalar-faithful numpy implementation of ``advance_mu_t``.

This is the framework's *golden path*: a direct, FP-order-preserving
implementation of the WRF small-step mu/theta update
(reference semantics: module_small_step_em.f90:7-252, advance_mu_t.c:17-239).
It vectorizes over (i, j) — each column's arithmetic is independent, so
element-wise FP ordering is identical to the reference loops — and keeps the
k reduction and k scan as explicit sequential loops so the floating-point
association of the vertical sum matches the reference exactly.  Expression
association follows the reference sources term by term (e.g.
``(muv*v_1)*msfvx_inv``, ``(muu*u_1)/msfuy``) and no FMA contraction is
introduced, mirroring the reference's ``-fmad=false`` determinism policy
(Makefile:12).

Used for: oracle-vs-oracle validation of the native C++ tier, golden fixture
minting, and as the correctness anchor for the JAX/Pallas device paths.

All arrays use the framework layout: 3-D ``(j, k, i)``, 2-D ``(j, i)``,
1-D ``(k,)``, float32.
"""

from __future__ import annotations

import numpy as np

from ..grid import ConfigFlags, GridBounds

F = np.float32


def advance_mu_t_numpy(
    *,
    ww: np.ndarray,
    ww_1: np.ndarray,
    u: np.ndarray,
    u_1: np.ndarray,
    v: np.ndarray,
    v_1: np.ndarray,
    mu: np.ndarray,
    mut: np.ndarray,
    muu: np.ndarray,
    muv: np.ndarray,
    t: np.ndarray,
    t_1: np.ndarray,
    t_ave: np.ndarray,
    ft: np.ndarray,
    mu_tend: np.ndarray,
    rdx: float,
    rdy: float,
    dts: float,
    epssm: float,
    dnw: np.ndarray,
    fnm: np.ndarray,
    fnp: np.ndarray,
    rdnw: np.ndarray,
    msfuy: np.ndarray,
    msfvx_inv: np.ndarray,
    msftx: np.ndarray,
    msfty: np.ndarray,
    flags: ConfigFlags,
    bounds: GridBounds,
    capture_intermediates: bool = False,
) -> dict[str, np.ndarray]:
    """Advance the perturbation theta and mass-conservation equations one
    acoustic small step; update the small-timestep omega (ww).

    Returns dict with new ``ww, mu, muave, muts, mudf, t, t_ave`` (inputs are
    not mutated).  Cells outside the boundary-condition-aware window keep
    their input values (``ww, mu, t, t_ave``) or zero (``muave, muts, mudf``),
    matching the reference's in/out buffer behavior.
    """
    i0, i1, j0, j1, k0, k1 = bounds.loop_bounds(flags)
    kde = bounds.mem(bounds.kde, "k")  # 0-based top index of the domain in k

    rdx, rdy, dts, epssm = F(rdx), F(rdy), F(dts), F(epssm)

    ww = np.array(ww, dtype=F, copy=True)
    mu = np.array(mu, dtype=F, copy=True)
    t = np.array(t, dtype=F, copy=True)
    t_ave = np.array(t_ave, dtype=F, copy=True)
    muave = np.zeros_like(mu)
    muts = np.zeros_like(mu)
    mudf = np.zeros_like(mu)

    js = slice(j0, j1 + 1)
    isl = slice(i0, i1 + 1)
    jsp = slice(j0 + 1, j1 + 2)   # j+1 window
    isp = slice(i0 + 1, i1 + 2)   # i+1 window

    # ------------------------------------------------------------------ #
    # Phase A — ww (d eta / dt) and column mass mu
    # (module_small_step_em.f90:112-174)
    # ------------------------------------------------------------------ #
    nk = k1 - k0 + 1
    nj = j1 - j0 + 1
    ni = i1 - i0 + 1
    dvdxi = np.zeros((nj, nk, ni), dtype=F)
    dmdt = np.zeros((nj, ni), dtype=F)

    msft2 = (msftx[js, isl] * msfty[js, isl]).astype(F)
    muv_lo, muv_hi = muv[js, isl], muv[jsp, isl]
    mvi_lo, mvi_hi = msfvx_inv[js, isl], msfvx_inv[jsp, isl]
    muu_lo, muu_hi = muu[js, isl], muu[js, isp]
    msu_lo, msu_hi = msfuy[js, isl], msfuy[js, isp]

    for k in range(k0, k1 + 1):
        # association mirrors the reference: v + (muv*v_1)*msfvx_inv and
        # u + (muu*u_1)/msfuy (module_small_step_em.f90:142-146)
        d = msft2 * (
            rdy * ((v[jsp, k, isl] + muv_hi * v_1[jsp, k, isl] * mvi_hi)
                   - (v[js, k, isl] + muv_lo * v_1[js, k, isl] * mvi_lo))
            + rdx * ((u[js, k, isp] + muu_hi * u_1[js, k, isp] / msu_hi)
                     - (u[js, k, isl] + muu_lo * u_1[js, k, isl] / msu_lo))
        )
        dvdxi[:, k - k0, :] = d
        dmdt += dnw[k] * d

    mu_old = mu[js, isl].copy()
    mu_new = mu_old + dts * (dmdt + mu_tend[js, isl])
    mu[js, isl] = mu_new
    mudf[js, isl] = dmdt + mu_tend[js, isl]
    muts[js, isl] = mut[js, isl] + mu_new
    muave[js, isl] = F(0.5) * ((F(1.0) + epssm) * mu_new + (F(1.0) - epssm) * mu_old)

    # Vertical scan: ww(k) = ww(k-1) - dnw(k-1)*(dmdt + dvdxi(k-1) + mu_tend)/msfty
    # integrated upward from the input surface value
    # (module_small_step_em.f90:159-163).  The scan covers k0+1..k1.
    mt = mu_tend[js, isl]
    msy = msfty[js, isl]
    for k in range(k0 + 1, k1 + 1):
        ww[js, k, isl] = (
            ww[js, k - 1, isl]
            - dnw[k - 1] * (dmdt + dvdxi[:, k - 1 - k0, :] + mt) / msy
        )

    # ww_1 (large-timestep ww) is already map-scale-factor coupled; subtract
    # it at every updated level including the surface
    # (module_small_step_em.f90:168-172).
    for k in range(k0, k1 + 1):
        ww[js, k, isl] = ww[js, k, isl] - ww_1[js, k, isl]

    # Debug capture at the phase boundary — the analog of the reference's
    # mid-kernel "*_before_theta.bin" dumps (module_small_step_em.f90:175-189)
    # for phase-by-phase bisection of numerical divergence.  Copies taken
    # HERE (not aliases of the outputs) so any phase-B scribble over a
    # phase-A buffer would be visible as capture-vs-output drift.
    captured = {}
    if capture_intermediates:
        captured = {
            "muave_before_theta": muave.copy(),
            "mu_before_theta": mu.copy(),
            "mudf_before_theta": mudf.copy(),
            "muts_before_theta": muts.copy(),
            "ww_before_theta": ww.copy(),
        }

    # ------------------------------------------------------------------ #
    # Phase B — perturbation theta
    # (module_small_step_em.f90:208-250)
    # ------------------------------------------------------------------ #
    for k in range(k0, k1 + 1):
        t_ave[js, k, isl] = t[js, k, isl]
        t[js, k, isl] = t[js, k, isl] + msy * dts * ft[js, k, isl]

    # wdtn: vertical interpolation of t_1 to w levels, weighted by the new ww;
    # zero at bottom (k0) and at the domain top (kde)
    # (module_small_step_em.f90:219-229).
    wdtn = np.zeros((nj, kde + 2 - k0, ni), dtype=F)
    for k in range(k0 + 1, k1 + 1):
        wdtn[:, k - k0, :] = ww[js, k, isl] * (
            fnm[k] * t_1[js, k, isl] + fnp[k] * t_1[js, k - 1, isl]
        )

    # Theta advection update: ±1 stencil in i and j on t_1, staggered u/v
    # fluxes, plus the vertical wdtn divergence
    # (module_small_step_em.f90:234-248).
    jsm = slice(j0 - 1, j1)  # j-1 window
    ism = slice(i0 - 1, i1)  # i-1 window
    half = F(0.5)
    for k in range(k0, k1 + 1):
        horiz = msftx[js, isl] * (
            half * rdy * (
                v[jsp, k, isl] * (t_1[jsp, k, isl] + t_1[js, k, isl])
                - v[js, k, isl] * (t_1[js, k, isl] + t_1[jsm, k, isl])
            )
            + half * rdx * (
                u[js, k, isp] * (t_1[js, k, isp] + t_1[js, k, isl])
                - u[js, k, isl] * (t_1[js, k, isl] + t_1[js, k, ism])
            )
        )
        vert = rdnw[k] * (wdtn[:, k + 1 - k0, :] - wdtn[:, k - k0, :])
        t[js, k, isl] = t[js, k, isl] - dts * msy * (horiz + vert)

    return {
        "ww": ww,
        "mu": mu,
        "muave": muave,
        "muts": muts,
        "mudf": mudf,
        "t": t,
        "t_ave": t_ave,
        **captured,
    }
