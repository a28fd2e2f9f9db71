"""advance_w: the vertically-implicit acoustic w/pressure substep.

Port of ``wrf_tpu/ops/advance_w.py``.  Full WRF treats the VERTICAL
acoustic modes implicitly every small step (``advance_w`` in
dyn_em/module_small_step_em.F builds a per-column tridiagonal system and
solves it with the Thomas algorithm).  This module provides that substep
as a *linearized vertical acoustic system*:

    dw/dt  = -cw * rdn(k)  * (pp(k) - pp(k-1))  + gw * t(k)   (interfaces)
    dpp/dt = -cw * rdnw(k) * (w(k+1) - w(k))                  (centers)

off-centered in time like WRF's small step (beta = (1+epssm)/2 on the new
level, 1-beta on the old; the surface interface w(k0) is rigid — treated
as zero inside the substep, the carried value passes through inert).
Substituting the pp update into the w equation yields, per column, the
tridiagonal system

    -A(k) w'(k-1) + (1 + A(k) + B(k)) w'(k) - B(k) w'(k+1) = rhs(k)

with A(k) = (cw*dts*beta)^2 * rdn(k) * rdnw(k-1), B(k) likewise with
rdnw(k), and rigid-lid boundary conditions w'(k0) = w'(ktop) = 0.  ``gw*t``
couples to the theta perturbation advance_mu_t computes in the same
substep; the solve is column-local and needs no halo.

Layout: w and pp ride the usual (J, K, I) arrays; w(k) lives on the
interface below mass level k (w(k0) is the surface), pp(k) at centers.
Updates apply on the mass window interior; outside it both fields pass
through unchanged.

Tiers here: the FP-order-exact numpy golden path (:func:`advance_w_numpy`,
bit-identical to the C++ oracle) and the masked whole-array PyTorch path
(:func:`advance_w`, the eager tier).  The fused kernels solve the same
system inside K1 and K3 (``ops/advance_mu_t_cuda.py``,
``ops/advance_mu_t_coupled_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32

#: default linearized vertical sound speed (cw) and buoyancy coupling (gw).
#: cw multiplies rdn ~ K/1 (eta units), so the implicit gain A ~ (cw*dts*K)^2
#: is unconditionally stable (that is the point of the implicit solve); gw is
#: scaled so the theta coupling perturbs w at O(1e-3) per substep at fixture
#: scales (t ~ 1e4).
DEFAULT_CW = 0.02
DEFAULT_GW = 1e-7


def rdn_from_dnw(dnw: np.ndarray) -> np.ndarray:
    """Interface spacing reciprocals: dn(k) = 0.5*(dnw(k) + dnw(k-1)),
    rdn(k) = 1/dn(k), zero at k=0 (no interface below the surface)."""
    dnw = np.asarray(dnw, F32)
    rdn = np.zeros_like(dnw)
    dn = F32(0.5) * (dnw[1:] + dnw[:-1])
    nz = np.nonzero(dn)[0]
    rdn[1:][nz] = (F32(1.0) / dn[nz]).astype(F32)
    return rdn


def advance_w_numpy(*, w, pp, t, rdn, rdnw, dts, epssm, window,
                    k0: int, k1: int, cw=DEFAULT_CW, gw=DEFAULT_GW):
    """Golden-path vertically-implicit substep; returns (w_new, pp_new).

    ``window`` is the mass window (i0, i1, j0, j1); vertical levels
    [k0, k1] are active, with rigid-lid BCs w(k0) = w(k1+1 -> clamped) = 0
    enforced on the implicit solve (w(k0) stays whatever the input carries;
    the solve updates interior interfaces k0+1..k1).
    """
    dts, epssm = F32(dts), F32(epssm)
    cw, gw = F32(cw), F32(gw)
    beta = F32(0.5) * (F32(1.0) + epssm)
    alfa = F32(1.0) - beta

    i0, i1, j0, j1 = window
    js, isl = slice(j0, j1 + 1), slice(i0, i1 + 1)
    w = np.array(w, dtype=F32, copy=True)
    pp = np.array(pp, dtype=F32, copy=True)
    t = np.asarray(t, F32)
    rdn = np.asarray(rdn, F32)
    rdnw = np.asarray(rdnw, F32)

    wv = w[js, :, isl]      # views into the output arrays
    ppv = pp[js, :, isl]
    tv = t[js, :, isl]

    c = cw * dts
    # old-level RHS pieces, computed level-sequentially (FP-order exact)
    nj, K, ni = wv.shape
    # divergence at centers: dv(k) = rdnw(k) * (w(k+1) - w(k)), zero above k1
    dv = np.zeros_like(wv)
    dv[:, k0, :] = rdnw[k0] * (wv[:, k0 + 1, :] - F32(0.0))
    for k in range(k0 + 1, k1):
        dv[:, k, :] = rdnw[k] * (wv[:, k + 1, :] - wv[:, k, :])
    dv[:, k1, :] = rdnw[k1] * (F32(0.0) - wv[:, k1, :])

    # rhs(k) = w(k) + c*beta*rdn(k)*(c*(dv(k) - dv(k-1)))  <- from pp^{n+1}
    #        - c*rdn(k)*(pp(k) - pp(k-1)) + dts*gw*t(k)
    # (the explicit part of the off-centering folds into the single
    #  c*rdn*(pp_k - pp_{k-1}) term because pp^{n+1} substitution already
    #  carries beta*dpp; see module docstring derivation)
    a = np.zeros(K, dtype=F32)   # sub-diagonal coefficient A(k)
    b = np.zeros(K, dtype=F32)   # super-diagonal coefficient B(k)
    for k in range(k0 + 1, k1 + 1):
        a[k] = (c * beta) * (c * beta) * rdn[k] * rdnw[k - 1]
        b[k] = (c * beta) * (c * beta) * rdn[k] * rdnw[k]

    rhs = np.zeros_like(wv)
    for k in range(k0 + 1, k1 + 1):
        rhs[:, k, :] = (
            wv[:, k, :]
            - (c * rdn[k]) * (ppv[:, k, :] - ppv[:, k - 1, :])
            + (((c * beta) * (c * alfa)) * rdn[k]) * (dv[:, k, :] - dv[:, k - 1, :])
            + (dts * gw) * tv[:, k, :]
        )

    # Thomas algorithm: diag(k) = 1 + a(k) + b(k), sub = -a(k), sup = -b(k)
    cp = np.zeros_like(wv)   # modified super-diagonal
    dp = np.zeros_like(wv)   # modified rhs
    w_new = np.zeros_like(wv)
    for k in range(k0 + 1, k1 + 1):
        diag = F32(1.0) + a[k] + b[k]
        if k == k0 + 1:
            denom = diag
            cp[:, k, :] = -b[k] / denom
            dp[:, k, :] = rhs[:, k, :] / denom
        else:
            denom = diag + a[k] * cp[:, k - 1, :]
            cp[:, k, :] = -b[k] / denom
            dp[:, k, :] = (rhs[:, k, :] + a[k] * dp[:, k - 1, :]) / denom
    w_new[:, k1, :] = dp[:, k1, :]
    for k in range(k1 - 1, k0, -1):
        w_new[:, k, :] = dp[:, k, :] - cp[:, k, :] * w_new[:, k + 1, :]
    # rigid lid: w(k0) keeps its input value (surface condition owned by
    # the caller), interfaces above k1 untouched.

    # pp update from the off-centered divergence of the NEW w
    dv_new = np.zeros_like(wv)
    for k in range(k0, k1):
        dv_new[:, k, :] = rdnw[k] * (w_new[:, k + 1, :] - w_new[:, k, :])
    dv_new[:, k1, :] = rdnw[k1] * (F32(0.0) - w_new[:, k1, :])

    for k in range(k0, k1 + 1):
        ppv[:, k, :] = ppv[:, k, :] - c * (
            beta * dv_new[:, k, :] + alfa * dv[:, k, :]
        )
    for k in range(k0 + 1, k1 + 1):
        wv[:, k, :] = w_new[:, k, :]
    return w, pp


def advance_w(*, w, pp, t, rdn, rdnw, dts, epssm, window,
              k0: int, k1: int, offsets=(0, 0),
              cw=DEFAULT_CW, gw=DEFAULT_GW):
    """Masked whole-array vertically-implicit substep on (halo-padded)
    local blocks, in eager PyTorch on the tensors' device; returns
    ``(w_new, pp_new)`` as new tensors.  The port of ``advance_w_jnp``:
    global ``window`` + ``offsets``, the same masks and association; its
    two ``lax.scan`` sweeps over k run here as Python loops on ``(J, I)``
    slices."""
    dts, epssm = F32(dts), F32(epssm)
    cw, gw = F32(cw), F32(gw)
    beta = F32(0.5) * (F32(1.0) + epssm)
    alfa = F32(1.0) - beta
    c = cw * dts
    cb2 = float((c * beta) * (c * beta))
    c_f, beta_f, alfa_f = float(c), float(beta), float(alfa)
    eb = float((c * beta) * (c * alfa))
    g_t = float(dts * gw)

    J, K, I = w.shape
    dev = w.device
    j_off, i_off = (int(x) for x in offsets)
    i0, i1, j0, j1 = (int(x) for x in window)
    i_idx = i_off + torch.arange(I, device=dev)
    j_idx = j_off + torch.arange(J, device=dev)
    mask = (((i_idx >= i0) & (i_idx <= i1))[None, None, :]
            & ((j_idx >= j0) & (j_idx <= j1))[:, None, None])   # (J, 1, I)
    kv = torch.arange(K, device=dev)
    k_int = ((kv > k0) & (kv <= k1))[None, :, None]           # interfaces
    k_cen = ((kv >= k0) & (kv <= k1))[None, :, None]          # centers
    below_top = (kv < k1)[None, :, None]

    rdn3 = rdn.view(1, K, 1)
    rdnw3 = rdnw.view(1, K, 1)
    a3 = torch.where(k_int, cb2 * rdn3 * torch.roll(rdnw3, 1, 1), 0.0)
    b3 = torch.where(k_int, cb2 * rdn3 * rdnw3, 0.0)

    # center divergence of the old w (surface interface and w above k1: 0)
    w_act = torch.where(k_int, w, 0.0)
    w_up = torch.where(below_top, torch.roll(w_act, -1, 1), 0.0)
    dv = torch.where(k_cen, rdnw3 * (w_up - w_act), 0.0)

    rhs = torch.where(
        k_int,
        w + (-(c_f * rdn3)) * (pp - torch.roll(pp, 1, 1))
        + (eb * rdn3) * (dv - torch.roll(dv, 1, 1))
        + g_t * t,
        0.0)

    # Thomas sweeps over k; c' is the same in every column, so it is
    # carried as a scalar (value-preserving: the same f32 operations)
    a1, b1 = a3.view(K), b3.view(K)
    dp = torch.zeros_like(w)
    cp = torch.zeros(K, dtype=w.dtype, device=dev)
    for k in range(k0 + 1, k1 + 1):
        diag = 1.0 + a1[k] + b1[k]
        denom = diag if k == k0 + 1 else diag + a1[k] * cp[k - 1]
        cp[k] = -b1[k] / denom
        dp[:, k, :] = (rhs[:, k, :] if k == k0 + 1
                       else rhs[:, k, :] + a1[k] * dp[:, k - 1, :]) / denom
    w_sol = torch.zeros_like(w)
    if k1 > k0:
        w_sol[:, k1, :] = dp[:, k1, :]   # dp - c'*0
    for k in range(k1 - 1, k0, -1):
        w_sol[:, k, :] = dp[:, k, :] - cp[k] * w_sol[:, k + 1, :]

    w_new = torch.where(k_int & mask, w_sol, w)

    # pp update from the off-centered divergence of the new w
    wn_act = torch.where(k_int, w_new, 0.0)
    wn_up = torch.where(below_top, torch.roll(wn_act, -1, 1), 0.0)
    dv_new = torch.where(k_cen, rdnw3 * (wn_up - wn_act), 0.0)
    pp_new = torch.where(k_cen & mask,
                         pp - c_f * (beta_f * dv_new + alfa_f * dv), pp)
    return w_new, pp_new
