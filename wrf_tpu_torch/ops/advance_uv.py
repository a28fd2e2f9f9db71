"""advance_uv: the acoustic-step wind update.

Port of ``wrf_tpu/ops/advance_uv.py``.

The reference sample contains only the mu/theta substep (advance_mu_t); in
the full WRF small_step_em loop the horizontal momenta are advanced every
acoustic substep from the pressure-gradient terms before advance_mu_t runs.
This module provides the framework's wind substep as a *linearized acoustic*
update — the coupled momenta respond to the horizontal gradient of the
column-mass perturbation through an effective sound-speed-squared constant:

    p'      = cs2 * mu'                        (linearized column pressure)
    u(i,j) += dts * (muu/msfuy)(i,j) * (-rdx) * (p'(i,j) - p'(i-1,j))
    v(i,j) += dts * (muv*msfvx_inv)(i,j) * (-rdy) * (p'(i,j) - p'(i,j-1))

staggered backward differences onto the u/v edge points, applied over the
edge windows interior to the mass window.  This closes the mu <-> (u, v)
acoustic feedback loop so the multi-substep integration has the real data
flow (winds change every substep; neighbors' mu is read).

Divergence damping: WRF's small step filters the external acoustic mode by
adding a term proportional to the PREVIOUS substep's mass-divergence
tendency to the pressure gradient (smdiv, dyn_em namelist) — that tendency
is exactly the ``mudf`` field advance_mu_t computes ("saved for the
divergence damping filter", module_small_step_em.f90).  With ``mudf`` and
``smdiv`` supplied, the effective pressure becomes

    p = cs2 * mu + (cs2 * smdiv) * mudf

so the gradient damps divergence growth; the reference computes mudf but
ships no consumer — this closes that loop.

Both a numpy golden implementation (FP-order exact, with the damping term)
and a masked whole-array PyTorch implementation (:func:`advance_uv`, the
eager tier, with the same damping term) are provided, verified
against each other like every other kernel in the framework.  The fused
kernels run the same update inside K1 and K3.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32

#: effective squared sound speed for the linearized pressure.  The momenta
#: are mass-coupled (u ~ mut*u_phys, mut ~ 5e4 Pa at the fixture scales), so
#: the discrete acoustic gain per substep is (dts*rdx)^2 * cs2 * mut and must
#: stay well below 1 for the coupled loop to be stable; 25.0 gives ~0.035 at
#: the default fixture scales (dts=2, dx=12 km).
DEFAULT_CS2 = 25.0


def uv_windows(window):
    """Edge-point update windows from the mass window ``(i0, i1, j0, j1)``:
    u points strictly interior in i, v points strictly interior in j."""
    i0, i1, j0, j1 = window
    return (i0 + 1, i1, j0, j1), (i0, i1, j0 + 1, j1)


def advance_uv_numpy(*, u, v, mu, muu, muv, msfuy, msfvx_inv,
                     rdx, rdy, dts, window, cs2=DEFAULT_CS2,
                     mudf=None, smdiv=0.0):
    """Golden-path wind update; returns new (u, v), inputs not mutated."""
    rdx, rdy, dts, cs2 = F32(rdx), F32(rdy), F32(dts), F32(cs2)
    (ui0, ui1, uj0, uj1), (vi0, vi1, vj0, vj1) = uv_windows(window)
    u = np.array(u, dtype=F32, copy=True)
    v = np.array(v, dtype=F32, copy=True)
    p = (cs2 * np.asarray(mu, F32)).astype(F32)
    if mudf is not None and smdiv:
        p = p + (cs2 * F32(smdiv)) * np.asarray(mudf, F32)

    ujs, uis = slice(uj0, uj1 + 1), slice(ui0, ui1 + 1)
    uim = slice(ui0 - 1, ui1)
    coef_u = (dts * (muu[ujs, uis] / msfuy[ujs, uis]) * (-rdx)).astype(F32)
    u[ujs, :, uis] = u[ujs, :, uis] + (
        coef_u * (p[ujs, uis] - p[ujs, uim])
    )[:, None, :]

    vjs, vis = slice(vj0, vj1 + 1), slice(vi0, vi1 + 1)
    vjm = slice(vj0 - 1, vj1)
    coef_v = (dts * (muv[vjs, vis] * msfvx_inv[vjs, vis]) * (-rdy)).astype(F32)
    v[vjs, :, vis] = v[vjs, :, vis] + (
        coef_v * (p[vjs, vis] - p[vjm, vis])
    )[:, None, :]
    return u, v


def advance_uv(*, u, v, mu, muu, muv, msfuy, msfvx_inv,
               rdx, rdy, dts, window, offsets=(0, 0), cs2=DEFAULT_CS2,
               mudf=None, smdiv=0.0):
    """Masked whole-array wind update on (halo-padded) local blocks, in
    eager PyTorch; returns new ``(u, v)`` tensors.  The port of
    ``advance_uv_jnp``: ``window`` is in the global coordinates defined by
    ``offsets`` (the global index of local row/col 0); the i-1 / j-1
    neighbours are rolls, and the wrapped edge cells are masked.  With
    ``mudf`` and a nonzero ``smdiv`` the pressure is
    ``cs2*mu + (cs2*smdiv)*mudf`` (the numpy version's association)."""
    rdx, rdy, dts, cs2 = (float(F32(x)) for x in (rdx, rdy, dts, cs2))
    j_off, i_off = (int(x) for x in offsets)
    J, _, I = u.shape
    dev = u.device
    i_idx = i_off + torch.arange(I, device=dev)
    j_idx = j_off + torch.arange(J, device=dev)
    (ui0, ui1, uj0, uj1), (vi0, vi1, vj0, vj1) = uv_windows(window)

    p = cs2 * mu
    if mudf is not None and smdiv:
        p = p + float(F32(cs2) * F32(smdiv)) * mudf
    u_mask = (((i_idx >= ui0) & (i_idx <= ui1))[None, :]
              & ((j_idx >= uj0) & (j_idx <= uj1))[:, None])
    v_mask = (((i_idx >= vi0) & (i_idx <= vi1))[None, :]
              & ((j_idx >= vj0) & (j_idx <= vj1))[:, None])
    du = (dts * (muu / msfuy) * (-rdx)) * (p - torch.roll(p, 1, 1))
    dv = (dts * (muv * msfvx_inv) * (-rdy)) * (p - torch.roll(p, 1, 0))
    u_new = u + torch.where(u_mask, du, 0.0)[:, None, :]
    v_new = v + torch.where(v_mask, dv, 0.0)[:, None, :]
    return u_new, v_new
