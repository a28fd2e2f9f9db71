"""advance_mu_t as whole-array PyTorch operations: the port's eager tier.

The port of ``wrf_tpu/ops/advance_mu_t_jnp.py`` (the JAX package's XLA
path): the update is expressed over the whole ``(j, k, i)`` window, with
the BC-aware loop bounds as per-axis masks, ``torch.roll`` for the +-1
neighbours, ``torch.sum`` for the column reduction and ``torch.cumsum``
for the ww scan.  It is an independent formulation, not a kernel's plain
version: like the XLA tier it leaves the order of the reduction and the
scan to the library, so it agrees with the kernels and the oracle within
the float32 tolerance class, not bit for bit.  It runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ConfigFlags, GridBounds

from .advance_mu_t_cuda import _f32


def window_masks(bounds: GridBounds,
                 flags: ConfigFlags) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis boolean masks for the BC-aware compute window (single-tile
    case: the tile sees the whole domain)."""
    i0, i1, j0, j1, _, _ = bounds.loop_bounds(flags)
    i_mask = np.zeros(bounds.idim, dtype=bool)
    i_mask[i0 : i1 + 1] = True
    j_mask = np.zeros(bounds.jdim, dtype=bool)
    j_mask[j0 : j1 + 1] = True
    return i_mask, j_mask


def _shift_m1(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[..., x-1, ...]: the -1 neighbour (edge cells are masked)."""
    return torch.roll(a, 1, dim)


def _shift_p1(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[..., x+1, ...]: the +1 neighbour (edge cells are masked)."""
    return torch.roll(a, -1, dim)


def advance_mu_t_impl(
    *, ww, ww_1, u, u_1, v, v_1, mu, mut, muu, muv, t, t_1, t_ave, ft,
    mu_tend, rdx, rdy, dts, epssm, dnw, fnm, fnp, rdnw,
    msfuy, msfvx_inv, msftx, msfty,
    i_mask, j_mask,     # (i,), (j,) bool tensors: the BC-aware window
    k0: int, k1: int, kde: int,
    capture_intermediates: bool = False,
) -> dict[str, torch.Tensor]:
    """One acoustic small step; returns new ``ww, mu, muave, muts, mudf, t,
    t_ave`` (fresh tensors; the inputs are not modified).  Cells outside
    the window keep their input values (zeros for the pure outputs).  With
    ``capture_intermediates`` the result also carries the five
    ``*_before_theta`` phase-A snapshots, the values of the outputs they
    are named after (nothing is zeroed: the edge treatment of
    ``advance_mu_t_jnp``)."""
    del kde   # the fill range k0+1..k1 never reaches the domain top
    rdx, rdy, dts, epssm = (_f32(s) for s in (rdx, rdy, dts, epssm))
    K = t.shape[1]
    mask2 = j_mask[:, None] & i_mask[None, :]              # (j, i)
    mask2f = mask2[:, None, :]                             # (j, 1, i)
    kv = torch.arange(K, device=t.device)
    k_window = ((kv >= k0) & (kv <= k1))[None, :, None]

    # ---- Phase A: horizontal mass-flux divergence -------------------------
    # association of the golden path: (muv*v_1)*msfvx_inv, (muu*u_1)/msfuy
    vflux = v + (muv[:, None, :] * v_1) * msfvx_inv[:, None, :]
    uflux = u + (muu[:, None, :] * u_1) / msfuy[:, None, :]
    dvdxi = (msftx * msfty)[:, None, :] * (
        rdy * (_shift_p1(vflux, 0) - vflux)
        + rdx * (_shift_p1(uflux, 2) - uflux))
    dmdt = torch.sum(dnw[None, k0 : k1 + 1, None] * dvdxi[:, k0 : k1 + 1, :],
                     dim=1)                                # (j, i)

    # ---- mu update with epsilon off-centering ----------------------------
    tend = dmdt + mu_tend
    mu_new = mu + dts * tend
    muave_new = 0.5 * ((1.0 + epssm) * mu_new + (1.0 - epssm) * mu)
    mu_out = torch.where(mask2, mu_new, mu)
    mudf_out = torch.where(mask2, tend, 0.0)
    muts_out = torch.where(mask2, mut + mu_new, 0.0)
    muave_out = torch.where(mask2, muave_new, 0.0)

    # ---- ww vertical scan: a cumulative sum along k -----------------------
    steps_k = (-dnw[None, k0:k1, None]
               * (dmdt[:, None, :] + dvdxi[:, k0:k1, :] + mu_tend[:, None, :])
               / msfty[:, None, :])                        # (j, nk-1, i)
    ww_base = ww[:, k0 : k0 + 1, :]
    ww_scan = torch.cat([ww_base, ww_base + torch.cumsum(steps_k, dim=1)],
                        dim=1)                             # (j, nk, i)
    ww_upd = ww_scan - ww_1[:, k0 : k1 + 1, :]
    ww_full = torch.cat([ww[:, :k0, :], ww_upd, ww[:, k1 + 1 :, :]], dim=1)
    ww_out = torch.where(mask2f, ww_full, ww)

    # the phase-A outputs before the theta phase, for phase-by-phase
    # bisection of a numerical divergence (the reference's mid-kernel
    # "*_before_theta.bin" dumps)
    captured = {}
    if capture_intermediates:
        captured = {"muave_before_theta": muave_out,
                    "mu_before_theta": mu_out,
                    "mudf_before_theta": mudf_out,
                    "muts_before_theta": muts_out,
                    "ww_before_theta": ww_out}

    # ---- Phase B: theta ---------------------------------------------------
    t_half = t + (msfty * dts)[:, None, :] * ft
    t_ave_out = torch.where(mask2f & k_window, t, t_ave)
    # wdtn(k) = ww(k) * (fnm(k)*t_1(k) + fnp(k)*t_1(k-1)), zero at the
    # surface (k0) and above k1
    interp = fnm[None, :, None] * t_1 + fnp[None, :, None] * _shift_m1(t_1, 1)
    kint = ((kv >= k0 + 1) & (kv <= k1))[None, :, None]
    wdtn = torch.where(kint, ww_out * interp, 0.0)
    fy = (_shift_p1(v, 0) * (_shift_p1(t_1, 0) + t_1)
          - v * (t_1 + _shift_m1(t_1, 0)))
    fx = (_shift_p1(u, 2) * (_shift_p1(t_1, 2) + t_1)
          - u * (t_1 + _shift_m1(t_1, 2)))
    horiz = msftx[:, None, :] * (0.5 * rdy * fy + 0.5 * rdx * fx)
    vert = rdnw[None, :, None] * (_shift_p1(wdtn, 1) - wdtn)
    t_new = t_half - (dts * msfty)[:, None, :] * (horiz + vert)
    t_out = torch.where(mask2f & k_window, t_new, t)

    return {"ww": ww_out, "mu": mu_out, "muave": muave_out,
            "muts": muts_out, "mudf": mudf_out, "t": t_out,
            "t_ave": t_ave_out, **captured}


#: the entry the tiers call: ``advance_mu_t_jnp.advance_mu_t_core`` is the
#: jitted impl; PyTorch runs it as it is
advance_mu_t_core = advance_mu_t_impl
