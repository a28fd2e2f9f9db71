"""The plain reference of a cell: one closed RK3 large step in whole-array PyTorch.

A frozen copy of the port's plain arithmetic, written out on the
ring-shaped arrays (``(ny+2, nz, nx+2)``; the compute window lies inside
the ring, so no halo padding is needed) and importing nothing but torch
and numpy:

* the acoustic substep, in WRF's small_step_em order: the wind update with
  divergence damping (the port's ``ops/advance_uv.py::advance_uv``), the
  mu/theta substep with the ww scan (``ops/advance_mu_t_eager.py``) and the
  vertically-implicit w/pp substep on the new theta (``ops/advance_w.py``);
  each stage's first substep damps with a zero ``mudf``;
* the RK3 shell (``models/rk3.py``): three stages of 1, ns/2 and ns
  substeps at dt/3, dt/2 and dt, each restarting from the step-start
  state, with the ``*_1`` advecting fields held at the base state;
* the nudging closure (``models/tendencies.py``): ``ft`` and ``mu_tend``
  recomputed once per large step from the step-start state as
  ``(x_ref - x) / (tau_steps * dt)``, and the winds damped by
  ``1 - rayleigh_uv`` after the step.

Nothing the program derives is taken: the window, the wind and Thomas
coefficients and the closure's rates are worked out here again from the
configuration and the seeded inputs.  ``dtype`` is the precision the
arithmetic runs in: float32, as the configuration states, or bfloat16 for
the control that must come out as not correct.

A domain too large for one card is stepped in blocks of rows
(:func:`blocks`): a :class:`Reference` built on one block's span of the
inputs (``span``) steps those rows with the window shifted to its place,
and its rows more than :func:`halo_width` from the span's cut edges are
the whole domain's, bit for bit (every operation is elementwise, a roll or
a reduction along k; what a roll wraps round a cut edge travels one row a
substep).  A domain of at most :data:`BLOCK_CELLS` ring cells is
one block, the whole domain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the evolved large-step state the comparison covers
EVOLVED = ("ww", "mu", "t", "t_ave", "u", "v", "w", "pp")


def _f32(x) -> float:
    """A scalar rounded to float32, kept as a Python float."""
    return float(np.float32(x))


def window(nx: int, ny: int, nz: int) -> tuple[int, ...]:
    """The compute window of specified lateral boundaries in ring
    coordinates: (i0, i1, j0, j1, k0, k1), inclusive.  The staggered edge
    and one row or column on every edge are excluded; mass levels run
    0..nz-2."""
    return (2, nx - 2, 2, ny - 2, 0, nz - 2)


def rk3_stages(ns: int) -> tuple[tuple[float, int], ...]:
    """(stage dt fraction, substeps) of WRF's three RK3 stages."""
    ns = max(2, ns)
    return ((1.0 / 3.0, 1), (0.5, max(1, ns // 2)), (1.0, ns))


#: the most ring cells (J*K*I) one block of the reference spans: a bound
#: on its working set on a card, which holds about 40 float32 arrays of
#: the block's size at once
BLOCK_CELLS = 2**27


def halo_width(cfg: dict, steps: int) -> int:
    """Rows of halo a block needs for ``steps`` large steps.

    A substep's new values at a cell read the old ones at most one row and
    one column away: the wind update's backward differences of mu and
    mudf (v at j from j-1, u at i from i-1), the mass-flux divergence's
    forward ones (j+1, i+1, which also carry the damping's mudf) and
    theta's centred fluxes (j-1..j+1, i-1..i+1); the ww scan, the w/pp
    solve and the closure stay in their column.  So a substep carries what
    a cut edge spoils one row in.  The stages of a large step
    restart from its start state, so the longest stage bounds a step's
    reach; this counts every stage's substeps, which also holds were the
    stages to follow one another."""
    return steps * sum(n for _, n in rk3_stages(cfg["time_step_sound"]))


def block_count(shape, halo: int) -> int:
    """The fewest j blocks whose spans hold at most :data:`BLOCK_CELLS`
    ring cells each (one where the whole domain does)."""
    J, K, I = shape
    nj = 1
    while nj < J and (math.ceil(J / nj) + 2 * halo * (nj > 1)) * K * I \
            > BLOCK_CELLS:
        nj += 1
    return nj


def blocks(shape, nj: int, halo: int) -> list[tuple[tuple, tuple]]:
    """The blocks of a ring-shaped ``(J, K, I)`` domain cut ``nj`` ways in
    j, whole rows each: ``(own, span)``, ``own`` the rows it answers for
    and ``span`` those with ``halo`` more on each side, clipped at the
    domain's edges; each ``(j0, j1, 0, I)``, half-open.  (Rows only: cut
    in i as well, torch's CPU sum over k takes another order at another
    row width, and the blocks would differ from the whole in the last
    place.)"""
    J, _, I = shape
    out = []
    for b in range(nj):
        j0, j1 = J * b // nj, J * (b + 1) // nj
        out.append(((j0, j1, 0, I),
                    (max(0, j0 - halo), min(J, j1 + halo), 0, I)))
    return out


def _masks(shape, win, dev):
    J, _, I = shape
    i0, i1, j0, j1 = win[:4]
    i = torch.arange(I, device=dev)
    j = torch.arange(J, device=dev)
    return (i >= i0) & (i <= i1), (j >= j0) & (j <= j1)


def advance_uv(s, c, dts, win, cs2, smdiv):
    """The linearized acoustic wind update, damped by the previous
    substep's mudf: ``p = cs2*mu + (cs2*smdiv)*mudf``; staggered backward
    differences onto the u and v points strictly inside the window."""
    rdx, rdy, dts, cs2 = (_f32(x) for x in (c["rdx"], c["rdy"], dts, cs2))
    i0, i1, j0, j1 = win[:4]
    J, _, I = s["u"].shape
    dev = s["u"].device
    i = torch.arange(I, device=dev)
    j = torch.arange(J, device=dev)
    p = cs2 * s["mu"]
    if smdiv:
        p = p + _f32(np.float32(cs2) * np.float32(smdiv)) * s["mudf"]
    u_mask = (((i >= i0 + 1) & (i <= i1))[None, :]
              & ((j >= j0) & (j <= j1))[:, None])
    v_mask = (((i >= i0) & (i <= i1))[None, :]
              & ((j >= j0 + 1) & (j <= j1))[:, None])
    du = (dts * (c["muu"] / c["msfuy"]) * (-rdx)) * (p - torch.roll(p, 1, 1))
    dv = (dts * (c["muv"] * c["msfvx_inv"]) * (-rdy)) * (p - torch.roll(p, 1, 0))
    return (s["u"] + torch.where(u_mask, du, 0.0)[:, None, :],
            s["v"] + torch.where(v_mask, dv, 0.0)[:, None, :])


def advance_mu_t(s, c, u, v, dts, epssm, win):
    """The mu/theta substep: the horizontal mass-flux divergence, mu with
    epsilon off-centering, the ww scan up the column and the theta update;
    cells outside the window keep their values."""
    rdx, rdy, dts, epssm = (_f32(x) for x in (c["rdx"], c["rdy"], dts, epssm))
    i_mask, j_mask = _masks(s["t"].shape, win, s["t"].device)
    k0, k1 = win[4:]
    t, mu, ww, t_ave = s["t"], s["mu"], s["ww"], s["t_ave"]
    ww_1, u_1, v_1, t_1 = c["ww_1"], c["u_1"], c["v_1"], c["t_1"]
    muu, muv, mut = c["muu"], c["muv"], c["mut"]
    msfuy, msfvx_inv, msftx, msfty = (c[n] for n in
                                      ("msfuy", "msfvx_inv", "msftx", "msfty"))
    dnw, fnm, fnp, rdnw = c["dnw"], c["fnm"], c["fnp"], c["rdnw"]
    ft, mu_tend = s["ft"], s["mu_tend"]
    K = t.shape[1]
    mask2 = j_mask[:, None] & i_mask[None, :]
    mask2f = mask2[:, None, :]
    kv = torch.arange(K, device=t.device)
    k_window = ((kv >= k0) & (kv <= k1))[None, :, None]

    def up(a, dim):      # a[x+1]
        return torch.roll(a, -1, dim)

    def down(a, dim):    # a[x-1]
        return torch.roll(a, 1, dim)

    vflux = v + (muv[:, None, :] * v_1) * msfvx_inv[:, None, :]
    uflux = u + (muu[:, None, :] * u_1) / msfuy[:, None, :]
    dvdxi = (msftx * msfty)[:, None, :] * (
        rdy * (up(vflux, 0) - vflux) + rdx * (up(uflux, 2) - uflux))
    dmdt = torch.sum(dnw[None, k0:k1 + 1, None] * dvdxi[:, k0:k1 + 1, :],
                     dim=1)
    tend = dmdt + mu_tend
    mu_new = mu + dts * tend
    mu_out = torch.where(mask2, mu_new, mu)
    mudf_out = torch.where(mask2, tend, 0.0)

    steps_k = (-dnw[None, k0:k1, None]
               * (dmdt[:, None, :] + dvdxi[:, k0:k1, :] + mu_tend[:, None, :])
               / msfty[:, None, :])
    ww_base = ww[:, k0:k0 + 1, :]
    ww_scan = torch.cat([ww_base, ww_base + torch.cumsum(steps_k, dim=1)],
                        dim=1)
    ww_upd = ww_scan - ww_1[:, k0:k1 + 1, :]
    ww_full = torch.cat([ww[:, :k0, :], ww_upd, ww[:, k1 + 1:, :]], dim=1)
    ww_out = torch.where(mask2f, ww_full, ww)

    t_half = t + (msfty * dts)[:, None, :] * ft
    t_ave_out = torch.where(mask2f & k_window, t, t_ave)
    interp = fnm[None, :, None] * t_1 + fnp[None, :, None] * down(t_1, 1)
    kint = ((kv >= k0 + 1) & (kv <= k1))[None, :, None]
    wdtn = torch.where(kint, ww_out * interp, 0.0)
    fy = up(v, 0) * (up(t_1, 0) + t_1) - v * (t_1 + down(t_1, 0))
    fx = up(u, 2) * (up(t_1, 2) + t_1) - u * (t_1 + down(t_1, 2))
    horiz = msftx[:, None, :] * (0.5 * rdy * fy + 0.5 * rdx * fx)
    vert = rdnw[None, :, None] * (up(wdtn, 1) - wdtn)
    t_new = t_half - (dts * msfty)[:, None, :] * (horiz + vert)
    t_out = torch.where(mask2f & k_window, t_new, t)
    return {"ww": ww_out, "mu": mu_out, "mudf": mudf_out, "t": t_out,
            "t_ave": t_ave_out}


def advance_w(w, pp, t, c, dts, epssm, win, cw, gw):
    """The vertically-implicit w/pp substep: per column the tridiagonal
    system of the linearized vertical acoustics, off-centered by epssm,
    rigid at the surface and the lid, solved by the Thomas algorithm."""
    dts, epssm, cw, gw = (np.float32(x) for x in (dts, epssm, cw, gw))
    beta = np.float32(0.5) * (np.float32(1.0) + epssm)
    alfa = np.float32(1.0) - beta
    cc = cw * dts
    cb2 = float((cc * beta) * (cc * beta))
    eb = float((cc * beta) * (cc * alfa))
    c_f, beta_f, alfa_f, g_t = float(cc), float(beta), float(alfa), float(dts * gw)
    J, K, I = w.shape
    dev = w.device
    i_mask, j_mask = _masks(w.shape, win, dev)
    k0, k1 = win[4:]
    mask = j_mask[:, None, None] & i_mask[None, None, :]
    kv = torch.arange(K, device=dev)
    k_int = ((kv > k0) & (kv <= k1))[None, :, None]
    k_cen = ((kv >= k0) & (kv <= k1))[None, :, None]
    below_top = (kv < k1)[None, :, None]
    rdn3 = c["rdn"].view(1, K, 1)
    rdnw3 = c["rdnw"].view(1, K, 1)
    a3 = torch.where(k_int, cb2 * rdn3 * torch.roll(rdnw3, 1, 1), 0.0)
    b3 = torch.where(k_int, cb2 * rdn3 * rdnw3, 0.0)

    w_act = torch.where(k_int, w, 0.0)
    w_up = torch.where(below_top, torch.roll(w_act, -1, 1), 0.0)
    dv = torch.where(k_cen, rdnw3 * (w_up - w_act), 0.0)
    rhs = torch.where(
        k_int,
        w + (-(c_f * rdn3)) * (pp - torch.roll(pp, 1, 1))
        + (eb * rdn3) * (dv - torch.roll(dv, 1, 1)) + g_t * t,
        0.0)

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
    w_sol[:, k1, :] = dp[:, k1, :]
    for k in range(k1 - 1, k0, -1):
        w_sol[:, k, :] = dp[:, k, :] - cp[k] * w_sol[:, k + 1, :]
    w_new = torch.where(k_int & mask, w_sol, w)

    wn_act = torch.where(k_int, w_new, 0.0)
    wn_up = torch.where(below_top, torch.roll(wn_act, -1, 1), 0.0)
    dv_new = torch.where(k_cen, rdnw3 * (wn_up - wn_act), 0.0)
    pp_new = torch.where(k_cen & mask,
                         pp - c_f * (beta_f * dv_new + alfa_f * dv), pp)
    return w_new, pp_new


class Reference:
    """One closed RK3 large step of a configuration, in ``dtype``.

    Built from the configuration and the seeded inputs (host or device
    arrays, ring-shaped); holds the constant fields and the closure's
    reference ``t`` and ``mu`` (the inputs') on ``device``.  ``step(state)``
    takes and returns a dict of the :data:`EVOLVED` fields.  ``span``
    ``(j0, j1, i0, i1)`` (a block's, :func:`blocks`) restricts it to those
    rows and columns of the domain: its fields and states are the span's."""

    def __init__(self, cfg: dict, inputs: dict, device, dtype=torch.float32,
                 span=None):
        from .inputs import grid, scalars

        self.dtype = dtype
        self.sc = scalars(cfg)
        nx, ny, nz = grid(cfg)
        i0, i1, j0, j1, k0, k1 = window(nx, ny, nz)
        self.span = span
        oj, oi = (span[0], span[2]) if span else (0, 0)
        self.win = (i0 - oi, i1 - oi, j0 - oj, j1 - oj, k0, k1)
        self.stages = rk3_stages(cfg["time_step_sound"])
        self.cs2, self.cw, self.gw = cfg["cs2"], cfg["cw"], cfg["gw"]
        clo = cfg["closure"]
        self.rate = _f32(1.0 / (clo["tau_steps"] * self.sc["dt"]))
        self.damp = _f32(1.0 - clo["rayleigh_uv"])
        const = ("ww_1", "u_1", "v_1", "t_1", "mut", "muu", "muv", "msfuy",
                 "msfvx_inv", "msftx", "msfty", "dnw", "fnm", "fnp", "rdnw",
                 "rdn")
        self.const = {n: self._dev(inputs[n], device) for n in const}
        self.const.update(rdx=self.sc["rdx"], rdy=self.sc["rdy"])
        self.ref_t = self._dev(inputs["t"], device)
        self.ref_mu = self._dev(inputs["mu"], device)

    def _dev(self, x, device):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        if self.span and x.ndim > 1:
            j0, j1, i0, i1 = self.span
            x = x[j0:j1, ..., i0:i1]
        return x.to(device=device, dtype=self.dtype)

    def initial(self, inputs: dict) -> dict:
        """The step-start state of step 1: the evolved fields of the inputs."""
        return {n: self._dev(inputs[n], self.ref_t.device) for n in EVOLVED}

    def state(self, fields: dict) -> dict:
        """A step-start state from the evolved fields a run produced (the
        span's rows and columns of them, where the reference has a span)."""
        return {n: fields[n].to(device=self.ref_t.device, dtype=self.dtype)
                for n in EVOLVED}

    def _loop(self, s: dict, dts: float, n_sub: int) -> dict:
        c, win = self.const, self.win
        s = dict(s, mudf=torch.zeros_like(s["mu"]))
        smdiv = self.sc["smdiv"]
        for _ in range(n_sub):
            u, v = advance_uv(s, c, dts, win, self.cs2, smdiv)
            out = advance_mu_t(s, c, u, v, dts, self.sc["epssm"], win)
            w, pp = advance_w(s["w"], s["pp"], out["t"], c, dts,
                              self.sc["epssm"], win, self.cw, self.gw)
            s = dict(s, **out, u=u, v=v, w=w, pp=pp)
        return s

    def step(self, state: dict) -> dict:
        """One closed large step from ``state``: the nudging tendencies
        from the step-start state, the three RK3 stages, the wind damping."""
        tend = {"ft": (self.ref_t - state["t"]) * self.rate,
                "mu_tend": (self.ref_mu - state["mu"]) * self.rate}
        out = None
        for frac, n_sub in self.stages:
            dts = (frac * self.sc["dt"]) / n_sub
            out = self._loop(dict(state, **tend), dts, n_sub)
        new = {n: out[n] for n in EVOLVED}
        new["u"] = new["u"] * self.damp
        new["v"] = new["v"] * self.damp
        return new
