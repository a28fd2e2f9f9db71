"""Seeded inputs of a cell: the ring-shaped domain fields, made on the device.

A frozen copy of the port's ``io/fixtures.make_case(balanced=True,
amplitude=...)``, rewritten to draw every field on ``device`` from one
``torch.Generator`` seeded with the run's ``--seed``, at the configuration's
grid and dx, and to return the ring-shaped arrays (the staggered extents
plus a 1-cell boundary ring, ``(ny+2, nz, nx+2)``) that the program's
``prepare`` and the reference both take.  It is ``make_case(halo=1)`` with
its memory window as the ring, so no extraction step is needed.  A run
takes them with :func:`make_host`: drawn one field at a time on the card
and each moved to the host before the next, so no domain larger than a
card's share ever sits whole on it.

What the fields are (magnitudes modelled on WRF, as in the fixture):
column dry mass ``mut`` ~ 5e4 Pa, mass-coupled winds ``u, v`` ~ 1e6 x
amplitude, theta perturbation ~ 1e4 x amplitude, map factors ~ 1, eta
layers ``dnw`` < 0 summing to -1; each 3-D and 2-D field is three smooth
low-wavenumber modes plus 5 % white noise.  The base winds ``u_1``/``v_1``
come from a streamfunction, so their coupled mass flux is discretely
non-divergent at this dx: the base state forces no mass drift.

The same seed on the same kind of device gives the same fields.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = np.float32

#: the ring-shaped fields, by rank (the program's prepare takes these names)
FIELDS_3D = ("ww", "ww_1", "u", "u_1", "v", "v_1", "t", "t_1", "t_ave", "ft",
             "w", "pp")
FIELDS_2D = ("mu", "mut", "muu", "muv", "mu_tend", "msfuy", "msfvx_inv",
             "msftx", "msfty")
FIELDS_1D = ("dnw", "fnm", "fnp", "rdnw", "rdn")


def grid(cfg: dict) -> tuple[int, int, int]:
    """(nx, ny, nz): the staggered extents e_we, e_sn, e_vert."""
    return cfg["e_we"], cfg["e_sn"], cfg["e_vert"]


def ring_shape(cfg: dict) -> tuple[int, int, int]:
    nx, ny, nz = grid(cfg)
    return (ny + 2, nz, nx + 2)


def scalars(cfg: dict) -> dict:
    """rdx, rdy, the large step dt, the acoustic dts, epssm and smdiv."""
    dt = float(cfg["time_step"])
    return {"rdx": 1.0 / cfg["dx"], "rdy": 1.0 / cfg["dy"], "dt": dt,
            "dts": dt / cfg["time_step_sound"], "epssm": cfg["epssm"],
            "smdiv": cfg["smdiv"]}


def rdn_from_dnw(dnw: np.ndarray) -> np.ndarray:
    """Interface spacing reciprocals: rdn(k) = 1/(0.5*(dnw(k)+dnw(k-1))),
    zero at k=0."""
    dnw = np.asarray(dnw, F32)
    rdn = np.zeros_like(dnw)
    dn = F32(0.5) * (dnw[1:] + dnw[:-1])
    nz = np.nonzero(dn)[0]
    rdn[1:][nz] = (F32(1.0) / dn[nz]).astype(F32)
    return rdn


def vertical(nz: int) -> dict[str, np.ndarray]:
    """The eta coordinate: dnw, fnm, fnp, rdnw, rdn (host float32)."""
    eta_w = np.linspace(1.0, 0.0, nz, dtype=np.float64) ** 1.3
    dnw = np.zeros(nz, dtype=F32)
    dnw[: nz - 1] = np.diff(eta_w).astype(F32)
    dnw[nz - 1] = dnw[nz - 2]
    rdnw = np.zeros(nz, dtype=F32)
    rdnw[dnw != 0] = (F32(1.0) / dnw[dnw != 0]).astype(F32)
    fnm = np.full(nz, 0.5, dtype=F32)
    fnp = np.full(nz, 0.5, dtype=F32)
    for k in range(1, nz - 1):
        d0, d1 = -float(dnw[k - 1]), -float(dnw[k])
        fnm[k] = F32(d1 / (d0 + d1))
        fnp[k] = F32(d0 / (d0 + d1))
    return {"dnw": dnw, "fnm": fnm, "fnp": fnp, "rdnw": rdnw,
            "rdn": rdn_from_dnw(dnw)}


def _modes(gen, dev, waves: int = 3):
    """``waves`` rows of (aj, ak, ai, pj, pk, pi): wavenumbers in
    [0.5, 2.5), phases in [0, 2 pi)."""
    p = torch.rand((waves, 6), generator=gen, device=dev, dtype=torch.float64)
    return torch.cat([0.5 + 2.0 * p[:, :3], 2 * math.pi * p[:, 3:]], dim=1)


def _axis(n: int, dev, extra: int = 0) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n + extra, dtype=torch.float64,
                          device=dev)


def _smooth3(gen, shape, amp: float, base: float = 0.0,
             waves: int = 3) -> torch.Tensor:
    """Three separable sin*cos*sin modes plus 5 % noise, float32."""
    J, K, I = shape
    dev = gen.device
    m = _modes(gen, dev, waves)
    j, k, i = _axis(J, dev), _axis(K, dev), _axis(I, dev)
    out = torch.zeros(shape, dtype=torch.float32, device=dev)
    for w in range(waves):
        sj = torch.sin(2 * math.pi * m[w, 0] * j + m[w, 3]).float()
        ck = torch.cos(2 * math.pi * m[w, 1] * k + m[w, 4]).float()
        si = torch.sin(2 * math.pi * m[w, 2] * i + m[w, 5]).float()
        out += (sj[:, None, None] * ck[None, :, None]) * si[None, None, :]
    noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return base + amp * (out / waves + 0.05 * noise)


def _smooth2(gen, shape2, amp: float, base: float = 0.0) -> torch.Tensor:
    J, I = shape2
    return _smooth3(gen, (J, 1, I), amp, base)[:, 0, :].contiguous()


def fields(cfg: dict, seed: int, device):
    """Every ring-shaped field of a cell, float32 on ``device``, from
    ``seed`` (any whole number; taken modulo 2**64), one ``(name, tensor)``
    at a time: a field is drawn only once the one before has been handed
    out, so a caller that moves each to the host never holds the domain on
    the card (the four 2-D fields the base winds need stay, and the
    streamfunction's float64 block while the winds are made)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    amp = float(cfg["amplitude"])
    J, K, I = s3 = ring_shape(cfg)
    s2 = (J, I)
    for n, v in vertical(K).items():
        yield n, torch.from_numpy(v).to(dev)
    kept = {}
    for n, shape, a, base in (
            ("msfuy", s2, 0.05, 1.0), ("msfvx_inv", s2, 0.05, 1.0),
            ("msftx", s2, 0.05, 1.0), ("msfty", s2, 0.05, 1.0),
            ("mut", s2, 2e3, 5e4), ("muu", s2, 2e3, 5e4),
            ("muv", s2, 2e3, 5e4), ("mu", s2, 1e2, 0.0),
            ("mu_tend", s2, 1e-1, 0.0),
            ("u", s3, 1e6 * amp, 0.0), ("v", s3, 1e6 * amp, 0.0),
            ("t_1", s3, 1e1 * amp, 0.0), ("t", s3, 1e4 * amp, 0.0),
            ("ft", s3, 1e0 * amp, 0.0), ("t_ave", s3, 1e4 * amp, 0.0),
            ("ww", s3, 1e-1 * amp, 0.0), ("ww_1", s3, 1e-3 * amp, 0.0),
            ("w", s3, 1e0, 0.0), ("pp", s3, 1e2, 0.0)):
        x = (_smooth2 if len(shape) == 2 else _smooth3)(gen, shape, a, base)
        if n in ("msfuy", "msfvx_inv", "muu", "muv"):
            kept[n] = x
        yield n, x
        del x
    # balanced base winds: U = rdy*d_j(psi), V = -rdx*d_i(psi) as coupled
    # fluxes have rdx*d_i(U) + rdy*d_j(V) = 0 cell by cell; uncoupled
    # through the mass and map-factor fields into the *_1 slots
    sc = scalars(cfg)
    rdx, rdy = sc["rdx"], sc["rdy"]
    m = _modes(gen, dev)
    jj, kk, ii = _axis(J, dev, 1), _axis(K, dev), _axis(I, dev, 1)
    psi = torch.zeros((J + 1, K, I + 1), dtype=torch.float64, device=dev)
    for w in range(3):
        psi += ((torch.sin(2 * math.pi * m[w, 0] * jj + m[w, 3])[:, None, None]
                 * torch.cos(2 * math.pi * m[w, 1] * kk + m[w, 4])[None, :, None])
                * torch.sin(2 * math.pi * m[w, 2] * ii + m[w, 5])[None, None, :])
    psi *= 1e4 / (3 * max(rdx, rdy))
    cflux_u = (psi[1:, :, :I] - psi[:J, :, :I]) * rdy
    u_1 = (cflux_u * kept["msfuy"].double()[:, None, :]
           / kept["muu"].double()[:, None, :]).float()
    del cflux_u
    yield "u_1", u_1
    del u_1
    cflux_v = -(psi[:J, :, 1:] - psi[:J, :, :I]) * rdx
    del psi
    yield "v_1", (cflux_v / (kept["muv"].double()[:, None, :]
                             * kept["msfvx_inv"].double()[:, None, :])).float()


def make_domain(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every ring-shaped field of a cell at once, float32 on ``device``
    (:func:`fields` gathered)."""
    return dict(fields(cfg, seed, device))


def make_host(cfg: dict, seed: int, device) -> dict[str, np.ndarray]:
    """The same fields, drawn on ``device`` one at a time and each moved to
    the host before the next is drawn: equal to :func:`make_domain`'s bit
    for bit, with at most one 3-D field of them on ``device`` at a time."""
    return {n: x.cpu().numpy() for n, x in fields(cfg, seed, device)}
