"""The acoustic small-step loop on one GPU: advance_uv + advance_mu_t per substep.

Port of ``wrf_tpu/models/small_step.py::SmallStepLoop`` for the 1x1
layout.  Every substep is ONE launch of the fused K1 kernel
(``advance_mu_t_fused(fuse_uv=True)``): the wind update runs inside it from
mu's neighbours, so u and v stream once per substep.  The loop zero-pads
every field by one cell (the halo a one-device layout gives), computes
the lean constants once, runs ``n_steps-1`` lean "lite" substeps that
carry only ww's scan-seed row, then one final substep that
re-materializes ww and writes t_ave, and trims the halo and the boundary
ring.  The substeps are a Python loop.

:func:`small_step_golden` is the JAX module's numpy golden loop, the
reference the driver's coupled tiers are verified against; that module
imports jax, so the loop and its numpy wind update are copied here.
"""

from __future__ import annotations

import numpy as np
import torch

from wrf_tpu.grid import ConfigFlags
from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy

from ..ops.advance_mu_t_cuda import (
    advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
)
from ..parallel.sharded import (
    domain_window, pad_local, prepare_arrays, strip_local,
)

#: effective squared sound speed of the linearized wind update
#: (``wrf_tpu.ops.advance_uv.DEFAULT_CS2``)
DEFAULT_CS2 = 25.0

#: what the scan substeps carry: ww only as its 2-D scan-seed row
CARRY_KEYS = ("ww_row", "mu", "t", "u", "v")

OUT_NAMES = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave", "u", "v")

#: fields the golden loop carries (and updates) across substeps
STATE_KEYS = ("ww", "mu", "t", "t_ave", "u", "v")

F32 = np.float32


def advance_uv_numpy(*, u, v, mu, muu, muv, msfuy, msfvx_inv, rdx, rdy, dts,
                     window, cs2=DEFAULT_CS2):
    """Golden-path wind update (``wrf_tpu.ops.advance_uv.advance_uv_numpy``
    without divergence damping); returns new (u, v), inputs not mutated.
    u points are updated strictly inside the mass window in i, v points
    strictly inside it in j."""
    rdx, rdy, dts, cs2 = F32(rdx), F32(rdy), F32(dts), F32(cs2)
    i0, i1, j0, j1 = window
    u = np.array(u, dtype=F32, copy=True)
    v = np.array(v, dtype=F32, copy=True)
    p = (cs2 * np.asarray(mu, F32)).astype(F32)

    ujs, uis, uim = slice(j0, j1 + 1), slice(i0 + 1, i1 + 1), slice(i0, i1)
    coef_u = (dts * (muu[ujs, uis] / msfuy[ujs, uis]) * (-rdx)).astype(F32)
    u[ujs, :, uis] = u[ujs, :, uis] + (
        coef_u * (p[ujs, uis] - p[ujs, uim]))[:, None, :]

    vjs, vis, vjm = slice(j0 + 1, j1 + 1), slice(i0, i1 + 1), slice(j0, j1)
    coef_v = (dts * (muv[vjs, vis] * msfvx_inv[vjs, vis]) * (-rdy)).astype(F32)
    v[vjs, :, vis] = v[vjs, :, vis] + (
        coef_v * (p[vjs, vis] - p[vjm, vis]))[:, None, :]
    return u, v


def small_step_golden(case, steps: int, cs2: float = DEFAULT_CS2):
    """Golden-path acoustic loop on memory-window arrays (single tile):
    each substep the numpy wind update, then ``advance_mu_t_numpy``
    (``wrf_tpu.models.small_step.small_step_golden`` without the w substep
    and divergence damping)."""
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, _, _ = case.bounds.loop_bounds(case.flags)
    state = {k: np.asarray(kw[k]) for k in STATE_KEYS}
    out = dict(state)
    for _ in range(steps):
        u, v = advance_uv_numpy(
            u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
            muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
            window=(i0, i1, j0, j1), cs2=cs2)
        out = advance_mu_t_numpy(**{**kw, **state, "u": u, "v": v})
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    return {**out, "u": state["u"], "v": state["v"]}


class SmallStepLoop:
    """The coupled acoustic small-step loop on one device.

    Same array contract as the JAX loop: ring-shaped inputs, ``prepare`` ->
    ``__call__``; returns the domain-shaped outputs, final winds included.
    ``kernel="cuda"`` runs :func:`advance_mu_t_fused` (the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors); ``kernel="plain"``
    always runs the plain version, for comparisons.
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda", device="cuda"):
        if kernel not in ("cuda", "plain"):
            raise ValueError(f"bad kernel {kernel!r}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        self.domain = (nx, ny, nz)
        self.n_steps = n_steps
        self.device = torch.device(device)
        self.window = domain_window(nx, ny, nz, flags)
        self._step = (advance_mu_t_fused if kernel == "cuda"
                      else advance_mu_t_fused_plain)

    def prepare(self, arrays) -> dict[str, torch.Tensor]:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device."""
        return prepare_arrays(arrays, self.device)

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        padded = pad_local(arrays)
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        common = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0,
                      k1=k1, kde=nz - 1, fuse_uv=True, cs2=DEFAULT_CS2,
                      **scalars)
        lean_kw = lean_kwargs(padded, rdx, rdy, dts, k0, k1)
        padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
        const = {k: v for k, v in padded.items() if k not in CARRY_KEYS}
        state = {k: padded[k] for k in CARRY_KEYS}

        for _ in range(self.n_steps - 1):
            out = self._step(**const, **state, **lean_kw, **common,
                             with_tave=False, ww_mode="lite", lean=True)
            state = {k: out[k] for k in CARRY_KEYS}
        out = self._step(**const, **state, **common,
                         with_tave=True, ww_mode="final")
        return strip_local(out, OUT_NAMES, self.domain)
