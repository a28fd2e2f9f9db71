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

With ``inner_steps`` = S > 1 the scan substeps are temporally blocked:
``(n_steps-1)//S`` launches of K3 (the coupled trapezoid,
``coupled_multistep``) on ring-S copies of the state and constants, then
the remaining lite substeps and the final one on K1 as above.

:func:`small_step_golden` is the JAX module's numpy golden loop, the
reference the driver's coupled tiers are verified against; that module
imports jax, so the loop and its numpy wind update are copied here.
"""

from __future__ import annotations

import numpy as np
import torch

from wrf_tpu.grid import ConfigFlags
from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy

from ..ops.advance_mu_t_coupled_cuda import (
    coupled_lean_kwargs, coupled_multistep, coupled_multistep_plain,
)
from ..ops.advance_mu_t_cuda import (
    advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
)
from ..parallel.halo import strip_ring, widen_ring_to
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
    ``kernel="cuda"`` runs :func:`advance_mu_t_fused` and, when blocked,
    :func:`coupled_multistep` (the CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors); ``kernel="plain"`` always runs the
    plain versions, for comparisons.  ``inner_steps`` = S blocks S scan
    substeps per K3 launch; ``fast`` runs those launches in K3's fast
    mode (a tolerance, not bits).  Divergence damping (``smdiv``) is not
    ported yet.
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda", device="cuda",
                 inner_steps: int = 1, fast: bool = False,
                 smdiv: float = 0.0):
        if kernel not in ("cuda", "plain"):
            raise ValueError(f"bad kernel {kernel!r}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not isinstance(inner_steps, int) or inner_steps < 1:
            raise ValueError("inner_steps must be a positive integer")
        if fast and inner_steps == 1:
            raise ValueError("fast re-associates the BLOCKED pass: it "
                             "requires inner_steps > 1 (alone it would "
                             "silently no-op)")
        if smdiv and inner_steps > 1:
            raise ValueError("inner_steps>1 does not support smdiv yet "
                             "(mudf would need its own extended rows)")
        if smdiv:
            raise NotImplementedError(
                "SmallStepLoop: divergence damping (smdiv) is not ported yet "
                "(ROADMAP.md, 'SmallStepLoop on one GPU', K1 slice (d))")
        self.domain = (nx, ny, nz)
        self.n_steps = n_steps
        self.inner_steps = inner_steps
        self.fast = fast
        self.device = torch.device(device)
        self.window = domain_window(nx, ny, nz, flags)
        plain = kernel == "plain"
        self._step = advance_mu_t_fused_plain if plain else advance_mu_t_fused
        self._block = coupled_multistep_plain if plain else coupled_multistep

    def prepare(self, arrays) -> dict[str, torch.Tensor]:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device."""
        return prepare_arrays(arrays, self.device)

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        padded = pad_local(arrays)
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        common = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0,
                      k1=k1, kde=nz - 1, cs2=DEFAULT_CS2, **scalars)
        padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
        const = {k: v for k, v in padded.items() if k not in CARRY_KEYS}
        state = {k: padded[k] for k in CARRY_KEYS}

        rem = self.n_steps - 1
        S = self.inner_steps
        if S > 1 and rem >= S:
            state = self._run_blocks(padded, state, common, rem // S)
            rem -= rem // S * S
        if rem:
            lean_kw = lean_kwargs(padded, rdx, rdy, dts, k0, k1)
        for _ in range(rem):
            out = self._step(**const, **state, **lean_kw, **common,
                             fuse_uv=True, with_tave=False, ww_mode="lite",
                             lean=True)
            state = {k: out[k] for k in CARRY_KEYS}
        out = self._step(**const, **state, **common, fuse_uv=True,
                         with_tave=True, ww_mode="final")
        return strip_local(out, OUT_NAMES, self.domain)

    def _run_blocks(self, padded, state, common, n_blocks):
        """``n_blocks`` K3 launches of S substeps on ring-S copies of the
        state; returns the state back in the ring-1 layout.  The constants
        are computed ON the widened inputs, in the JAX loop's order
        (computed first and widened after, dvdxi_const's rolls would leave
        wrapped values in ring cells the trapezoid reads)."""
        S = self.inner_steps

        def widen(x):
            return widen_ring_to(x, 0, S)

        wide = {k: widen(padded[k])
                for k in ("ww_1", "u_1", "v_1", "ft", "t_1", "muu", "muv",
                          "msfuy", "msfvx_inv", "msftx", "msfty")}
        wide.update({k: padded[k] for k in ("fnm", "fnp", "rdnw", "dnw")})
        rdx, rdy, dts = common["rdx"], common["rdy"], common["dts"]
        lean = lean_kwargs(wide, rdx, rdy, dts, common["k0"], common["k1"])
        const = {"t_1": wide["t_1"], "mu_tend": widen(padded["mu_tend"]),
                 "msftx": wide["msftx"], "msfty": wide["msfty"],
                 **{k: wide[k] for k in ("fnm", "fnp", "rdnw", "dnw")},
                 **lean, **coupled_lean_kwargs(wide, rdx, rdy, dts)}
        state = {k: widen(v) for k, v in state.items()}
        for _ in range(n_blocks):
            state = self._block(**const, **state, **common, n_inner=S,
                                fast=self.fast)
        return {k: strip_ring(state[k], 0, S) for k in CARRY_KEYS}
