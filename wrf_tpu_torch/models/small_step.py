"""The acoustic small-step loop on one GPU: advance_uv + advance_mu_t per substep.

Port of ``wrf_tpu/models/small_step.py::SmallStepLoop`` for the 1x1
layout.  Every substep is ONE launch of the fused K1 kernel
(``advance_mu_t_fused(fuse_uv=True)``): the wind update runs inside it from
mu's neighbours, so u and v stream once per substep.  The loop zero-pads
every field by one cell (the halo a one-device layout gives), computes
the lean constants once, runs ``n_steps-1`` lean "lite" substeps that
carry only ww's scan-seed row, then one final substep that
re-materializes ww and writes t_ave, and trims the halo and the boundary
ring.  The substeps are a Python loop.  With ``with_w`` every substep also
runs the vertically-implicit w/pp substep inside the kernel (``fuse_w``),
and w and pp join the carried state.

With ``inner_steps`` = S > 1 the scan substeps are temporally blocked:
``(n_steps-1)//S`` launches of K3 (the coupled trapezoid,
``coupled_multistep``) on ring-S copies of the state and constants, then
the remaining lite substeps and the final one on K1 as above.

``kernel="eager"`` is the counterpart of the JAX loop's ``kernel="xla"``:
each substep is three whole-array calls, ``advance_uv`` ->
``advance_mu_t_impl`` -> ``advance_w``, with no hand-written kernel.

:func:`small_step_golden` is the numpy golden loop, the reference the
driver's coupled tiers are verified against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import ConfigFlags
from ..ops.advance_mu_t_coupled_cuda import (
    coupled_lean_kwargs, coupled_multistep, coupled_multistep_plain,
)
from ..ops.advance_mu_t_cuda import (
    advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
)
from ..ops.advance_mu_t_eager import advance_mu_t_impl
from ..ops.advance_uv import DEFAULT_CS2, advance_uv, advance_uv_numpy
from ..ops.advance_w import DEFAULT_CW, DEFAULT_GW, advance_w, advance_w_numpy
from ..ops.reference_numpy import advance_mu_t_numpy
from ..ops.thomas import thomas_vectors
from ..parallel.halo import strip_ring, widen_ring_to
from ..parallel.sharded import (
    FIELDS_1D, FIELDS_2D, FIELDS_3D, domain_window, pad_local,
    prepare_arrays, strip_local,
)

#: what the scan substeps carry: ww only as its 2-D scan-seed row
CARRY_KEYS = ("ww_row", "mu", "t", "u", "v")

OUT_NAMES = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave", "u", "v")

#: fields the golden loop carries (and updates) across substeps
STATE_KEYS = ("ww", "mu", "t", "t_ave", "u", "v")

#: the vertical-acoustics state and its vertical vector (``with_w``)
W_STATE = ("w", "pp")
W_FIELDS_1D = ("rdn",)


def small_step_golden(case, steps: int, cs2: float = DEFAULT_CS2,
                      with_w: bool = False,
                      cw: float = DEFAULT_CW, gw: float = DEFAULT_GW):
    """Golden-path acoustic loop on memory-window arrays (single tile):
    each substep the numpy wind update, then ``advance_mu_t_numpy`` and,
    with ``with_w``, the vertically-implicit w/pp substep
    (``advance_w_numpy``) on the theta field the mu/t substep just
    produced (``wrf_tpu.models.small_step.small_step_golden`` without
    divergence damping)."""
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = case.bounds.loop_bounds(case.flags)
    window = (i0, i1, j0, j1)
    state = {k: np.asarray(kw[k]) for k in STATE_KEYS}
    out = dict(state)
    if with_w:
        f = case.fields
        wst = {"w": np.asarray(f["grid_w"]), "pp": np.asarray(f["grid_pp"])}
        rdn = np.asarray(f["grid_rdn"])
    for _ in range(steps):
        u, v = advance_uv_numpy(
            u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
            muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
            window=window, cs2=cs2)
        out = advance_mu_t_numpy(**{**kw, **state, "u": u, "v": v})
        if with_w:
            wst["w"], wst["pp"] = advance_w_numpy(
                w=wst["w"], pp=wst["pp"], t=out["t"], rdn=rdn,
                rdnw=kw["rdnw"], dts=kw["dts"], epssm=kw["epssm"],
                window=window, k0=k0, k1=k1, cw=cw, gw=gw)
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    res = {**out, "u": state["u"], "v": state["v"]}
    if with_w:
        res.update(wst)
    return res


class SmallStepLoop:
    """The coupled acoustic small-step loop on one device.

    Same array contract as the JAX loop: ring-shaped inputs, ``prepare`` ->
    ``__call__``; returns the domain-shaped outputs, final winds included
    (and ``w``/``pp`` with ``with_w``).  ``kernel="cuda"`` runs
    :func:`advance_mu_t_fused` and, when blocked,
    :func:`coupled_multistep` (the CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors); ``kernel="plain"`` always runs the
    plain versions, for comparisons; ``kernel="eager"`` runs the three
    whole-array ops per substep (no kernel; it cannot block).
    ``inner_steps`` = S blocks S scan substeps per K3 launch; ``fast``
    runs those launches in K3's fast mode (a tolerance, not bits).
    ``with_w`` adds the vertically-implicit w/pp substep to every substep
    (``fuse_w`` in the kernels), with the linearized coefficients ``cw``
    and ``gw``.  Divergence damping (``smdiv``) is not ported yet.
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda", device="cuda",
                 inner_steps: int = 1, fast: bool = False,
                 smdiv: float = 0.0, cs2: float = DEFAULT_CS2,
                 with_w: bool = False,
                 cw: float = DEFAULT_CW, gw: float = DEFAULT_GW):
        if kernel not in ("cuda", "plain", "eager"):
            raise ValueError(f"bad kernel {kernel!r}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not isinstance(inner_steps, int) or inner_steps < 1:
            raise ValueError("inner_steps must be a positive integer")
        if fast and inner_steps == 1:
            raise ValueError("fast re-associates the BLOCKED pass: it "
                             "requires inner_steps > 1 (alone it would "
                             "silently no-op)")
        if inner_steps > 1 and kernel == "eager":
            raise ValueError("inner_steps requires the fused kernel "
                             "(kernel='cuda' or 'plain')")
        if smdiv and inner_steps > 1:
            raise ValueError("inner_steps>1 does not support smdiv yet "
                             "(mudf would need its own extended rows)")
        if smdiv:
            raise NotImplementedError(
                "SmallStepLoop: divergence damping (smdiv) is not ported yet "
                "(ROADMAP.md, 'SmallStepLoop on one GPU', K1 slice (d))")
        self.domain = (nx, ny, nz)
        self.n_steps = n_steps
        self.kernel = kernel
        self.inner_steps = inner_steps
        self.fast = fast
        self.cs2 = cs2
        self.with_w = with_w
        self.cw, self.gw = cw, gw
        self.device = torch.device(device)
        self.window = domain_window(nx, ny, nz, flags)
        plain = kernel == "plain"
        self._step = advance_mu_t_fused_plain if plain else advance_mu_t_fused
        self._block = coupled_multistep_plain if plain else coupled_multistep
        self._extra = W_STATE + W_FIELDS_1D if with_w else ()
        self._names = FIELDS_3D + FIELDS_2D + FIELDS_1D + self._extra
        self.carry_keys = CARRY_KEYS + (W_STATE if with_w else ())
        self.out_names = OUT_NAMES + (W_STATE if with_w else ())

    def prepare(self, arrays) -> dict[str, torch.Tensor]:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device."""
        return prepare_arrays(arrays, self.device, extra=self._extra)

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        padded = pad_local({n: arrays[n] for n in self._names})
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        if self.kernel == "eager":
            out = self._run_eager(padded, scalars)
            return strip_local(out, self.out_names, self.domain)
        common = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0,
                      k1=k1, kde=nz - 1, cs2=self.cs2, **scalars)
        if self.with_w:
            # the Thomas K-vectors of this dts, computed once for every
            # launch of this call (fast: with the cumsum scale vectors)
            common.update(
                fuse_w=True, cw=self.cw, gw=self.gw,
                thomas=thomas_vectors(
                    rdn=padded["rdn"], rdnw=padded["rdnw"], dts=dts,
                    epssm=epssm, cw=self.cw, gw=self.gw, k0=k0, k1=k1,
                    fast=self.fast))
        padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
        const = {k: v for k, v in padded.items() if k not in self.carry_keys}
        state = {k: padded[k] for k in self.carry_keys}

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
            state = {k: out[k] for k in self.carry_keys}
        out = self._step(**const, **state, **common, fuse_uv=True,
                         with_tave=True, ww_mode="final")
        return strip_local(out, self.out_names, self.domain)

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
        if self.with_w:
            const["rdn"] = padded["rdn"]
        state = {k: widen(v) for k, v in state.items()}
        for _ in range(n_blocks):
            state = self._block(**const, **state, **common, n_inner=S,
                                fast=self.fast)
        return {k: strip_ring(state[k], 0, S) for k in self.carry_keys}

    def _run_eager(self, padded, scalars):
        """Every substep as three whole-array calls: the wind update, the
        mu/t substep and, with ``with_w``, the w/pp substep on its new
        theta (the JAX loop's ``kernel="xla"`` substep on one device)."""
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        J, _, I = padded["t"].shape
        dev = padded["t"].device
        offs = (-1, -1)
        i_idx = torch.arange(I, device=dev) + offs[1]
        j_idx = torch.arange(J, device=dev) + offs[0]
        i_mask = (i_idx >= i0) & (i_idx <= i1)
        j_mask = (j_idx >= j0) & (j_idx <= j1)
        carry = STATE_KEYS + (W_STATE if self.with_w else ())
        const = {k: v for k, v in padded.items()
                 if k not in carry + W_FIELDS_1D}
        state = {k: padded[k] for k in carry}
        out = dict(state)
        for _ in range(self.n_steps):
            u, v = advance_uv(
                u=state["u"], v=state["v"], mu=state["mu"],
                muu=const["muu"], muv=const["muv"], msfuy=const["msfuy"],
                msfvx_inv=const["msfvx_inv"], rdx=scalars["rdx"],
                rdy=scalars["rdy"], dts=scalars["dts"],
                window=(i0, i1, j0, j1), offsets=offs, cs2=self.cs2)
            ins = {k: state[k] for k in ("ww", "mu", "t", "t_ave")}
            out = advance_mu_t_impl(**const, **ins, u=u, v=v, **scalars,
                                    i_mask=i_mask, j_mask=j_mask, k0=k0,
                                    k1=k1, kde=nz - 1)
            out = {**out, "u": u, "v": v}
            if self.with_w:
                out["w"], out["pp"] = advance_w(
                    w=state["w"], pp=state["pp"], t=out["t"],
                    rdn=padded["rdn"], rdnw=padded["rdnw"],
                    dts=scalars["dts"], epssm=scalars["epssm"],
                    window=(i0, i1, j0, j1), offsets=offs, k0=k0, k1=k1,
                    cw=self.cw, gw=self.gw)
            state = {k: out[k] for k in carry}
        return out
