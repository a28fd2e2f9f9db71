"""The acoustic small-step loop on one GPU: advance_uv + advance_mu_t per substep.

Port of ``wrf_tpu/models/small_step.py::SmallStepLoop`` for the 1x1
layout.  Every substep is ONE launch of the fused K1 kernel
(``advance_mu_t_fused(fuse_uv=True)``): the wind update runs inside it from
mu's neighbours, so u and v stream once per substep.  The loop zero-pads
every field by one cell (the halo a one-device layout gives), computes
the lean constants once, runs ``n_steps-1`` lean "lite" substeps that
carry only ww's scan-seed row, then one final substep that
re-materializes ww and writes t_ave, and trims the halo and the boundary
ring.  The substeps are a Python loop; the numpy golden loop stays in
``wrf_tpu.models.small_step.small_step_golden``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wrf_tpu.grid import ConfigFlags

from ..convert import arrays_from_numpy
from ..ops.advance_mu_t_cuda import (
    advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
)
from ..parallel.sharded import (
    FIELDS_1D, FIELDS_2D, FIELDS_3D, RING, domain_window, pad_to_mesh,
)

#: effective squared sound speed of the linearized wind update
#: (``wrf_tpu.ops.advance_uv.DEFAULT_CS2``)
DEFAULT_CS2 = 25.0

#: what the scan substeps carry: ww only as its 2-D scan-seed row
CARRY_KEYS = ("ww_row", "mu", "t", "u", "v")

OUT_NAMES = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave", "u", "v")


def pad_halo(x: torch.Tensor) -> torch.Tensor:
    """One zero cell on both sides of j and i (a new tensor)."""
    if x.ndim == 3:
        return F.pad(x, (1, 1, 0, 0, 1, 1))
    if x.ndim == 2:
        return F.pad(x, (1, 1, 1, 1))
    return x


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
        names = FIELDS_3D + FIELDS_2D + FIELDS_1D
        return arrays_from_numpy({n: pad_to_mesh(arrays[n]) for n in names},
                                 self.device)

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        nx, ny, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        padded = {n: pad_halo(arrays[n]) for n in FIELDS_3D + FIELDS_2D}
        padded.update({n: arrays[n] for n in FIELDS_1D})
        nj_loc, ni_loc = arrays["mu"].shape
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

        res = {}
        for name in OUT_NAMES:
            val = out[name]
            if val.ndim == 3:
                val = val[1 : 1 + nj_loc, :, 1 : 1 + ni_loc]
                res[name] = val[RING : ny + RING, :, RING : nx + RING]
            else:
                val = val[1 : 1 + nj_loc, 1 : 1 + ni_loc]
                res[name] = val[RING : ny + RING, RING : nx + RING]
        return res
