"""The mu/t small-step loop on one device, and the ring-shaped array glue.

Port of ``wrf_tpu/parallel/sharded.py`` for the 1x1 layout (one device):
``ShardedAdvanceMuT``, the multi-substep advance_mu_t loop, plus the numpy
glue (field lists, compute window, fixture interop).  Arrays here are
*ring-shaped*: the staggered domain extents plus a 1-cell boundary ring,
``(jde+2, kdim, ide+2)``; the ring carries caller-provided lateral-boundary
data.  ``pad_to_mesh`` is the identity on the 1x1 layout and raises for
any other mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import arrays_from_numpy
from ..grid import ConfigFlags, GridBounds
from ..ops.advance_mu_t_cuda import advance_mu_t_fused, lean_kwargs
from ..ops.advance_mu_t_eager import advance_mu_t_impl
from ..ops.advance_mu_t_msteps_cuda import advance_mu_t_multistep, wind_ramp

#: the ten 3-D and nine 2-D fields of the kernel signature, in argument order
FIELDS_3D = ("ww", "ww_1", "u", "u_1", "v", "v_1", "t", "t_1", "t_ave", "ft")
FIELDS_2D = ("mu", "mut", "muu", "muv", "mu_tend",
             "msfuy", "msfvx_inv", "msftx", "msfty")
FIELDS_1D = ("dnw", "fnm", "fnp", "rdnw")
SCALARS = ("rdx", "rdy", "dts", "epssm")
STATE_KEYS = ("ww", "mu", "t", "t_ave")  # carried between small steps

#: width of the caller-provided global boundary ring carried by the state
RING = 1

#: wind-scale ramp per substep under ``vary_winds``: 1 + 1e-7*n at substep n
WIND_RAMP = 1e-7


def domain_window(nx: int, ny: int, nz: int, flags: ConfigFlags):
    """BC-aware compute window in 0-based *ring* coordinates (domain
    coordinates shifted by the RING offset)."""
    i0, i1, j0, j1, k0, k1 = GridBounds.for_domain(nx, ny, nz, halo=0).loop_bounds(flags)
    return (i0 + RING, i1 + RING, j0 + RING, j1 + RING, k0, k1)


def pad_to_mesh(x, mesh_shape=(1, 1)):
    """Pad the decomposed axes up to multiples of the mesh shape: the
    identity on the 1x1 layout, the only one ported."""
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh {mesh_shape} is not ported yet (ROADMAP.md, modules to "
            "port: 'Multi-GPU decomposition and halo backends')")
    return x


def pad_halo(x: torch.Tensor) -> torch.Tensor:
    """One zero cell on both sides of j and i (a new tensor): the 1-cell
    halo a one-device layout gives (``halo.halo3``/``halo2`` unsharded)."""
    if x.ndim == 3:
        return F.pad(x, (1, 1, 0, 0, 1, 1))
    if x.ndim == 2:
        return F.pad(x, (1, 1, 1, 1))
    return x


def prepare_arrays(arrays, device, extra=()) -> dict[str, torch.Tensor]:
    """Ring-shaped arrays (numpy) -> float32 tensors on ``device``: what the
    loops' ``prepare`` returns.  ``extra`` names fields beyond the kernel
    signature (the w/pp state and ``rdn``)."""
    names = FIELDS_3D + FIELDS_2D + FIELDS_1D + tuple(extra)
    return arrays_from_numpy({n: pad_to_mesh(arrays[n]) for n in names},
                             device)


def pad_local(arrays) -> dict[str, torch.Tensor]:
    """A loop's local blocks: the prepared 3-D and 2-D fields with their
    1-cell halo (new tensors, which the loop may update in place), the
    1-D fields as they are."""
    return {n: pad_halo(x) for n, x in arrays.items()}


def strip_local(out, names, domain) -> dict[str, torch.Tensor]:
    """Domain-shaped views of a loop's padded outputs: the halo and the
    boundary ring dropped."""
    nx, ny, _ = domain
    j, i = slice(1 + RING, 1 + RING + ny), slice(1 + RING, 1 + RING + nx)
    return {n: out[n][j, :, i] if out[n].ndim == 3 else out[n][j, i]
            for n in names}


class ShardedAdvanceMuT:
    """The multi-substep advance_mu_t loop on one device (1x1 layout).

    Build once per (domain, flags, n_steps); ``prepare`` ring-shaped numpy
    arrays, then call.  ``kernel``: "cuda" runs K1 (and K2 when blocked)
    through their wrappers — the CUDA kernels on CUDA tensors, their plain
    versions on CPU tensors — and "eager" runs
    :func:`~wrf_tpu_torch.ops.advance_mu_t_eager.advance_mu_t_impl` every
    substep.  ``vary_winds`` rescales u/v by ``1 + WIND_RAMP*n`` (float32)
    at substep ``n`` (the acoustic loop changes the winds every substep).

    ``inner_steps`` = S > 1 temporally blocks the loop: ``(n_steps-1)//S``
    K2 passes of S substeps, then single K1 substeps for the rest, then the
    final K1 substep; bit-compatible with ``inner_steps=1``.  ``fast``
    runs the blocked passes in K2's closed form (a tolerance, not bits).
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda",
                 vary_winds: bool = False, inner_steps: int = 1,
                 fast: bool = False, device="cuda"):
        if kernel not in ("cuda", "eager"):
            raise ValueError(f"bad kernel {kernel!r}")
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if inner_steps < 1:
            raise ValueError("inner_steps must be >= 1")
        if fast and inner_steps == 1:
            raise ValueError("fast re-associates the BLOCKED pass: it "
                             "requires inner_steps > 1 (alone it would "
                             "silently no-op)")
        if inner_steps > 1 and kernel != "cuda":
            raise ValueError("inner_steps requires the cuda kernel")
        self.domain = (nx, ny, nz)
        self.n_steps = n_steps
        self.kernel = kernel
        self.vary_winds = vary_winds
        self.inner_steps = inner_steps
        self.fast = fast
        self.device = torch.device(device)
        self.window = domain_window(nx, ny, nz, flags)

    def prepare(self, arrays) -> dict[str, torch.Tensor]:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device."""
        return prepare_arrays(arrays, self.device)

    def _wscale(self, n: int) -> float:
        # the ramp K2 applies, so blocked and single substeps see one scale
        return wind_ramp(n, WIND_RAMP, 0) if self.vary_winds else 1.0

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        padded = pad_local(arrays)
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        # this device's padded-local row/column 0 in ring coordinates
        common = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0,
                      k1=k1, kde=nz - 1, **scalars)
        last = self.n_steps - 1
        if self.kernel == "cuda":
            out = self._run_cuda(padded, common, last)
        else:
            out = self._run_eager(padded, scalars, last, k0, k1, nz)
        return strip_local(out, out, self.domain)

    def _run_cuda(self, padded, common, last):
        # t_ave is pointwise t_old and never read back, and ww is consumed
        # only through its k0 seed row: the scan substeps carry the 2-D
        # seed row, and the final substep re-materializes ww and t_ave
        k0 = common["k0"]
        lean_kw = lean_kwargs(padded, common["rdx"], common["rdy"],
                              common["dts"], k0, common["k1"])
        padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
        carry = ("ww_row", "mu", "t")
        const = {k: v for k, v in padded.items() if k not in carry}
        state = {k: padded[k] for k in carry}

        S = self.inner_steps
        n_blocked = (last // S) * S if S > 1 else 0
        k2_const = {k: const[k] for k in ("u", "v", "t_1", "mu_tend", "msftx",
                                          "msfty", "dnw", "fnm", "fnp", "rdnw")}
        for b in range(n_blocked // S):
            state = advance_mu_t_multistep(
                **k2_const, **state, **lean_kw, **common, n_inner=S,
                wind_step0=b * S,
                wind_scale_step=WIND_RAMP if self.vary_winds else 0.0,
                fast=self.fast)
        for n in range(n_blocked, last):
            out = advance_mu_t_fused(
                **const, **state, **lean_kw, **common,
                wind_scale=self._wscale(n), with_tave=False,
                ww_mode="lite", lean=True)
            state = {k: out[k] for k in carry}
        return advance_mu_t_fused(**const, **state, **common,
                                  wind_scale=self._wscale(last),
                                  with_tave=True, ww_mode="final")

    def _run_eager(self, padded, scalars, last, k0, k1, nz):
        i0, i1, j0, j1 = self.window[:4]
        J, _, I = padded["t"].shape
        dev = padded["t"].device
        i_idx = torch.arange(I, device=dev) - 1
        j_idx = torch.arange(J, device=dev) - 1
        i_mask = (i_idx >= i0) & (i_idx <= i1)
        j_mask = (j_idx >= j0) & (j_idx <= j1)
        const = {k: v for k, v in padded.items() if k not in STATE_KEYS}
        state = {k: padded[k] for k in STATE_KEYS}
        for n in range(last + 1):
            ins = {**const, **state}
            ws = self._wscale(n)
            if ws != 1.0:
                ins["u"], ins["v"] = ins["u"] * ws, ins["v"] * ws
            out = advance_mu_t_impl(**ins, **scalars, i_mask=i_mask,
                                    j_mask=j_mask, k0=k0, k1=k1, kde=nz - 1)
            state = {k: out[k] for k in STATE_KEYS}
        return out


def case_to_domain(case, with_w: bool = False) -> dict[str, np.ndarray]:
    """Extract ring-shaped arrays (staggered extents + the 1-cell boundary
    ring of lateral-BC data) from a fixture Case's memory-window arrays.
    ``with_w`` additionally extracts the vertical-acoustics state
    (w, pp, rdn) for the advance_w substep."""
    b = case.bounds
    j0, j1 = b.mem(b.jds, "j") - RING, b.mem(b.jde, "j") + RING
    i0, i1 = b.mem(b.ids, "i") - RING, b.mem(b.ide, "i") + RING
    kw = case.kernel_kwargs()
    if with_w:
        f = case.fields
        kw = {**kw, "w": f["grid_w"], "pp": f["grid_pp"], "rdn": f["grid_rdn"]}
    names = FIELDS_3D + FIELDS_2D + FIELDS_1D
    if with_w:
        names = names + ("w", "pp", "rdn")
    out = {}
    for name in names:
        arr = np.asarray(kw[name])
        if arr.ndim == 3:
            out[name] = arr[j0 : j1 + 1, :, i0 : i1 + 1]
        elif arr.ndim == 2:
            out[name] = arr[j0 : j1 + 1, i0 : i1 + 1]
        else:
            out[name] = arr
    return out


def embed_outputs(case, out_dom: dict) -> dict:
    """Embed a loop's domain-shaped outputs back into memory-window arrays
    for comparison against memory-window goldens: carried state embeds into
    its own input field, derived 2-D/3-D outputs into zeros."""
    kw = case.kernel_kwargs()
    out = {}
    for name, val in out_dom.items():
        arr = np.asarray(val)
        if name in ("ww", "mu", "t", "t_ave", "u", "v"):
            like = np.asarray(kw[name])
        elif name in ("w", "pp"):
            like = np.asarray(case.fields["grid_" + name])
        else:
            shape = case.bounds.shape3 if arr.ndim == 3 else case.bounds.shape2
            like = np.zeros(shape, dtype=np.float32)
        out[name] = embed_domain(arr, like, case.bounds)
    return out


def embed_domain(dom: np.ndarray, like: np.ndarray, bounds: GridBounds) -> np.ndarray:
    """Embed a domain-shaped result back into a memory-window array ``like``
    for comparison against memory-window goldens."""
    out = np.array(like, copy=True)
    j0, i0 = bounds.mem(bounds.jds, "j"), bounds.mem(bounds.ids, "i")
    if dom.ndim == 3:
        out[j0 : j0 + dom.shape[0], :, i0 : i0 + dom.shape[2]] = dom
    else:
        out[j0 : j0 + dom.shape[0], i0 : i0 + dom.shape[1]] = dom
    return out
