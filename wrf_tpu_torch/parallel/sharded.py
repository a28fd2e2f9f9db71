"""Ring-shaped domain arrays: field lists, compute window and fixture interop.

The numpy glue of ``wrf_tpu/parallel/sharded.py``, which imports jax at
module top.  Arrays here are *ring-shaped*: the staggered domain extents
plus a 1-cell boundary ring, ``(jde+2, kdim, ide+2)``; the ring carries
caller-provided lateral-boundary data.  Only the 1x1 layout (one device)
is ported: ``pad_to_mesh`` is the identity there.
"""

from __future__ import annotations

import numpy as np

from wrf_tpu.grid import ConfigFlags, GridBounds

#: the ten 3-D and nine 2-D fields of the kernel signature, in argument order
FIELDS_3D = ("ww", "ww_1", "u", "u_1", "v", "v_1", "t", "t_1", "t_ave", "ft")
FIELDS_2D = ("mu", "mut", "muu", "muv", "mu_tend",
             "msfuy", "msfvx_inv", "msftx", "msfty")
FIELDS_1D = ("dnw", "fnm", "fnp", "rdnw")
SCALARS = ("rdx", "rdy", "dts", "epssm")

#: width of the caller-provided global boundary ring carried by the state
RING = 1


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
