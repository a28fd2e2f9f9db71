"""The mu/t small-step loop over a mesh of shards, and the ring-shaped array glue.

Port of ``wrf_tpu/parallel/sharded.py``: ``ShardedAdvanceMuT``, the
multi-substep advance_mu_t loop over a 2-D ``(j, i)`` mesh, plus the glue
(field lists, compute window, halo pad, fixture interop).  Where the
reference synthesizes per-GPU j-slab bounds on the host and stages 3-row
halos through ``cudaMemcpy``, here

* a field on a mesh is a dict of local blocks keyed by the shard's
  ``(jj, ii)``, each on its shard's device (:func:`scatter`,
  :func:`gather`); one process drives every shard, or, on a mesh that
  spans processes, each process its own shards (``parallel/distributed.py``),
  and :func:`gather` all-gathers the blocks so that every process holds the
  domain-shaped result;
* the 1-cell halo each stencil needs is exchanged between neighbouring
  blocks (``parallel/halo.py``), never through the host;
* per-shard boundary handling is *mask-based*: every shard runs the same
  program, and the window masks computed from the shard's global offset
  make only global-edge shards apply the bound shrink.

Halo construction is hoisted OUT of the substep loop: advance_mu_t never
reads neighbour values of its in/out fields, so one exchange before the
loop is exact; the carried state keeps its (stale, never-read, masked) halo
rows and only the final interior is returned.

Arrays here are *ring-shaped*: the staggered domain extents plus a 1-cell
boundary ring, ``(jde+2, kdim, ide+2)``; the ring carries caller-provided
lateral-boundary data.  Arrays are zero-padded up to mesh-divisible sizes
(:func:`pad_to_mesh`); the padding is excluded by the masks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..grid import ConfigFlags, GridBounds
from ..ops.advance_mu_t_cuda import advance_mu_t_fused, lean_kwargs
from ..ops.advance_mu_t_eager import advance_mu_t_impl
from ..ops.advance_mu_t_msteps_cuda import advance_mu_t_multistep, wind_ramp
from . import distributed, halo
from .mesh import Mesh, make_mesh

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


def _mesh_shape(mesh) -> tuple[int, int]:
    return tuple(mesh.shape) if isinstance(mesh, Mesh) else tuple(mesh)


def pad_to_mesh(x, mesh=(1, 1)):
    """Zero-pad the decomposed axes (j, and i of 3-D and 2-D arrays) up to
    multiples of the mesh shape; ``mesh`` is a :class:`Mesh` or its
    ``(nj, ni)``.  numpy in, numpy out; tensor in, tensor out; an array
    that needs no padding comes back as it is."""
    nj, ni = _mesh_shape(mesh)
    if x.ndim not in (2, 3):
        return x
    pj, pi = (-x.shape[0]) % nj, (-x.shape[-1]) % ni
    if not (pj or pi):
        return x
    if isinstance(x, torch.Tensor):
        return F.pad(x, (0, pi) + (0, 0) * (x.ndim - 2) + (0, pj))
    return np.pad(x, ((0, pj),) + ((0, 0),) * (x.ndim - 2) + ((0, pi),))


def scatter(x, mesh: Mesh) -> dict:
    """A global (mesh-divisible) array -> the blocks of this process's
    shards, a dict keyed by the shard's ``(jj, ii)``, each a float32 tensor
    on its shard's device.  Vertical vectors (1-D) are replicated.  Blocks
    of a tensor that already lies on the shard's device are views of it."""
    nj, ni = mesh.shape
    if x.ndim in (2, 3) and (x.shape[0] % nj or x.shape[-1] % ni):
        raise ValueError(f"array {tuple(x.shape)} does not divide over the "
                         f"{nj}x{ni} mesh (pad_to_mesh first)")
    out = {}
    for jj, ii in mesh.local_coords():
        blk = x
        if x.ndim in (2, 3):
            njl, nil = x.shape[0] // nj, x.shape[-1] // ni
            blk = x[jj * njl:(jj + 1) * njl, ..., ii * nil:(ii + 1) * nil]
        dev = mesh.device((jj, ii))
        if isinstance(blk, torch.Tensor):
            out[jj, ii] = blk.to(dev, torch.float32)
        else:   # a copy: the port must never write through to numpy
            out[jj, ii] = torch.tensor(np.ascontiguousarray(blk, np.float32),
                                       device=dev)
    return out


def gather(blocks: dict, mesh: Mesh, device=None) -> torch.Tensor:
    """Inverse of :func:`scatter`: the global tensor on ``device`` (default:
    this process's first shard's).  A 1x1 mesh gives its one block back,
    and a replicated vector its first copy (no copy in either case when the
    block lies on ``device``).  On a mesh that spans processes the blocks
    of every rank are all-gathered first, and every rank gets the whole."""
    device = (torch.device(device) if device is not None
              else mesh.device(mesh.local_coords()[0]))
    nj, ni = mesh.shape
    first = next(iter(blocks.values()))
    if first.ndim == 1 or (nj, ni) == (1, 1):
        return first.to(device)
    if mesh.spans_processes:
        blocks = distributed.all_gather_blocks(mesh, blocks, device)
    rows = [torch.cat([blocks[jj, ii].to(device) for ii in range(ni)], dim=-1)
            if ni > 1 else blocks[jj, 0].to(device) for jj in range(nj)]
    return torch.cat(rows, dim=0) if nj > 1 else rows[0]


def shard_offsets(coord, nj_loc: int, ni_loc: int) -> tuple[int, int]:
    """Global ring coordinates of row 0 and column 0 of shard ``coord``'s
    halo-padded local block."""
    return (coord[0] * nj_loc - 1, coord[1] * ni_loc - 1)


def pad_halo(x: torch.Tensor) -> torch.Tensor:
    """One zero cell on both sides of j and i (a new tensor): the 1-cell
    halo a one-shard layout gives (``halo.halo3``/``halo2`` unsharded)."""
    if x.ndim == 3:
        return F.pad(x, (1, 1, 0, 0, 1, 1))
    if x.ndim == 2:
        return F.pad(x, (1, 1, 1, 1))
    return x


def prepare_arrays(arrays, mesh: Mesh, extra=(), blocks: bool = True):
    """Ring-shaped arrays (numpy) -> float32 tensors on the mesh's devices:
    what the loops' ``prepare`` returns.  With ``blocks`` every field is a
    dict of local blocks (:func:`scatter` of the mesh-padded array); without
    (the loops built with no mesh: one shard on one device) a plain tensor.
    ``extra`` names fields beyond the kernel signature (the w/pp state and
    ``rdn``)."""
    names = FIELDS_3D + FIELDS_2D + FIELDS_1D + tuple(extra)
    out = {n: scatter(pad_to_mesh(np.asarray(arrays[n]), mesh), mesh)
           for n in names}
    return out if blocks else {n: b[0, 0] for n, b in out.items()}


def as_blocks(arrays: dict, mesh: Mesh, blocks: bool) -> dict:
    """A loop's prepared input as dicts of blocks: itself when the loop was
    built on a mesh, else each tensor as the one block of a 1x1 mesh."""
    return arrays if blocks else {n: {(0, 0): x} for n, x in arrays.items()}


def pad_local(arrays: dict, mesh: Mesh, j_sh: bool, i_sh: bool) -> dict:
    """The loops' one-time halo construction: every 3-D and 2-D field's
    blocks with their 1-cell halo (new tensors, which the loop may update
    in place), exchanged with the neighbours on sharded axes and zero
    elsewhere; 1-D fields as they are.  Returns ``{shard: {name: block}}``."""
    padded = {}
    for n, b in arrays.items():
        ndim = next(iter(b.values())).ndim
        if ndim == 3:
            padded[n] = halo.halo3(b, mesh, j_sharded=j_sh, i_sharded=i_sh)
        elif ndim == 2:
            padded[n] = halo.halo2(b, mesh, j_sharded=j_sh, i_sharded=i_sh)
        else:
            padded[n] = b
    return {c: {n: padded[n][c] for n in padded}
            for c in mesh.local_coords()}


def strip_local(outs: dict, names, domain, mesh: Mesh) -> dict:
    """Domain-shaped outputs from the shards' padded ones: every block's
    owned interior (halo dropped), gathered on the first local shard's
    device (on every rank of a mesh that spans processes), the boundary
    ring and the mesh padding dropped.  Views all the way on a 1x1 mesh."""
    nx, ny, _ = domain
    res = {}
    for n in names:
        own = {c: o[n][1:-1, ..., 1:-1] for c, o in outs.items()}
        res[n] = gather(own, mesh)[RING:ny + RING, ..., RING:nx + RING]
    return res


def merge_interior(blocks: dict, dom: torch.Tensor) -> dict:
    """New blocks: copies of a ring-shaped field's ``blocks`` with the
    domain-shaped ``dom`` written over the ring interior (every shard takes
    the part of ``dom`` that falls into its block)."""
    ny, nx = dom.shape[0], dom.shape[-1]
    out = {}
    for (jj, ii), b in blocks.items():
        njl, nil = b.shape[0], b.shape[-1]
        j0, j1 = max(jj * njl, RING), min((jj + 1) * njl, RING + ny)
        i0, i1 = max(ii * nil, RING), min((ii + 1) * nil, RING + nx)
        new = b.clone()
        if j1 > j0 and i1 > i0:
            new[j0 - jj * njl:j1 - jj * njl, ...,
                i0 - ii * nil:i1 - ii * nil] = \
                dom[j0 - RING:j1 - RING, ..., i0 - RING:i1 - RING]
        out[jj, ii] = new
    return out


def local_mesh(mesh, device) -> Mesh:
    """The loops' mesh argument resolved: ``mesh`` itself, or one shard on
    ``device`` when it is None."""
    return mesh if mesh is not None else make_mesh([device], (1, 1))


class ShardedAdvanceMuT:
    """The multi-substep advance_mu_t loop over a mesh of shards.

    Build once per (mesh, domain, flags, n_steps); ``prepare`` ring-shaped
    numpy arrays, then call.  ``mesh`` None means one shard on ``device``,
    and then ``prepare`` returns plain tensors; on a mesh it returns every
    field as its local blocks on their devices.  The call returns
    domain-shaped tensors on the first shard's device either way.

    ``kernel``: "cuda" runs K1 (and K2 when blocked) through their
    wrappers — the CUDA kernels on CUDA tensors, their plain versions on
    CPU tensors — and "eager" runs
    :func:`~wrf_tpu_torch.ops.advance_mu_t_eager.advance_mu_t_impl` every
    substep.  ``vary_winds`` rescales u/v by ``1 + WIND_RAMP*n`` (float32)
    at substep ``n`` (the acoustic loop changes the winds every substep).

    ``inner_steps`` = S > 1 temporally blocks the loop: ``(n_steps-1)//S``
    K2 passes of S substeps, then single K1 substeps for the rest, then the
    final K1 substep; bit-compatible with ``inner_steps=1``.  ``fast``
    runs the blocked passes in K2's closed form (a tolerance, not bits).

    ``const_dtype=torch.bfloat16`` narrows the read-only 3-D streams once
    per call, outside the substeps: u and v (read-only here, scaled on
    load), u_1, v_1, ww_1, ft, t_1 and the 3-D lean constants; the kernels
    widen them on load, and t, mu and ww stay float32.  Requires the cuda
    kernel.

    The halos are built once, before the loop; no substep exchanges (see
    the module docstring), so every shard runs its whole loop on its own.
    """

    def __init__(self, nx: int, ny: int, nz: int, flags: ConfigFlags,
                 n_steps: int = 1, kernel: str = "cuda",
                 vary_winds: bool = False, inner_steps: int = 1,
                 fast: bool = False, device="cuda", *,
                 mesh: Mesh | None = None, const_dtype=None):
        if kernel not in ("cuda", "eager"):
            raise ValueError(f"bad kernel {kernel!r}")
        if const_dtype is not None and kernel != "cuda":
            raise ValueError("const_dtype requires the cuda kernel (the JAX "
                             "loop's 'pallas')")
        if const_dtype not in (None, torch.bfloat16):
            raise ValueError(f"const_dtype must be torch.bfloat16 or None, "
                             f"got {const_dtype!r}")
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
        self.const_dtype = const_dtype
        self.device = torch.device(device)
        self._blocks = mesh is not None
        self.mesh = local_mesh(mesh, self.device)
        self.window = domain_window(nx, ny, nz, flags)

    def prepare(self, arrays) -> dict:
        """Ring-shaped arrays (numpy) -> float32 tensors on the device(s),
        padded to the mesh."""
        return prepare_arrays(arrays, self.mesh, blocks=self._blocks)

    def _wscale(self, n: int) -> float:
        # the ramp K2 applies, so blocked and single substeps see one scale
        return wind_ramp(n, WIND_RAMP, 0) if self.vary_winds else 1.0

    def __call__(self, arrays, rdx, rdy, dts, epssm) -> dict[str, torch.Tensor]:
        _, _, nz = self.domain
        i0, i1, j0, j1, k0, k1 = self.window
        mesh = self.mesh
        arrays = as_blocks(arrays, mesh, self._blocks)
        nj_loc, _, ni_loc = next(iter(arrays["t"].values())).shape
        local = pad_local(arrays, mesh, mesh.shape[0] > 1, mesh.shape[1] > 1)
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "epssm": epssm}
        last = self.n_steps - 1
        outs = {}
        for c, padded in local.items():
            # this shard's padded-local row/column 0 in ring coordinates
            offs = shard_offsets(c, nj_loc, ni_loc)
            if self.kernel == "cuda":
                common = dict(window=(i0, i1, j0, j1), offsets=offs, k0=k0,
                              k1=k1, kde=nz - 1, **scalars)
                outs[c] = self._run_cuda(padded, common, last)
            else:
                outs[c] = self._run_eager(padded, scalars, last, offs)
        names = next(iter(outs.values())).keys()
        return strip_local(outs, names, self.domain, mesh)

    def _run_cuda(self, padded, common, last):
        # t_ave is pointwise t_old and never read back, and ww is consumed
        # only through its k0 seed row: the scan substeps carry the 2-D
        # seed row, and the final substep re-materializes ww and t_ave
        k0 = common["k0"]
        lean_kw = lean_kwargs(padded, common["rdx"], common["rdy"],
                              common["dts"], k0, common["k1"])
        padded["ww_row"] = padded["ww"][:, k0, :].contiguous()
        if self.const_dtype is not None:
            # cast ONCE per call, after the constants were computed from
            # the float32 fields: every 3-D stream but the carried t
            cd = self.const_dtype
            for n in ("u", "v", "u_1", "v_1", "ww_1", "ft", "t_1"):
                padded[n] = padded[n].to(cd)
            lean_kw = {k: (x.to(cd) if x.ndim == 3 else x)
                       for k, x in lean_kw.items()}
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

    def _run_eager(self, padded, scalars, last, offs):
        i0, i1, j0, j1, k0, k1 = self.window
        nz = self.domain[2]
        J, _, I = padded["t"].shape
        dev = padded["t"].device
        i_idx = torch.arange(I, device=dev) + offs[1]
        j_idx = torch.arange(J, device=dev) + offs[0]
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
