"""K1: the fused acoustic substep (advance_mu_t), on the GPU and in plain PyTorch.

The port of ``wrf_tpu/ops/advance_mu_t_pallas.py`` (kernel ``_kernel``,
wrapper ``advance_mu_t_pallas``).  :func:`advance_mu_t_fused` keeps that
wrapper's keyword contract and result dict for the modes ported so far:

* ``fuse_uv`` — the wind substep (advance_uv) runs inside the kernel;
* ``ww_mode`` "full" (the reference's single call), "lite" (scan substeps:
  only the 2-D scan-seed row ``ww_row`` is carried) and "final" (the last
  substep re-materializes ww);
* ``lean`` — scan substeps read the precomputed ``tconst`` /
  ``dvdxi_const`` / ``ww1_k0`` (:func:`lean_kwargs`) instead of ww_1, u_1,
  v_1 and ft;
* ``with_tave``;
* ``wind_scale`` — the read-only winds (no ``fuse_uv``) are multiplied by
  this scalar on load, before any differencing: the per-substep wind ramp
  of the mu/t loop (``ShardedAdvanceMuT``);
* ``fuse_w`` — the vertically-implicit w/pp substep (``ops/advance_w.py``)
  runs inside the kernel after theta, on this substep's new ``t``: a
  per-column Thomas solve with the coefficient vectors of
  ``ops/thomas.py``.  It composes with every mode above;
* ``mudf_in``, ``smdiv`` — divergence damping of the fused wind update:
  the pressure becomes ``p = cs2*mu + (cs2*smdiv)*mudf_in`` at the five
  points the update reads, ``mudf_in`` being the previous substep's
  ``mudf`` output.  Without ``fuse_uv`` damping is off whatever ``smdiv``
  says, as in the TPU wrapper;
* ``capture`` — five extra outputs ``muave_``, ``mu_``, ``mudf_``, ``muts_``
  and ``ww_before_theta``: the phase-A state between the mu/ww pass and the
  theta pass, in fresh buffers, zero on rows 0 and J-1 (``ww_mode="full"``
  without ``lean`` only);
* ``overlap`` — the j halo exchange inside the kernel (``fuse_uv`` only):
  the block's halo rows 0 and J-1 of ``mu``, ``v`` and ``mudf_in`` are
  taken as stale, and rows 1 and J-2 read the ring neighbours' rows
  instead.  The TPU wrapper's ``overlap`` names a mesh axis, because each
  shard is a program of its own there; here one process holds every shard,
  so ``overlap`` names the rows themselves: a dict of row views
  ``{"mu_lo": prev's mu[J-2], "mu_hi": next's mu[1], "v_hi": next's v[1]}``
  plus ``"mudf_lo"`` / ``"mudf_hi"`` under damping.  The kernel loads them
  through their device pointers, so nothing is copied, staged or waited
  for; the rows are those the ``rdma`` and ``ppermute`` refreshes would
  have moved, so the result is bit-equal to theirs;
* bf16 constant streams — the read-only 3-D operands ``t_1``, ``tconst``,
  ``dvdxi_const``, ``ww_1``, ``u_1``, ``v_1``, ``ft`` (and ``u``, ``v``
  without ``fuse_uv``) may arrive as ``torch.bfloat16``; they are widened
  to float32 on load, and all arithmetic, state and outputs stay float32.
  A bf16 state operand is a ``ValueError``.  The kernel has one element
  type for all its constant streams: when every one of them is bf16 it
  reads them narrow, and a mixed set is widened before the launch (exact,
  so the result is the same).

Dispatch is by the device of the tensors: CUDA tensors launch the
hand-written kernel (``csrc/advance_mu_t_kernel.cuh``) and count one in
:data:`LAUNCHES`; CPU tensors run :func:`advance_mu_t_fused_plain`, the
whole-array transcription of the same arithmetic.  There is no fallback
from one to the other.

Buffers: a launch writes none of its operands, on either device.  Every
field it updates comes back in a fresh tensor: ``mu``, ``u`` and ``v``
(read at neighbour cells while they are updated), and ``t``, ``ww``
(full/final), ``ww_row`` (lite), ``t_ave`` (with_tave), ``w`` and ``pp``
(fuse_w), which the TPU kernel donates and updates in place.  A loop
passes the results back as the next substep's inputs, and PyTorch's
caching allocator hands the freed buffers out again, so nothing is
copied; the blocks a loop started from keep their contents and their
``_version``, so what a memo built from them (``models/stage_memo.py``)
still holds after the launch.  Outside the cells a launch computes (rows
0 and J-1, the columns outside the window, the levels outside its k
range) the state passes through into the fresh outputs.
:func:`mark_in_place` and :func:`check_no_alias` serve the wrappers of K2
and K3, which still update their state in place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .halo_rdma_cuda import _enable_peer
from .thomas import ThomasVectors, thomas_vectors

#: CUDA kernel launches since import (one per launch, and only there)
LAUNCHES = 0

_WW_MODES = {"full": 0, "lite": 1, "final": 2}
_SMEM_LIMIT = 48 * 1024   # dynamic shared memory a block takes without opt-in
LANES = 32                # threads of a block along i (csrc: kLanes)
#: rows of a block along j (csrc: at most kMaxRows = 4), measured (PERF.md)
BLOCK_ROWS = 4
_kernel_fn = None


def _f32(x) -> float:
    """A scalar rounded to float32 (kept as a Python float, which PyTorch
    and ctypes pass on exactly)."""
    return float(np.float32(x))


#: the 3-D operands that may arrive as bf16 (plus u and v without fuse_uv)
CONST_STREAMS = ("t_1", "tconst", "dvdxi_const", "ww_1", "u_1", "v_1", "ft")

#: the neighbour rows ``overlap`` names (the mudf rows only under damping)
OVERLAP_ROWS = ("mu_lo", "mu_hi", "v_hi", "mudf_lo", "mudf_hi")


def check_const_streams(named: dict, const_ok, suffix: str = "") -> None:
    """The TPU wrappers' ``_ingest3`` check: of the 3-D operands ``named``
    only those in ``const_ok`` may be bf16."""
    for name, x in named.items():
        if (x is not None and x.dtype == torch.bfloat16
                and name not in const_ok):
            raise ValueError(f"bf16 {name!r} is not a constant stream"
                             f"{suffix}")


def widen(x):
    """A bf16 tensor as float32 (exact); anything else as it is."""
    if x is not None and x.dtype == torch.bfloat16:
        return x.float()
    return x


#: the five phase-A outputs of ``capture`` (the 2-D ones, then ww's)
CAPTURE_NAMES = ("muave_before_theta", "mu_before_theta",
                 "mudf_before_theta", "muts_before_theta", "ww_before_theta")


def mark_in_place(tensors) -> None:
    """Raise the ``_version`` of every tensor a launch wrote through its
    pointer, as a torch op writing in place does, for what keys on
    versions (``models/stage_memo.py``)."""
    torch.autograd.graph.increment_version(list(tensors))


def check_no_alias(written: dict, read: dict) -> None:
    """No buffer a launch updates in place (``written``: name -> tensor or
    None) overlaps one it only reads (``read``, likewise).  The kernel
    loads a level's operands before it stores the levels below, and other
    threads read the neighbour columns of the read-only fields, so an
    overlap would change the result; raises ``ValueError`` naming both.
    A tensor's bytes are taken as ``nbytes`` from its first element, its
    span when it is contiguous (the kernel takes no other)."""
    spans = [(x.data_ptr(), x.nbytes, name) for name, x in written.items()
             if x is not None]
    for rn, x in read.items():
        if x is None:
            continue
        lo = x.data_ptr()
        hi = lo + x.nbytes
        for wlo, wbytes, wn in spans:
            if lo < wlo + wbytes and wlo < hi:
                raise ValueError(f"{rn} must not alias {wn}, which is "
                                 f"updated in place")


def _check_modes(*, tensors, t_ave, wind_scale, fuse_uv, mudf_in,
                 fuse_w, w, pp, rdn, capture, overlap, with_tave, ww_mode,
                 ww_row, ww, lean, tconst, dvdxi_const, ww1_k0):
    """The TPU wrapper's argument checks (``tensors``: the 3-D operands by
    name), and the port's own on the ``overlap`` rows."""
    if fuse_w and (w is None or pp is None or rdn is None):
        raise ValueError("fuse_w requires w, pp and rdn")
    if capture and (ww_mode != "full" or lean):
        raise ValueError("capture requires the plain full-ww path "
                         "(ww_mode='full', lean=False)")
    if overlap is not None:
        if not fuse_uv:
            raise ValueError("overlap requires fuse_uv (the coupled "
                             "substep; the mu_t-only loop has no per-"
                             "substep exchange to hide)")
        want = OVERLAP_ROWS[:3] + (OVERLAP_ROWS[3:] if mudf_in is not None
                                   else ())
        check_overlap_rows(overlap, want, OVERLAP_ROWS)
    if fuse_uv and wind_scale != 1.0:
        # both model the wind->mass coupling; combined, the scaled winds
        # would be written back out and the scale compound every substep
        raise ValueError("fuse_uv and wind_scale != 1 are mutually "
                         "exclusive")
    check_const_streams(
        tensors, CONST_STREAMS + (() if fuse_uv else ("u", "v")),
        " here (state/aliased operands must be f32)")
    if with_tave and t_ave is None:
        raise ValueError("t_ave is required when with_tave=True")
    if ww_mode not in _WW_MODES:
        raise ValueError(f"bad ww_mode {ww_mode!r}")
    if ww_mode != "full" and ww_row is None:
        raise ValueError("ww_row is required in lite/final ww_mode")
    if ww_mode != "lite" and ww is None:
        raise ValueError("ww is required in full/final ww_mode")
    if lean:
        if ww_mode != "lite" or with_tave:
            raise ValueError("lean mode requires ww_mode='lite' and "
                             "with_tave=False")
        if tconst is None or dvdxi_const is None or ww1_k0 is None:
            raise ValueError("lean mode requires tconst, dvdxi_const, ww1_k0")


def check_overlap_rows(overlap: dict, want, known,
                       in_place: dict | None = None) -> None:
    """``overlap`` names the neighbour rows ``want`` and nothing outside
    ``known``, and none of them lies in a buffer the launch updates in
    place (``in_place``: name -> tensor or None; K3's state, K1 has none):
    the kernel reads them while other blocks write those."""
    missing = [n for n in want if overlap.get(n) is None]
    extra = sorted(set(overlap) - set(known))
    if missing or extra:
        raise ValueError(f"overlap names the neighbours' rows {tuple(want)}; "
                         f"missing {missing}, unknown {extra}")
    for n in want:
        for name, buf in (in_place or {}).items():
            if (buf is not None
                    and overlap[n].untyped_storage().data_ptr()
                    == buf.untyped_storage().data_ptr()):
                raise ValueError(f"overlap[{n!r}] must not alias {name}, "
                                 f"which is updated in place")


def overlap_pointers(overlap, shapes: dict, dev) -> list:
    """The neighbour-row pointers of a launch, in the order of ``shapes``
    (name -> expected shape, or None for a row the launch does not read):
    each row a contiguous float32 view on a CUDA device.  A row on another
    device than ``dev`` is read through a peer pointer (peer access is
    enabled here, once per pair); the caller orders the devices' streams.
    ``overlap=None``: all None."""
    ptrs = []
    for n, shape in shapes.items():
        if overlap is None or shape is None:
            ptrs.append(None)
            continue
        row = overlap[n]
        if (not isinstance(row, torch.Tensor) or row.device.type != "cuda"
                or row.dtype != torch.float32 or tuple(row.shape) != shape
                or not row.is_contiguous()):
            raise ValueError(f"overlap[{n!r}]: expected a contiguous float32 "
                             f"CUDA tensor of shape {shape}")
        _enable_peer(dev, row.device)
        ptrs.append(row.data_ptr())
    return ptrs


def advance_mu_t_fused(
    *,
    ww, ww_1, u, u_1, v, v_1,
    mu, mut, muu, muv,
    t, t_1, ft, mu_tend,
    rdx, rdy, dts, epssm,
    dnw, fnm, fnp, rdnw,
    msfuy, msfvx_inv, msftx, msfty,
    window,                       # (i0, i1, j0, j1) in global coordinates
    k0: int, k1: int, kde: int,   # vertical bounds (kde: API parity only)
    t_ave=None,                   # required unless with_tave=False
    offsets=(0, 0),               # (j_off, i_off): this block's global origin
    wind_scale=1.0,
    fuse_uv: bool = False,        # run the advance_uv wind substep in-kernel
    cs2: float = 0.0,             # linearized sound speed^2 (fuse_uv only)
    mudf_in=None, smdiv: float = 0.0,
    fuse_w: bool = False,
    w=None, pp=None, rdn=None, cw: float = 0.0, gw: float = 0.0,
    with_tave: bool = True,       # update t_ave (skip inside scans)
    ww_mode: str = "full",        # "full" | "lite" | "final"
    ww_row=None,                  # (J, I) scan-seed row (lite/final)
    lean: bool = False,           # scan substeps: folded constants
    tconst=None, dvdxi_const=None, ww1_k0=None,
    capture: bool = False,
    overlap=None,
    thomas: ThomasVectors | None = None,   # fuse_w: precomputed K-vectors
):
    """One fused acoustic substep; the contract of ``advance_mu_t_pallas``.

    Arrays: 3-D ``(J, K, I)``, 2-D ``(J, I)``, vertical ``(K,)``, float32
    tensors on one device.  Rows 0 and J-1 are never computed: state passes
    through there and ``muave``/``muts``/``mudf`` are zero.  Returns
    ``muave, muts, mudf, mu, t``, plus ``ww`` (full/final) or ``ww_row``
    (lite), ``t_ave`` (with_tave), ``u``/``v`` (fuse_uv), ``w``/``pp``
    (fuse_w) and the five :data:`CAPTURE_NAMES` (capture), each in a
    fresh tensor: no operand is written (the module docstring).
    ``thomas`` (not in the TPU contract) lets a loop pass the
    :func:`~wrf_tpu_torch.ops.thomas.thomas_vectors` bundle it computed
    once; without it the wrapper computes the bundle from ``rdn``.
    """
    del kde   # API parity
    _check_modes(tensors=dict(u=u, v=v, t=t, t_1=t_1, ww_1=ww_1, u_1=u_1,
                              v_1=v_1, ft=ft, tconst=tconst,
                              dvdxi_const=dvdxi_const, ww=ww, t_ave=t_ave),
                 t_ave=t_ave, wind_scale=wind_scale, fuse_uv=fuse_uv,
                 mudf_in=mudf_in, fuse_w=fuse_w, w=w, pp=pp,
                 rdn=rdn, capture=capture,
                 overlap=overlap, with_tave=with_tave, ww_mode=ww_mode,
                 ww_row=ww_row, ww=ww, lean=lean, tconst=tconst,
                 dvdxi_const=dvdxi_const, ww1_k0=ww1_k0)
    kw = dict(ww=ww, ww_1=ww_1, u=u, u_1=u_1, v=v, v_1=v_1, mu=mu, mut=mut,
              muu=muu, muv=muv, t=t, t_1=t_1, ft=ft, mu_tend=mu_tend,
              rdx=rdx, rdy=rdy, dts=dts, epssm=epssm, dnw=dnw, fnm=fnm,
              fnp=fnp, rdnw=rdnw, msfuy=msfuy, msfvx_inv=msfvx_inv,
              msftx=msftx, msfty=msfty, window=window, k0=k0, k1=k1,
              t_ave=t_ave, offsets=offsets, wind_scale=wind_scale,
              fuse_uv=fuse_uv, cs2=cs2, with_tave=with_tave, ww_mode=ww_mode,
              ww_row=ww_row, lean=lean, tconst=tconst,
              dvdxi_const=dvdxi_const, ww1_k0=ww1_k0, mudf_in=mudf_in,
              smdiv=smdiv, capture=capture, overlap=overlap)
    if fuse_w:
        if thomas is None:
            thomas = thomas_vectors(rdn=rdn, rdnw=rdnw, dts=dts, epssm=epssm,
                                    cw=cw, gw=gw, k0=k0, k1=k1)
        kw.update(fuse_w=True, w=w, pp=pp, thomas=thomas)
    if t.device.type == "cpu":
        return advance_mu_t_fused_plain(**kw)
    if t.device.type == "cuda":
        return _launch(**kw)
    raise ValueError(f"advance_mu_t_fused: unsupported device {t.device}")


def advance_mu_t_fused_plain(
    *, ww, ww_1, u, u_1, v, v_1, mu, mut, muu, muv, t, t_1, ft, mu_tend,
    rdx, rdy, dts, epssm, dnw, fnm, fnp, rdnw,
    msfuy, msfvx_inv, msftx, msfty, window, k0: int, k1: int,
    kde: int | None = None,
    t_ave=None, offsets=(0, 0), wind_scale=1.0, fuse_uv: bool = False,
    cs2: float = 0.0,
    with_tave: bool = True, ww_mode: str = "full", ww_row=None,
    lean: bool = False, tconst=None, dvdxi_const=None, ww1_k0=None,
    fuse_w: bool = False, w=None, pp=None, rdn=None, cw: float = 0.0,
    gw: float = 0.0, thomas: ThomasVectors | None = None,
    mudf_in=None, smdiv: float = 0.0, capture: bool = False,
    overlap: dict | None = None,
):
    """Whole-array PyTorch version of the kernel, on any device.

    A transcription of the TPU kernel's arithmetic, term for term and in
    the same association: window masks from ``torch.arange`` + offsets,
    ``torch.roll`` for the i, j and k neighbours (wrapping like the TPU
    kernel's rolls; the masks make the wrapped values unused), and the
    dmdt column sum and the ww scan as k loops.  The column sum runs in k
    order (the oracle's and the CUDA kernel's order; the TPU kernel leaves
    the order of its jnp.sum to the compiler).  Same buffer contract as
    :func:`advance_mu_t_fused`: every result is a new tensor and no operand
    is written.  bf16 constant streams are widened on entry;
    under ``overlap`` the halo rows of copies of ``mu``, ``v`` and
    ``mudf_in`` take the neighbours' rows before the rolls (the caller's
    tensors are not written, and the pass-through rows of the outputs keep
    the stale values, as the kernel's do).
    """
    del kde   # API parity
    if capture and (ww_mode != "full" or lean):
        raise ValueError("capture requires the plain full-ww path "
                         "(ww_mode='full', lean=False)")
    if overlap is not None and not fuse_uv:
        raise ValueError("overlap requires fuse_uv")
    ww_1, u_1, v_1, t_1, ft, tconst, dvdxi_const = (
        widen(x) for x in (ww_1, u_1, v_1, t_1, ft, tconst, dvdxi_const))
    if not fuse_uv:
        u, v = widen(u), widen(v)
    if fuse_w and thomas is None:
        if w is None or pp is None or rdn is None:
            raise ValueError("fuse_w requires w, pp and rdn")
        thomas = thomas_vectors(rdn=rdn, rdnw=rdnw, dts=dts, epssm=epssm,
                                cw=cw, gw=gw, k0=k0, k1=k1)
    rdx, rdy, dts, epssm, cs2, ws = (
        _f32(s) for s in (rdx, rdy, dts, epssm, cs2, wind_scale))
    J, K, I = t.shape
    dev = t.device
    i0, i1, j0, j1 = (int(x) for x in window)
    j_off, i_off = (int(x) for x in offsets)

    def col(x):  # (J, I) -> (J, 1, I), broadcasting over k
        return x[:, None, :]

    def lev(x):  # (K,) -> (1, K, 1)
        return x.view(1, K, 1)

    i_glob = torch.arange(I, device=dev).view(1, 1, I) + i_off
    j_loc = torch.arange(J, device=dev).view(J, 1, 1)
    j_glob = j_loc + j_off
    i_in = (i_glob >= i0) & (i_glob <= i1)
    j_in = (j_glob >= j0) & (j_glob <= j1)
    computed = (j_loc >= 1) & (j_loc <= J - 2)   # edge rows pass through
    mask = i_in & j_in & computed                # (J, 1, I)
    kv = torch.arange(K, device=dev).view(1, K, 1)
    kmask = (kv >= k0) & (kv <= k1)
    upd = kmask & mask

    mu_mem = col(mu)       # what the pass-through rows of mu's output hold
    u_in, v_in = u, v
    if overlap is not None:
        # the stale halo rows take the neighbours' rows, on copies
        mu, v = mu.clone(), v.clone()
        mu[0], mu[J - 1] = overlap["mu_lo"], overlap["mu_hi"]
        v[J - 1] = overlap["v_hi"]
        if mudf_in is not None:
            mudf_in = mudf_in.clone()
            mudf_in[0], mudf_in[J - 1] = (overlap["mudf_lo"],
                                          overlap["mudf_hi"])
    mu3 = col(mu)
    muu_over_msfuy = col(muu / msfuy)
    muv_msfvxi = col(muv * msfvx_inv)
    msftx3, msfty3 = col(msftx), col(msfty)

    # ---- fused wind substep (advance_uv) ---------------------------------
    if ws != 1.0:   # read-only winds, scaled on load (never with fuse_uv)
        u, v = u * ws, v * ws
    if fuse_uv:
        p = cs2 * mu3
        if mudf_in is not None and smdiv != 0.0:
            # divergence damping: the previous substep's mass-divergence
            # tendency stiffens the pressure (ops/advance_uv.py)
            p = p + damp_coefficient(cs2, smdiv) * col(mudf_in)
        u_mask = (i_glob >= i0 + 1) & (i_glob <= i1) & j_in
        v_mask = i_in & (j_glob >= j0 + 1) & (j_glob <= j1)
        du = (dts * muu_over_msfuy * (-rdx)) * (p - torch.roll(p, 1, 2))
        dv = (dts * muv_msfvxi * (-rdy)) * (p - torch.roll(p, 1, 0))
        u = u + torch.where(u_mask, du, 0.0)
        v = v + torch.where(v_mask, dv, 0.0)

    # ---- mass-flux divergence and column sum -------------------------------
    msft2 = msftx3 * msfty3
    v_p = torch.roll(v, -1, 0)
    if lean:
        dvdxi = dvdxi_const + msft2 * (
            rdy * (v_p - v) + rdx * (torch.roll(u, -1, 2) - u))
    else:
        vflux = v + muv_msfvxi * v_1
        uflux = u + muu_over_msfuy * u_1
        dvdxi = msft2 * (
            rdy * (torch.roll(vflux, -1, 0) - vflux)
            + rdx * (torch.roll(uflux, -1, 2) - uflux))
    dmdt = torch.zeros_like(mu3)   # column sum in k order, as the oracle
    for k in range(k0, k1 + 1):
        dmdt = dmdt + dnw[k] * dvdxi[:, k:k + 1, :]

    # ---- mu with epsilon off-centering -----------------------------------
    tend = dmdt + col(mu_tend)
    mu_new = mu3 + dts * tend
    mu_val = torch.where(mask, mu_new, mu_mem)
    mudf = torch.where(mask, tend, 0.0)
    muts = torch.where(mask, col(mut) + mu_new, 0.0)
    muave = torch.where(
        mask, 0.5 * (_f32(1.0 + epssm) * mu_new + _f32(1.0 - epssm) * mu3), 0.0)

    # ---- ww scan, k ascending from the seed -------------------------------
    steps = (-lev(dnw) * (dmdt + dvdxi + col(mu_tend))) * (1.0 / msfty3)
    seed = ww[:, k0:k0 + 1, :] if ww_mode == "full" else col(ww_row)
    scan = torch.roll(steps, 1, 1)   # level k holds step(k-1)
    scan[:, k0:k0 + 1, :] = seed
    for k in range(k0 + 1, k1 + 1):
        scan[:, k, :] = scan[:, k - 1, :] + scan[:, k, :]
    if ww_mode == "lite":
        # lean: the -ww_1 part of the theta flux lives in tconst, so ww_new
        # is the raw scan value; the carry is the next seed row
        ww1k0 = col(ww1_k0) if lean else ww_1[:, k0:k0 + 1, :]
        ww_new = torch.where(upd, scan if lean else scan - ww_1, 0.0)
        ww_row_new = torch.where(mask, seed - ww1k0, seed)
    else:
        ww_new = torch.where(upd, scan - ww_1, ww)

    # ---- theta ---------------------------------------------------------------
    t_half = t + tconst if lean else t + (msfty3 * dts) * ft
    kint = (kv >= k0 + 1) & (kv <= k1)
    wdtn = ww_new * (lev(fnm) * t_1 + lev(fnp) * torch.roll(t_1, 1, 1))
    wdtn = torch.where(kint, wdtn, 0.0)
    vert = lev(rdnw) * (torch.roll(wdtn, -1, 1) - wdtn)
    fy = (v_p * (torch.roll(t_1, -1, 0) + t_1)
          - v * (t_1 + torch.roll(t_1, 1, 0)))
    fx = (torch.roll(u, -1, 2) * (torch.roll(t_1, -1, 2) + t_1)
          - u * (t_1 + torch.roll(t_1, 1, 2)))
    horiz = msftx3 * (0.5 * rdy * fy + 0.5 * rdx * fx)
    t_new = t_half - (dts * msfty3) * (horiz + vert)
    t_full = torch.where(upd, t_new, t)

    res = {"muave": muave[:, 0], "muts": muts[:, 0], "mudf": mudf[:, 0],
           "mu": mu_val[:, 0]}
    if with_tave:
        res["t_ave"] = torch.where(upd, t, t_ave)
    res["t"] = t_full
    if ww_mode == "lite":
        res["ww_row"] = ww_row_new[:, 0]
    else:
        res["ww"] = ww_new
    if fuse_uv:
        res["u"] = torch.where(computed, u, u_in)
        res["v"] = torch.where(computed, v, v_in)
    if fuse_w:
        w_new, pp_new = w_step_plain(w, pp, t_full, thomas, lev(rdnw),
                                     kmask, kint, mask, k0, k1)
        res["w"], res["pp"] = w_new, pp_new
    if capture:
        # the phase-A values the outputs hold, taken before theta; the
        # never-computed rows 0 and J-1 are zero in all five
        res.update(
            muave_before_theta=muave[:, 0].clone(),
            mu_before_theta=torch.where(computed, mu_val, 0.0)[:, 0],
            mudf_before_theta=mudf[:, 0].clone(),
            muts_before_theta=muts[:, 0].clone(),
            ww_before_theta=torch.where(computed, ww_new, 0.0))
    return res


def damp_coefficient(cs2, smdiv) -> float:
    """``cs2 * smdiv`` as one float32 product: the damping coefficient the
    kernel receives as a scalar (the TPU wrapper forms it the same way)."""
    return float(np.float32(cs2) * np.float32(smdiv))


def w_step_plain(w, pp, t_full, th: ThomasVectors, rdnw3, kmask_upd, kmask_w,
                 mask, k0: int, k1: int, fast: bool = False):
    """The fused vertically-implicit w/pp substep on whole arrays: the TPU
    kernels' ``fuse_w`` block (``_w_solver.w_step``), term for term.
    ``kmask_upd`` is k0 <= k <= k1 (centres), ``kmask_w`` k0 < k <= k1
    (interior interfaces), ``mask`` the (J, 1, I) column window; the k
    rolls wrap and every wrapped value is masked.  Exact mode runs the two
    Thomas sweeps as k loops; ``fast`` runs them as the scaled log-depth
    cumsums (a re-association).  Returns new ``(w, pp)`` tensors."""
    K = w.shape[1]

    def lev(x):
        return x.view(1, K, 1)

    w_act = torch.where(kmask_w, w, 0.0)       # rigid surface and lid
    dvz = torch.where(kmask_upd,
                      rdnw3 * (torch.roll(w_act, -1, 1) - w_act), 0.0)
    rhs = (w - lev(th.crdn) * (pp - torch.roll(pp, 1, 1))
           + lev(th.erdn) * (dvz - torch.roll(dvz, 1, 1)) + th.g_t * t_full)
    if fast:
        kv = torch.arange(K, device=w.device).view(1, K, 1)
        fws, fwp, bws, bwp = (lev(x) for x in th.fast)
        y = rhs * fws                            # inclusive cumsum over k
        d = 1
        while d < K:
            y = y + torch.where(kv >= d, torch.roll(y, d, 1), 0.0)
            d *= 2
        y = (fwp * y) * bws                      # reverse inclusive cumsum
        d = 1
        while d < K:
            y = y + torch.where(kv < K - d, torch.roll(y, -d, 1), 0.0)
            d *= 2
        w_sol = bwp * y
    else:
        w_sol = torch.zeros_like(w)              # the sweeps' dpw
        for k in range(k0 + 1, k1 + 1):
            w_sol[:, k, :] = ((rhs[:, k, :] + th.a[k] * w_sol[:, k - 1, :])
                              / th.den[k])
        for k in range(k1 - 1, k0, -1):
            w_sol[:, k, :] = w_sol[:, k, :] - th.cp[k] * w_sol[:, k + 1, :]
    w_new = torch.where(kmask_w & mask, w_sol, w)
    wn_act = torch.where(kmask_w, w_sol, 0.0)
    dvz_new = torch.where(kmask_upd,
                          rdnw3 * (torch.roll(wn_act, -1, 1) - wn_act), 0.0)
    pp_new = torch.where(kmask_upd & mask,
                         pp - th.c_w * (th.beta * dvz_new + th.alfa * dvz), pp)
    return w_new, pp_new


# --------------------------------------------------------------------------
# Lean-mode constants (computed once per loop call, as the TPU loop does)
# --------------------------------------------------------------------------
def lean_constants(*, ww_1, u_1, v_1, ft, t_1, fnm, fnp, rdnw,
                   muu, muv, msfuy, msfvx_inv, msftx, msfty,
                   rdx, rdy, dts, k0: int, k1: int):
    """The lean-mode constants on (halo-padded) local blocks.

    ``dvdxi_const`` is the u_1/v_1 static part of the mass-flux divergence;
    ``tconst`` folds the slow theta tendency (ft) together with the ww_1
    part of the vertical theta flux; ``ww1_k0`` is the seed-row recurrence
    term (``advance_mu_t_pallas.lean_constants``, same arithmetic).  Each
    is built by one of the parts below, which a cache may call alone."""
    vert = lean_vert_flux(ww_1=ww_1, t_1=t_1, fnm=fnm, fnp=fnp, rdnw=rdnw,
                          msfty=msfty, dts=dts, k0=k0, k1=k1)
    tconst = lean_tconst(ft=ft, msfty=msfty, dts=dts, vert=vert)
    dvdxi_const = lean_dvdxi_const(u_1=u_1, v_1=v_1, muu=muu, muv=muv,
                                   msfuy=msfuy, msfvx_inv=msfvx_inv,
                                   msftx=msftx, msfty=msfty, rdx=rdx, rdy=rdy)
    return tconst, dvdxi_const, lean_ww1_k0(ww_1=ww_1, k0=k0)


def lean_vert_flux(*, ww_1, t_1, fnm, fnp, rdnw, msfty, dts, k0: int,
                   k1: int):
    """``tconst``'s ww_1 term, ``(dts * msfty) * vert1``: the vertical
    theta flux of ww_1 on its interior interfaces."""
    dts = _f32(dts)
    K = t_1.shape[1]
    kv = torch.arange(K, device=t_1.device)
    kint = ((kv > k0) & (kv <= k1))[None, :, None]
    fnm3, fnp3, rdnw3 = (x.view(1, K, 1) for x in (fnm, fnp, rdnw))
    interp = fnm3 * t_1 + fnp3 * torch.roll(t_1, 1, 1)
    wdtn1 = torch.where(kint, ww_1 * interp, 0.0)
    vert1 = rdnw3 * (torch.roll(wdtn1, -1, 1) - wdtn1)
    return (dts * msfty[:, None, :]) * vert1


def lean_tconst(*, ft, msfty, dts, vert):
    """``tconst = (msfty * dts) * ft + vert``, ``vert`` being
    :func:`lean_vert_flux` (two products and an add, no fused multiply-add:
    the bits of the whole expression)."""
    return (msfty[:, None, :] * _f32(dts)) * ft + vert


def lean_dvdxi_const(*, u_1, v_1, muu, muv, msfuy, msfvx_inv, msftx, msfty,
                     rdx, rdy):
    """``dvdxi_const``: the u_1/v_1 part of the mass-flux divergence."""
    rdx, rdy = _f32(rdx), _f32(rdy)
    c_u = (muu / msfuy)[:, None, :] * u_1
    c_v = (muv * msfvx_inv)[:, None, :] * v_1
    msft2 = (msftx * msfty)[:, None, :]
    return msft2 * (rdy * (torch.roll(c_v, -1, 0) - c_v)
                    + rdx * (torch.roll(c_u, -1, 2) - c_u))


def lean_ww1_k0(*, ww_1, k0: int):
    """``ww1_k0``: ww_1's seed level, a contiguous 2-D block."""
    return ww_1[:, k0, :].contiguous()


def lean_kwargs(padded: dict, rdx, rdy, dts, k0: int, k1: int) -> dict:
    """The lean-mode constants as :func:`advance_mu_t_fused` kwargs, from a
    loop's padded local field dict."""
    tconst, dvdxi_const, ww1_k0 = lean_constants(
        ww_1=padded["ww_1"], u_1=padded["u_1"], v_1=padded["v_1"],
        ft=padded["ft"], t_1=padded["t_1"], fnm=padded["fnm"],
        fnp=padded["fnp"], rdnw=padded["rdnw"], muu=padded["muu"],
        muv=padded["muv"], msfuy=padded["msfuy"],
        msfvx_inv=padded["msfvx_inv"], msftx=padded["msftx"],
        msfty=padded["msfty"], rdx=rdx, rdy=rdy, dts=dts, k0=k0, k1=k1,
    )
    return {"tconst": tconst, "dvdxi_const": dvdxi_const, "ww1_k0": ww1_k0}


# --------------------------------------------------------------------------
# The CUDA launch
# --------------------------------------------------------------------------
def _kernel():
    """The C entry of csrc/advance_mu_t.cu (library built on first use)."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load().wrf_tpu_torch_advance_mu_t
        fn.argtypes = ([ctypes.c_void_p] * 57 + [ctypes.c_float] * 11
                       + [ctypes.c_int] * 18 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def launch_shape(K: int, fuse_w: bool) -> tuple[int, int, int]:
    """``(lanes, rows, shared-memory bytes)`` of one block: ``LANES`` columns
    along i by ``BLOCK_ROWS`` rows along j, one thread per column.  Only
    ``fuse_w`` keeps a K-long float slice per thread in dynamic shared
    memory (the w/pp solve's sweep state); it takes fewer rows where K
    levels of ``BLOCK_ROWS`` rows would pass the no-opt-in limit, and
    raises past one row.  Without ``fuse_w`` no K is too deep."""
    if not fuse_w:
        return LANES, BLOCK_ROWS, 0
    for rows in range(BLOCK_ROWS, 0, -1):
        if K * LANES * rows * 4 <= _SMEM_LIMIT:
            return LANES, rows, K * LANES * rows * 4
    raise ValueError(f"K={K} levels exceed the w/pp solve's shared-memory "
                     f"sweep buffer ({_SMEM_LIMIT // (LANES * 4)} levels "
                     f"max)")


def narrow_streams(fields: dict, names,
                   narrow_ok: bool = True) -> tuple[dict, bool]:
    """One element type for a launch's constant streams.  ``names`` are the
    streams of ``fields`` (name -> ``(tensor, ndim, used)``) that may be
    bf16.  When every used one is (and the kernel has a narrow instance for
    the mode, ``narrow_ok``), the launch reads them narrow: returns the
    fields as they are and True.  Otherwise the bf16 ones are widened to
    float32 first (exact, so the result is the same): returns the fields
    with those replaced and False."""
    used = [n for n in names if fields[n][2]]
    if (narrow_ok and used
            and all(fields[n][0].dtype == torch.bfloat16 for n in used)):
        return fields, True
    out = dict(fields)
    for n in used:
        x, ndim, _ = fields[n]
        out[n] = (widen(x), ndim, True)
    return out, False


def checked_pointers(fields: dict, shapes: dict, dev, narrow=()) -> list:
    """``data_ptr()`` of each field the launch uses (None where unused),
    after checking that it is a contiguous float32 tensor on ``dev`` of its
    expected shape (bfloat16 for the names in ``narrow``).  ``fields`` maps
    a name to ``(tensor, ndim, used)``; ``shapes`` maps an ndim to the
    expected shape."""
    ptrs = []
    for name, (x, ndim, used) in fields.items():
        if not used:
            ptrs.append(None)
            continue
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError(f"{name}: expected a tensor on {dev}")
        want = torch.bfloat16 if name in narrow else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {x.dtype}")
        if tuple(x.shape) != shapes[ndim]:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{shapes[ndim]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        ptrs.append(x.data_ptr())
    return ptrs


def _launch(*, ww, ww_1, u, u_1, v, v_1, mu, mut, muu, muv, t, t_1, ft,
            mu_tend, rdx, rdy, dts, epssm, dnw, fnm, fnp, rdnw, msfuy,
            msfvx_inv, msftx, msfty, window, k0, k1, t_ave, offsets,
            wind_scale, fuse_uv, cs2, with_tave, ww_mode, ww_row, lean,
            tconst, dvdxi_const, ww1_k0, fuse_w=False, w=None, pp=None,
            thomas=None, mudf_in=None, smdiv=0.0, capture=False,
            overlap=None):
    global LAUNCHES
    J, K, I = t.shape
    dev = t.device
    if not (0 <= k0 <= k1 < K):
        raise ValueError(f"bad vertical bounds k0={k0}, k1={k1} for K={K}")
    shapes = {3: (J, K, I), 2: (J, I), 1: (K,)}
    # without fuse_uv damping is off whatever smdiv says (the TPU wrapper)
    use_damp = fuse_uv and mudf_in is not None and smdiv != 0.0
    fields = dict(
        ww=(ww, 3, ww_mode != "lite"), ww_1=(ww_1, 3, not lean),
        u=(u, 3, True), u_1=(u_1, 3, not lean), v=(v, 3, True),
        v_1=(v_1, 3, not lean), t=(t, 3, True), t_1=(t_1, 3, True),
        t_ave=(t_ave, 3, with_tave), ft=(ft, 3, not lean),
        tconst=(tconst, 3, lean), dvdxi_const=(dvdxi_const, 3, lean),
        mu=(mu, 2, True), mudf_in=(mudf_in, 2, use_damp),
        mut=(mut, 2, True), muu=(muu, 2, True),
        muv=(muv, 2, True), mu_tend=(mu_tend, 2, True),
        msfuy=(msfuy, 2, True), msfvx_inv=(msfvx_inv, 2, True),
        msftx=(msftx, 2, True), msfty=(msfty, 2, True),
        ww_row=(ww_row, 2, ww_mode != "full"), ww1_k0=(ww1_k0, 2, lean),
        dnw=(dnw, 1, True), fnm=(fnm, 1, True), fnp=(fnp, 1, True),
        rdnw=(rdnw, 1, True),
        w=(w, 3, fuse_w), pp=(pp, 3, fuse_w),
        **{"thomas." + n: (getattr(thomas, n, None), 1, fuse_w)
           for n in ("a", "cp", "den", "crdn", "erdn")},
    )
    streams = CONST_STREAMS + (() if fuse_uv else ("u", "v"))
    # no narrow capture instance is built
    fields, const_bf16 = narrow_streams(fields, streams,
                                        narrow_ok=not capture)
    ptrs = checked_pointers(fields, shapes, dev,
                            narrow=streams if const_bf16 else ())
    th_scalars = ((thomas.c_w, thomas.g_t, thomas.beta, thomas.alfa)
                  if fuse_w else (0.0,) * 4)
    rows = overlap_pointers(overlap, {
        "mu_lo": (I,), "mu_hi": (I,), "v_hi": (K, I),
        "mudf_lo": (I,) if use_damp else None,
        "mudf_hi": (I,) if use_damp else None}, dev)

    # a fresh buffer for every output of the mode (the kernel writes every
    # element), by its ndim, in the C entry's order; None: not an output
    ndims = dict(mu=2, muave=2, muts=2, mudf=2,
                 u=3 if fuse_uv else None, v=3 if fuse_uv else None, t=3,
                 ww=3 if ww_mode != "lite" else None,
                 t_ave=3 if with_tave else None,
                 ww_row=2 if ww_mode == "lite" else None,
                 w=3 if fuse_w else None, pp=3 if fuse_w else None,
                 **{n: (3 if n.startswith("ww") else 2) if capture else None
                    for n in CAPTURE_NAMES})
    res = {n: torch.empty(shapes[d], dtype=torch.float32, device=dev)
           for n, d in ndims.items() if d is not None}
    outs = [res[n].data_ptr() if n in res else None for n in ndims]
    i0, i1, j0, j1 = (int(x) for x in window)
    j_off, i_off = (int(x) for x in offsets)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *outs, *rows,
                 _f32(rdx), _f32(rdy), _f32(dts), _f32(epssm), _f32(cs2),
                 damp_coefficient(cs2, smdiv) if use_damp else 0.0,
                 _f32(wind_scale), *th_scalars, J, K, I, i0, i1, j0, j1,
                 j_off, i_off, int(k0), int(k1),
                 int(fuse_uv), int(lean), _WW_MODES[ww_mode], int(with_tave),
                 int(fuse_w), int(const_bf16), launch_shape(K, fuse_w)[1],
                 stream)
    if err != 0:
        raise RuntimeError(f"advance_mu_t kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return res
