"""K3 (and K4): S coupled acoustic substeps per pass, on the GPU and in plain PyTorch.

The port of ``wrf_tpu/ops/advance_mu_t_msteps.py``'s depth-S coupled
trapezoid (kernel ``_coupled_ms_kernel``, wrapper
``coupled_multistep_pallas``) and of its hand-unrolled S=2 pair (kernel
``_coupled2_kernel``, wrapper ``coupled_two_step_pallas``).  Each substep
is K1's fused scan substep (``fuse_uv`` + ``lean`` + ``lite``): the wind
update from ``p = cs2*mu``, dvdxi and dmdt, the mu update, the seeded ww
scan and theta, and with ``fuse_w`` the vertically-implicit w/pp substep
(``ops/advance_w.py``) on that substep's new theta.  Substeps couple
through mu, u and v at neighbour cells, so substep s updates the winds and
mu on rows extended by ``S-1-s`` on each side of the block's own rows, and
theta, ww, w and pp on its own rows only.

Array contract (the Pallas wrappers'): 3-D ``(J2, K, I)``, 2-D
``(J2, I)``, vertical ``(K,)``, float32 tensors in the ring-S layout of
:func:`wrf_tpu_torch.parallel.halo.widen_ring_to` — the first and last S
rows are ring rows, never computed; ``offsets`` maps local row S to
global ring row ``j_off + 1``; i wraps.  ``cu``, ``cv`` and ``msft2`` come
from :func:`coupled_lean_kwargs`, ``tconst``, ``dvdxi_const`` and
``ww1_k0`` from :func:`~wrf_tpu_torch.ops.advance_mu_t_cuda.lean_kwargs`,
both computed on the widened inputs.  Returns ``{"t", "mu", "ww_row",
"u", "v"}`` (+ ``w``/``pp`` under ``fuse_w``): t, ww_row, w and pp are read
only at their own column and are updated IN PLACE (the dispatchers raise
their ``_version`` after the launch); u, v and mu are read
at neighbour rows while other blocks update them, so they come back in
fresh tensors whose S ring rows pass through from the inputs.

``overlap`` is the j leg of the width-S ring exchange inside the kernel:
the S ring rows on either side of ``mu``, ``u`` and ``v`` in memory are
taken as stale, and every read of one goes to the ring neighbours' blocks
instead.  The TPU wrapper's ``overlap`` names a mesh axis; here one process
holds every shard, so it names the rows: a dict of contiguous row-slab
views ``{"mu_lo", "u_lo", "v_lo"}`` (the previous shard's last S interior
rows) and ``{"mu_hi", "u_hi", "v_hi"}`` (the next shard's first S).  The
kernel loads them through their device pointers (the staged form once,
while staging): nothing is copied or waited for, and the result equals the
one on refreshed ring rows bit for bit.  The ring rows of the outputs pass
the stale memory rows through.

bf16 constant streams: ``t_1``, ``tconst`` and ``dvdxi_const`` may arrive
as ``torch.bfloat16`` and are widened to float32 on load; a bf16 ``u``,
``v`` or ``t`` is a ``ValueError``.  When all three are bf16 the kernel
reads them narrow; a mixed set is widened before the launch (exact).

Two modes: exact (the ww scan and the Thomas sweeps sequential in k) and
``fast`` (the scan, and both sweeps of the w solve, as the TPU kernel's
log-depth masked cumsums, a re-association).  The CUDA kernel runs them
sequentially in both, so its fast mode is its exact mode; its plain
version keeps the cumsums.

Dispatch is by the device of the tensors: CUDA tensors launch the
hand-written kernel (``csrc/advance_mu_t_coupled_kernel.cuh``), in the
form and on the tile :func:`plan` picks, and count
one in :data:`LAUNCHES` (:data:`PAIR_LAUNCHES` for
:func:`coupled_two_step`); CPU tensors run
:func:`coupled_multistep_plain`.  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from .advance_mu_t_cuda import (
    _f32, check_const_streams, check_overlap_rows, checked_pointers,
    mark_in_place, narrow_streams, overlap_pointers, w_step_plain, widen,
)
from .thomas import ThomasVectors, thomas_vectors

#: CUDA launches of :func:`coupled_multistep` since import
LAUNCHES = 0
#: CUDA launches of :func:`coupled_two_step` since import
PAIR_LAUNCHES = 0

#: depths the CUDA kernel is instantiated for
MAX_INNER = 8

#: the most dynamic shared memory one block may take on an H100
SMEM_LIMIT = 232448
#: (rows, columns) of a block's own tile in the streaming form; the block
#: also computes the trapezoid's S-1 extra cells on every side
STREAMING_TILE = (16, 32)
#: the staged form's candidate tiles: widths that are multiples of 8 (so
#: that every box of bf16 streams starts on 16 bytes) and heights 1-32
STAGED_TI = (8, 16, 24, 32)
STAGED_TJ = tuple(range(1, 33))
#: the fewest own columns a staged tile may have: the k-ordered sums run one
#: thread per column, so a smaller tile leaves the block idle there and
#: stages more halo per column (S=5's 5x8 tile ties the streaming form)
MIN_OWN = 32
#: the forms' codes in the C entry
FORMS = {"streaming": 0, "staged": 1}

#: the 3-D operands that may arrive as bf16
CONST_STREAMS = ("t_1", "tconst", "dvdxi_const")

#: the neighbour row slabs ``overlap`` names, in the C entry's order
OVERLAP_ROWS = ("mu_lo", "mu_hi", "u_lo", "u_hi", "v_lo", "v_hi")

_kernel_fn = None


def _check(*, tensors, n_inner, fuse_w, w, pp, rdn, ti, overlap, J2,
           written):
    """The Pallas wrapper's argument checks (``tensors``: the 3-D operands
    by name), and the port's own on ``written``, updated in place."""
    if n_inner < 2:
        raise ValueError("n_inner must be >= 2 (use the single-step kernel "
                         "for S=1)")
    if fuse_w and (w is None or pp is None or rdn is None):
        raise ValueError("fuse_w requires w, pp and rdn")
    if ti is not None:
        raise NotImplementedError(
            "coupled_multistep: ti (the TPU's 128-lane tiled layout) is met "
            "by the kernel's own (j, i) tiles, which plan() picks per "
            "launch; pass no ti (ROADMAP.md, §2, closed)")
    check_const_streams(tensors, CONST_STREAMS)
    if J2 - 2 * n_inner < 1:
        raise ValueError(f"J2={J2}: no row inside the ring-{n_inner} rows")
    if overlap is not None:
        check_overlap_rows(overlap, OVERLAP_ROWS, OVERLAP_ROWS,
                           in_place=written)


def coupled_lean_kwargs(padded: dict, rdx, rdy, dts) -> dict:
    """The 2-D wind and flux coefficients of the coupled substep, in K1's
    association: ``cu = dts*(muu/msfuy)*(-rdx)``, ``cv =
    dts*(muv*msfvx_inv)*(-rdy)``, ``msft2 = msftx*msfty`` (products only,
    so computing them outside the kernel changes no bit)."""
    rdx, rdy, dts = _f32(rdx), _f32(rdy), _f32(dts)
    return {
        "cu": dts * (padded["muu"] / padded["msfuy"]) * (-rdx),
        "cv": dts * (padded["muv"] * padded["msfvx_inv"]) * (-rdy),
        "msft2": padded["msftx"] * padded["msfty"],
    }


def coupled_multistep(
    *,
    u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row,
    mu, mu_tend, msftx, msfty, cu, cv, msft2,
    rdx, rdy, dts, cs2,
    dnw, fnm, fnp, rdnw,
    window, offsets=(0, 0),
    k0: int, k1: int, kde: int,
    n_inner: int = 2,
    fuse_w: bool = False,
    w=None, pp=None, rdn=None,
    cw: float = 0.0, gw: float = 0.0, epssm=0.0,
    fast: bool = False,
    ti: int | None = None,
    overlap: dict | None = None,
    thomas: ThomasVectors | None = None,
):
    """``n_inner`` coupled substeps in one pass over ring-``n_inner``
    arrays; the contract of ``coupled_multistep_pallas`` without its TPU
    tiling arguments (see the module docstring).  ``thomas`` (not in the
    TPU contract) is the precomputed
    :func:`~wrf_tpu_torch.ops.thomas.thomas_vectors` bundle of a loop."""
    global LAUNCHES
    del kde   # API parity
    written = dict(t=t, ww_row=ww_row, **(dict(w=w, pp=pp) if fuse_w else {}))
    _check(tensors=dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst,
                        dvdxi_const=dvdxi_const), n_inner=n_inner,
           fuse_w=fuse_w, w=w, pp=pp, rdn=rdn, ti=ti, overlap=overlap,
           J2=t.shape[0], written=written)
    kw = dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst, dvdxi_const=dvdxi_const,
              ww1_k0=ww1_k0, ww_row=ww_row, mu=mu, mu_tend=mu_tend,
              msftx=msftx, msfty=msfty, cu=cu, cv=cv, msft2=msft2, rdx=rdx,
              rdy=rdy, dts=dts, cs2=cs2, dnw=dnw, fnm=fnm, fnp=fnp,
              rdnw=rdnw, window=window, offsets=offsets, k0=k0, k1=k1,
              n_inner=n_inner, overlap=overlap,
              **_w_kwargs(fuse_w, w, pp, rdn, rdnw, dts, epssm, cw, gw, k0, k1,
                          fast and t.device.type == "cpu", thomas))
    if t.device.type == "cpu":
        out = coupled_multistep_plain(**kw, fast=fast)
    elif t.device.type == "cuda":
        out = _launch(**kw)
        LAUNCHES += 1
    else:
        raise ValueError(f"coupled_multistep: unsupported device {t.device}")
    mark_in_place(written.values())
    return out


def _w_kwargs(fuse_w, w, pp, rdn, rdnw, dts, epssm, cw, gw, k0, k1, fast,
              thomas):
    """The w-solve keywords the plain version and the launch take: nothing
    without ``fuse_w``; else the state and the Thomas bundle (computed here
    unless the caller passed one; ``fast`` asks for the cumsum vectors)."""
    if not fuse_w:
        return {}
    if thomas is None or (fast and thomas.fast is None):
        thomas = thomas_vectors(rdn=rdn, rdnw=rdnw, dts=dts, epssm=epssm,
                                cw=cw, gw=gw, k0=k0, k1=k1, fast=fast)
    return dict(fuse_w=True, w=w, pp=pp, thomas=thomas)


def coupled_two_step(
    *,
    u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row,
    mu, mu_tend, msftx, msfty, cu, cv, msft2,
    rdx, rdy, dts, cs2,
    dnw, fnm, fnp, rdnw,
    window, offsets=(0, 0),
    k0: int, k1: int, kde: int,
    fuse_w: bool = False,
    w=None, pp=None, rdn=None,
    cw: float = 0.0, gw: float = 0.0, epssm=0.0,
    fast: bool = False,
    thomas: ThomasVectors | None = None,
):
    """Two coupled substeps over ring-2 arrays; the contract of
    ``coupled_two_step_pallas`` without its TPU tiling arguments.  The
    TPU's hand-unrolled pair computes what the depth-S trapezoid computes
    at S=2, so this runs K3's S=2 instance (its own template instance of
    the CUDA kernel; :func:`coupled_multistep_plain` with ``n_inner=2`` on
    CPU tensors).  Like the TPU pair it takes no ``overlap``: S=2 with the
    in-kernel exchange goes through :func:`coupled_multistep`."""
    global PAIR_LAUNCHES
    del kde   # API parity
    written = dict(t=t, ww_row=ww_row, **(dict(w=w, pp=pp) if fuse_w else {}))
    _check(tensors=dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst,
                        dvdxi_const=dvdxi_const), n_inner=2,
           fuse_w=fuse_w, w=w, pp=pp, rdn=rdn, ti=None, overlap=None,
           J2=t.shape[0], written=written)
    kw = dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst, dvdxi_const=dvdxi_const,
              ww1_k0=ww1_k0, ww_row=ww_row, mu=mu, mu_tend=mu_tend,
              msftx=msftx, msfty=msfty, cu=cu, cv=cv, msft2=msft2, rdx=rdx,
              rdy=rdy, dts=dts, cs2=cs2, dnw=dnw, fnm=fnm, fnp=fnp,
              rdnw=rdnw, window=window, offsets=offsets, k0=k0, k1=k1,
              n_inner=2,
              **_w_kwargs(fuse_w, w, pp, rdn, rdnw, dts, epssm, cw, gw, k0, k1,
                          fast and t.device.type == "cpu", thomas))
    if t.device.type == "cpu":
        out = coupled_multistep_plain(**kw, fast=fast)
    elif t.device.type == "cuda":
        out = _launch(**kw)
        PAIR_LAUNCHES += 1
    else:
        raise ValueError(f"coupled_two_step: unsupported device {t.device}")
    mark_in_place(written.values())
    return out


def coupled_multistep_plain(
    *, u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu, mu_tend,
    msftx, msfty, cu, cv, msft2, rdx, rdy, dts, cs2, dnw, fnm, fnp, rdnw,
    window, k0: int, k1: int, offsets=(0, 0), n_inner: int = 2,
    fast: bool = False, kde=None, epssm=0.0,
    fuse_w: bool = False, w=None, pp=None, rdn=None, cw: float = 0.0,
    gw: float = 0.0, thomas: ThomasVectors | None = None,
    overlap: dict | None = None,
):
    """Whole-array PyTorch version of the kernel, on any device.

    A transcription of the TPU kernel: the same
    extent-tracked row slicing (an array ``a`` with extent ``a_lo`` covers
    rows ``[S - a_lo, J2 - S + a_lo)``), ``torch.roll`` for the i and k
    neighbours, and K1's plain version's operations in its order (the
    dmdt column sum in k order; exact mode's ww scan as a k loop).  Under
    ``fuse_w`` every substep ends with :func:`w_step_plain` on the own
    rows, on that substep's new theta (``fast``: the cumsum form).  Same
    in-place contract as :func:`coupled_multistep`.  bf16 constant streams
    are widened on entry; under ``overlap`` the ring rows of copies of
    ``mu``, ``u`` and ``v`` take the neighbours' rows first (the caller's
    tensors are not written, and the outputs' ring rows keep the stale
    values, as the kernel's do).
    """
    del kde   # API parity
    t_1, tconst, dvdxi_const = (widen(x) for x in (t_1, tconst, dvdxi_const))
    mem = (u, v, mu)    # what the ring rows of the outputs pass through
    if overlap is not None:
        n_ring = int(n_inner)
        mu, u, v = mu.clone(), u.clone(), v.clone()
        for x, n in ((mu, "mu"), (u, "u"), (v, "v")):
            x[:n_ring] = overlap[n + "_lo"]
            x[x.shape[0] - n_ring:] = overlap[n + "_hi"]
    if fuse_w and (thomas is None or (fast and thomas.fast is None)):
        if w is None or pp is None or rdn is None:
            raise ValueError("fuse_w requires w, pp and rdn")
        thomas = thomas_vectors(rdn=rdn, rdnw=rdnw, dts=dts, epssm=epssm,
                                cw=cw, gw=gw, k0=k0, k1=k1, fast=fast)
    rdx, rdy, dts, cs2 = (_f32(x) for x in (rdx, rdy, dts, cs2))
    S = int(n_inner)
    J2, K, I = t.shape
    nc = J2 - 2 * S            # the rows the pass owns
    dev = t.device
    i0, i1, j0, j1 = (int(x) for x in window)
    j_off, i_off = (int(x) for x in offsets)
    c = slice(S, J2 - S)

    def col(x):  # (J2, I) -> (J2, 1, I), broadcasting over k
        return x[:, None, :]

    def lev(x):  # (K,) -> (1, K, 1)
        return x.view(1, K, 1)

    def sl(a, a_lo, lo, hi):   # rows [-lo, nc + hi) of an extent-a_lo array
        return a[a_lo - lo: a_lo + nc + hi]

    # ---- masks on the full ring-S row range -----------------------------
    i_glob = torch.arange(I, device=dev).view(1, 1, I) + i_off
    j_glob = torch.arange(J2, device=dev).view(J2, 1, 1) + (j_off + 1 - S)
    i_in = (i_glob >= i0) & (i_glob <= i1)
    j_in = (j_glob >= j0) & (j_glob <= j1)
    mask_f = i_in & j_in
    u_mask_f = (i_glob >= i0 + 1) & (i_glob <= i1) & j_in
    v_mask_f = i_in & (j_glob >= j0 + 1) & (j_glob <= j1)
    mask_c = mask_f[c]
    kv = torch.arange(K, device=dev).view(1, K, 1)
    upd = (kv >= k0) & (kv <= k1) & mask_c
    kint = (kv >= k0 + 1) & (kv <= k1)

    # ---- once-per-pass centre constants (theta and ww) -------------------
    t1c = t_1[c]
    t1_jp, t1_jm = t_1[S + 1: J2 - S + 1], t_1[S - 1: J2 - S - 1]
    t1_ip, t1_im = torch.roll(t1c, -1, 2), torch.roll(t1c, 1, 2)
    interp = lev(fnm) * t1c + lev(fnp) * torch.roll(t1c, 1, 1)
    msftx_c, msfty_c = col(msftx)[c], col(msfty)[c]
    inv_msfty = 1.0 / msfty_c
    mute, cu3, cv3, msft23 = col(mu_tend), col(cu), col(cv), col(msft2)
    mutend_c, w1 = mute[c], col(ww1_k0)[c]
    tcon = tconst[c]

    def ww_scan(steps, seed):
        if fast:   # log-depth masked cumsum (the TPU kernel's fast_scan)
            y = torch.where(kint, torch.roll(steps, 1, 1), 0.0)
            d = 1
            while d < K:
                y = y + torch.where(kv >= d, torch.roll(y, d, 1), 0.0)
                d *= 2
            return torch.where(upd, seed + y, 0.0)
        scan = torch.roll(steps, 1, 1)   # level k holds step(k-1)
        scan[:, k0:k0 + 1, :] = seed
        for k in range(k0 + 1, k1 + 1):
            scan[:, k, :] = scan[:, k - 1, :] + scan[:, k, :]
        return torch.where(upd, scan, 0.0)

    def theta(t_in, u_s, v_s, v_p, ww_new):
        wdtn = torch.where(kint, ww_new * interp, 0.0)
        vert = lev(rdnw) * (torch.roll(wdtn, -1, 1) - wdtn)
        fy = v_p * (t1_jp + t1c) - v_s * (t1c + t1_jm)
        fx = (torch.roll(u_s, -1, 2) * (t1_ip + t1c)
              - u_s * (t1c + t1_im))
        horiz = msftx_c * (0.5 * rdy * fy + 0.5 * rdx * fx)
        return torch.where(upd, (t_in + tcon) - (dts * msfty_c)
                           * (horiz + vert), t_in)

    # ---- S substeps, extents shrinking ------------------------------------
    mu_c, u_c, v_c = col(mu), u, v
    mu_lo = u_lo = v_lo = S        # full arrays: extent S (v's hi is S too)
    t_c, seed = t[c], col(ww_row)[c]
    if fuse_w:
        w_c, pp_c = w[c], pp[c]
        kupd = (kv >= k0) & (kv <= k1)
    for s in range(S):
        r = S - 1 - s
        p = cs2 * mu_c                                   # extent +-(r+1)
        pm = sl(p, mu_lo, r, r)
        u_n = sl(u_c, u_lo, r, r) + torch.where(
            sl(u_mask_f, S, r, r),
            sl(cu3, S, r, r) * (pm - torch.roll(pm, 1, 2)), 0.0)
        v_n = sl(v_c, v_lo, r, r + 1) + torch.where(
            sl(v_mask_f, S, r, r + 1),
            sl(cv3, S, r, r + 1)
            * (sl(p, mu_lo, r, r + 1) - sl(p, mu_lo, r + 1, r)), 0.0)
        dvdxi = sl(dvdxi_const, S, r, r) + sl(msft23, S, r, r) * (
            rdy * (v_n[1:] - v_n[:-1])
            + rdx * (torch.roll(u_n, -1, 2) - u_n))
        dmdt = torch.zeros_like(pm)   # column sum in k order, as K1's
        for k in range(k0, k1 + 1):
            dmdt = dmdt + dnw[k] * dvdxi[:, k:k + 1, :]
        mu_n = torch.where(sl(mask_f, S, r, r),
                           sl(mu_c, mu_lo, r, r)
                           + dts * (dmdt + sl(mute, S, r, r)),
                           sl(mu_c, mu_lo, r, r))

        steps = (-lev(dnw) * (sl(dmdt, r, 0, 0) + sl(dvdxi, r, 0, 0)
                              + mutend_c)) * inv_msfty
        ww_new = ww_scan(steps, seed)
        seed = torch.where(mask_c, seed - w1, seed)
        t_c = theta(t_c, sl(u_n, r, 0, 0), sl(v_n, r, 0, 0),
                    v_n[r + 1: r + 1 + nc], ww_new)
        if fuse_w:
            w_c, pp_c = w_step_plain(w_c, pp_c, t_c, thomas, lev(rdnw), kupd,
                                     kint, mask_c, k0, k1, fast=fast)
        mu_c, u_c, v_c = mu_n, u_n, v_n
        mu_lo = u_lo = v_lo = r

    t[c] = t_c
    ww_row[c] = seed[:, 0]
    u_out, v_out, mu_out = (x.clone() for x in mem)
    u_out[c], v_out[c], mu_out[c] = u_c, v_c[:nc], mu_c[:, 0]
    res = {"t": t, "mu": mu_out, "ww_row": ww_row, "u": u_out, "v": v_out}
    if fuse_w:
        w[c], pp[c] = w_c, pp_c
        res["w"], res["pp"] = w, pp
    return res


# --------------------------------------------------------------------------
# The launch plan: which form of the kernel, on which tile
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Box:
    """One staged 3-D box (``csrc/advance_mu_t_coupled_kernel.cuh``,
    ``Box``): ``rows`` rows from ``top`` rows above the tile's first own
    row, ``width`` columns from ``lo`` before its first own column, every
    level, elements of ``esize`` bytes, at byte ``off`` of shared memory."""
    top: int
    rows: int
    lo: int
    width: int
    off: int
    esize: int


def _align_up(x: int, m: int) -> int:
    return -(-x // m) * m


def staged_layout(S: int, K: int, tj: int, ti: int,
                  const_bytes: int) -> tuple[dict, int]:
    """The staged form's shared memory for a tj x ti tile at depth S, as the
    kernel's ``staged_layout`` lays it out: ``({name: Box}, bytes)``.  u, v
    and dvdxi_const cover pass 1's extent at the first substep (u one
    column east more, v one row north more), t_1 the own columns and one
    cell around them, tconst and t the own columns; then a float per level
    of pass 1's extent (dvdxi, then the ww scan), the four K-vectors and
    six 2-D planes (mu, du and dv of two substeps, msft2)."""
    boxes, off = {}, 0
    for name, top, rows, lo, hi, esize in (
            ("u", S - 1, tj + 2 * S - 2, S - 1, S, 4),
            ("v", S - 1, tj + 2 * S - 1, S - 1, S - 1, 4),
            ("dvdxi_const", S - 1, tj + 2 * S - 2, S - 1, S - 1, const_bytes),
            ("t_1", 1, tj + 2, 1, 1, const_bytes),
            ("tconst", 0, tj, 0, 0, const_bytes),
            ("t", 0, tj, 0, 0, 4)):
        m = 16 // esize
        lo_a = _align_up(lo, m)
        box = Box(top, rows, lo_a, lo_a + _align_up(ti + hi, m), off, esize)
        boxes[name] = box
        off += K * rows * box.width * esize
    off += _align_up(K * (tj + 2 * S - 2) * (ti + 2 * S - 2), 4) * 4
    off += _align_up(4 * K, 4) * 4
    return boxes, off + 6 * (tj + 2 * S) * (ti + 2 * S) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch runs: ``form`` "staged" (the tile's 3-D operands in
    shared memory for all S substeps) or "streaming" (each substep reads
    them from device memory), the block's own ``tile`` (rows, columns) and
    its dynamic shared memory in bytes."""
    form: str
    tile: tuple
    smem: int


@functools.lru_cache(maxsize=None)
def plan(S: int, K: int, fuse_w: bool, const_bytes: int, overlap: bool,
         J2: int, I: int) -> Plan:
    """The form and tile of a launch: a pure function of its shape and
    flags.  Without ``fuse_w``, the staged form on the candidate tile
    (STAGED_TJ x STAGED_TI, at least MIN_OWN own columns, within
    SMEM_LIMIT) that stages the fewest bytes per own column (the largest
    such tile on a tie); the streaming form on STREAMING_TILE where no
    candidate fits, and for every ``fuse_w`` launch (a staged form with w
    and pp in shared memory lost to it at S=2, 4 and 5 on an H100, PERF.md
    §6).  ``overlap``'s slabs and the block's size (J2, I) do not
    change what fits: the slabs are read while staging, and a tile may be
    larger than the block.  Cached: the search costs the host about a
    millisecond, as long as a launch."""
    del overlap, J2, I   # the same plan for every one of them
    best = None
    for ti in STAGED_TI:
        for tj in STAGED_TJ:
            if tj * ti < MIN_OWN:
                continue
            smem = staged_layout(S, K, tj, ti, const_bytes)[1]
            if smem > SMEM_LIMIT:
                continue
            key = (smem / (tj * ti), -tj * ti)
            if best is None or key < best[0]:
                best = (key, Plan("staged", (tj, ti), smem))
    if best is not None and not fuse_w:
        return best[1]
    tj, ti = STREAMING_TILE
    return Plan("streaming", STREAMING_TILE,
                (2 * S + 1) * (tj + 2 * S) * (ti + 2 * S) * 4)


def tiles(S: int, J2: int, I: int, tile):
    """The own columns of every block of a launch, as the kernel cuts
    them: ``(rows, columns)`` ranges, the ragged edge clipped."""
    tj, ti = tile
    for cj0 in range(S, J2 - S, tj):
        for ci0 in range(0, I, ti):
            yield (range(cj0, min(cj0 + tj, J2 - S)),
                   range(ci0, min(ci0 + ti, I)))


def staged_bytes(p: Plan, S: int, J2: int, K: int, I: int,
                 const_bytes: int) -> int:
    """Bytes the launch reads from device memory into shared memory: every
    block's boxes (the rows its tile needs, the boxes' full widths) and its
    mu plane; 0 for the streaming form, which stages no 3-D operand."""
    if p.form != "staged":
        return 0
    boxes, _ = staged_layout(S, K, *p.tile, const_bytes)
    extra = {"u": 2 * S - 2, "v": 2 * S - 1, "dvdxi_const": 2 * S - 2,
             "t_1": 2, "tconst": 0, "t": 0}
    total = 0
    for rows, cols in tiles(S, J2, I, p.tile):
        nj, ni = len(rows), len(cols)
        total += sum(K * (nj + extra[n]) * b.width * b.esize
                     for n, b in boxes.items())
        total += (nj + 2 * S) * (ni + 2 * S) * 4
    return total


# --------------------------------------------------------------------------
# The CUDA launch
# --------------------------------------------------------------------------
def _kernel():
    """The C entry of csrc/advance_mu_t_coupled.cu (library built on first
    use)."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load().wrf_tpu_torch_coupled_multistep
        fn.argtypes = ([ctypes.c_void_p] * 35 + [ctypes.c_float] * 8
                       + [ctypes.c_int] * 18 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(*, u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu,
            mu_tend, msftx, msfty, cu, cv, msft2, rdx, rdy, dts, cs2, dnw,
            fnm, fnp, rdnw, window, offsets, k0, k1, n_inner, fuse_w=False,
            w=None, pp=None, thomas=None, overlap=None):
    S = int(n_inner)
    if S > MAX_INNER:
        raise ValueError(f"n_inner={S}: the CUDA kernel is built for depths "
                         f"2..{MAX_INNER}")
    J2, K, I = t.shape
    dev = t.device
    if not (0 <= k0 <= k1 < K):
        raise ValueError(f"bad vertical bounds k0={k0}, k1={k1} for K={K}")
    fields = dict(
        u=(u, 3, True), v=(v, 3, True), t=(t, 3, True), t_1=(t_1, 3, True),
        tconst=(tconst, 3, True), dvdxi_const=(dvdxi_const, 3, True),
        ww1_k0=(ww1_k0, 2, True), ww_row=(ww_row, 2, True), mu=(mu, 2, True),
        mu_tend=(mu_tend, 2, True), msftx=(msftx, 2, True),
        msfty=(msfty, 2, True), cu=(cu, 2, True), cv=(cv, 2, True),
        msft2=(msft2, 2, True), dnw=(dnw, 1, True), fnm=(fnm, 1, True),
        fnp=(fnp, 1, True), rdnw=(rdnw, 1, True),
        w=(w, 3, fuse_w), pp=(pp, 3, fuse_w),
        **{"thomas." + n: (getattr(thomas, n, None), 1, fuse_w)
           for n in ("a", "cp", "den", "crdn", "erdn")},
    )
    th_scalars = ((thomas.c_w, thomas.g_t, thomas.beta, thomas.alfa)
                  if fuse_w else (0.0,) * 4)
    fields, const_bf16 = narrow_streams(fields, CONST_STREAMS)
    ptrs = checked_pointers(fields, {3: (J2, K, I), 2: (J2, I), 1: (K,)}, dev,
                            narrow=CONST_STREAMS if const_bf16 else ())
    # contiguous slabs of S rows each
    rows = overlap_pointers(overlap, {
        n: (S, I) if n.startswith("mu") else (S, K, I)
        for n in OVERLAP_ROWS}, dev)
    res = {"u": torch.empty_like(u), "v": torch.empty_like(v),
           "mu": torch.empty_like(mu)}
    i0, i1, j0, j1 = (int(x) for x in window)
    j_off, i_off = (int(x) for x in offsets)
    p = plan(S, K, fuse_w, 2 if const_bf16 else 4, overlap is not None,
             J2, I)
    tj, ti = p.tile
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, res["u"].data_ptr(), res["v"].data_ptr(),
                 res["mu"].data_ptr(), *rows, _f32(rdx), _f32(rdy),
                 _f32(dts), _f32(cs2), *th_scalars, J2, K, I, i0, i1, j0, j1,
                 j_off, i_off, int(k0), int(k1), S, int(fuse_w),
                 int(const_bf16), tj, ti, FORMS[p.form], p.smem, stream)
    if err != 0:
        raise RuntimeError(f"coupled_multistep kernel launch failed: CUDA "
                           f"error {err}")
    out = {"t": t, "mu": res["mu"], "ww_row": ww_row, "u": res["u"],
           "v": res["v"]}
    if fuse_w:
        out["w"], out["pp"] = w, pp
    return out
