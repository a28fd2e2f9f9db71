"""K2: S temporally-blocked mu/t scan substeps, on the GPU and in plain PyTorch.

The port of ``wrf_tpu/ops/advance_mu_t_msteps.py`` (kernel ``_kernel``,
wrapper ``advance_mu_t_multistep_pallas``).  :func:`advance_mu_t_multistep`
keeps that wrapper's keyword contract and result dict: ``n_inner`` lean/lite
scan substeps of the mu/t loop in one pass, each K1's lean/lite substep
(:func:`~wrf_tpu_torch.ops.advance_mu_t_cuda.advance_mu_t_fused`, no
``fuse_uv``) with the winds scaled by ``ws(s) = 1 + (wind_step0 + s) *
wind_scale_step``.  Two modes:

* exact — S sequential substeps; equal bit for bit to S K1 calls with
  ``wind_scale=ws(s)``;
* ``fast`` — the TPU kernel's closed form: the substep is affine in
  ``(1, s, ws)``, so the S theta increments sum to
  ``S*G0 + S(S-1)/2*G1 + sum(ws)*G2``.  Re-associated, held to a tolerance.

Dispatch is by the device of the tensors: CUDA tensors launch the
hand-written kernel (``csrc/advance_mu_t_msteps.cu``) and count one in
:data:`LAUNCHES`; CPU tensors run :func:`advance_mu_t_multistep_plain`.
There is no fallback from one to the other.

bf16 constant streams: ``u``, ``v``, ``t_1``, ``tconst`` and
``dvdxi_const`` may arrive as ``torch.bfloat16`` and are widened to float32
on load; ``t`` (state) may not.  When all five are bf16 the kernel reads
them narrow; a mixed set is widened before the launch (exact).

Buffers: ``t``, ``mu`` and ``ww_row`` are read only at their own column,
so both versions update them IN PLACE and return them (the TPU kernel
aliases the same three); the dispatcher raises their ``_version`` after
the launch, as K1's does.  None of the three may overlap an operand the
launch only reads (the wrapper raises, on either device, before any
launch): the kernel loads a level's operands before it stores t at the
levels below, and reads the neighbour columns of the read-only fields.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .advance_mu_t_cuda import (
    _f32, check_const_streams, check_no_alias, checked_pointers,
    mark_in_place, narrow_streams, widen,
)

#: CUDA kernel launches since import (one per launch, and only there)
LAUNCHES = 0

#: the 3-D operands that may arrive as bf16
CONST_STREAMS = ("u", "v", "t_1", "tconst", "dvdxi_const")

#: the operands a launch updates in place; it only reads the others
WRITTEN = ("t", "mu", "ww_row")

_kernel_fn = None


def wind_ramp(wind_step0, wind_scale_step, s: int) -> float:
    """ws(s) = 1 + (wind_step0 + s) * wind_scale_step in float32, in the TPU
    kernel's association (``msteps.py:582``): ``wind_step0 + s`` is an
    exact integer, so ws(s) is the loop's scale at substep
    ``wind_step0 + s`` for any block index."""
    f = np.float32
    return float(f(1.0) + (f(wind_step0) + f(s)) * f(wind_scale_step))


def _check(tensors: dict, n_inner):
    if n_inner < 1:
        raise ValueError("n_inner must be >= 1")
    check_const_streams(tensors, CONST_STREAMS)


def advance_mu_t_multistep(
    *,
    u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row,
    mu, mu_tend, msftx, msfty,
    rdx, rdy, dts, epssm,
    dnw, fnm, fnp, rdnw,
    window, offsets=(0, 0),
    k0: int, k1: int, kde: int,
    n_inner: int = 2,
    wind_step0=0.0, wind_scale_step=0.0,
    fast: bool = False,
):
    """``n_inner`` lean/lite scan substeps in one pass; the contract of
    ``advance_mu_t_multistep_pallas``.

    Arrays: 3-D ``(J, K, I)``, 2-D ``(J, I)``, vertical ``(K,)``, float32
    tensors on one device; rows 0 and J-1 are never computed.  The lean
    constants come from :func:`~wrf_tpu_torch.ops.advance_mu_t_cuda.lean_kwargs`.
    Returns ``{"t", "mu", "ww_row"}`` — the state the loop carries — updated
    in place.
    """
    del epssm, kde   # unused by the scan substep; kept for API parity
    _check(dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst,
                dvdxi_const=dvdxi_const), n_inner)
    kw = dict(u=u, v=v, t=t, t_1=t_1, tconst=tconst, dvdxi_const=dvdxi_const,
              ww1_k0=ww1_k0, ww_row=ww_row, mu=mu, mu_tend=mu_tend,
              msftx=msftx, msfty=msfty, rdx=rdx, rdy=rdy, dts=dts, dnw=dnw,
              fnm=fnm, fnp=fnp, rdnw=rdnw, window=window, offsets=offsets,
              k0=k0, k1=k1, n_inner=n_inner, wind_step0=wind_step0,
              wind_scale_step=wind_scale_step, fast=fast)
    check_no_alias(written={n: kw[n] for n in WRITTEN},
                   read={n: x for n, x in kw.items()
                         if isinstance(x, torch.Tensor) and n not in WRITTEN})
    if t.device.type == "cpu":
        res = advance_mu_t_multistep_plain(**kw)
    elif t.device.type == "cuda":
        res = _launch(**kw)
    else:
        raise ValueError(f"advance_mu_t_multistep: unsupported device "
                         f"{t.device}")
    mark_in_place(kw[n] for n in WRITTEN)
    return res


def advance_mu_t_multistep_plain(
    *, u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu, mu_tend,
    msftx, msfty, rdx, rdy, dts, dnw, fnm, fnp, rdnw, window, k0: int,
    k1: int, offsets=(0, 0), n_inner: int = 2, wind_step0=0.0,
    wind_scale_step=0.0, fast: bool = False, epssm=None, kde=None,
):
    """Whole-array PyTorch version of the kernel, on any device.

    A transcription of the TPU kernel's two modes: the invariants (t_1's
    neighbours and vertical interpolant, the 2-D coefficients) are formed
    once, then exact mode runs the S substeps with the K1 plain version's
    operations in its order (``torch.roll`` neighbours, the dmdt column sum
    and the ww scan as k loops), and fast mode the closed form with the two
    masked ww cumsums as sequential k loops (the TPU kernel's log-depth
    form is a re-association of the same sums).  Same in-place contract as
    :func:`advance_mu_t_multistep`.  bf16 constant streams are widened on
    entry.
    """
    del epssm, kde   # API parity
    u, v, t_1, tconst, dvdxi_const = (
        widen(x) for x in (u, v, t_1, tconst, dvdxi_const))
    rdx, rdy, dts = _f32(rdx), _f32(rdy), _f32(dts)
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
    mask = ((i_glob >= i0) & (i_glob <= i1) & (j_glob >= j0) & (j_glob <= j1)
            & (j_loc >= 1) & (j_loc <= J - 2))      # edge rows pass through
    kv = torch.arange(K, device=dev).view(1, K, 1)
    upd = (kv >= k0) & (kv <= k1) & mask
    kint = (kv >= k0 + 1) & (kv <= k1)

    # ---- once-per-pass invariants -------------------------------------
    msftx3, msfty3 = col(msftx), col(msfty)
    msft2 = msftx3 * msfty3
    inv_msfty = 1.0 / msfty3
    mt, w1 = col(mu_tend), col(ww1_k0)
    t1_jp, t1_jm = torch.roll(t_1, -1, 0), torch.roll(t_1, 1, 0)
    t1_ip, t1_im = torch.roll(t_1, -1, 2), torch.roll(t_1, 1, 2)
    interp = lev(fnm) * t_1 + lev(fnp) * torch.roll(t_1, 1, 1)
    dm = dts * msfty3

    def column_sum(x):   # in k order, as the oracle and the CUDA kernels
        s = torch.zeros_like(mt)
        for k in range(k0, k1 + 1):
            s = s + dnw[k] * x[:, k:k + 1, :]
        return s

    def horizontal(u_s, v_s):
        fy = torch.roll(v_s, -1, 0) * (t1_jp + t_1) - v_s * (t_1 + t1_jm)
        fx = torch.roll(u_s, -1, 2) * (t1_ip + t_1) - u_s * (t_1 + t1_im)
        return msftx3 * (0.5 * rdy * fy + 0.5 * rdx * fx)

    def vertical_diff(x):
        return lev(rdnw) * (torch.roll(x, -1, 1) - x)

    t_st, mu_st, seed = t, col(mu), col(ww_row)
    if fast:
        v_p = torch.roll(v, -1, 0)
        dyn = msft2 * (rdy * (v_p - v) + rdx * (torch.roll(u, -1, 2) - u))
        dmdt_c, dmdt_d = column_sum(dvdxi_const), column_sum(dyn)

        def kcumsum(steps):   # y(k) = sum_{k0 <= m < k} steps(m) on kint
            y = torch.where(kint, torch.roll(steps, 1, 1), 0.0)
            for k in range(k0 + 1, k1 + 1):
                y[:, k] = y[:, k - 1] + y[:, k]
            return y

        y_c = kcumsum((-lev(dnw) * (dmdt_c + dvdxi_const + mt)) * inv_msfty)
        y_d = kcumsum((-lev(dnw) * (dmdt_d + dyn)) * inv_msfty)
        ic = torch.where(kint & upd, interp, 0.0)
        g0 = tconst - dm * vertical_diff(ic * (seed + y_c))
        g1 = -(dm * vertical_diff(-(ic * w1)))
        g2 = -(dm * (horizontal(u, v) + vertical_diff(ic * y_d)))
        f = np.float32
        sn, ss = f(n_inner), f(n_inner * (n_inner - 1) // 2)
        sws = sn + (sn * f(wind_step0) + ss) * f(wind_scale_step)
        sn, ss, sws = float(sn), float(ss), float(sws)
        t_st = torch.where(upd, t_st + (sn * g0 + ss * g1 + sws * g2), t_st)
        mu_st = torch.where(
            mask, mu_st + dts * (sn * (dmdt_c + mt) + sws * dmdt_d), mu_st)
        seed = torch.where(mask, seed - sn * w1, seed)
    else:
        for s in range(n_inner):
            ws = wind_ramp(wind_step0, wind_scale_step, s)
            u_s, v_s = u * ws, v * ws
            dvdxi = dvdxi_const + msft2 * (
                rdy * (torch.roll(v_s, -1, 0) - v_s)
                + rdx * (torch.roll(u_s, -1, 2) - u_s))
            dmdt = column_sum(dvdxi)
            mu_st = torch.where(mask, mu_st + dts * (dmdt + mt), mu_st)

            # ww scan, k ascending from the seed; level k holds step(k-1)
            scan = torch.roll((-lev(dnw) * (dmdt + dvdxi + mt)) * inv_msfty,
                              1, 1)
            scan[:, k0:k0 + 1, :] = seed
            for k in range(k0 + 1, k1 + 1):
                scan[:, k, :] = scan[:, k - 1, :] + scan[:, k, :]
            ww_new = torch.where(upd, scan, 0.0)
            seed = torch.where(mask, seed - w1, seed)

            wdtn = torch.where(kint, ww_new * interp, 0.0)
            t_new = (t_st + tconst) - dm * (horizontal(u_s, v_s)
                                            + vertical_diff(wdtn))
            t_st = torch.where(upd, t_new, t_st)

    return {"t": t.copy_(t_st), "mu": mu.copy_(mu_st[:, 0]),
            "ww_row": ww_row.copy_(seed[:, 0])}


# --------------------------------------------------------------------------
# The CUDA launch
# --------------------------------------------------------------------------
def _kernel():
    """The C entry of csrc/advance_mu_t_msteps.cu (library built on first
    use)."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load().wrf_tpu_torch_advance_mu_t_msteps
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_float] * 5
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _launch(*, u, v, t, t_1, tconst, dvdxi_const, ww1_k0, ww_row, mu,
            mu_tend, msftx, msfty, rdx, rdy, dts, dnw, fnm, fnp, rdnw,
            window, offsets, k0, k1, n_inner, wind_step0, wind_scale_step,
            fast):
    global LAUNCHES
    J, K, I = t.shape
    dev = t.device
    if not (0 <= k0 <= k1 < K):
        raise ValueError(f"bad vertical bounds k0={k0}, k1={k1} for K={K}")
    if J < 3:
        raise ValueError(f"J={J}: no row between the two edge rows")
    fields = dict(
        u=(u, 3, True), v=(v, 3, True), t=(t, 3, True), t_1=(t_1, 3, True),
        tconst=(tconst, 3, True), dvdxi_const=(dvdxi_const, 3, True),
        ww1_k0=(ww1_k0, 2, True), ww_row=(ww_row, 2, True), mu=(mu, 2, True),
        mu_tend=(mu_tend, 2, True), msftx=(msftx, 2, True),
        msfty=(msfty, 2, True), dnw=(dnw, 1, True), fnm=(fnm, 1, True),
        fnp=(fnp, 1, True), rdnw=(rdnw, 1, True),
    )
    fields, const_bf16 = narrow_streams(fields, CONST_STREAMS)
    ptrs = checked_pointers(fields, {3: (J, K, I), 2: (J, I), 1: (K,)}, dev,
                            narrow=CONST_STREAMS if const_bf16 else ())
    i0, i1, j0, j1 = (int(x) for x in window)
    j_off, i_off = (int(x) for x in offsets)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, _f32(rdx), _f32(rdy), _f32(dts), _f32(wind_step0),
                 _f32(wind_scale_step), J, K, I, i0, i1, j0, j1, j_off,
                 i_off, int(k0), int(k1), int(n_inner), int(fast),
                 int(const_bf16), stream)
    if err != 0:
        raise RuntimeError(f"advance_mu_t_msteps kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return {"t": t, "mu": mu, "ww_row": ww_row}
