"""ctypes bindings for the native (C++) tier.

The native library is the framework's compiled scalar oracle — the role the
C99 port plays in the reference (advance_mu_t.c).  It is built on demand
with ``g++`` from the sources in this directory into the package's
git-ignored ``_build/`` directory (beside the CUDA kernel library, see
``_build.py``), named by a hash of the sources and flags; the binding
exposes the kernel and the comparator suite with numpy-array ergonomics.
The CLI verification driver (``driver.cc``: fixture -> N steps -> timing
line -> per-field report) is built the same way into an executable,
:func:`build_driver`.  A missing compiler raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR
from ..grid import ConfigFlags, GridBounds

_DIR = Path(__file__).resolve().parent

#: -ffp-contract=off disables FMA contraction so the oracle's arithmetic is
#: bit-comparable with the other tiers (the reference's -fmad=false policy)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-ffp-contract=off")
LIB_SRCS = ("advance_mu_t.cc", "advance_uv.cc", "advance_w.cc", "compare.cc",
            "codec.cc")
DRIVER_SRCS = ("driver.cc",)
_HEADERS = ("wrf_tpu_native.h", "codec.h")
_lib = None


class _Window(ctypes.Structure):
    _fields_ = [
        ("jdim", ctypes.c_int32),
        ("kdim", ctypes.c_int32),
        ("idim", ctypes.c_int32),
        ("i0", ctypes.c_int32),
        ("i1", ctypes.c_int32),
        ("j0", ctypes.c_int32),
        ("j1", ctypes.c_int32),
        ("k0", ctypes.c_int32),
        ("k1", ctypes.c_int32),
        ("kde", ctypes.c_int32),
    ]


class _CompareResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("equal", ctypes.c_int64),
        ("different", ctypes.c_int64),
        ("max_rel_err", ctypes.c_float),
        ("max_abs_err", ctypes.c_float),
        ("max_ulp", ctypes.c_int64),
        ("rmse", ctypes.c_double),
        ("nan_seen", ctypes.c_int64),
    ]


def _hashed(sources: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in sources + _HEADERS:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the oracle library for the current sources and flags lives."""
    return BUILD_DIR / f"libwrf_tpu_torch_native_{_hashed(LIB_SRCS)}.so"


def driver_path() -> Path:
    """Where the CLI driver executable for the current sources lives."""
    digest = _hashed(DRIVER_SRCS + LIB_SRCS)
    return BUILD_DIR / f"wrf_tpu_torch_driver_{digest}"


def build(force: bool = False) -> Path:
    """Build the native library with ``$CXX`` (default ``g++``) unless the
    library for these sources exists."""
    return _compile(library_path(), LIB_SRCS, ("-shared",), force)


def build_driver(force: bool = False) -> Path:
    """Build the CLI verification driver (``wrf_tpu_torch_driver FIXTURE
    [steps]``: the oracle's advance_mu_t for N steps, a timing line, then
    every output field against the fixture's goldens) unless the executable
    for these sources exists; returns its path."""
    return _compile(driver_path(), DRIVER_SRCS + LIB_SRCS, (), force)


def _compile(out: Path, sources: tuple[str, ...], link_flags: tuple[str, ...],
             force: bool) -> Path:
    if out.exists() and not force:
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler found (g++ on PATH, or set CXX): the native "
            "oracle is built from wrf_tpu_torch/native at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *link_flags, "-o", str(tmp),
           *(str(_DIR / name) for name in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
        fp = ctypes.POINTER(ctypes.c_float)
        _lib.wrf_advance_mu_t.restype = ctypes.c_int32
        _lib.wrf_advance_mu_t.argtypes = (
            [ctypes.POINTER(_Window)]
            + [fp] * 18
            + [ctypes.c_float] * 4
            + [fp] * 8
        )
        _lib.wrf_advance_mu_t_capture.restype = ctypes.c_int32
        _lib.wrf_advance_mu_t_capture.argtypes = (
            [ctypes.POINTER(_Window)]
            + [fp] * 18
            + [ctypes.c_float] * 4
            + [fp] * 8
            + [fp] * 5
        )
        _lib.wrf_advance_uv.restype = ctypes.c_int32
        _lib.wrf_advance_uv.argtypes = (
            [ctypes.POINTER(_Window)] + [fp] * 7 + [ctypes.c_float] * 4
            + [fp, ctypes.c_float]
        )
        _lib.wrf_advance_w.restype = ctypes.c_int32
        _lib.wrf_advance_w.argtypes = (
            [ctypes.POINTER(_Window)] + [fp] * 5 + [ctypes.c_float] * 4
        )
        _lib.wrf_swap_4d.restype = None
        _lib.wrf_swap_4d.argtypes = [fp, fp] + [ctypes.c_int64] * 4
        _lib.wrf_compare.restype = None
        _lib.wrf_compare.argtypes = [fp, fp, ctypes.c_int64,
                                     ctypes.POINTER(_CompareResult)]
        _lib.wrf_float_ulps.restype = ctypes.c_int64
        _lib.wrf_float_ulps.argtypes = [ctypes.c_float, ctypes.c_float]
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _c_contig_f32(a: np.ndarray, name: str, writable: bool = False) -> np.ndarray:
    out = np.ascontiguousarray(a, dtype=np.float32)
    if writable and out is a:
        out = out.copy()
    return out


def advance_mu_t_native(
    *,
    ww: np.ndarray,
    ww_1: np.ndarray,
    u: np.ndarray,
    u_1: np.ndarray,
    v: np.ndarray,
    v_1: np.ndarray,
    mu: np.ndarray,
    mut: np.ndarray,
    muu: np.ndarray,
    muv: np.ndarray,
    t: np.ndarray,
    t_1: np.ndarray,
    t_ave: np.ndarray,
    ft: np.ndarray,
    mu_tend: np.ndarray,
    rdx: float,
    rdy: float,
    dts: float,
    epssm: float,
    dnw: np.ndarray,
    fnm: np.ndarray,
    fnp: np.ndarray,
    rdnw: np.ndarray,
    msfuy: np.ndarray,
    msfvx_inv: np.ndarray,
    msftx: np.ndarray,
    msfty: np.ndarray,
    flags: ConfigFlags,
    bounds: GridBounds,
    capture_intermediates: bool = False,
) -> dict[str, np.ndarray]:
    """Run the native scalar kernel; same contract as
    :func:`wrf_tpu_torch.ops.reference_numpy.advance_mu_t_numpy` (functional —
    inputs are not mutated).  With ``capture_intermediates`` the result
    additionally carries the five ``*_before_theta`` phase-boundary
    snapshots (reference: module_small_step_em.f90:175-189)."""
    lib = _get_lib()
    i0, i1, j0, j1, k0, k1 = bounds.loop_bounds(flags)
    w = _Window(
        jdim=bounds.jdim, kdim=bounds.kdim, idim=bounds.idim,
        i0=i0, i1=i1, j0=j0, j1=j1, k0=k0, k1=k1,
        kde=bounds.mem(bounds.kde, "k"),
    )

    ww_o = _c_contig_f32(ww, "ww", writable=True)
    mu_o = _c_contig_f32(mu, "mu", writable=True)
    t_o = _c_contig_f32(t, "t", writable=True)
    t_ave_o = _c_contig_f32(t_ave, "t_ave", writable=True)
    muave_o = np.zeros_like(mu_o)
    muts_o = np.zeros_like(mu_o)
    mudf_o = np.zeros_like(mu_o)

    ins = {
        name: _c_contig_f32(arr, name)
        for name, arr in dict(
            ww_1=ww_1, u=u, u_1=u_1, v=v, v_1=v_1, mut=mut, muu=muu, muv=muv,
            t_1=t_1, ft=ft, mu_tend=mu_tend, dnw=dnw, fnm=fnm, fnp=fnp,
            rdnw=rdnw, msfuy=msfuy, msfvx_inv=msfvx_inv, msftx=msftx,
            msfty=msfty,
        ).items()
    }

    args = (
        ctypes.byref(w),
        _fp(ww_o), _fp(ins["ww_1"]), _fp(ins["u"]), _fp(ins["u_1"]),
        _fp(ins["v"]), _fp(ins["v_1"]),
        _fp(mu_o), _fp(ins["mut"]), _fp(muave_o), _fp(muts_o),
        _fp(ins["muu"]), _fp(ins["muv"]),
        _fp(mudf_o), _fp(t_o), _fp(ins["t_1"]),
        _fp(t_ave_o), _fp(ins["ft"]), _fp(ins["mu_tend"]),
        ctypes.c_float(rdx), ctypes.c_float(rdy),
        ctypes.c_float(dts), ctypes.c_float(epssm),
        _fp(ins["dnw"]), _fp(ins["fnm"]), _fp(ins["fnp"]), _fp(ins["rdnw"]),
        _fp(ins["msfuy"]), _fp(ins["msfvx_inv"]),
        _fp(ins["msftx"]), _fp(ins["msfty"]),
    )
    if capture_intermediates:
        caps = {name: np.zeros_like(mu_o) for name in
                ("muave_before_theta", "mu_before_theta",
                 "mudf_before_theta", "muts_before_theta")}
        caps["ww_before_theta"] = np.zeros_like(ww_o)
        rc = lib.wrf_advance_mu_t_capture(
            *args, *(_fp(caps[n]) for n in
                     ("muave_before_theta", "mu_before_theta",
                      "mudf_before_theta", "muts_before_theta",
                      "ww_before_theta")))
    else:
        caps = {}
        rc = lib.wrf_advance_mu_t(*args)
    if rc != 0:
        raise RuntimeError(f"wrf_advance_mu_t failed with rc={rc}")
    return {
        "ww": ww_o, "mu": mu_o, "muave": muave_o, "muts": muts_o,
        "mudf": mudf_o, "t": t_o, "t_ave": t_ave_o, **caps,
    }


def advance_uv_native(
    *,
    u: np.ndarray,
    v: np.ndarray,
    mu: np.ndarray,
    muu: np.ndarray,
    muv: np.ndarray,
    msfuy: np.ndarray,
    msfvx_inv: np.ndarray,
    rdx: float,
    rdy: float,
    dts: float,
    cs2: float,
    flags: ConfigFlags,
    bounds: GridBounds,
    mudf: np.ndarray | None = None,
    smdiv: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Native wind substep; same contract as
    :func:`wrf_tpu_torch.ops.advance_uv.advance_uv_numpy` (functional)."""
    lib = _get_lib()
    i0, i1, j0, j1, k0, k1 = bounds.loop_bounds(flags)
    w = _Window(
        jdim=bounds.jdim, kdim=bounds.kdim, idim=bounds.idim,
        i0=i0, i1=i1, j0=j0, j1=j1, k0=k0, k1=k1,
        kde=bounds.mem(bounds.kde, "k"),
    )
    u_o = _c_contig_f32(u, "u", writable=True)
    v_o = _c_contig_f32(v, "v", writable=True)
    ins = {name: _c_contig_f32(arr, name) for name, arr in dict(
        mu=mu, muu=muu, muv=muv, msfuy=msfuy, msfvx_inv=msfvx_inv).items()}
    mudf_c = None
    if mudf is not None and smdiv:
        mudf_c = _c_contig_f32(mudf, "mudf")
    rc = lib.wrf_advance_uv(
        ctypes.byref(w), _fp(u_o), _fp(v_o),
        _fp(ins["mu"]), _fp(ins["muu"]), _fp(ins["muv"]),
        _fp(ins["msfuy"]), _fp(ins["msfvx_inv"]),
        ctypes.c_float(rdx), ctypes.c_float(rdy),
        ctypes.c_float(dts), ctypes.c_float(cs2),
        _fp(mudf_c) if mudf_c is not None else None,
        ctypes.c_float(smdiv),
    )
    if rc != 0:
        raise RuntimeError(f"wrf_advance_uv failed with rc={rc}")
    return u_o, v_o


def advance_w_native(
    *,
    w: np.ndarray,
    pp: np.ndarray,
    t: np.ndarray,
    rdn: np.ndarray,
    rdnw: np.ndarray,
    dts: float,
    epssm: float,
    cw: float,
    gw: float,
    flags: ConfigFlags,
    bounds: GridBounds,
) -> tuple[np.ndarray, np.ndarray]:
    """Native vertically-implicit w/pp substep; same contract as
    :func:`wrf_tpu_torch.ops.advance_w.advance_w_numpy` (functional)."""
    lib = _get_lib()
    i0, i1, j0, j1, k0, k1 = bounds.loop_bounds(flags)
    win = _Window(
        jdim=bounds.jdim, kdim=bounds.kdim, idim=bounds.idim,
        i0=i0, i1=i1, j0=j0, j1=j1, k0=k0, k1=k1,
        kde=bounds.mem(bounds.kde, "k"),
    )
    w_o = _c_contig_f32(w, "w", writable=True)
    pp_o = _c_contig_f32(pp, "pp", writable=True)
    ins = {name: _c_contig_f32(arr, name) for name, arr in dict(
        t=t, rdn=rdn, rdnw=rdnw).items()}
    rc = lib.wrf_advance_w(
        ctypes.byref(win), _fp(w_o), _fp(pp_o),
        _fp(ins["t"]), _fp(ins["rdn"]), _fp(ins["rdnw"]),
        ctypes.c_float(dts), ctypes.c_float(epssm),
        ctypes.c_float(cw), ctypes.c_float(gw),
    )
    if rc != 0:
        raise RuntimeError(f"wrf_advance_w failed with rc={rc}")
    return w_o, pp_o


def swap_4d_native(arr: np.ndarray) -> np.ndarray:
    """Native 4-D layout reorder ``(j, m, k, i) -> (m, j, k, i)`` — the
    reference's ``swap_data_4d`` (common.cu:330-342); cross-checked
    against :func:`wrf_tpu_torch.io.codec.swap_field_4d`."""
    lib = _get_lib()
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if a.ndim != 4:
        raise ValueError(f"expected 4-D array, got ndim={a.ndim}")
    jdim, mdim, kdim, idim = a.shape
    out = np.empty((mdim, jdim, kdim, idim), np.float32)
    lib.wrf_swap_4d(_fp(a), _fp(out), idim, kdim, jdim, mdim)
    return out


@dataclasses.dataclass(frozen=True)
class NativeCompare:
    n: int
    equal: int
    different: int
    max_rel_err: float
    max_abs_err: float
    max_ulp: int
    rmse: float
    nan_seen: int


def compare_native(actual: np.ndarray, golden: np.ndarray) -> NativeCompare:
    """Run the native comparator suite (used to cross-check the Python one)."""
    lib = _get_lib()
    a = np.ascontiguousarray(actual, dtype=np.float32).ravel()
    g = np.ascontiguousarray(golden, dtype=np.float32).ravel()
    if a.size != g.size:
        raise ValueError("size mismatch")
    res = _CompareResult()
    lib.wrf_compare(_fp(a), _fp(g), a.size, ctypes.byref(res))
    return NativeCompare(
        n=res.n, equal=res.equal, different=res.different,
        max_rel_err=res.max_rel_err, max_abs_err=res.max_abs_err,
        max_ulp=res.max_ulp, rmse=res.rmse, nan_seen=res.nan_seen,
    )
