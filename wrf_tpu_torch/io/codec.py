"""Big-endian field-per-file binary codec.

The reference stores every scalar and field as its own raw big-endian binary
file — Fortran ``ACCESS="STREAM", convert="big_endian"`` on the writer side
(advance_mu_t_driver.f90:330), manual byte-swapping readers on the C side
(advance_mu_t_driver.c:302-415).  Field files are laid out i-fastest, then k,
then j, which is exactly the C-order flattening of our ``(j, k, i)`` arrays.

This codec is that format, bidirectional, so fixtures written here are
byte-compatible with what the reference drivers consume and produce.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_BE_F32 = np.dtype(">f4")
_BE_I32 = np.dtype(">i4")


def read_int(path: str | os.PathLike) -> int:
    """Read one big-endian int32 scalar (reference ``read_dim_data``,
    advance_mu_t_driver.c:302-322)."""
    data = Path(path).read_bytes()
    return int(np.frombuffer(data[:4], dtype=_BE_I32)[0])


def write_int(path: str | os.PathLike, value: int) -> None:
    Path(path).write_bytes(np.array([value], dtype=_BE_I32).tobytes())


def read_real(path: str | os.PathLike) -> float:
    """Read one big-endian float32 scalar (reference ``read_real_data``,
    advance_mu_t_driver.c:395-415)."""
    data = Path(path).read_bytes()
    return float(np.frombuffer(data[:4], dtype=_BE_F32)[0])


def write_real(path: str | os.PathLike, value: float) -> None:
    Path(path).write_bytes(np.array([value], dtype=_BE_F32).tobytes())


def read_field(
    path: str | os.PathLike,
    shape: tuple[int, ...],
    *,
    nan_check: bool = True,
) -> np.ndarray:
    """Read a float32 field stored i-fastest/k/j into an array of ``shape``.

    ``shape`` is in array convention: ``(kdim,)`` for 1-D k-vectors,
    ``(jdim, idim)`` for 2-D, ``(jdim, kdim, idim)`` for 3-D.  The file's
    (j-outer, k, i-inner) element order is exactly C-order for these shapes.
    NaN values abort, mirroring the reference's read-time tripwire
    (advance_mu_t_driver.c:349-353).
    """
    raw = np.fromfile(path, dtype=_BE_F32)
    n = int(np.prod(shape))
    if raw.size < n:
        raise ValueError(f"{path}: expected {n} float32 values, found {raw.size}")
    out = raw[:n].astype(np.float32).reshape(shape)
    if nan_check and np.isnan(out).any():
        raise ValueError(f"{path}: field contains NaN")
    return out


def write_field(path: str | os.PathLike, data: np.ndarray) -> None:
    """Write a float32 field in the big-endian i-fastest stream format
    (reference ``write_data``, common.cu:299-327)."""
    np.ascontiguousarray(data, dtype=np.float32).astype(_BE_F32).tofile(path)


def read_flag(path: str | os.PathLike) -> bool:
    """Config flags are stored as int32 0/1 files
    (advance_mu_t_driver.c:135-137)."""
    return bool(read_int(path))


def write_flag(path: str | os.PathLike, value: bool) -> None:
    write_int(path, int(bool(value)))


def swap_field_4d(arr: np.ndarray) -> np.ndarray:
    """Swap the two outer axes of a 4-D field — the reference's
    ``swap_data_4d`` layout reorder between its "ikjm" and "ikmj" memory
    orders (common.cu:330-342), which in this framework's C-order view is
    ``(s, j, k, i) <-> (j, s, k, i)``.  Involution."""
    if arr.ndim != 4:
        raise ValueError(f"expected 4-D array, got ndim={arr.ndim}")
    return np.ascontiguousarray(np.swapaxes(arr, 0, 1))


def read_field_4d(
    path: str | os.PathLike,
    shape4: tuple[int, int, int, int],
    *,
    layout: str = "sjki",
    nan_check: bool = True,
) -> np.ndarray:
    """Read a 4-D field (e.g. moisture species) stored i-fastest/k/j/s
    (the reference's ``read_data_4d`` stream order, common.cu:10-48).

    ``shape4`` is ``(sdim, jdim, kdim, idim)``.  ``layout="sjki"`` returns
    the natural C-order array; ``"jski"`` returns the reference's swapped
    "ikmj" in-memory order (species inside j)."""
    if layout not in ("sjki", "jski"):
        raise ValueError(f"bad layout {layout!r}")
    arr = read_field(path, shape4, nan_check=nan_check)
    return arr if layout == "sjki" else swap_field_4d(arr)
