"""Fixture minting without jax.

``wrf_tpu.io.fixtures.make_case`` is numpy except for one helper,
``rdn_from_dnw``, which it imports from ``wrf_tpu.ops.advance_w`` — a module
that imports jax at top.  :func:`make_case` here runs that same function
with the module name bound, for the duration of the call only, to a
stand-in that holds the numpy helper alone, so the port can mint the very
same fixtures where jax is absent.  Reading and writing fixture
directories (``read_case``, ``write_case``, ``read_golden``) is jax-free
already and is used from ``wrf_tpu.io.fixtures`` directly.
"""

from __future__ import annotations

import sys
import types

import numpy as np

import wrf_tpu.ops  # noqa: F401  (parent package of the stand-in; jax-free)
from wrf_tpu.io import fixtures as _fixtures

F32 = np.float32

_ADVANCE_W = "wrf_tpu.ops.advance_w"


def rdn_from_dnw(dnw: np.ndarray) -> np.ndarray:
    """Interface spacing reciprocals: dn(k) = 0.5*(dnw(k) + dnw(k-1)),
    rdn(k) = 1/dn(k), zero at k=0 (``wrf_tpu.ops.advance_w.rdn_from_dnw``)."""
    dnw = np.asarray(dnw, F32)
    rdn = np.zeros_like(dnw)
    dn = F32(0.5) * (dnw[1:] + dnw[:-1])
    nz = np.nonzero(dn)[0]
    rdn[1:][nz] = (F32(1.0) / dn[nz]).astype(F32)
    return rdn


def make_case(*args, **kwargs) -> _fixtures.Case:
    """``wrf_tpu.io.fixtures.make_case`` (same arguments, same arrays),
    without importing jax."""
    stand_in = types.ModuleType(_ADVANCE_W)
    stand_in.rdn_from_dnw = rdn_from_dnw
    saved = sys.modules.get(_ADVANCE_W)
    sys.modules[_ADVANCE_W] = stand_in
    try:
        return _fixtures.make_case(*args, **kwargs)
    finally:
        if saved is None:
            del sys.modules[_ADVANCE_W]
        else:
            sys.modules[_ADVANCE_W] = saved
