"""Ring-S halos for the depth-S coupled trapezoid, on one device.

Port of the unsharded branch of ``wrf_tpu/parallel/halo.py::widen_ring_to``
and of its inverse, the ``strip3``/``strip2`` of
``wrf_tpu/models/small_step.py``.  S coupled substeps advance information
S cells, so the blocked loop reads mu S rows deep and u/v S-1 rows deep
around each row it updates; on one device the extra ring cells lie outside
the compute window and are zeros (mask-protected).  Only the j axis is
widened: on the 1x1 layout i keeps its ring-1 layout and wraps.  The
port's blocks carry no alignment rows after the ring, so the layout is
``[lo_S..lo1, interior, hi1..hi_S]``.
"""

from __future__ import annotations

import torch


def widen_ring_to(x: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    """Grow a ring-1-padded block to ring-``width`` along ``axis``: ``width-1``
    zero cells on each side.  Returns a new tensor (``x`` itself when
    ``width < 2``)."""
    if width < 2:
        return x
    zshape = list(x.shape)
    zshape[axis] = width - 1
    zeros = x.new_zeros(zshape)
    return torch.cat([zeros, x, zeros], dim=axis)


def strip_ring(x: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    """Inverse of :func:`widen_ring_to`: the ring-1 block, as a view."""
    if width < 2:
        return x
    return x.narrow(axis, width - 1, x.shape[axis] - 2 * (width - 1))
