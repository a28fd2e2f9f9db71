"""Halo exchange between the shards of a mesh: the ``ppermute`` backend.

Port of ``wrf_tpu/parallel/halo.py`` (``exchange_axis`` ... ``halo2``).
The reference stages 3-row j halos through the host once per kernel
launch; here the 1-cell halo the stencil needs (its reads are +-1 in i and
j) moves directly between neighbouring shards' blocks.  Wrap-around rows
that land on global-domain edges carry garbage and are excluded by the
compute-window masks: every shard runs the identical program.

Where the JAX functions run *inside* ``shard_map`` on one local block and
exchange with ``lax.ppermute``, these take **all the blocks of a field**,
a dict keyed by the shard's ``(jj, ii)`` (``parallel/sharded.py::scatter``),
and the :class:`~wrf_tpu_torch.parallel.mesh.Mesh`; the exchange is plain
slicing and ``Tensor.copy_`` between blocks (a library copy, as the JAX
form is an XLA collective outside any kernel).  The hand-written exchange
kernel is the ``rdma`` backend, ``ops/halo_rdma_cuda.py``.

The constructors (``exchange_axis``, ``with_halo``, ``widen_ring_to``)
return new blocks.  The refreshes (``refresh_axis``, ``refresh_axis_w``)
update the halo cells of the given blocks IN PLACE and return them: every
send reads owned cells and every receive writes halo cells, so no order of
the copies changes a result.

On a mesh that spans processes (``parallel/distributed.py``) the dicts hold
this process's shards only.  A neighbour on the same process is read as
above; one on another rank arrives through ``torch.distributed``
point-to-point messages, one ``batch_isend_irecv`` per exchange call
(:func:`neighbour_slabs`), in an order every rank derives alike: shards
j-major, then the slab to the next neighbour before the slab to the
previous one.  On a ring of two both neighbours are the same remote rank,
and the two messages stay apart by their tags.

Ring-S halos serve the depth-S coupled trapezoid: S coupled substeps
advance information S cells, so the blocked loop reads mu S rows deep and
u/v S-1 rows deep around each row it updates, exchanged 1/S as often at S
times the width.  The port's blocks carry no alignment rows after the
ring, so the layout is ``[lo_S..lo1, interior, hi1..hi_S]``.

Every exchange counts what it moves in :data:`SENT`: a plain count, kept
for ``tools/scaling_report.py``, which reads it around a loop's call; no
exchange times itself, and no loop reads the count.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from . import distributed

#: what the exchanges of this process moved since import, by the function
#: that moved it and the mesh axis (``"exchange_axis j"``,
#: ``"refresh_axis_w i"``, ``"widen_ring_to j"`` here; ``"rdma j"`` for
#: K5, ``ops/halo_rdma_cuda.py``): ``(kind, "messages")`` counts one slab
#: that one shard receives from one neighbour, ``(kind, "bytes")`` its
#: bytes, summed over this process's shards.  Read it as a difference
#: around a call.
SENT: collections.Counter = collections.Counter()


def count_sent(kind: str, messages: int, nbytes: int) -> None:
    """Add one exchange's messages and bytes to :data:`SENT`."""
    SENT[kind, "messages"] += messages
    SENT[kind, "bytes"] += nbytes


def _n_int(x: torch.Tensor, axis: int, n_interior, ring: int = 1) -> int:
    return x.shape[axis] - 2 * ring if n_interior is None else n_interior


def _recv(src: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``src`` on ``like``'s device (itself when already there)."""
    return src.to(like.device, non_blocking=True)


def neighbour_slabs(blocks: dict, mesh, axis_name: str, to_next,
                    to_prev, kind: str) -> dict:
    """``{c: (from_prev, from_next)}`` for every shard ``c`` of ``blocks``:
    ``to_next(b)`` is the slab a shard's block ``b`` gives its next
    neighbour along ``axis_name`` and ``to_prev(b)`` the one it gives its
    previous neighbour (every block has one shape, and both slabs of a
    block have one shape).  A slab from a shard of
    this process is that view itself; one from another rank arrives in a
    new tensor, all of them through one :func:`distributed.p2p` batch, in
    the order of the mesh's cached plan (:meth:`Mesh.exchange_plan`).
    ``kind`` names the caller in :data:`SENT` (two messages a shard)."""
    sources, outgoing, incoming = mesh.exchange_plan(axis_name)
    give = (to_next, to_prev)
    recvs = [torch.empty_like(to_next(blocks[d]),
                              memory_format=torch.contiguous_format)
             for _, _, d in incoming]
    distributed.p2p(
        mesh, [(r, tag, give[slot](blocks[s]))
               for r, tag, s, slot in outgoing],
        [(r, tag, x) for (r, tag, _), x in zip(incoming, recvs)])
    out = {c: tuple(give[slot](blocks[s]) if isinstance(s, tuple)
                    else recvs[s] for slot, s in enumerate(src))
           for c, src in sources.items()}
    slab = next(iter(out.values()))[0]   # sized from a slab made above
    count_sent(f"{kind} {axis_name}", 2 * len(out),
               2 * len(out) * slab.numel() * slab.element_size())
    return out


def exchange_axis(blocks: dict, axis: int, axis_name: str, mesh) -> dict:
    """Pad every block with one halo cell on both sides of ``axis``, filled
    with the neighbouring shards' edge cells (ring exchange; edges masked)."""
    # the previous shard's top row is our bottom halo, and vice versa
    slabs = neighbour_slabs(
        blocks, mesh, axis_name,
        lambda b: b.narrow(axis, b.shape[axis] - 1, 1),
        lambda b: b.narrow(axis, 0, 1), "exchange_axis")
    return {c: torch.cat([_recv(slabs[c][0], x), x, _recv(slabs[c][1], x)],
                         dim=axis)
            for c, x in blocks.items()}


def _pad_axes(x: torch.Tensor, axes) -> torch.Tensor:
    pads = [0, 0] * x.ndim
    for axis in axes:
        pads[2 * (x.ndim - 1 - axis)] = pads[2 * (x.ndim - 1 - axis) + 1] = 1
    return F.pad(x, pads)


def pad_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Pad one zero cell on both sides of ``axis`` (unsharded axes, so all
    shards keep congruent shapes)."""
    return _pad_axes(x, (axis,))


def with_halo(blocks: dict, mesh, *, j_axis: int, i_axis: int,
              j_sharded: bool, i_sharded: bool) -> dict:
    """The blocks padded by a 1-cell halo in j and i: exchanged with mesh
    neighbours on sharded axes, zero-padded otherwise."""
    if not (j_sharded or i_sharded):   # one copy, not one per axis
        return {c: _pad_axes(x, (j_axis, i_axis)) for c, x in blocks.items()}
    if j_sharded:
        blocks = exchange_axis(blocks, j_axis, "j", mesh)
    else:
        blocks = {c: pad_axis(x, j_axis) for c, x in blocks.items()}
    if i_sharded:
        return exchange_axis(blocks, i_axis, "i", mesh)
    return {c: pad_axis(x, i_axis) for c, x in blocks.items()}


def halo3(blocks: dict, mesh, j_sharded: bool = True,
          i_sharded: bool = True) -> dict:
    """(j, k, i) local blocks -> (j+2, k, i+2)."""
    return with_halo(blocks, mesh, j_axis=0, i_axis=2, j_sharded=j_sharded,
                     i_sharded=i_sharded)


def halo2(blocks: dict, mesh, j_sharded: bool = True,
          i_sharded: bool = True) -> dict:
    """(j, i) local blocks -> (j+2, i+2)."""
    return with_halo(blocks, mesh, j_axis=0, i_axis=1, j_sharded=j_sharded,
                     i_sharded=i_sharded)


def refresh_axis(blocks: dict, axis: int, axis_name: str, mesh,
                 n_interior: int | None = None) -> dict:
    """Refresh the 1-cell halo of ALREADY-padded blocks along ``axis`` from
    the neighbours' interior edges (the in-loop exchange for fields that
    changed during a substep), in place.

    ``n_interior``: owned extent (halo cells sit at 0 and n_interior+1);
    defaults to ``shape[axis] - 2``.
    """
    return refresh_axis_w(blocks, axis, axis_name, mesh, n_interior, 1)


def refresh_axis_w(blocks: dict, axis: int, axis_name: str, mesh,
                   n_interior: int | None, width: int) -> dict:
    """Refresh all ``2*width`` halo cells of ring-``width`` blocks along
    ``axis`` with ONE width-``width`` exchange per direction, in place
    (owned cells sit at ``[width, width+n)``; halos at ``[0, width)`` and
    ``[width+n, 2*width+n)`` — :func:`widen_ring_to`'s layout)."""
    R = width
    n = _n_int(next(iter(blocks.values())), axis, n_interior, R)
    slabs = neighbour_slabs(blocks, mesh, axis_name,
                            lambda b: b.narrow(axis, n, R),   # my last R
                            lambda b: b.narrow(axis, R, R),   # my first R
                            "refresh_axis_w")
    for c, x in blocks.items():
        x.narrow(axis, 0, R).copy_(slabs[c][0], non_blocking=True)
        x.narrow(axis, n + R, R).copy_(slabs[c][1], non_blocking=True)
    return blocks


def _widen_zero(x: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    zshape = list(x.shape)
    zshape[axis] = width - 1
    zeros = x.new_zeros(zshape)
    return torch.cat([zeros, x, zeros], dim=axis)


def widen_ring_to(x, axis: int, width: int, axis_name: str | None = None,
                  mesh=None, n_interior: int | None = None):
    """Grow ring-1-padded blocks to ring-``width`` along ``axis``: new
    tensors (the input itself when ``width < 2``).  ``x`` is one block or a
    dict of blocks.

    Unsharded axes (``axis_name`` None) add ``width-1`` zero cells on each
    side (out of the window, mask-protected).  Sharded axes (``axis_name``
    and ``mesh`` given, ``x`` a dict of blocks) pull the ``width-1`` extra
    cells per side from the neighbours' interiors in one exchange, which
    therefore must span at least ``width`` cells."""
    R = width
    if R < 2:
        return x
    if axis_name is None:
        if isinstance(x, dict):
            return {c: _widen_zero(b, axis, R) for c, b in x.items()}
        return _widen_zero(x, axis, R)
    n = _n_int(next(iter(x.values())), axis, n_interior)
    if n < R:
        raise ValueError(f"ring-{R} needs >= {R} interior cells per "
                         f"shard along {axis_name!r}, got {n}")
    # interior cell e sits at ring-1 index 1+e: the extra low cells are
    # the previous shard's interior [n-R, n-1) (our cells -R..-2), the
    # extra high cells the next shard's interior [1, R)
    slabs = neighbour_slabs(x, mesh, axis_name,
                            lambda b: b.narrow(axis, n - R + 1, R - 1),
                            lambda b: b.narrow(axis, 2, R - 1),
                            "widen_ring_to")
    return {c: torch.cat([_recv(slabs[c][0], b), b, _recv(slabs[c][1], b)],
                         dim=axis)
            for c, b in x.items()}


def strip_ring(x: torch.Tensor, axis: int, width: int) -> torch.Tensor:
    """Inverse of :func:`widen_ring_to` on one block: the ring-1 block, as
    a view."""
    if width < 2:
        return x
    return x.narrow(axis, width - 1, x.shape[axis] - 2 * (width - 1))
