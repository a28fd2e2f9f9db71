"""K5: the ring-neighbour row exchange, the ``rdma`` halo backend.

Port of ``wrf_tpu/parallel/halo.py``'s Pallas remote-DMA exchange
(``_rdma_rows``, ``remote_refresh_axis``, ``remote_refresh_multi``).  Every
shard of a ring sends its LAST interior row to the next shard's low halo
row and its FIRST interior row to the previous shard's high halo row; a
ring of one sends both to itself.  On a 2-D mesh every index of the other
axis runs its own independent ring.  The rows are axis 0 of the blocks, so
the exchange serves the j halos; lane-axis (i) halos are single-column
strided slices and stay on the ``ppermute`` form
(``parallel/halo.py::refresh_axis``).

Like the ``ppermute`` functions these take all the blocks of a field (a
dict keyed by the shard's ``(jj, ii)``) and the mesh, where the JAX
functions take one block under ``shard_map``.  Dropped with the TPU: the
128-lane padding and rank-3 shape of the staging buffer, ``collective_id``,
``interpret`` and the device-id types.  The refreshes need no staging
buffer at all: one launch per sending shard moves each row straight from
the sender's block into the neighbours' halo rows (``csrc/halo_rdma.cu``),
IN PLACE, where the TPU form stages, exchanges and scatters back.
:func:`rdma_rows` is the bare exchange of caller-staged 2-slot buffers.

Dispatch is by the device of the blocks: CUDA blocks launch the
hand-written kernel and count one in :data:`LAUNCHES` per launch (one per
sending shard); CPU blocks run the plain version (indexing and
``Tensor.copy_``).  There is no fallback from one to the other.  The
``*_plain`` functions run the plain version on any device, for
comparisons.

Ordering: shards on one device share its current stream, which orders
every put of an exchange before the kernels that read the halo rows.  For
a ring that spans several devices the wrapper orders the devices' streams
with events: a sender waits until both neighbours' earlier work on their
blocks is done, and a receiver's later work waits for both senders.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

#: CUDA kernel launches since import (one per sending shard, and only there)
LAUNCHES = 0

#: segments (contiguous rows) one launch can move
MAX_SEGMENTS = 16

#: elements a thread block of the put kernel covers per trip (256 x float4)
_ELEMS_PER_BLOCK = 1024
_MAX_BLOCKS = 256

_kernel_fn = None
_peers_enabled: set[tuple[int, int]] = set()


def _kernel():
    """The C entry of csrc/halo_rdma.cu (library built on first use)."""
    global _kernel_fn
    if _kernel_fn is None:
        lib = _build.load()
        fn = lib.wrf_tpu_torch_halo_put
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.wrf_tpu_torch_halo_enable_peer.argtypes = [ctypes.c_int,
                                                       ctypes.c_int]
        lib.wrf_tpu_torch_halo_enable_peer.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _enable_peer(dev: torch.device, peer: torch.device) -> None:
    """Let kernels on ``dev`` write through pointers into ``peer``'s memory
    (once per pair)."""
    key = (dev.index, peer.index)
    if dev == peer or key in _peers_enabled:
        return
    _kernel()
    err = _build.load().wrf_tpu_torch_halo_enable_peer(*key)
    if err != 0:
        raise RuntimeError(f"halo_rdma: enabling peer access {dev} -> {peer} "
                           f"failed: CUDA error {err}")
    _peers_enabled.add(key)


def _check_block(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: blocks must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def plan_put(segments):
    """What one launch needs, from one sending shard's segments.  A segment
    is ``(src block, src row, dst block, dst row)``; rows are addressed by
    pointer arithmetic on the contiguous blocks.  The plan holds raw
    pointers: it is good for as long as the blocks are."""
    n = len(segments)
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"halo_rdma: {n} segments per shard; one launch "
                         f"moves 1..{MAX_SEGMENTS}")
    dev = segments[0][0].device
    srcs = (ctypes.c_void_p * n)()
    dsts = (ctypes.c_void_p * n)()
    counts = (ctypes.c_longlong * n)()
    for q, (src, sr, dst, dr) in enumerate(segments):
        if src.device != dev or dst.device.type != "cuda":
            raise ValueError(f"halo_rdma: a sender's rows lie on {dev}; got "
                             f"{src.device} -> {dst.device}")
        if src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"halo_rdma: row shapes differ: "
                             f"{tuple(src.shape[1:])} -> "
                             f"{tuple(dst.shape[1:])}")
        if dst.device != dev:
            _enable_peer(dev, dst.device)
        row = src.stride(0)   # contiguous: the elements of one row
        srcs[q] = src.data_ptr() + 4 * row * sr
        dsts[q] = dst.data_ptr() + 4 * row * dr
        counts[q] = row
    blocks = max(1, min(_MAX_BLOCKS, -(-max(counts) // _ELEMS_PER_BLOCK)))
    return dev, srcs, dsts, counts, n, blocks


def put(plan) -> None:
    """One launch of the put kernel on the sender's device and current
    stream: every row of one sending shard."""
    global LAUNCHES
    dev, srcs, dsts, counts, n, blocks = plan
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(srcs, dsts, counts, n, blocks, stream)
    if err != 0:
        raise RuntimeError(f"halo_rdma put kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1


def _put(ring_segments, devices, plain: bool) -> None:
    """Run one ring's exchange: ``ring_segments[s]`` are sender ``s``'s
    ``(src block, src row, dst block, dst row)`` segments, ``devices[s]``
    its device."""
    if plain or devices[0].type == "cpu":
        for segments in ring_segments:
            for src, sr, dst, dr in segments:
                dst[dr].copy_(src[sr], non_blocking=True)
        return
    m = len(devices)
    several = len(set(devices)) > 1
    if several:
        # a sender may write into a neighbour's block only after the
        # neighbour's earlier work on it (the kernel that produced it)
        ready = []
        for d in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            ready.append(ev)
    done = []
    for s, segments in enumerate(ring_segments):
        stream = torch.cuda.current_stream(devices[s])
        if several:
            stream.wait_event(ready[(s + 1) % m])
            stream.wait_event(ready[(s - 1) % m])
        put(plan_put(segments))
        if several:
            ev = torch.cuda.Event()
            ev.record(stream)
            done.append(ev)
    if several:
        # a receiver's later work reads its halo rows: after both senders
        for r, d in enumerate(devices):
            stream = torch.cuda.current_stream(d)
            stream.wait_event(done[(r - 1) % m])
            stream.wait_event(done[(r + 1) % m])


def _exchange(rings, plain: bool) -> None:
    for ring_segments, devices in rings:
        _put(ring_segments, devices, plain)


def _rows_rings(rows: dict, recv: dict, axis_name: str, mesh):
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs = []
        for s, c in enumerate(ring):
            _check_block(f"rows[{c}]", rows[c])
            if rows[c].shape[0] != 2:
                raise ValueError(f"rows[{c}]: a 2-slot buffer (2, ...), got "
                                 f"{tuple(rows[c].shape)}")
            segs.append([(rows[c], 0, recv[ring[(s + 1) % m]], 0),
                         (rows[c], 1, recv[ring[(s - 1) % m]], 1)])
        out.append((segs, [rows[c].device for c in ring]))
    return out


def rdma_rows(rows: dict, axis_name: str, mesh, *,
              plain: bool = False) -> dict:
    """Ring-exchange 2-slot staging buffers along ``axis_name``: slot 0 of
    every shard (its last interior rows) lands in the NEXT shard's receive
    slot 0, slot 1 (its first interior rows) in the PREVIOUS shard's
    receive slot 1.  ``rows[c]`` is shard ``c``'s ``(2, ...)`` buffer;
    returns the received buffers, ``recv[c] = [from_prev, from_next]``."""
    recv = {c: torch.empty_like(r) for c, r in rows.items()}
    _exchange(_rows_rings(rows, recv, axis_name, mesh), plain)
    return recv


def rdma_rows_plain(rows: dict, axis_name: str, mesh) -> dict:
    """:func:`rdma_rows` as indexing and ``Tensor.copy_`` between the
    blocks, on any device."""
    return rdma_rows(rows, axis_name, mesh, plain=True)


def _refresh_rings(fields, axis_name: str, mesh, n_interior, recv_only):
    ro = list(recv_only) + [""] * (len(fields) - len(recv_only))
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs = []
        for s, c in enumerate(ring):
            nxt, prv = ring[(s + 1) % m], ring[(s - 1) % m]
            mine = []
            for k, (blocks, r) in enumerate(zip(fields, ro)):
                x = blocks[c]
                _check_block(f"fields[{k}][{c}]", x)
                n = (x.shape[0] - 2) if n_interior is None else n_interior
                if r != "hi":   # my last interior row: next's LOW halo
                    mine.append((x, n, blocks[nxt], 0))
                # my first interior row: previous shard's HIGH halo
                mine.append((x, 1, blocks[prv], n + 1))
            segs.append(mine)
        out.append((segs, [fields[0][c].device for c in ring]))
    return out


def remote_refresh_axis(blocks: dict, axis_name: str, mesh,
                        n_interior: int | None = None, *,
                        plain: bool = False) -> dict:
    """``halo.refresh_axis`` along block axis 0 as the hand-written
    exchange: refresh the two halo rows of ALREADY-padded blocks from the
    ring neighbours' interior edges, in place; one launch per shard.
    ``n_interior``: owned rows (halo rows sit at 0 and n_interior+1)."""
    _exchange(_refresh_rings([blocks], axis_name, mesh, n_interior, ()),
              plain)
    return blocks


def remote_refresh_multi(fields: list, axis_name: str, mesh,
                         n_interior: int | None = None, *,
                         recv_only: tuple[str, ...] = (),
                         plain: bool = False) -> list:
    """Refresh the axis-0 halos of SEVERAL already-padded fields (each a
    dict of blocks; 3-D and 2-D may mix) with ONE launch per shard, in
    place, where the ``ppermute`` form costs a copy per field per
    direction: at small local tiles the exchange is launch-bound, so fewer
    launches is where its cost goes.

    ``fields[k]`` with ``recv_only[k] == "hi"`` only receives its high halo
    row (and only sends its first interior row): for fields whose low halo
    is never read (the coupled loop's ``v``)."""
    _exchange(_refresh_rings(fields, axis_name, mesh, n_interior, recv_only),
              plain)
    return fields


def remote_refresh_axis_plain(blocks, axis_name, mesh, n_interior=None):
    """:func:`remote_refresh_axis` through the plain copies, on any
    device."""
    return remote_refresh_axis(blocks, axis_name, mesh, n_interior,
                               plain=True)


def remote_refresh_multi_plain(fields, axis_name, mesh, n_interior=None, *,
                               recv_only=()):
    """:func:`remote_refresh_multi` through the plain copies, on any
    device."""
    return remote_refresh_multi(fields, axis_name, mesh, n_interior,
                                recv_only=recv_only, plain=True)
