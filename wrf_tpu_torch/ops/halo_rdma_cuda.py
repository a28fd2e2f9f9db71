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
buffer at all: the put kernel (``csrc/halo_rdma.cu``) moves each row
straight from the sender's block into the neighbours' halo rows, IN PLACE,
where the TPU form stages, exchanges and scatters back.
:func:`rdma_rows` is the bare exchange of caller-staged 2-slot buffers.

One launch per device per exchange: the segments (contiguous rows) of every
sender of every ring of the axis whose source lies on one device form one
table (:func:`segment_tables`), launched once on that device's current
stream; a device with more than :data:`MAX_SEGMENTS` segments takes
further launches.  Four shards on one card exchange with one launch.  The
launch's table is a plan of raw pointers, built on every call from the
live blocks: the loops hand fresh ``mu``, ``v`` and ``mudf`` buffers to
every exchange, so a plan kept from an earlier call would point at
whatever lies at its addresses now.

Dispatch is by the device of the blocks: CUDA blocks launch the
hand-written kernel and count one in :data:`LAUNCHES` per launch (one per
device per exchange); CPU blocks run the plain version (indexing and
``Tensor.copy_``).  There is no fallback from one to the other.  The
``*_plain`` functions run the plain version on any device, for
comparisons.

Ordering: shards on one device share its current stream, which orders
every put of an exchange before the kernels that read the halo rows.
Across devices the wrapper orders the streams with events, per device: a
device's launch waits until the earlier work of every device it writes
into is done, and a device's later work waits for every device that wrote
into it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..parallel.halo import count_sent

#: CUDA kernel launches since import (one per device per exchange, and only
#: there)
LAUNCHES = 0

#: segments (contiguous rows) one launch can move: csrc/halo_rdma.cu's
#: kMaxSegs, a by-value table of 24 bytes a segment
MAX_SEGMENTS = 64

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


def _check_block(name: str, c, x: torch.Tensor) -> None:
    """Shard ``c``'s block of ``name``: contiguous float32 on the CPU or a
    CUDA device (the message is formatted only for a block that fails)."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name}[{c}]: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}[{c}]: blocks must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}[{c}]: unsupported device {x.device}")


def segment_tables(rings, max_segments: int = MAX_SEGMENTS) -> dict:
    """What each device launches for one exchange: ``rings`` is a list of
    ``(ring_segments, devices)``, where ``ring_segments[s]`` are sender
    ``s``'s segments and ``devices[s]`` its device.  Returns ``{device:
    [table, ...]}``: every segment whose sender lies on the device, ring by
    ring and sender by sender in ring order, cut into tables of at most
    ``max_segments`` (one launch each).  The segments and devices are
    opaque here."""
    by_dev: dict = {}
    for ring_segments, devices in rings:
        for segments, dev in zip(ring_segments, devices):
            by_dev.setdefault(dev, []).extend(segments)
    return {dev: [segs[q:q + max_segments]
                  for q in range(0, len(segs), max_segments)]
            for dev, segs in by_dev.items()}


def addresses(segments) -> tuple:
    """``(src address, dst address, elements)`` per ``(src block, src row,
    dst block, dst row)`` segment: rows are addressed by pointer arithmetic
    on the contiguous float32 blocks."""
    out = []
    for src, sr, dst, dr in segments:
        row = src.stride(0)   # contiguous: the elements of one row
        if dst.stride(0) != row:
            raise ValueError(f"halo_rdma: rows of {row} elements into rows "
                             f"of {dst.stride(0)}")
        out.append((src.data_ptr() + 4 * row * sr,
                    dst.data_ptr() + 4 * row * dr, row))
    return tuple(out)


def _plan(dev: torch.device, addrs: tuple):
    """A launch plan from one device's ``addresses``: the three ctypes
    arrays of the C entry, the segment count and the blocks per segment."""
    n = len(addrs)
    srcs = (ctypes.c_void_p * n)(*(a[0] for a in addrs))
    dsts = (ctypes.c_void_p * n)(*(a[1] for a in addrs))
    counts = (ctypes.c_longlong * n)(*(a[2] for a in addrs))
    blocks = max(1, min(_MAX_BLOCKS,
                        -(-max(a[2] for a in addrs) // _ELEMS_PER_BLOCK)))
    return dev, srcs, dsts, counts, n, blocks


def plan_put(segments):
    """What one launch needs, from the segments of senders on one device.
    A segment is ``(src block, src row, dst block, dst row)``.  The plan
    holds raw pointers: it is good for as long as the blocks are."""
    n = len(segments)
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"halo_rdma: {n} segments in one launch; it moves "
                         f"1..{MAX_SEGMENTS}")
    dev = segments[0][0].device
    for src, _, dst, _ in segments:
        if src.device != dev or dst.device.type != "cuda":
            raise ValueError(f"halo_rdma: a launch's rows lie on {dev}; got "
                             f"{src.device} -> {dst.device}")
        if src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"halo_rdma: row shapes differ: "
                             f"{tuple(src.shape[1:])} -> "
                             f"{tuple(dst.shape[1:])}")
        if dst.device != dev:
            _enable_peer(dev, dst.device)
    return _plan(dev, addresses(segments))


def put(plan) -> None:
    """One launch of the put kernel on the plan's device and its current
    stream.  The stream is read as a raw handle (what PyTorch's own kernel
    launchers read; a ``torch.cuda.Stream`` object costs the host ~3 us a
    launch), and the device is switched only when it is not current."""
    global LAUNCHES
    dev, srcs, dsts, counts, n, blocks = plan
    fn = _kernel()
    if torch.cuda.current_device() == dev.index:
        err = fn(srcs, dsts, counts, n, blocks,
                 torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(srcs, dsts, counts, n, blocks,
                     torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"halo_rdma put kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1


def _plan_exchange(rings):
    """The launch plans of one exchange (``rings`` as
    :func:`segment_tables` takes them): ``{device: [plan, ...]}`` and, per
    launching device, the other devices it writes into."""
    tables = segment_tables(rings)
    plans = {dev: [plan_put(tab) for tab in tabs]
             for dev, tabs in tables.items()}
    into = {dev: {seg[2].device for tab in tabs for seg in tab} - {dev}
            for dev, tabs in tables.items()}
    return plans, into


def _launch(exchange) -> None:
    plans, into = exchange
    if not any(into.values()):   # one device: its stream orders everything
        for dev_plans in plans.values():
            for plan in dev_plans:
                put(plan)
        return
    # a device may write into another's blocks only after that device's
    # earlier work on them (the kernel that produced them)
    ready = {}
    for d in set().union(*into.values()):
        ready[d] = torch.cuda.Event()
        ready[d].record(torch.cuda.current_stream(d))
    done = {}
    for dev, dev_plans in plans.items():
        stream = torch.cuda.current_stream(dev)
        for d in into[dev]:
            stream.wait_event(ready[d])
        for plan in dev_plans:
            put(plan)
        done[dev] = torch.cuda.Event()
        done[dev].record(stream)
    # a receiver's later work reads its halo rows: after every writer
    for dev, targets in into.items():
        for d in targets:
            torch.cuda.current_stream(d).wait_event(done[dev])


def _exchange(fields, names, rings, plain: bool) -> None:
    """One exchange among ``fields`` (dicts of blocks by shard, named
    ``names``), whose segments ``rings`` lists (as :func:`segment_tables`
    takes them): the plain copies for CPU blocks (or ``plain``), else one
    launch per device from plans built for this call."""
    for name, blocks in zip(names, fields):
        for c, x in blocks.items():
            _check_block(name, c, x)
    if plain or next(iter(fields[0].values())).is_cpu:
        for ring_segments, _ in rings:
            for segments in ring_segments:
                for src, sr, dst, dr in segments:
                    dst[dr].copy_(src[sr], non_blocking=True)
        return
    _launch(_plan_exchange(rings))


def _rows_rings(rows: dict, recv: dict, axis_name: str, mesh):
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs = [[(rows[c], 0, recv[ring[(s + 1) % m]], 0),
                 (rows[c], 1, recv[ring[(s - 1) % m]], 1)]
                for s, c in enumerate(ring)]
        out.append((segs, [rows[c].device for c in ring]))
    return out


def rdma_rows(rows: dict, axis_name: str, mesh, *,
              plain: bool = False) -> dict:
    """Ring-exchange 2-slot staging buffers along ``axis_name``: slot 0 of
    every shard (its last interior rows) lands in the NEXT shard's receive
    slot 0, slot 1 (its first interior rows) in the PREVIOUS shard's
    receive slot 1.  ``rows[c]`` is shard ``c``'s ``(2, ...)`` buffer;
    returns the received buffers, ``recv[c] = [from_prev, from_next]``."""
    for c, r in rows.items():
        if r.shape[0] != 2:
            raise ValueError(f"rows[{c}]: a 2-slot buffer (2, ...), got "
                             f"{tuple(r.shape)}")
    mesh.require_one_process("the rdma exchange (K5)")
    recv = {c: torch.empty_like(r) for c, r in rows.items()}
    _exchange([rows, recv], ("rows", "recv"),
              _rows_rings(rows, recv, axis_name, mesh), plain)
    row = next(iter(rows.values())).stride(0)   # elements of one slot
    count_sent(f"rdma {axis_name}", 2 * len(rows), 8 * len(rows) * row)
    return recv


def rdma_rows_plain(rows: dict, axis_name: str, mesh) -> dict:
    """:func:`rdma_rows` as indexing and ``Tensor.copy_`` between the
    blocks, on any device."""
    return rdma_rows(rows, axis_name, mesh, plain=True)


def _refresh_rings(fields, axis_name: str, mesh, n_interior, recv_only):
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs = []
        for s, c in enumerate(ring):
            nxt, prv = ring[(s + 1) % m], ring[(s - 1) % m]
            mine = []
            for blocks, r in zip(fields, recv_only):
                x = blocks[c]
                n = (x.shape[0] - 2) if n_interior is None else n_interior
                if r != "hi":   # my last interior row: next's LOW halo
                    mine.append((x, n, blocks[nxt], 0))
                # my first interior row: previous shard's HIGH halo
                mine.append((x, 1, blocks[prv], n + 1))
            segs.append(mine)
        out.append((segs, [fields[0][c].device for c in ring]))
    return out


@functools.lru_cache(maxsize=None)
def _field_names(n: int) -> tuple[str, ...]:
    return tuple(f"fields[{k}]" for k in range(n))


def _refresh(fields, axis_name, mesh, n_interior, recv_only, plain):
    mesh.require_one_process("the rdma exchange (K5)")
    ro = tuple(recv_only) + ("",) * (len(fields) - len(recv_only))
    _exchange(fields, _field_names(len(fields)),
              _refresh_rings(fields, axis_name, mesh, n_interior, ro),
              plain)
    # one segment (a row, as long in every block of a field) per shard
    # and direction; a "hi" field's shards send only their first row
    n = len(fields[0])
    rows = [(1 if r == "hi" else 2, next(iter(f.values())).stride(0))
            for f, r in zip(fields, ro)]
    count_sent(f"rdma {axis_name}", n * sum(m for m, _ in rows),
               4 * n * sum(m * row for m, row in rows))


def remote_refresh_axis(blocks: dict, axis_name: str, mesh,
                        n_interior: int | None = None, *,
                        plain: bool = False) -> dict:
    """``halo.refresh_axis`` along block axis 0 as the hand-written
    exchange: refresh the two halo rows of ALREADY-padded blocks from the
    ring neighbours' interior edges, in place; one launch per device.
    ``n_interior``: owned rows (halo rows sit at 0 and n_interior+1)."""
    _refresh([blocks], axis_name, mesh, n_interior, (), plain)
    return blocks


def remote_refresh_multi(fields: list, axis_name: str, mesh,
                         n_interior: int | None = None, *,
                         recv_only: tuple[str, ...] = (),
                         plain: bool = False) -> list:
    """Refresh the axis-0 halos of SEVERAL already-padded fields (each a
    dict of blocks; 3-D and 2-D may mix) with ONE launch per device, in
    place, where the ``ppermute`` form costs a copy per field per
    direction: at small local tiles the exchange is launch-bound, so fewer
    launches is where its cost goes.

    ``fields[k]`` with ``recv_only[k] == "hi"`` only receives its high halo
    row (and only sends its first interior row): for fields whose low halo
    is never read (the coupled loop's ``v``)."""
    _refresh(fields, axis_name, mesh, n_interior, recv_only, plain)
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
