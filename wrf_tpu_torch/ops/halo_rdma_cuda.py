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

Across processes on one host (a mesh of ``parallel/distributed.py``) the
same entry points reach a neighbour in another process through its
:class:`Mailbox`: a buffer every rank allocates once per (mesh, axis, slot
length) and maps into its neighbours' processes with CUDA IPC, holding two
slots (by the exchange's parity) per incoming message and 32-bit
counters.  The TPU kernel's semaphores become those counters
(``csrc/halo_ipc.cu``): one launch per device of the signalled put waits
until the receiver has released the slot (the barrier semaphore), copies
the rows into it and adds one per block to the receiver's data counter
(the recv semaphore); one launch of the wait kernel spins until its data
counters reach what the plan predicts, then scatters the rows into the
halo rows (``rdma``) or leaves them in the mailbox, where K1 and K3 read
them (``rdma_overlap``, :meth:`Mailbox.neighbour_rows`).  A slot is
released by the wait launch of the next exchange on the mailbox, after
whatever read it.  Segments between shards of one process still go
through the put kernel above.  The plain version posts the same rows into
a mailbox of the same layout through ``distributed.p2p`` and scatters by
indexing.  There is no fallback: CUDA blocks of a mesh over processes go
through the two kernels or raise, and a wait that times out (10 s) raises
where the loop reads back (``distributed.all_gather_blocks``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..parallel import distributed
from ..parallel.halo import count_sent

#: CUDA kernel launches since import (one per device per exchange, and only
#: there)
LAUNCHES = 0
#: launches of the signalled put into the neighbours' mailboxes
#: (csrc/halo_ipc.cu) since import: one per process per exchange that
#: crosses processes
PUT_LAUNCHES = 0
#: launches of the wait kernel on this rank's mailbox since import: one per
#: process per exchange that crosses processes
WAIT_LAUNCHES = 0

#: segments (contiguous rows) one launch can move: csrc/halo_rdma.cu's
#: kMaxSegs, a by-value table of 24 bytes a segment
MAX_SEGMENTS = 64

#: elements a thread block of the put kernel covers per trip (256 x float4)
_ELEMS_PER_BLOCK = 1024
_MAX_BLOCKS = 256

#: messages one launch of the signalled put or the wait serves
#: (csrc/halo_ipc.cu's kMaxMsgs)
MAX_MESSAGES = 32
#: the x extent of their grids at most
_MAX_IPC_BLOCKS = 64
#: floats: every item of a mailbox slot starts 16 bytes aligned
_ALIGN = 4
_MASK = 0xFFFFFFFF

_kernel_fn = None
_ipc_fns = None
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
    if any(seg for ring_segments, _ in rings for seg in ring_segments):
        _launch(_plan_exchange(rings))


def _rows_rings(rows: dict, recv: dict, axis_name: str, mesh):
    """K5's segments of :func:`rdma_rows` between shards of this process,
    ring by ring."""
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs, devs = [], []
        for s, c in enumerate(ring):
            if c not in rows:
                continue
            nxt, prv = ring[(s + 1) % m], ring[(s - 1) % m]
            segs.append([seg for seg in ((rows[c], 0, recv.get(nxt), 0),
                                         (rows[c], 1, recv.get(prv), 1))
                         if seg[2] is not None])
            devs.append(rows[c].device)
        out.append((segs, devs))
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
    mesh.require_one_host("the rdma exchange (K5)")
    recv = {c: torch.empty_like(r) for c, r in rows.items()}
    _exchange([rows, recv], ("rows", "recv"),
              _rows_rings(rows, recv, axis_name, mesh), plain)
    if mesh.spans_processes:
        _cross(mesh, axis_name, [("0", rows, 0, 1, recv, 0)],
               [("1", rows, 1, 1, recv, 1)], plain)
    row = next(iter(rows.values())).stride(0)   # elements of one slot
    count_sent(f"rdma {axis_name}", 2 * len(rows), 8 * len(rows) * row)
    return recv


def rdma_rows_plain(rows: dict, axis_name: str, mesh) -> dict:
    """:func:`rdma_rows` as indexing and ``Tensor.copy_`` between the
    blocks, on any device."""
    return rdma_rows(rows, axis_name, mesh, plain=True)


def _n_rows(x: torch.Tensor, n_interior) -> int:
    return (x.shape[0] - 2) if n_interior is None else n_interior


def _refresh_rings(fields, axis_name: str, mesh, n_interior, recv_only):
    """K5's segments of a refresh between shards of this process, ring by
    ring."""
    out = []
    for ring in mesh.rings(axis_name):
        m = len(ring)
        segs, devs = [], []
        for s, c in enumerate(ring):
            if c not in fields[0]:
                continue
            nxt, prv = ring[(s + 1) % m], ring[(s - 1) % m]
            mine = []
            for blocks, r in zip(fields, recv_only):
                x = blocks[c]
                n = _n_rows(x, n_interior)
                if r != "hi" and nxt in blocks:
                    # my last interior row: next's LOW halo
                    mine.append((x, n, blocks[nxt], 0))
                if prv in blocks:
                    # my first interior row: previous shard's HIGH halo
                    mine.append((x, 1, blocks[prv], n + 1))
            segs.append(mine)
            devs.append(fields[0][c].device)
        out.append((segs, devs))
    return out


@functools.lru_cache(maxsize=None)
def _field_names(n: int) -> tuple[str, ...]:
    return tuple(f"fields[{k}]" for k in range(n))


def _refresh(fields, axis_name, mesh, n_interior, recv_only, plain,
             loopback=False):
    mesh.require_one_host("the rdma exchange (K5)")
    ro = tuple(recv_only) + ("",) * (len(fields) - len(recv_only))
    names = _field_names(len(fields))
    _exchange(fields, names,
              [] if loopback else
              _refresh_rings(fields, axis_name, mesh, n_interior, ro),
              plain)
    if mesh.spans_processes or loopback:
        n = [_n_rows(next(iter(f.values())), n_interior) for f in fields]
        _cross(mesh, axis_name,
               [(k, f, m, 1, f, 0)
                for k, f, m, r in zip(names, fields, n, ro) if r != "hi"],
               [(k, f, 1, 1, f, m + 1) for k, f, m in zip(names, fields, n)],
               plain, loopback)
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
                         plain: bool = False, loopback: bool = False) -> list:
    """Refresh the axis-0 halos of SEVERAL already-padded fields (each a
    dict of blocks; 3-D and 2-D may mix) with ONE launch per device, in
    place, where the ``ppermute`` form costs a copy per field per
    direction: at small local tiles the exchange is launch-bound, so fewer
    launches is where its cost goes.

    ``fields[k]`` with ``recv_only[k] == "hi"`` only receives its high halo
    row (and only sends its first interior row): for fields whose low halo
    is never read (the coupled loop's ``v``).

    ``loopback`` sends every row, between shards of this process too,
    through this process's own :class:`Mailbox` with the two kernels of the
    cross-process exchange, as if every neighbour sat in another process:
    how one process holds those kernels against their plain version."""
    _refresh(fields, axis_name, mesh, n_interior, recv_only, plain,
             loopback)
    return fields


def remote_refresh_axis_plain(blocks, axis_name, mesh, n_interior=None):
    """:func:`remote_refresh_axis` through the plain copies, on any
    device."""
    return remote_refresh_axis(blocks, axis_name, mesh, n_interior,
                               plain=True)


def remote_refresh_multi_plain(fields, axis_name, mesh, n_interior=None, *,
                               recv_only=(), loopback=False):
    """:func:`remote_refresh_multi` through the plain copies, on any
    device."""
    return remote_refresh_multi(fields, axis_name, mesh, n_interior,
                                recv_only=recv_only, plain=True,
                                loopback=loopback)


# --------------------------------------------------------------------------
# Across processes: the mailbox, the signalled put and the wait
# --------------------------------------------------------------------------
def _ipc():
    """The two C entries of csrc/halo_ipc.cu (library built on first use)."""
    global _ipc_fns
    if _ipc_fns is None:
        lib = _build.load()
        ptr, i = ctypes.c_void_p, ctypes.c_int
        put = lib.wrf_tpu_torch_ipc_put
        put.argtypes = [ptr, ptr, ptr, ptr, i, ptr, ptr, ptr, i, ptr, i, ptr]
        put.restype = i
        wait = lib.wrf_tpu_torch_ipc_wait
        wait.argtypes = [ptr, ptr, ptr, i, ptr, ptr, i, ptr, i, ptr, i, ptr]
        wait.restype = i
        _ipc_fns = (put, wait)
    return _ipc_fns


def _head(n_in: int, n_out: int) -> int:
    """Floats before a mailbox's slots: its int32 counters (a data counter
    per incoming message, a free counter per outgoing one, the error word),
    rounded up to 16 bytes."""
    return -(-(n_in + n_out + 1) // _ALIGN) * _ALIGN


def _layout(items) -> tuple[list, list, int]:
    """``(offsets, lengths, end)`` in floats of a message's items in its
    slot, each 16 bytes aligned; an item is ``(name, blocks, row, nrows,
    ...)`` and moves ``nrows`` rows of its blocks (one shape for all)."""
    offs, lens, end = [], [], 0
    for _, blocks, _, nrows, *_ in items:
        x = next(iter(blocks.values()))
        offs.append(end)
        lens.append(nrows * x[0].numel())
        end += -(-lens[-1] // _ALIGN) * _ALIGN
    return offs, lens, end


def _put_blocks(layouts) -> int:
    """The grid's x extent of an exchange's put launches, from its items'
    lengths on both ends alike: every block adds one to its message's data
    counter, so the receiver counts on this many per segment."""
    longest = max((n for _, lens, _ in layouts for n in lens), default=0)
    return max(1, min(_MAX_IPC_BLOCKS, -(-longest // _ELEMS_PER_BLOCK)))


class Mailbox:
    """One rank's receive slots for the ring messages of a mesh axis that
    cross processes, and its counters, in one allocation on its device
    (``signalled``: the kernels' form, mapped into the neighbours'
    processes) or for the plain version.

    Layout, in float32 words: the int32 counters (``head`` words: a data
    counter per incoming message, a free counter per outgoing message, the
    error word), then two slots of ``slot`` floats per incoming message q,
    ``[q][parity]``: exchange number s on the mailbox fills parity ``s % 2``,
    so a put may run while the receiver still reads the previous exchange's
    slots.  Messages and their order are :meth:`Mesh.mailbox_plan`'s.  One
    mailbox per (mesh, axis, slot length, device), made at the first
    exchange that needs it (on every rank at the same point: its mapping
    is a collective) and kept on the mesh for its lifetime."""

    def __init__(self, mesh, axis_name: str, slot: int, device,
                 signalled: bool, loopback: bool = False):
        (self.outgoing, self.incoming, self.into, self.back,
         counts) = mesh.mailbox_plan(axis_name, loopback)
        self.rank = mesh.rank
        self.slot = slot
        self.signalled = signalled
        n_in, n_out = len(self.incoming), len(self.outgoing)
        self.head = _head(n_in, n_out)
        self.buf = torch.zeros(self.head + 2 * n_in * slot,
                               dtype=torch.float32, device=device)
        self.counters = self.buf[:self.head].view(torch.int32)
        #: exchanges made through this mailbox
        self.seq = 0
        #: what each data counter reaches once the last exchange has landed
        self.targets = [0] * n_in
        #: every rank's (incoming, outgoing) messages
        self.counts = counts
        #: ``{rank: its mailbox, mapped here}``
        self.remote = {}
        if not signalled:
            return
        peers = ({r for r, *_ in self.outgoing}
                 | {r for r, *_ in self.incoming})
        if loopback:
            maps = {self.rank: self.buf}
        else:
            maps = distributed.share_mailbox(mesh, self.buf, peers)
        for r, t in maps.items():
            _enable_peer(self.buf.device, t.device)
            self.remote[r] = t

    @classmethod
    def of(cls, mesh, axis_name, slot, device, signalled, loopback=False):
        """The mesh's mailbox for these messages, made on first use."""
        key = (axis_name, slot, str(device), signalled, loopback)
        box = mesh.mailboxes.get(key)
        if box is None:
            box = mesh.mailboxes[key] = cls(mesh, axis_name, slot, device,
                                             signalled, loopback)
        return box

    def head_of(self, rank: int) -> int:
        """Where rank ``rank``'s mailbox (of this axis and slot length)
        starts its slots, in floats."""
        return _head(*self.counts[rank])

    def slot_view(self, q: int, parity: int) -> torch.Tensor:
        """Incoming message ``q``'s slot of ``parity``, a 1-D view."""
        start = self.head + (2 * q + parity) * self.slot
        return self.buf[start:start + self.slot]

    def raise_if_failed(self) -> None:
        """Raise when a launch on this mailbox timed out (a rank that never
        sent, or a plan the ranks disagree on): reads the error word on the
        device."""
        if not self.signalled:
            return
        err = int(self.counters[len(self.incoming)
                                + len(self.outgoing)].item())
        if err:
            what = {1: "the signalled put waited for a slot of outgoing",
                    2: "the wait waited for incoming"}.get(err & 0xFF, "?")
            raise RuntimeError(
                f"halo_ipc: rank {self.rank}: {what} message {err >> 8} "
                f"for more than 10 s (error word {err:#x}); the exchange "
                "across processes is broken")

    @staticmethod
    def neighbour_rows(mesh, axis_name: str, to_next, to_prev, *,
                       plain: bool = False, loopback: bool = False) -> dict:
        """The rows a kernel reads of its ring neighbours in other
        processes, through this rank's mailbox (the ``rdma_overlap``
        backend's j leg across processes).  ``to_next`` lists ``(name,
        blocks, row, nrows)``: every shard ``c`` sends ``blocks[c][row:row +
        nrows]`` to its next neighbour, which receives it as ``name``;
        ``to_prev`` likewise to the previous neighbour.  Returns ``{shard:
        {name: rows}}`` for this process's shards whose neighbour sits in
        another process (every shard under ``loopback``), each a ``(nrows,
        ...)`` view of the mailbox: the slot stays unreleased until the next
        exchange on the mailbox, so a kernel launched before that reads it
        whole."""
        mesh.require_one_host("the rdma exchange (K5)")
        views = _cross(mesh, axis_name,
                       [(*it, None, 0) for it in to_next],
                       [(*it, None, 0) for it in to_prev], plain, loopback)
        if views:
            rows = [v for got in views.values() for v in got.values()]
            count_sent(f"rdma {axis_name}", len(views),
                       4 * sum(v.numel() for v in rows))
        return views


def _cross(mesh, axis_name, to_next, to_prev, plain, loopback=False):
    """The messages of one exchange between shards in different processes
    (all of them under ``loopback``), through the mailboxes.  ``to_next``
    and ``to_prev`` list what a shard sends its next and its previous ring
    neighbour, ``(name, blocks, row, nrows, dst, dst_row)``: sender ``c``'s
    ``blocks[c][row:row + nrows]`` lands in receiver ``d``'s
    ``dst[d][dst_row:dst_row + nrows]``, or, with ``dst`` None, stays in
    the mailbox.  Every rank calls this for every exchange, in one order.
    Returns ``{d: {name: view}}`` of the rows that stayed."""
    items = (to_next, to_prev)
    layouts = [_layout(it) for it in items]
    slot = max(end for *_, end in layouts)
    first = next(iter((to_next or to_prev)[0][1].values()))
    for it in to_next + to_prev:
        for c, x in it[1].items():
            _check_block(it[0], c, x)
    signalled = not plain and first.device.type == "cuda"
    box = Mailbox.of(mesh, axis_name, slot, first.device, signalled,
                     loopback)
    parity = box.seq % 2
    if signalled:
        _signalled(box, items, layouts, parity)
    else:
        _posted(mesh, box, items, layouts, parity, loopback)
    box.seq += 1
    views: dict = {}
    for q, (_, _, d, way) in enumerate(box.incoming):
        slot_q = box.slot_view(q, parity)
        offs, lens, _ = layouts[way]
        for (name, blocks, _, nrows, dst, _), off, n in zip(items[way], offs,
                                                            lens):
            if dst is None:
                row_shape = next(iter(blocks.values())).shape[1:]
                views.setdefault(d, {})[name] = slot_q[off:off + n].view(
                    nrows, *row_shape)
    return views


def _posted(mesh, box, items, layouts, parity, loopback) -> None:
    """The plain version: every message packed into one buffer and posted
    into the receiver's slot through ``distributed.p2p`` (copied, under
    ``loopback``), then scattered by indexing."""
    sends = []
    for k, (r, tag, c, way) in enumerate(box.outgoing):
        offs, lens, end = layouts[way]
        if not end:
            continue
        x0 = items[way][0][1][c]
        buf = torch.empty(end, dtype=torch.float32, device=x0.device)
        for (_, blocks, row, nrows, *_), off, n in zip(items[way], offs,
                                                       lens):
            buf[off:off + n].copy_(blocks[c][row:row + nrows].reshape(-1),
                                   non_blocking=True)
        if loopback:
            box.slot_view(box.into[k], parity)[:end].copy_(buf)
        else:
            sends.append((r, tag, buf))
    if not loopback:
        distributed.p2p(mesh, sends, [
            (r, tag, box.slot_view(q, parity)[:layouts[way][2]])
            for q, (r, tag, _, way) in enumerate(box.incoming)
            if layouts[way][2]])
    for q, (_, _, d, way) in enumerate(box.incoming):
        slot_q = box.slot_view(q, parity)
        offs, lens, _ = layouts[way]
        for (_, _, _, nrows, dst, dr), off, n in zip(items[way], offs, lens):
            if dst is not None:
                dst[d][dr:dr + nrows].copy_(
                    slot_q[off:off + n].view(dst[d][dr:dr + nrows].shape),
                    non_blocking=True)


def _row_ptr(x: torch.Tensor, row: int) -> int:
    return x.data_ptr() + 4 * row * x.stride(0)


def _tables(box, items, layouts, parity) -> dict:
    """The launch tables of one signalled exchange, in 4-byte words of the
    mailboxes (a pure function of the plan, checked on the CPU):

    * ``puts``: ``(src block, src row, receiver rank, word in its mailbox,
      floats, outgoing message)``, outgoing messages in plan order;
    * ``msgs``: per outgoing message ``(receiver rank, word of its data
      counter, word of this rank's free counter, free target)``: the slot
      of exchange s is free once exchange s-2's was released;
    * ``release``: ``(sender rank, word of its free counter)`` per incoming
      message, releasing the previous exchange's slots (none on the
      first);
    * ``scatter``: ``(word in this mailbox, dst block, dst row, floats)``;
    * ``gain``: the blocks each incoming message's data counter gains.
    """
    blocks = _put_blocks(layouts)
    n_in = len(box.incoming)
    puts, msgs = [], []
    for k, (r, _, c, way) in enumerate(box.outgoing):
        q = box.into[k]
        at = box.head_of(r) + (2 * q + parity) * box.slot
        for (_, blks, row, *_), off, n in zip(items[way], *layouts[way][:2]):
            puts.append((blks[c], row, r, at + off, n, k))
        msgs.append((r, q, n_in + k, (box.seq - 1) & _MASK))
    release = ([(r, box.counts[r][0] + box.back[q])
                for q, (r, *_) in enumerate(box.incoming)]
               if box.seq > 0 else [])
    scatter, gain = [], []
    for q, (_, _, d, way) in enumerate(box.incoming):
        at = box.head + (2 * q + parity) * box.slot
        for (*_, dst, dr), off, n in zip(items[way], *layouts[way][:2]):
            if dst is not None:
                scatter.append((at + off, dst[d], dr, n))
        gain.append(blocks * len(items[way]))
    return dict(puts=puts, msgs=msgs, release=release, scatter=scatter,
                gain=gain, blocks=blocks)


def _signalled(box, items, layouts, parity) -> None:
    """The kernels' form: one put launch (per :data:`MAX_SEGMENTS`
    segments) into the receivers' slots, then one wait launch (likewise) on
    this rank's mailbox, on the device's current stream."""
    global PUT_LAUNCHES, WAIT_LAUNCHES
    n_in, n_out = len(box.incoming), len(box.outgoing)
    if n_out > MAX_MESSAGES or n_in > MAX_MESSAGES:
        raise ValueError(f"halo_ipc: {n_out} outgoing and {n_in} incoming "
                         f"messages; a launch serves {MAX_MESSAGES}")
    put_fn, wait_fn = _ipc()
    tab = _tables(box, items, layouts, parity)
    dev = box.buf.device

    def word(rank, w):
        return box.remote[rank].data_ptr() + 4 * w

    mine = box.buf.data_ptr()
    err = mine + 4 * (n_in + n_out)
    blocks = tab["blocks"]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    data = [word(r, w) for r, w, _, _ in tab["msgs"]]
    free = [mine + 4 * w for _, _, w, _ in tab["msgs"]]
    target = [t for *_, t in tab["msgs"]]
    m = len(data)
    with torch.cuda.device(dev):
        for lo in range(0, len(tab["puts"]), MAX_SEGMENTS):
            segs = tab["puts"][lo:lo + MAX_SEGMENTS]
            n = len(segs)
            e = put_fn(
                (ctypes.c_void_p * n)(*(_row_ptr(x, row)
                                        for x, row, *_ in segs)),
                (ctypes.c_void_p * n)(*(word(r, w) for _, _, r, w, _, _
                                        in segs)),
                (ctypes.c_longlong * n)(*(t[4] for t in segs)),
                (ctypes.c_int * n)(*(t[5] for t in segs)), n,
                (ctypes.c_void_p * m)(*data), (ctypes.c_void_p * m)(*free),
                (ctypes.c_uint * m)(*target), m, err, blocks, stream)
            if e != 0:
                raise RuntimeError(f"halo_ipc put kernel launch failed: "
                                   f"CUDA error {e}")
            PUT_LAUNCHES += 1
        if not n_in:
            return
        for q, g in enumerate(tab["gain"]):
            box.targets[q] = (box.targets[q] + g) & _MASK
        counters = (ctypes.c_void_p * n_in)(*(mine + 4 * q
                                              for q in range(n_in)))
        targets = (ctypes.c_uint * n_in)(*box.targets)
        scatter = tab["scatter"]
        for lo in range(0, max(len(scatter), 1), MAX_SEGMENTS):
            segs = scatter[lo:lo + MAX_SEGMENTS]
            rel = [word(r, w) for r, w in tab["release"]] if lo == 0 else []
            n, k = max(len(segs), 1), max(len(rel), 1)
            e = wait_fn(
                (ctypes.c_void_p * n)(*(mine + 4 * w for w, *_ in segs)),
                (ctypes.c_void_p * n)(*(_row_ptr(x, row)
                                        for _, x, row, _ in segs)),
                (ctypes.c_longlong * n)(*(t[3] for t in segs)), len(segs),
                counters, targets, n_in, (ctypes.c_void_p * k)(*rel),
                len(rel), err, blocks, stream)
            if e != 0:
                raise RuntimeError(f"halo_ipc wait kernel launch failed: "
                                   f"CUDA error {e}")
            WAIT_LAUNCHES += 1
