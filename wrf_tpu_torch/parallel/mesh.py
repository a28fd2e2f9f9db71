"""The (j, i) mesh of shards for the 2-D spatial domain decomposition.

Port of ``wrf_tpu/parallel/mesh.py``.  The reference decomposes the domain
1-D along j across 3 GPUs and drives them from one host thread; this port
generalizes to a 2-D ``(j, i)`` mesh of *shards*, all driven by one Python
process: every SPMD step of the JAX package's ``shard_map`` programs is a
"for each shard" loop over per-shard local blocks, with the halo exchange
between those loops (``parallel/halo.py``, ``ops/halo_rdma_cuda.py``).

A :class:`Mesh` is an ``(nj, ni)`` grid of ``torch.device``s in which **a
device may appear more than once**: ``make_mesh(["cuda:0"] * 4, (2, 2))``
puts four shards on one card, the way the JAX tests put eight virtual
devices on one host.  The vertical dimension k is never sharded (column
scans are shard-local).  There are no sharding-spec objects: a field on a
mesh is a dict of local blocks keyed by the shard's ``(jj, ii)``
(``parallel/sharded.py::scatter``).

Shards on different CUDA devices exchange halos through peer pointers, so
neighbouring devices must have peer access; a mesh without it raises.

A mesh may span several processes (``parallel/distributed.py``, the port of
the JAX package's multi-host recipe): its owner table names the process
rank of every shard, counted j-major, and each process holds and drives
only its own shards' blocks (:meth:`Mesh.local_coords`).  A one-process
mesh owns every shard.  The ``rdma`` exchanges reach a j neighbour in
another process on the same host through its mailbox, mapped here with
CUDA IPC (:meth:`Mesh.mailbox_plan`, ``ops/halo_rdma_cuda.py``); they
refuse neighbours on two hosts (:meth:`Mesh.require_one_host`).
"""

from __future__ import annotations

import math

import torch

#: mesh axis names: j (outer / slab) and i (lane) decomposition
AXES = ("j", "i")


def factor_near_square(n: int) -> tuple[int, int]:
    """Factor ``n = a*b`` with a >= b and a/b minimal — a near-square mesh
    maximizes the volume-to-halo-surface ratio of each shard."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


class Mesh:
    """An ``(nj, ni)`` grid of devices, one entry per shard; each axis is a
    ring (shard ``n-1``'s next neighbour is shard 0; the window masks keep
    the wrapped rows out of every result).

    ``owners`` is the process rank of every shard, j-major (default: every
    shard this process's), ``rank`` the calling process's rank,
    ``backend`` the transport of the default ``torch.distributed`` process
    group ("gloo" or "nccl"; ``group`` is that group's handle, None) and
    ``hosts`` every rank's host name (default: one host).  NCCL needs one
    card per rank: a mesh that puts two ranks on one device under NCCL
    raises here, before any exchange."""

    #: the ``torch.distributed`` process group the ranks count in: the
    #: default one
    group = None

    def __init__(self, devices, shape: tuple[int, int], *, owners=None,
                 rank: int = 0, backend: str | None = None, hosts=None):
        nj, ni = (int(n) for n in shape)
        devices = [torch.device(d) for d in devices]
        if nj < 1 or ni < 1 or nj * ni != len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} != device count "
                             f"{len(devices)}")
        owners = [0] * len(devices) if owners is None else [int(r) for r
                                                             in owners]
        if len(owners) != len(devices):
            raise ValueError(f"owner table of {len(owners)} ranks for "
                             f"{len(devices)} shards")
        if backend not in (None, "gloo", "nccl"):
            raise ValueError(f"bad backend {backend!r}: gloo or nccl")
        self.shape = (nj, ni)
        self.devices = [devices[jj * ni:(jj + 1) * ni] for jj in range(nj)]
        self.owners = [owners[jj * ni:(jj + 1) * ni] for jj in range(nj)]
        self.rank = int(rank)
        self.backend = backend
        self.hosts = hosts
        #: whether the shards sit in more than one process
        self.spans_processes = len(set(owners)) > 1
        self._plans: dict = {}
        #: the mailboxes of the rdma exchange across processes
        #: (``ops/halo_rdma_cuda.py::Mailbox``), made at first use and kept
        #: for the mesh's lifetime
        self.mailboxes: dict = {}
        self._one_host: str | None = None
        if self.spans_processes and backend is None:
            raise ValueError("a mesh over several processes needs its "
                             "backend (gloo or nccl)")
        if backend == "nccl":
            self._check_nccl()
        self._check_peer_access()

    def coords(self) -> list[tuple[int, int]]:
        """Every shard's ``(jj, ii)``, j-major."""
        nj, ni = self.shape
        return [(jj, ii) for jj in range(nj) for ii in range(ni)]

    def owner(self, coord) -> int:
        """The rank of the process that holds shard ``coord``."""
        return self.owners[coord[0]][coord[1]]

    def local_coords(self) -> list[tuple[int, int]]:
        """The shards this process holds, j-major."""
        return [c for c in self.coords() if self.owner(c) == self.rank]

    def require_one_host(self, what: str) -> None:
        """Raise for ``what``, which writes through device pointers (peer
        pointers inside a process, CUDA IPC mappings between processes),
        where it cannot: j neighbours in two processes on different hosts;
        two such neighbours on CUDA devices without peer access; a rank
        whose shards with a j neighbour in another process sit on more than
        one device (its mailbox lies on one).  Checked once per mesh; a
        one-process mesh passes."""
        if not self.spans_processes:
            return
        if self._one_host is None:
            self._one_host = self._device_pointer_fault()
        if self._one_host:
            raise ValueError(f"{what}: {self._one_host}")

    def _device_pointer_fault(self) -> str:
        host = (lambda r: self.hosts[r]) if self.hosts is not None else (
            lambda r: "")
        mine = set()
        for c in self.coords():
            for shift in (1, -1):
                nb = self.neighbour(c, "j", shift)
                a, b = self.owner(c), self.owner(nb)
                if a == b:
                    continue
                if host(a) != host(b):
                    return (f"neighbouring shards {c} (rank {a} on "
                            f"{host(a)}) and {nb} (rank {b} on {host(b)}) sit "
                            "on two hosts, and the port has no device-pointer "
                            "transport between hosts: use "
                            "halo_backend='ppermute'")
                da, db = self.device(c), self.device(nb)
                if da.type == db.type == "cuda" and da != db and not (
                        torch.cuda.can_device_access_peer(da.index, db.index)
                        and torch.cuda.can_device_access_peer(db.index,
                                                              da.index)):
                    return (f"neighbouring shards {c} (rank {a}, {da}) and "
                            f"{nb} (rank {b}, {db}) sit on cards without peer "
                            "access: the mailbox of one is mapped into the "
                            "other's process")
                if a == self.rank:
                    mine.add(self.device(c))
        if len(mine) > 1:
            return (f"rank {self.rank}'s shards with a j neighbour in another "
                    f"process sit on {sorted(map(str, mine))}: its mailbox "
                    "lies on one device")
        return ""

    def device(self, coord) -> torch.device:
        return self.devices[coord[0]][coord[1]]

    def exchange_plan(self, axis_name: str) -> tuple:
        """How this process's shards meet their neighbours along
        ``axis_name``, built once per axis: ``(sources, outgoing,
        incoming)``.  ``sources`` maps every local shard to the source of
        its halo from the previous and from the next neighbour: a local
        shard's coordinate, or the position of the message in ``incoming``.
        ``outgoing`` lists ``(rank, tag, shard, slot)`` (the slab a local
        shard gives a remote neighbour: slot 0 its slab to the next
        neighbour, 1 to the previous) and ``incoming`` ``(rank, tag,
        shard)``.  Every rank enumerates the mesh's messages in one order
        (shards j-major, to the next neighbour before to the previous) and
        tags them by that position, so two messages between one pair of
        ranks (a ring of two) stay apart."""
        if axis_name in self._plans:
            return self._plans[axis_name]
        sources = {c: [None, None] for c in self.local_coords()}
        outgoing, incoming = [], []
        tag = 0
        for s in self.coords():
            for shift, slot in ((+1, 0), (-1, 1)):
                d = self.neighbour(s, axis_name, shift)
                src, dst = self.owner(s), self.owner(d)
                if dst == self.rank:
                    if src == self.rank:
                        sources[d][slot] = s
                    else:
                        sources[d][slot] = len(incoming)
                        incoming.append((src, tag, d))
                elif src == self.rank:
                    outgoing.append((dst, tag, s, slot))
                tag += src != dst
        plan = ({c: tuple(v) for c, v in sources.items()}, outgoing,
                incoming)
        self._plans[axis_name] = plan
        return plan

    def mailbox_plan(self, axis_name: str, loopback: bool = False
                     ) -> tuple:
        """The messages of :meth:`exchange_plan` that cross processes, with
        the places they take in the mailboxes of the cross-process rdma
        exchange (``ops/halo_rdma_cuda.py``), built once per axis:
        ``(outgoing, incoming, into, back, counts)``.  ``outgoing`` lists
        ``(rank, tag, shard, slot)`` and ``incoming`` ``(rank, tag, shard,
        slot)`` in :meth:`exchange_plan`'s order and tags (``slot`` 0: the
        sender's slab to its next neighbour, the receiver's low halo; 1:
        to its previous one, the high halo).  ``into[k]`` is outgoing
        message k's position in its receiver's incoming list (its slot in
        the receiver's mailbox), ``back[q]`` incoming message q's position
        in its sender's outgoing list (its free counter in the sender's
        mailbox), ``counts[r]`` rank r's (incoming, outgoing) message
        counts.  ``loopback`` counts every ring message, within a process
        too, as crossing: how one process drives the transport alone."""
        key = ("mailbox", axis_name, loopback)
        if key in self._plans:
            return self._plans[key]
        msgs = []   # (src rank, dst rank, src shard, dst shard, slot)
        for s in self.coords():
            for shift, slot in ((+1, 0), (-1, 1)):
                d = self.neighbour(s, axis_name, shift)
                src, dst = self.owner(s), self.owner(d)
                if loopback or src != dst:
                    msgs.append((src, dst, s, d, slot))
        ranks = {r for row in self.owners for r in row}
        n_out = dict.fromkeys(ranks, 0)
        n_in = dict.fromkeys(ranks, 0)
        outgoing, incoming, into, back = [], [], [], []
        for tag, (src, dst, s, d, slot) in enumerate(msgs):
            if src == self.rank:
                outgoing.append((dst, tag, s, slot))
                into.append(n_in[dst])
            if dst == self.rank:
                incoming.append((src, tag, d, slot))
                back.append(n_out[src])
            n_out[src] += 1
            n_in[dst] += 1
        plan = (outgoing, incoming, into, back,
                {r: (n_in[r], n_out[r]) for r in ranks})
        self._plans[key] = plan
        return plan

    def neighbour(self, coord, axis_name: str, shift: int) -> tuple[int, int]:
        """The shard ``shift`` steps along the ring of ``axis_name``."""
        a = AXES.index(axis_name)
        c = list(coord)
        c[a] = (c[a] + shift) % self.shape[a]
        return tuple(c)

    def rings(self, axis_name: str) -> list[list[tuple[int, int]]]:
        """The independent rings along ``axis_name``: one list of shard
        coordinates, in ring order, per index of the other axis."""
        nj, ni = self.shape
        if axis_name == "j":
            return [[(jj, ii) for jj in range(nj)] for ii in range(ni)]
        return [[(jj, ii) for ii in range(ni)] for jj in range(nj)]

    def unique_devices(self) -> list[torch.device]:
        """The devices of this process's shards, in shard order."""
        seen: list[torch.device] = []
        for c in self.local_coords():
            if self.device(c) not in seen:
                seen.append(self.device(c))
        return seen

    def join_streams(self) -> None:
        """Order the devices' current streams: work queued from here on, on
        any device of the mesh, runs after the work queued so far on every
        other.  What a kernel that reads a neighbour shard's block through
        a peer pointer needs before it (the neighbour's block is complete)
        and after it (the neighbour may reuse the block).  Nothing on one
        device, whose stream orders its shards, or on the CPU; only this
        process's devices."""
        devs = [d for d in self.unique_devices() if d.type == "cuda"]
        if len(devs) < 2:
            return
        events = []
        for d in devs:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
        for d in devs:
            stream = torch.cuda.current_stream(d)
            for other, ev in zip(devs, events):
                if other != d:
                    stream.wait_event(ev)

    def _check_nccl(self) -> None:
        """NCCL refuses two ranks on one device: name them here."""
        place: dict = {}
        for c in self.coords():
            dev, r = self.device(c), self.owner(c)
            if dev.type != "cuda":
                raise ValueError(f"the nccl backend moves CUDA tensors; "
                                 f"shard {c} sits on {dev}")
            host = self.hosts[r] if self.hosts is not None else ""
            ranks = place.setdefault((host, str(dev)), set())
            ranks.add(r)
            if len(ranks) > 1:
                raise ValueError(
                    f"the nccl backend needs one card per rank, but ranks "
                    f"{sorted(ranks)} both drive {dev}"
                    + (f" on {host}" if host else "")
                    + ": use backend='gloo' on a shared card")

    def _check_peer_access(self) -> None:
        """Neighbouring shards of this process on different CUDA devices
        need peer access.  Pairs across processes need it only for the rdma
        backends, whose mailboxes are mapped into the neighbour's process
        (:meth:`require_one_host` checks them when a loop asks for one);
        ``ppermute`` reaches them through ``torch.distributed``."""
        for c in self.local_coords():
            a = self.device(c)
            for axis in AXES:
                nb = self.neighbour(c, axis, 1)
                if self.owner(nb) != self.rank:
                    continue
                b = self.device(nb)
                if a == b or "cuda" not in (a.type, b.type):
                    continue
                if a.type != b.type:
                    raise ValueError(f"mesh mixes device types: {a} and {b}")
                if not (torch.cuda.can_device_access_peer(a.index, b.index)
                        and torch.cuda.can_device_access_peer(b.index,
                                                              a.index)):
                    raise RuntimeError(
                        f"neighbouring shards sit on {a} and {b}, which have "
                        "no peer access: the halo exchange writes through "
                        "peer pointers")

    def __repr__(self) -> str:
        procs = (f", rank {self.rank} of owners {self.owners}"
                 if self.spans_processes else "")
        return (f"Mesh({self.shape[0]}x{self.shape[1]} on "
                f"{[str(d) for d in self.unique_devices()]}{procs})")


def default_devices() -> list[torch.device]:
    """Every visible CUDA device, in order; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass the "
                           "devices (e.g. ['cpu'] * 4) explicitly")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices: list | None = None,
              shape: tuple[int, int] | None = None) -> Mesh:
    """Build a ``(j, i)`` mesh over ``devices`` (default: every visible CUDA
    device), one shard per entry; a device may be listed several times.

    ``shape`` fixes (nj, ni) explicitly; otherwise a near-square
    factorization is used with the larger factor on j (the outer dimension,
    which benefits most from contiguous slabs).
    """
    devices = list(devices if devices is not None else default_devices())
    if shape is None:
        shape = factor_near_square(len(devices))
    return Mesh(devices, shape)


def make_mesh_1d(devices: list | None = None) -> Mesh:
    """A j-only mesh ``(n, 1)``: one ring of every device."""
    devices = list(devices if devices is not None else default_devices())
    return Mesh(devices, (len(devices), 1))


def mesh_from_spec(spec: str, device) -> Mesh:
    """The mesh a command line asks for: ``spec`` is ``"JxI"``; the shards
    take the visible CUDA devices in order, wrapping round when there are
    fewer than ``J*I`` (all on the CPU when ``device`` is the CPU)."""
    try:
        nj, ni = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"bad mesh {spec!r}: expected JxI, "
                         "e.g. 2x2") from None
    device = torch.device(device)
    devices = [device] if device.type == "cpu" else default_devices()
    return Mesh([devices[s % len(devices)] for s in range(nj * ni)],
                (nj, ni))


def describe(mesh: Mesh) -> str:
    """How many shards sit on how many devices, so that no one reads a
    four-shards-on-one-card time as a four-card time."""
    devs = mesh.unique_devices()
    nj, ni = mesh.shape
    out = (f"mesh {nj}x{ni}: {nj * ni} shard(s) on {len(devs)} device(s) "
           f"({', '.join(str(d) for d in devs)})")
    if mesh.spans_processes:
        n = len({r for row in mesh.owners for r in row})
        out += (f" in this process (rank {mesh.rank}), of {n} processes "
                f"over {mesh.backend}")
    return out
