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
    the wrapped rows out of every result)."""

    def __init__(self, devices, shape: tuple[int, int]):
        nj, ni = (int(n) for n in shape)
        devices = [torch.device(d) for d in devices]
        if nj < 1 or ni < 1 or nj * ni != len(devices):
            raise ValueError(f"mesh shape {tuple(shape)} != device count "
                             f"{len(devices)}")
        self.shape = (nj, ni)
        self.devices = [devices[jj * ni:(jj + 1) * ni] for jj in range(nj)]
        self._check_peer_access()

    def coords(self) -> list[tuple[int, int]]:
        """Every shard's ``(jj, ii)``, j-major."""
        nj, ni = self.shape
        return [(jj, ii) for jj in range(nj) for ii in range(ni)]

    def device(self, coord) -> torch.device:
        return self.devices[coord[0]][coord[1]]

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
        seen: list[torch.device] = []
        for c in self.coords():
            if self.device(c) not in seen:
                seen.append(self.device(c))
        return seen

    def join_streams(self) -> None:
        """Order the devices' current streams: work queued from here on, on
        any device of the mesh, runs after the work queued so far on every
        other.  What a kernel that reads a neighbour shard's block through
        a peer pointer needs before it (the neighbour's block is complete)
        and after it (the neighbour may reuse the block).  Nothing on one
        device, whose stream orders its shards, or on the CPU."""
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

    def _check_peer_access(self) -> None:
        for c in self.coords():
            a = self.device(c)
            for axis in AXES:
                b = self.device(self.neighbour(c, axis, 1))
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
        return (f"Mesh({self.shape[0]}x{self.shape[1]} on "
                f"{[str(d) for d in self.unique_devices()]})")


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
    return (f"mesh {nj}x{ni}: {nj * ni} shard(s) on {len(devs)} device(s) "
            f"({', '.join(str(d) for d in devs)})")
