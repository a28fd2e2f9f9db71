"""Meshes that span processes: the multi-host recipe over ``torch.distributed``.

Port of ``wrf_tpu/parallel/distributed.py``.  A one-process run needs none
of this: a :class:`~wrf_tpu_torch.parallel.mesh.Mesh` over the visible
devices is enough.  Across processes each one calls :func:`initialize` once,
builds the global mesh with :func:`global_mesh` (every rank's devices in
rank order, and the owner table: rank r holds a consecutive j-major run of
shards, as JAX enumerates devices), and turns the block of every field it
holds into its shards' blocks with :func:`host_local_arrays`.
``ShardedAdvanceMuT``, ``SmallStepLoop`` and ``RK3Integrator`` then run
unchanged: their exchanges reach a neighbour on another rank through
:func:`p2p` and their gathers through :func:`all_gather_blocks`, so every
rank ends a call with the domain-shaped result, as JAX's
``process_allgather`` gives it.

The transport is the process group's and is chosen explicitly
(:func:`initialize`'s ``backend``, "gloo" unless asked):

* gloo moves host memory: blocks on a CUDA device are staged through
  pinned host buffers (a device-to-host copy before a send, a host-to-device
  copy after a receive); CPU blocks go as they are.  gloo serves any number
  of ranks on one card, which is how a one-card machine runs the path;
* nccl moves device memory with no staging and needs one card per rank: a
  mesh that puts two ranks on one device raises before any exchange
  (``Mesh``), and nothing switches to the other transport by itself.

The exchange kernels of ``halo_backend`` "rdma" and "rdma_overlap" write
through device pointers.  A j neighbour in another process on the same
host is reached through its mailbox: a persistent buffer of every rank,
mapped into its neighbours' processes once with CUDA IPC
(:func:`share_mailbox`), which a signalled put fills and a wait kernel
empties (``ops/halo_rdma_cuda.py``).  Neighbours on two hosts refuse these
backends by name (``Mesh.require_one_host``); ``ppermute`` serves any
layout.

``tools/multihost_check.py`` (``python -m
wrf_tpu_torch.tools.multihost_check``) drives this module across real OS
processes and holds every result bit for bit against the one-process run of
the same program on the same mesh.
"""

from __future__ import annotations

import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, default_devices

#: environment variables that name a cluster to ``init_method="env://"``
CLUSTER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize(**kwargs) -> None:
    """Join the process group (``dist.init_process_group(**kwargs)``).

    With explicit arguments every error surfaces (a second initialisation
    included); ``backend`` is "gloo" (the default) or "nccl".  With none, the cluster the
    environment names (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) is joined
    over gloo; with no cluster named, or a group already joined, nothing
    happens and the process stays a one-process world."""
    if not kwargs:
        if dist.is_initialized() or not any(k in os.environ
                                            for k in CLUSTER_ENV):
            return
        kwargs = {"init_method": "env://"}
    kwargs.setdefault("backend", "gloo")
    if kwargs["backend"] not in ("gloo", "nccl"):
        raise ValueError(f"bad backend {kwargs['backend']!r}: the port's "
                         "transports are gloo and nccl")
    dist.init_process_group(**kwargs)


def _world() -> tuple[int, int]:
    """(rank, size) in the default process group; (0, 1) outside one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


#: the default group and its gloo twin that names the devices under nccl
_NAMING: list = [None, None]


def _naming_group():
    """A gloo group over every rank for the object gathers: the default
    group itself under gloo; under nccl one gloo group per default group,
    made once (every rank calls this at the same point, in
    :func:`global_mesh`)."""
    if dist.get_backend() == "gloo":
        return None
    if _NAMING[0] is not dist.group.WORLD:
        _NAMING[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _NAMING[1]


def global_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """The ``(j, i)`` mesh over every device of every process: this rank's
    ``devices`` (default: every visible CUDA device) gathered from all ranks
    in rank order, so rank r holds a consecutive j-major run of shards.
    ``shape`` None takes JAX's factorisation: ``nj`` the largest divisor of
    the device count n that is at most ``isqrt(n)``, shape ``(nj, n //
    nj)`` (8 gives (2, 4)).  Outside a process group this is a one-process
    mesh over ``devices``."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    rank, size = _world()
    backend = dist.get_backend() if dist.is_initialized() else None
    mine = ([str(d) for d in devices], socket.gethostname())
    if size > 1:
        # the devices are named over gloo even under nccl: nccl refuses two
        # ranks on one card at its first call, and the mesh must name them
        every = [None] * size
        dist.all_gather_object(every, mine, group=_naming_group())
    else:
        every = [mine]
    all_devices = [d for devs, _ in every for d in devs]
    owners = [r for r, (devs, _) in enumerate(every) for _ in devs]
    n = len(all_devices)
    if shape is None:
        nj = math.isqrt(n)
        while n % nj:
            nj -= 1
        shape = (nj, n // nj)
    mesh = Mesh(all_devices, shape, owners=owners, rank=rank,
                backend=backend, hosts=[h for _, h in every])
    if backend == "nccl" and size > 1:
        # nccl's first call on a group must involve every rank: make it
        # this barrier, on this rank's card, not a point-to-point batch
        torch.cuda.set_device(devices[0])
        dist.barrier()
    return mesh


def process_local_block(mesh: Mesh, global_shape, rank: int | None = None
                        ) -> tuple[slice, ...]:
    """Rank ``rank``'s (default: this process's) contiguous index block of a
    mesh-divisible array of ``global_shape``: the union of its shards'
    slices (j on axis 0 and i on the last axis of 2-D and 3-D arrays; a 1-D
    array is replicated, its block the whole).  Raises when the rank holds
    no shard, or shards that do not tile one block."""
    rank = mesh.rank if rank is None else int(rank)
    mine = [c for c in mesh.coords() if mesh.owner(c) == rank]
    if not mine:
        raise ValueError(f"rank {rank} holds no shard of {mesh}")
    gshape = tuple(int(n) for n in global_shape)
    if len(gshape) not in (2, 3):
        return tuple(slice(0, n) for n in gshape)
    nj, ni = mesh.shape
    if gshape[0] % nj or gshape[-1] % ni:
        raise ValueError(f"array {gshape} does not divide over the {nj}x{ni} "
                         "mesh (pad_to_mesh first)")
    js, is_ = [c[0] for c in mine], [c[1] for c in mine]
    if len(mine) != (max(js) - min(js) + 1) * (max(is_) - min(is_) + 1):
        raise ValueError(f"rank {rank}'s shards {mine} do not tile one block")
    njl, nil = gshape[0] // nj, gshape[-1] // ni
    return ((slice(min(js) * njl, (max(js) + 1) * njl),)
            + tuple(slice(0, n) for n in gshape[1:-1])
            + (slice(min(is_) * nil, (max(is_) + 1) * nil),))


def host_local_arrays(mesh: Mesh, arrays: dict,
                      global_shapes: dict | None = None) -> dict:
    """This rank's blocks of every field as the loops take them: ``{name:
    {shard: float32 tensor on the shard's device}}`` for the shards this
    process holds, what a JAX process hands to
    ``jax.make_array_from_process_local_data``.

    ``arrays`` holds each field's block on this rank (numpy, already padded
    to the mesh as ``pad_to_mesh`` pads the whole), which is copied, never
    written through.  1-D fields are the whole vector on every rank and are
    replicated to every shard.  Without ``global_shapes`` (name -> the
    padded global shape) the ranks own j-slabs, as in JAX: the global j
    extent is the local one times the number of ranks; with it, any layout
    works and each rank passes the block :func:`process_local_block`
    names."""
    nranks = len({mesh.owner(c) for c in mesh.coords()})
    nj, ni = mesh.shape
    local = mesh.local_coords()
    out = {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if arr.ndim not in (2, 3):
            out[name] = {c: torch.tensor(np.ascontiguousarray(arr, np.float32),
                                         device=mesh.device(c))
                         for c in local}
            continue
        gshape = (tuple(global_shapes[name]) if global_shapes is not None
                  else (arr.shape[0] * nranks,) + arr.shape[1:])
        blk = process_local_block(mesh, gshape)
        want = tuple(s.stop - s.start for s in blk)
        if arr.shape != want:
            raise ValueError(
                f"{name}: this rank's block is {arr.shape}, but its shards "
                f"of the {gshape} array span {want}"
                + ("" if global_shapes is not None else
                   " (ranks that do not own j-slabs need global_shapes)"))
        njl, nil = gshape[0] // nj, gshape[-1] // ni
        out[name] = {}
        for c in local:
            j0, i0 = c[0] * njl - blk[0].start, c[1] * nil - blk[-1].start
            piece = arr[j0:j0 + njl, ..., i0:i0 + nil]
            out[name][c] = torch.tensor(
                np.ascontiguousarray(piece, np.float32), device=mesh.device(c))
    return out


# --------------------------------------------------------------------------
# The transport: point-to-point messages and the all-gather of blocks
# --------------------------------------------------------------------------
def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _host_buffer(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _sync(tensors) -> None:
    """Wait for the queued device-to-host copies into staged buffers."""
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


def p2p(mesh: Mesh, outgoing, incoming) -> None:
    """One batch of point-to-point messages between this rank and others,
    as one ``dist.batch_isend_irecv``: ``outgoing`` lists ``(rank, tag,
    tensor)`` to send and ``incoming`` ``(rank, tag, tensor)`` to fill,
    each in the order both ends enumerate them (tags count the messages of
    the batch, so two messages between one pair of ranks stay apart).
    Returns when every message has arrived and been copied into its
    tensor (on a CUDA device: queued on its current stream).

    NCCL ignores the tags: it pairs the messages between two ranks in the
    order they are posted.  Both ends list them in one order (the mesh's
    exchange plan), so the k-th send to a rank meets that rank's k-th
    receive under either transport."""
    if not (outgoing or incoming):
        return
    sends = []
    for _, _, x in outgoing:
        x = x.contiguous()
        if _staged(mesh, x):
            x = _host_buffer(x).copy_(x, non_blocking=True)
        sends.append(x)
    _sync([x for _, _, x in outgoing if _staged(mesh, x)])
    recvs = [_host_buffer(x) if _staged(mesh, x)
             else x if x.is_contiguous() else torch.empty_like(
                 x, memory_format=torch.contiguous_format)
             for _, _, x in incoming]
    ops = ([dist.P2POp(dist.isend, buf, r, tag=tag)
            for (r, tag, _), buf in zip(outgoing, sends)]
           + [dist.P2POp(dist.irecv, buf, r, tag=tag)
              for (r, tag, _), buf in zip(incoming, recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for (_, _, dst), buf in zip(incoming, recvs):
        if buf is not dst:
            dst.copy_(buf, non_blocking=True)


def all_gather_blocks(mesh: Mesh, blocks: dict, device) -> dict:
    """Every shard's block of a field on every rank: ``blocks`` holds this
    rank's (one shape for all), the result every shard's, keyed alike, on
    ``device``.  One all-gather of each rank's blocks stacked in shard
    order (padded to the most any rank holds).  The loops read back here,
    so this is where a timed-out wait of the mailbox exchange raises."""
    for box in list(mesh.mailboxes.values()):
        box.raise_if_failed()
    device = torch.device(device)
    local = mesh.local_coords()
    rank, size = mesh.rank, _world()[1]
    by_rank = [[c for c in mesh.coords() if mesh.owner(c) == r]
               for r in range(size)]
    most = max(len(cs) for cs in by_rank)
    first = blocks[local[0]]
    mine = torch.stack([blocks[c].to(device) for c in local]
                       + [torch.zeros_like(first, device=device)]
                       * (most - len(local)))
    staged = _staged(mesh, mine)
    if staged:
        on_device, mine = mine, _host_buffer(mine).copy_(mine,
                                                         non_blocking=True)
        _sync([on_device])
    parts = [_host_buffer(mine) if staged else torch.empty_like(mine)
             for _ in range(size)]
    dist.all_gather(parts, mine)
    out = {}
    for r, cs in enumerate(by_rank):
        part = parts[r].to(device, non_blocking=True) if staged else parts[r]
        for k, c in enumerate(cs):
            out[c] = blocks[c] if r == rank else part[k]
    return out


# --------------------------------------------------------------------------
# The mailboxes of the cross-process rdma exchange
# --------------------------------------------------------------------------
def share_mailbox(mesh: Mesh, buf: torch.Tensor, peers) -> dict:
    """Map this rank's mailbox ``buf`` (a CUDA tensor that lives as long as
    the mesh) into the processes of ``peers`` (the ranks it exchanges
    with), and theirs into this one: ``{rank: that rank's mailbox}``, each
    a tensor on its owner's device whose memory is the owner's.  Every rank
    calls this at the same point (one object all-gather over every rank,
    on the gloo group that names the devices).  The handles are torch's
    own CUDA IPC handles (``reduce_tensor``), which carry the allocation's
    offset and keep the owner's block alive while a peer maps it."""
    from torch.multiprocessing.reductions import reduce_tensor

    peers = sorted(int(r) for r in peers)
    rank, size = _world()
    every = [None] * size
    dist.all_gather_object(every, (reduce_tensor(buf), peers),
                           group=_naming_group())
    out = {}
    for r in peers:
        (rebuild, args), theirs = every[r]
        if rank not in theirs:
            raise RuntimeError(f"rank {rank} exchanges with rank {r}, which "
                               f"names only {theirs}: the ranks disagree on "
                               "the mesh")
        out[r] = rebuild(*args)
    return out


def close_mailboxes(mesh: Mesh) -> None:
    """Drop this rank's mailboxes and its mappings of its peers' (after a
    last check of their error words).  Call it on every rank before the
    process group ends, so that no rank exits while a peer still maps its
    memory."""
    boxes = list(mesh.mailboxes.values())
    mesh.mailboxes.clear()
    for box in boxes:
        box.raise_if_failed()
