"""What the stage loops of an RK3 step keep between calls: one memo.

The three stages of an RK3 step restart from one state, and a step's
constants keep their tensors from step to step, so most of what a stage
builds before its first launch was built before: on the fused path a
warm step builds the blocks of the inputs the step changed in stage 1,
and nothing in stages 2 and 3.  The three loops of an
``RK3Integrator`` share one :class:`StageMemo`, which keeps the halo pads
(:meth:`StageMemo.pad`, an entry a field), the lean constants
(:meth:`StageMemo.lean`, an entry a part of :data:`LEAN_PARTS`) and the
w/pp Thomas K-vectors (``thomas``, ``ops/thomas.py::ThomasCache``).

An entry is keyed by plain values and by the identity and ``_version`` of
every block it was built from (weak references: an id is not reused while
its entry can match), and checks each block it built at its stored
``_version``: an in-place write to either is a miss, which drops the entry
before new blocks are built.  K1 writes the state it carries to fresh
buffers, so the blocks it starts from stay as they were and hit in every
stage; the wrappers of K2 and K3, which update their state in place,
mark what they write through device pointers
(``ops/advance_mu_t_cuda.py::mark_in_place``); K5's j halo refresh before
the first substep on a mesh in one process is the one unmarked write, and
it writes the rows the pad wrote.  A hit costs no device work and no host
synchronisation.  ``keep=False`` keeps nothing: a mesh over processes,
whose blocks cannot be keyed here, a self-exchange that writes the halo,
and a cold run, which sets it on a shared memo before its first step.
"""

from __future__ import annotations

import collections
import weakref

from ..ops.advance_mu_t_cuda import (
    lean_dvdxi_const, lean_tconst, lean_vert_flux, lean_ww1_k0,
)
from ..ops.thomas import ThomasCache
from ..parallel.mesh import Mesh
from ..parallel.sharded import pad_local

#: the blocks :meth:`StageMemo.pad` built and reused since import (a
#: shard's 3-D or 2-D block each): ``PADS["built"]``, ``PADS["reused"]``.
#: Read it as a difference around a call, as ``parallel/halo.py::SENT``.
PADS: collections.Counter = collections.Counter()

#: the blocks :meth:`StageMemo.lean` built and reused since import, per
#: part: ``LEAN["built", "tconst"]``, ...  Read it as :data:`PADS`.
LEAN: collections.Counter = collections.Counter()

#: the parts of the lean constants, in the order they are built: each
#: part's function, the padded fields it reads (``vert`` is the part of
#: that name) and the scalars it takes
LEAN_PARTS = (
    ("dvdxi_const", lean_dvdxi_const,
     ("u_1", "v_1", "muu", "muv", "msfuy", "msfvx_inv", "msftx", "msfty"),
     ("rdx", "rdy")),
    ("ww1_k0", lean_ww1_k0, ("ww_1",), ("k0",)),
    ("vert", lean_vert_flux,
     ("ww_1", "t_1", "fnm", "fnp", "rdnw", "msfty"), ("dts", "k0", "k1")),
    ("tconst", lean_tconst, ("ft", "msfty", "vert"), ("dts",)),
)


class _Entry:
    """Blocks built (``out``), with what they were built from: ``key`` and
    each source block by weak reference with its ``_version``, and each
    built block's ``_version`` when stored."""

    __slots__ = ("key", "srcs", "out", "out_versions")

    def __init__(self, key, srcs: dict, out: dict):
        self.key = key
        self.srcs = {c: (weakref.ref(x), x._version) for c, x in srcs.items()}
        self.out = out
        self.out_versions = {c: y._version for c, y in out.items()}

    def holds(self, key, srcs: dict) -> bool:
        if self.key != key or self.srcs.keys() != srcs.keys():
            return False
        for c, x in srcs.items():
            ref, version = self.srcs[c]
            if ref() is not x or x._version != version:
                return False
        return all(y._version == self.out_versions[c]
                   for c, y in self.out.items())


class StageMemo:
    """What the stage loops keep (see the module docstring)."""

    def __init__(self, keep: bool = True):
        self.keep = keep
        self.thomas = ThomasCache()
        self._entries: dict[tuple[str, str], _Entry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def held(self, kind: str) -> dict:
        """The stored blocks of every ``kind`` ("pad" or "lean") entry:
        ``{name: {shard: block}}``."""
        return {n: e.out for (k, n), e in self._entries.items() if k == kind}

    def _lookup(self, kind: str, name: str, key, srcs: dict):
        """The stored blocks of ``(kind, name)`` if they were built from
        ``key`` and ``srcs`` and nothing wrote them since; else None, and
        the old entry is dropped, so that its blocks go first."""
        e = self._entries.get((kind, name))
        if self.keep and e is not None and e.holds(key, srcs):
            return e.out
        self._entries.pop((kind, name), None)
        return None

    def _store(self, kind: str, name: str, key, srcs: dict, out: dict):
        if self.keep:
            self._entries[kind, name] = _Entry(key, srcs, out)

    def pad(self, arrays: dict, mesh: Mesh, j_sh: bool,
            i_sh: bool) -> tuple[dict, int]:
        """``pad_local(arrays, mesh, j_sh, i_sh)`` in new per-shard dicts,
        and the bytes of the blocks this call built.  Every stale entry
        goes before one ``pad_local`` call builds every miss."""
        # the mesh by its layout: a stage loop built without one makes its
        # own 1x1 mesh, and the three stages of an RK3 step share a memo
        setup = (mesh.shape, tuple(map(tuple, mesh.devices)), j_sh, i_sh)
        got, miss = {}, {}
        for n, b in arrays.items():
            if next(iter(b.values())).ndim == 1:
                got[n] = b
            elif (out := self._lookup("pad", n, setup, b)) is not None:
                got[n] = out
                PADS["reused"] += len(out)
            else:
                miss[n] = b
        built = 0
        if miss:
            new = pad_local(miss, mesh, j_sh, i_sh)
            for n in miss:
                got[n] = {c: p[n] for c, p in new.items()}
                self._store("pad", n, setup, miss[n], got[n])
            built = sum(x.nbytes for p in new.values() for x in p.values())
            PADS["built"] += sum(len(p) for p in new.values())
        return ({c: {n: got[n][c] for n in arrays}
                 for c in mesh.local_coords()}, built)

    def lean(self, local: dict, rdx, rdy, dts, k0: int,
             k1: int) -> tuple[dict, int]:
        """``{shard: lean_kwargs(padded, rdx, rdy, dts, k0, k1)}`` for the
        loop's padded per-shard dicts ``local``, part by part in
        :data:`LEAN_PARTS` order (the same torch ops, in the same order, as
        ``lean_constants``: a hit is bit for bit a fresh build), and the
        bytes of the 3-D blocks this call built (0 on a full hit).
        ``tconst`` reads ``vert``, so it misses whenever ``vert`` was
        rebuilt.  No kernel writes the constants."""
        scalars = {"rdx": rdx, "rdy": rdy, "dts": dts, "k0": k0, "k1": k1}
        fields = {c: dict(p) for c, p in local.items()}
        built = 0
        for name, fn, reads, takes in LEAN_PARTS:
            key = tuple(scalars[k] for k in takes)
            srcs = {(c, n): f[n] for c, f in fields.items() for n in reads}
            out = self._lookup("lean", name, key, srcs)
            if out is not None:
                LEAN["reused", name] += len(out)
            else:
                out = {c: fn(**{n: f[n] for n in reads},
                             **{k: scalars[k] for k in takes})
                       for c, f in fields.items()}
                self._store("lean", name, key, srcs, out)
                LEAN["built", name] += len(out)
                built += sum(x.nbytes for x in out.values() if x.ndim == 3)
            for c, f in fields.items():
                f[name] = out[c]
        return ({c: {n: f[n] for n in ("tconst", "dvdxi_const", "ww1_k0")}
                 for c, f in fields.items()}, built)
