"""What decides ``correct``: the timed path's states against the plain reference.

A run keeps two kinds of the program's answers:

* ``step1``: the state after the first large step, which the reference
  computes from the seeded inputs alone (the start: ``prepare`` and the
  first step of the closed loop);
* ``window``: a sample of the window's calls, drawn from the seed, each
  kept as the state the call started from and the state it produced.  The
  reference follows the program from that start state, since it cannot
  integrate the hundreds of steps before it within a run; the constants,
  the closure's reference state and everything derived from them are its
  own.

Each comparison is the largest scaled error over the evolved fields,
``max|got - want| / max|want|`` per field: :func:`scaled_error`.  A field
that is not finite reads ``inf``.  :func:`call_errors` makes every
comparison of a run block by block (``reference.blocks``), each block on
one of the run's cards in turn, reading the program's answers where they
lie (:func:`region`); both maxima combine over the blocks exactly, so the
scaled error is the whole domain's.  Each of the two numbers has its limit in
``wrfbench/limits/<cell>.json``; the run is correct when both are at most
their limits and every call's checksum was finite.

:class:`Control` is the reference computed in bfloat16, put in the
program's place (the control that must come out as not correct), and
:class:`Fault` breaks the program's step underneath the harness in the ways
a step can go wrong: it returns its state unchanged (``unchanged``), it
advances only half of the domain's rows (``half``), or one value of its
answer is altered where it is produced (``altered``); and on a mesh
(:data:`MESH_FAULTS`), one shard's update is left out (``shard``) or the
halo exchange between the shards is (``exchange``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .inputs import ring_shape
from .reference import EVOLVED, Reference, block_count, blocks, halo_width


def maxima(got: torch.Tensor, want: torch.Tensor):
    """``(max|got - want|, max|want|)`` as floats, or None where either is
    not finite."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return None
    return (got - want).abs().max().item(), want.abs().max().item()


def combined(parts) -> float:
    """The scaled error of a field from the :func:`maxima` of its parts:
    ``max|got - want| / max|want|`` over all of them (the absolute error
    where ``want`` is all zero); ``inf`` where a part is not finite."""
    if any(p is None for p in parts):
        return math.inf
    err, scale = max(p[0] for p in parts), max(p[1] for p in parts)
    return err / scale if scale > 0 else err


def field_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|`` of one whole field."""
    return combined([maxima(got, want)])


def scaled_error(got: dict, want: dict) -> dict[str, float]:
    """:func:`field_error` of every evolved field both states hold."""
    return {n: field_error(got[n], want[n]) for n in EVOLVED
            if n in got and n in want}


def region(x, j0: int, j1: int, i0: int, i1: int, device=None):
    """Rows ``j0:j1`` and columns ``i0:i1`` of a ring-shaped field: a
    tensor (a view), or a mesh's field as the program lays it out, a dict
    of equal blocks keyed ``(jj, ii)`` that tile the field j-major (put
    together on ``device``, default the first block's)."""
    if isinstance(x, torch.Tensor):
        return x[j0:j1, ..., i0:i1]
    first = next(iter(x.values()))
    device = first.device if device is None else device
    nj_loc, ni_loc = first.shape[0], first.shape[-1]
    rows = []
    for jj in range(j0 // nj_loc, (j1 - 1) // nj_loc + 1):
        a = max(j0 - jj * nj_loc, 0)
        b = min(j1 - jj * nj_loc, nj_loc)
        cols = [x[jj, ii][a:b, ..., max(i0 - ii * ni_loc, 0):
                          min(i1 - ii * ni_loc, ni_loc)].to(device)
                for ii in range(i0 // ni_loc, (i1 - 1) // ni_loc + 1)]
        rows.append(torch.cat(cols, dim=-1))
    return torch.cat(rows, dim=0)


def call_errors(cfg, host, calls, steps: int, devices):
    """The scaled errors of each of a run's ``calls``, ``(start, got)``
    pairs of evolved states (``start`` None: the seeded inputs ``host``),
    where the reference follows ``steps`` large steps from ``start``.

    Block by block (``block_count`` blocks of rows), block ``b`` on
    ``devices[b % len(devices)]``: the block's
    reference is built once for every call, and only the block's rows of a
    state are read.  Per field the largest ``|got - want|`` and ``|want|``
    over the blocks, and whether all were finite, give
    ``max|got - want| / max|want|`` of the whole domain."""
    shape = ring_shape(cfg)
    halo = halo_width(cfg, steps)
    parts = [{} for _ in calls]         # per call: field -> [maxima]
    for b, (own, span) in enumerate(blocks(shape, block_count(shape, halo),
                                           halo)):
        dev = devices[b % len(devices)]
        ref = Reference(cfg, host, dev, span=span)
        r0, r1 = own[0] - span[0], own[1] - span[0]    # own rows in span
        for (start, got), fields in zip(calls, parts):
            s = (ref.initial(host) if start is None else
                 ref.state({n: region(start[n], *span, device=dev)
                            for n in EVOLVED}))
            for _ in range(steps):
                s = ref.step(s)
            for n in EVOLVED:
                if n in got:
                    fields.setdefault(n, []).append(maxima(
                        region(got[n], *own, device=dev).to(dev),
                        s[n][r0:r1]))
            del s
        del ref
    return [{n: combined(p) for n, p in fields.items()} for fields in parts]


class Control:
    """The reference in place of the program, in ``dtype`` (bfloat16: the
    precision below the float32 the configuration states).  It steps in
    the check's blocks of rows, block ``b`` on ``devices[b % n]``, and
    keeps its state whole on the first device (one block: the whole
    domain, as the reference steps it)."""

    def __init__(self, cfg, traffic, host_inputs, devices,
                 dtype=torch.bfloat16):
        self.steps_per_call = traffic.get("steps_per_sync", 1)
        shape = ring_shape(cfg)
        halo = halo_width(cfg, self.steps_per_call)
        self.refs = [(own, span, Reference(cfg, host_inputs,
                                           devices[b % len(devices)],
                                           dtype=dtype, span=span))
                     for b, (own, span) in enumerate(
                         blocks(shape, block_count(shape, halo), halo))]
        self.state = {n: torch.as_tensor(np.asarray(host_inputs[n])).to(
            devices[0], dtype) for n in EVOLVED}

    def step(self, state, spans: bool = False):
        new = {n: torch.empty_like(x) for n, x in state.items()}
        for own, span, ref in self.refs:
            s = ref.state({n: region(state[n], *span) for n in EVOLVED})
            for _ in range(self.steps_per_call):
                s = ref.step(s)
            r0, r1 = own[0] - span[0], own[1] - span[0]
            for n in EVOLVED:
                new[n][own[0]:own[1]] = s[n][r0:r1].to(new[n].device)
        return new, new["t"].float().sum().item()

    def evolved(self, state):
        return state

    def close(self):
        self.refs = self.state = None


FAULTS = ("unchanged", "half", "altered")
#: the faults only a program on a mesh can have
MESH_FAULTS = ("shard", "exchange")


def _blocks(x) -> dict:
    """A state's field as blocks keyed ``(jj, ii)``: a tensor is one."""
    return x if isinstance(x, dict) else {(0, 0): x}


def _like(x, blocks: dict):
    """``blocks`` in the layout of the field ``x``."""
    return blocks if isinstance(x, dict) else blocks[0, 0]


class Fault:
    """The program with its step broken in one of :data:`FAULTS` (or, on
    a mesh, :data:`MESH_FAULTS`).  A state's field is a tensor or a mesh's
    dict of blocks (``program.ClosedStep``)."""

    def __init__(self, program, kind: str):
        if kind not in FAULTS + MESH_FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.program, self.kind = program, kind
        self.state = program.state
        self.steps_per_call = program.steps_per_call
        if kind == "exchange":
            # every stage's loop takes its axes for unsharded: zero halos
            # at the shards' edges, no refresh, no exchange in the kernels
            for loop in program.rk3.loops:
                loop._j_sh = loop._i_sh = loop._overlap = False

    def step(self, state, spans: bool = False):
        if self.kind == "unchanged":
            return state, self.program.checksum(state)
        new, checksum = self.program.step(state, spans)
        new = dict(new)
        for n in EVOLVED:
            if n not in new or self.kind not in ("half", "shard"):
                continue
            old, got = _blocks(state[n]), dict(_blocks(new[n]))
            if self.kind == "shard":
                # the first shard keeps the state the step started from
                got[0, 0] = old[0, 0]
            else:
                # rows from the middle on keep the state the step started
                # from
                rows = next(iter(got.values())).shape[0]
                mid = rows * (max(jj for jj, _ in got) + 1) // 2
                for (jj, ii), b in got.items():
                    k = min(max(mid - jj * rows, 0), rows)
                    got[jj, ii] = torch.cat([b[:k], old[jj, ii][k:]])
            new[n] = _like(new[n], got)
        if self.kind == "altered":
            # one value of t, at the middle of the (mesh-padded) field
            got = {c: b.clone() for c, b in _blocks(new["t"]).items()}
            first = next(iter(got.values()))
            rows, _, cols = first.shape
            nj = max(jj for jj, _ in got) + 1
            ni = max(ii for _, ii in got) + 1
            j, i = rows * nj // 2, cols * ni // 2
            top = max(b.abs().max().to(first.device) for b in got.values())
            b = got[j // rows, i // cols]
            b[j % rows, first.shape[1] // 2, i % cols] += (
                1e-2 * top.to(b.device))
            new["t"] = _like(new["t"], got)
        return new, checksum

    def evolved(self, state):
        return self.program.evolved(state)

    def close(self):
        self.program.close()
