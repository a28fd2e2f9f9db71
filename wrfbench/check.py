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
that is not finite reads ``inf``.  Each of the two numbers has its limit in
``wrfbench/limits/<cell>.json``; the run is correct when both are at most
their limits and every call's checksum was finite.

:class:`Control` is the reference computed in bfloat16, put in the
program's place (the control that must come out as not correct), and
:class:`Fault` breaks the program's step underneath the harness in the ways
a step can go wrong: it returns its state unchanged (``unchanged``), it
advances only half of the domain's rows (``half``), or one value of its
answer is altered where it is produced (``altered``).
"""

from __future__ import annotations

import math

import torch

from .reference import EVOLVED, Reference


def field_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|`` (the absolute error where ``want``
    is all zero); ``inf`` where either is not finite."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return math.inf
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err / scale if scale > 0 else err


def scaled_error(got: dict, want: dict) -> dict[str, float]:
    """:func:`field_error` of every evolved field both states hold."""
    return {n: field_error(got[n], want[n]) for n in EVOLVED
            if n in got and n in want}


class Control:
    """The reference in place of the program, in ``dtype`` (bfloat16: the
    precision below the float32 the configuration states)."""

    def __init__(self, cfg, traffic, host_inputs, device,
                 dtype=torch.bfloat16):
        self.ref = Reference(cfg, host_inputs, device, dtype=dtype)
        self.steps_per_call = traffic.get("steps_per_sync", 1)
        self.state = self.ref.initial(host_inputs)

    def step(self, state, spans: bool = False):
        for _ in range(self.steps_per_call):
            state = self.ref.step(state)
        return state, state["t"].float().sum().item()

    def evolved(self, state):
        return state

    def close(self):
        self.ref = self.state = None


FAULTS = ("unchanged", "half", "altered")


class Fault:
    """The program with its step broken in one of :data:`FAULTS`."""

    def __init__(self, program, kind: str):
        if kind not in FAULTS:
            raise ValueError(f"unknown fault {kind!r}")
        self.program, self.kind = program, kind
        self.state = program.state
        self.steps_per_call = program.steps_per_call

    def step(self, state, spans: bool = False):
        if self.kind == "unchanged":
            return state, self.evolved(state)["t"].sum().item()
        new, checksum = self.program.step(state, spans)
        new = dict(new)
        if self.kind == "half":
            # rows from the middle on keep the state the step started from
            for n in EVOLVED:
                if n in new:
                    half = new[n].shape[0] // 2
                    new[n] = torch.cat([new[n][:half], state[n][half:]])
        else:
            t = new["t"].clone()
            j, k, i = (s // 2 for s in t.shape)
            t[j, k, i] += 1e-2 * t.abs().max()
            new["t"] = t
        return new, checksum

    def evolved(self, state):
        return self.program.evolved(state)

    def close(self):
        self.program.close()
