"""The traced run: a ``torch.profiler`` window of steady calls, reduced once.

:func:`profile` runs ``n`` calls of the program under the profiler, each in
a ``wrfbench.traced_call`` span with the program's own calls in
``wrfbench.<call>`` spans inside (``program.ClosedStep.step``), exports
the Chrome trace to a temporary file and reduces it (:func:`reduce`):

* the traced window: the first span's start to the last span's end, on the
  host clock of the trace (every call ends in a readback, so the device's
  work of a call lies inside its span);
* the device records inside it (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), one per kernel launch, copy or fill the host made, each
  with the card it ran on;
* each card's busy time, the union of its records, and their mean over
  the run's cards;
* each card's idle gaps, each put to the innermost ``wrfbench.*`` span the
  host was in when the gap opened (``wrfbench.traced_call`` where it was
  in none of the program's), averaged over the cards.

The per-layer metrics (``wrfbench/metrics/``) read the :class:`Trace`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile

import torch
from torch.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "wrfbench.traced_call"


@dataclasses.dataclass
class Trace:
    calls: int                  # traced calls
    steps: int                  # large steps in them
    window_us: float
    busy_us: float              # the mean over the run's cards
    #: (name, start us, duration us, card) of every device record in the
    #: window
    device: list
    #: idle us by the innermost wrfbench span the host was in, the mean
    #: over the run's cards
    idle_by_span: dict
    #: busy us of each of the run's cards, by its index
    busy_by_card: dict = dataclasses.field(default_factory=dict)

    def kernels(self, card=None) -> dict[str, tuple[int, float]]:
        """``{name: (records, us)}`` over every card, or on ``card``."""
        out = {}
        for name, _, dur, dev in self.device:
            if card is not None and dev != card:
                continue
            n, us = out.get(name, (0, 0.0))
            out[name] = (n + 1, us + dur)
        return out


def profile(program, state, n: int, cards=()):
    """``n`` traced calls of ``program`` from ``state``, the device records
    of ``cards`` (CUDA devices) with them; returns the state after them and
    the reduced :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cards:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            with record_function(CALL_SPAN):
                state, _ = program.step(state, spans=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return state, reduce(events, n * program.steps_per_call, len(cards))


def _card(e: dict) -> int:
    """The card of a device record: its ``device`` argument."""
    return e.get("args", {}).get("device", 0)


def reduce(events: list, steps: int, n_cards: int = 1) -> Trace:
    """A :class:`Trace` from Chrome trace events of a run on ``n_cards``
    cards (each card as the records name it; a card of the run that no
    record names was idle throughout)."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("wrfbench.")]
    calls = [e for e in spans if e["name"] == CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no traced call")
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    dev = sorted(((e["name"], float(e["ts"]), float(e["dur"]), _card(e))
                  for e in events if e.get("cat") in DEVICE_CATS
                  and lo <= e["ts"] <= hi), key=lambda r: r[1])
    cards = sorted({r[3] for r in dev})
    cards += [None] * (max(n_cards, 1) - len(cards))
    busy_by_card, idle = {}, {}
    for card in cards:
        busy, end = 0.0, lo
        gaps = []
        for _, ts, dur, d in dev:
            if d != card:
                continue
            if ts > end:
                gaps.append((end, ts - end))
            busy += max(0.0, ts + dur - max(ts, end))
            end = max(end, ts + dur)
        if hi > end:
            gaps.append((end, hi - end))
        if card is not None:
            busy_by_card[card] = busy
        for start, length in gaps:
            held = [e for e in spans
                    if e["ts"] <= start < e["ts"] + e["dur"]]
            # the innermost: the latest to open, the shortest of those
            name = (max(held, key=lambda e: (e["ts"], -e["dur"]))["name"]
                    if held else "between calls")
            idle[name] = idle.get(name, 0.0) + length / len(cards)
    return Trace(calls=len(calls), steps=steps, window_us=hi - lo,
                 busy_us=sum(busy_by_card.values()) / len(cards), device=dev,
                 idle_by_span=idle, busy_by_card=busy_by_card)


def short_name(name: str) -> str:
    """A device record's name without ``void`` and the library's
    namespaces, cut to 96 characters."""
    name = re.sub(r"\bvoid |at::native::|\(anonymous namespace\)::|std::",
                  "", name)
    return name[:96]


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the ten spans the
    host was in during the longest idle time, in seconds over the traced
    window."""
    ops = {}
    for name, (_, us) in tr.kernels().items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + us
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
