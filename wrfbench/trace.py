"""The traced run: a ``torch.profiler`` window of steady calls, reduced once.

:func:`profile` runs ``n`` calls of the program under the profiler, each in
a ``wrfbench.traced_call`` span with the program's own calls in
``wrfbench.<call>`` spans inside (``program.ClosedStep.step``), exports
the Chrome trace to a temporary file and reduces it (:func:`reduce`):

* the traced window: the first span's start to the last span's end, on the
  host clock of the trace (every call ends in a readback, so the device's
  work of a call lies inside its span);
* the device records inside it (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), one per kernel launch, copy or fill the host made;
* the busy time, the union of those records;
* the device's idle gaps, each put to the innermost ``wrfbench.*`` span the
  host was in when the gap opened (``wrfbench.traced_call`` where it was
  in none of the program's).

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
    busy_us: float
    #: (name, start us, duration us) of every device record in the window
    device: list
    #: idle us by the innermost wrfbench span the host was in
    idle_by_span: dict

    def kernels(self) -> dict[str, tuple[int, float]]:
        """``{name: (records, us)}``."""
        out = {}
        for name, _, dur in self.device:
            n, us = out.get(name, (0, 0.0))
            out[name] = (n + 1, us + dur)
        return out


def profile(program, state, n: int, device):
    """``n`` traced calls of ``program`` from ``state``; returns the state
    after them and the reduced :class:`Trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
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
    return state, reduce(events, n * program.steps_per_call)


def reduce(events: list, steps: int) -> Trace:
    """A :class:`Trace` from Chrome trace events."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("wrfbench.")]
    calls = [e for e in spans if e["name"] == CALL_SPAN]
    if not calls:
        raise ValueError("the trace holds no traced call")
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    dev = sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                  for e in events if e.get("cat") in DEVICE_CATS
                  and lo <= e["ts"] <= hi), key=lambda r: r[1])
    busy, end = 0.0, lo
    gaps = []
    for _, ts, dur in dev:
        if ts > end:
            gaps.append((end, ts - end))
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    if hi > end:
        gaps.append((end, hi - end))
    inner = sorted((e for e in spans if e["name"] != CALL_SPAN),
                   key=lambda e: e["ts"])
    idle = {}
    for start, length in gaps:
        name = next((e["name"] for e in inner + calls
                     if e["ts"] <= start < e["ts"] + e["dur"]), "between calls")
        idle[name] = idle.get(name, 0.0) + length
    return Trace(calls=len(calls), steps=steps, window_us=hi - lo,
                 busy_us=busy, device=dev, idle_by_span=idle)


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
