"""Timing and profiling utilities.

Port of ``wrf_tpu/utils/timing.py``: the same names, defaults and
arithmetic.  The reference instruments with wall-clock timers around the
kernel call only (gettimeofday, advance_mu_t_driver.c:222-245;
system_clock, advance_mu_t_driver.f90:172-214) and reports elapsed ms.
PyTorch's CUDA calls return before the card has finished, so:

  * **synchronised timing** — ``timed`` times a callable that must end in a
    synchronise (``torch.cuda.synchronize()``, or a scalar ``.item()``
    read back from the card), and ``per_step_time`` differences two step
    counts so launch latency, the final synchronise and first-touch effects
    cancel;
  * **profiler hooks** — ``trace`` wraps a block in a ``torch.profiler``
    trace and writes a Chrome trace (``chrome://tracing``, Perfetto) into
    ``log_dir``;
  * **spans** — ``span`` marks a layer of the program (the RK3 step, a
    stage's pad, inputs and substeps, the merge, the closure) while a
    ``torch.profiler`` records, and does nothing otherwise; each finished
    span lands in :data:`SPANS` with its host and device time, and
    ``span_totals`` sums them by name.

A time taken with these on the CPU is the host's; only a run on the card
gives a device number.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function


def timed(fn: Callable[[], float], repeats: int = 4) -> float:
    """Best-of-N wall-clock of ``fn`` (which must synchronize internally,
    e.g. by returning a Python float read back from the device)."""
    fn()  # warm up / build
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def per_step_time(make_fn: Callable[[int], Callable[[], float]],
                  n1: int = 50, n2: int = 250, repeats: int = 4) -> float:
    """Marginal per-step time of a device-resident loop:
    ``(T(n2) - T(n1)) / (n2 - n1)``.  ``make_fn(n)`` returns a synchronized
    callable running n steps."""
    t1 = timed(make_fn(n1), repeats)
    t2 = timed(make_fn(n2), repeats)
    return (t2 - t1) / (n2 - n1)


def blocked_counts(inner_steps: int, n1: int = 50, n2: int = 250,
                   min_passes: int = 8) -> tuple[int, int]:
    """Pass-aligned step counts for the marginal method on a temporally
    blocked loop.

    The blocked loops run ``(n_steps-1)//S`` S-substep passes, then
    ``(n_steps-1) % S`` SINGLE-step substeps, then the final substep
    (``parallel/sharded.py``, ``models/small_step.py``).  If the
    single-step tail differs between the two counts, the marginal blends
    the blocked rate with the single-step rate — at deep S the blend is
    mostly tail: with the default (50, 250), every S in
    {16,24,32,48,64,96} leaves ``200 % S = 8`` extra single substeps
    inside the signal.  The returned counts make ``n-1`` a multiple of S
    on both sides, so the tails are zero, the final substep cancels, and
    the difference is whole blocked passes only.
    """
    S = max(1, int(inner_steps))
    if S == 1:
        return n1, n2
    a1 = S * max(1, round((n1 - 1) / S)) + 1
    # >= min_passes whole passes in the difference: a 2-3 pass signal at
    # deep S sits inside the host clock's noise
    span = S * max(min_passes, round((n2 - n1) / S))
    return a1, a1 + span


#: every finished span since the last ``trace`` opened, in closing order
SPANS: list = []
#: the spans open now, innermost last
_OPEN: list = []
#: what ``span`` returns while no profiler records: one shared no-op
_OFF = contextlib.nullcontext()


class Span:
    """One span of the program: ``name``, the ``parent`` span it opened in
    (None outside any), its ``count`` (None, or a number the caller sets
    inside the block), the host clock at enter and exit (``t0``, ``t1``,
    ``perf_counter_ns``) and, on a CUDA device, a pair of timing events on
    that device's current stream.  Nothing is synchronised or read while a
    span is open: :meth:`device_ms` reads the events afterwards.  A
    finished span keeps only these: every other object it made is freed on
    exit, so a traced step leaves few objects for the garbage collector to
    count (a collection of the whole heap stalls the host for tens of ms)."""

    __slots__ = ("name", "parent", "count", "t0", "t1", "_start", "_end",
                 "_stream", "_rf")

    def __init__(self, name: str, count, device):
        self.name, self.count = name, count
        self.parent = _OPEN[-1] if _OPEN else None
        self.t0 = self.t1 = self._start = self._end = self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
        self._rf = record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        _OPEN.append(self)
        self.t0 = time.perf_counter_ns()
        if self._stream is not None:
            self._start.record(self._stream)
        return self

    def __exit__(self, *exc):
        if self._stream is not None:
            self._end.record(self._stream)
        self.t1 = time.perf_counter_ns()
        _OPEN.pop()
        SPANS.append(self)
        self._rf.__exit__(*exc)
        self._stream = self._rf = None
        return False

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_ms(self) -> float | None:
        """ms on the device's stream between enter and exit (waits for the
        exit event); None for a span that took no events."""
        if self._end is None:
            return None
        self._end.synchronize()
        return self._start.elapsed_time(self._end)


def span(name: str, count=None, device=None):
    """A span named ``name`` around a block of the program, while a
    ``torch.profiler`` records (``trace``, ``run_sim --profile``).

    Off (no profiler recording) it returns one shared no-op context, which
    yields None: no ``record_function``, no event, no allocation.  On, the
    context yields its :class:`Span`: it enters ``record_function(name)``,
    so the span nests in the Chrome trace under the caller's own, on the
    device records' clock; takes the host clock at enter and exit; records
    a pair of CUDA timing events on the current stream of ``device`` where
    that is a CUDA device (none for the CPU), and appends itself to
    :data:`SPANS` on exit.  ``count`` (or ``Span.count``, set inside the
    block) is summed by :func:`span_totals`.  On a mesh of several cards
    the callers pass the first local shard's device, so a span's device
    time is that card's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, count, device)


def span_totals() -> dict[str, dict]:
    """:data:`SPANS` summed by name: ``calls``; ``host_ms``; ``device_ms``
    and ``device_self_ms`` (the span less the part its child spans cover),
    None unless every span of the name took events; ``count``, the sum of
    the counts given.  Waits for the events of every span."""
    dev = {id(s): s.device_ms() for s in SPANS}
    covered = {}
    for s in SPANS:
        if s.parent is not None and dev[id(s)] is not None:
            covered[id(s.parent)] = covered.get(id(s.parent), 0.0) + dev[id(s)]
    out = {}
    for s in SPANS:
        t = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0,
                                    "device_ms": 0.0, "device_self_ms": 0.0,
                                    "count": 0})
        t["calls"] += 1
        t["host_ms"] += s.host_ms()
        t["count"] += s.count or 0
        d = dev[id(s)]
        if d is None or t["device_ms"] is None:
            t["device_ms"] = t["device_self_ms"] = None
        else:
            t["device_ms"] += d
            t["device_self_ms"] += d - covered.get(id(s), 0.0)
    return out


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace context for kernel-level inspection: the
    host's activity, and the card's where CUDA is available, written as a
    Chrome trace ``trace_<pid>_<n>.json`` into ``log_dir`` (default
    ``wrf_tpu_trace`` in the temporary directory, ``$TMPDIR`` or
    ``/tmp``).  Yields ``log_dir``.  Opening it clears :data:`SPANS`, so
    after it they hold the spans of this trace alone."""
    SPANS.clear()
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "wrf_tpu_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
