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
    ``log_dir``.

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


def grid_points_per_s(nx: int, ny: int, nz: int, step_seconds: float) -> float:
    return nx * ny * nz / step_seconds


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace context for kernel-level inspection: the
    host's activity, and the card's where CUDA is available, written as a
    Chrome trace ``trace_<pid>_<n>.json`` into ``log_dir`` (default
    ``wrf_tpu_trace`` in the temporary directory, ``$TMPDIR`` or
    ``/tmp``).  Yields ``log_dir``."""
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
