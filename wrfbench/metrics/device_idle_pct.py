"""device_idle_pct: the share of a large step in which no kernel, copy or
fill runs on a card, the mean over the run's cards: one less the cards'
mean busy time per large step in the trace (the union of each card's
records) over the untraced window's time per large step.  The traced
calls' own span is not the base: the profiler's host-side recording
stretches it (at 12 km a traced call takes about 2.6 times an untraced
one), while the device records keep their length."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    busy_s = run.trace.busy_us / 1e6 / run.trace.steps
    return 100.0 * (1.0 - busy_s / (run.window_s / run.steps))
