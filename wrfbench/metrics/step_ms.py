"""step_ms: the window's wall time over the large steps completed in it
(host clock; each call ends in its readback)."""


def read(run):
    return 1e3 * run.window_s / run.steps
