"""host_issue_ms: host ms per large step the program takes to issue a
step, profiler on: its ``wrf.rk3.step``, ``wrf.rk3.merge`` and
``wrf.closure.damp`` spans (the readback is the harness's).  Compare with
the untraced ``step_ms``: while this is the smaller, the card and not the
host sets the pace, even with the profiler's cost on the host."""

from wrfbench import spans


def read(run):
    return spans.per_step(
        run, ["wrf.rk3.step", "wrf.rk3.merge", "wrf.closure.damp"], "host_ms")
