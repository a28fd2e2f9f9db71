"""substeps_ms: device ms per large step in the stages' substep launches
and their halo refreshes, the final launch included (the program's
``wrf.loop.substeps`` spans)."""

from wrfbench import spans


def read(run):
    return spans.per_step(run, ["wrf.loop.substeps"], "device_ms")
