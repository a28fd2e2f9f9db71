"""pad_ms: device ms per large step in the stages' halo pad (the program's
``wrf.loop.pad`` spans: ``pad_local``, three a step)."""

from wrfbench import spans


def read(run):
    return spans.per_step(run, ["wrf.loop.pad"], "device_ms")
