"""merge_ms: device ms per large step in folding the step's outputs back
into the state (the program's ``wrf.rk3.merge`` span)."""

from wrfbench import spans


def read(run):
    return spans.per_step(run, ["wrf.rk3.merge"], "device_ms")
