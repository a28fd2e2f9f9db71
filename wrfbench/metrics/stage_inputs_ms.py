"""stage_inputs_ms: device ms per large step in the stages' inputs, from
after the pad to the first launch (the program's ``wrf.loop.inputs``
spans: the carried state's start, the lean constants, the casts)."""

from wrfbench import spans


def read(run):
    return spans.per_step(run, ["wrf.loop.inputs"], "device_ms")
