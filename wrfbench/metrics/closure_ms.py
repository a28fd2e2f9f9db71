"""closure_ms: device ms per large step in the nudging closure: its
tendencies before each stage and the wind damping after the merge (the
program's ``wrf.closure.tendency`` and ``wrf.closure.damp`` spans)."""

from wrfbench import spans


def read(run):
    return spans.per_step(run, ["wrf.closure.tendency", "wrf.closure.damp"],
                          "device_ms")
