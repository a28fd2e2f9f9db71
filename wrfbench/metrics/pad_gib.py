"""pad_gib: GiB per large step of the new blocks the stages' halo pad
writes (the count of the program's ``wrf.loop.pad`` spans, from the
padded shapes); a count, which repeats exactly."""

from wrfbench import spans


def read(run):
    n = spans.per_step(run, ["wrf.loop.pad"], "count")
    return None if n is None else n / 2**30
