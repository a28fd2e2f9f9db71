"""setup_s: process start to the first timed step: imports, loading (or
building) the kernel library, the inputs, ``prepare`` and the warm-up."""


def read(run):
    return run.setup_s
