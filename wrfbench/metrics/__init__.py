"""One reader per metric, found by the metric's name in ``BENCHMARK.json``.

Each file ``<name>.py`` holds ``read(run) -> float | None``: the metric of
a finished run (:class:`wrfbench.record.RunRecord`), or None where the run
has nothing for it to read (the harness then leaves the metric out).  A
reader of a device metric never returns a number from a run without a
device trace.
"""
