"""The program's own spans in a traced run, per large step.

While the profiler of a ``--trace 1`` run records, the program marks its
layers with spans (``wrf_tpu_torch.utils.timing.span``): ``wrf.rk3.step``
(the whole RK3 step), ``wrf.closure.tendency`` (the closure's call before
each stage), ``wrf.loop.pad``, ``wrf.loop.inputs`` and ``wrf.loop.substeps``
(each stage's loop: the halo pad with the bytes it wrote as its count, the
stage's inputs, the substep launches), ``wrf.rk3.merge`` and
``wrf.closure.damp``.  Each holds host ms and device ms, the latter from a
pair of CUDA events on the card's stream.  After the window this module
reads ``span_totals()``, the one program name it uses.

:func:`per_step` is None where the run has no trace, where the program
keeps no spans (a version before them), or where the spans do not cover
the traced steps (``wrf.rk3.step``'s calls differ from the trace's large
steps): a run that missed steps reports nothing rather than a wrong number.
"""

from __future__ import annotations

STEP = "wrf.rk3.step"


def totals(run) -> dict | None:
    """The program's span totals of ``run``'s traced window, or None."""
    if run.trace is None:
        return None
    try:
        from wrf_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "span_totals", None)
    if read is None:
        return None
    tot = read()
    if tot.get(STEP, {}).get("calls") != run.trace.steps:
        return None
    return tot


def per_step(run, names, key: str) -> float | None:
    """``key`` (``host_ms``, ``device_ms`` or ``count``) summed over the
    spans ``names``, per large step of the trace; None where a span is
    missing or has no value (device ms of a run off the card)."""
    tot = totals(run)
    if tot is None:
        return None
    vals = [tot.get(n, {}).get(key) for n in names]
    if any(v is None for v in vals):
        return None
    return sum(vals) / run.trace.steps
