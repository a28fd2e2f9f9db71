"""other_kernels_ms: device ms per large step in every kernel, copy and fill
that is not K1 (the RK3 shell's and the stages' set-up, the closure, the
merge and the readback), from the trace: on the card that spends most."""

from wrfbench.metrics.k1_roofline_pct import K1


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    us = max(sum(us for name, (_, us) in run.trace.kernels(card).items()
                 if K1 not in name) for card in run.trace.busy_by_card)
    return us / 1e3 / run.trace.steps
