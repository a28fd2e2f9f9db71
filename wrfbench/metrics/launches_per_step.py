"""launches_per_step: kernel launches, copies and fills per large step.
Counted from the trace's device records, one per call the host made (the
kernel library links its own CUDA runtime, so its launches are counted
where they reach the device); a count, which repeats exactly."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.device) / run.trace.steps
