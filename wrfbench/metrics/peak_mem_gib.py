"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the program's
set-up and warm-up steps (read before the harness holds any state of its
own for the check), in GiB: the fullest of the run's cards."""


def read(run):
    if run.program_peak_bytes is None:
        return None
    return run.program_peak_bytes / 2**30
