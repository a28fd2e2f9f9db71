"""step_ms_p95: the 95th percentile of the window's large steps, each timed
on the host clock up to its scalar readback (numpy's linear percentile; a
call of K steps counts K steps of its time / K)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.step_s) * 1e3, 95))
