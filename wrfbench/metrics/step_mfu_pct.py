"""step_mfu_pct: the whole large step's share of the run's cards' peak.
The least time of one large step's algorithmic work (``yardstick.step_work``:
every substep of the three stages and the closure's fields, from the grid
and the path, whatever kernels run), spread over the run's cards
(``chips`` x the card's peaks), over the window's ms per large step."""

from wrfbench import yardstick


def read(run):
    if run.program_peak_bytes is None:     # not run on the card
        return None
    least = yardstick.bound_s(*yardstick.step_work(run.cfg, run.traffic))
    return 100.0 * least / run.chips / (run.window_s / run.steps)
