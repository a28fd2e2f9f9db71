"""k1_roofline_pct: K1's share of its roofline.  The least time of the K1
launches of a large step (``yardstick.k1_work``: the forms the cell's path
launches, from the frozen traffic model), spread over the run's cards
(``chips`` x the card's peaks), over the slowest card's K1 device time
per large step in the trace."""

from wrfbench import yardstick

K1 = "advance_mu_t_kernel"


def read(run):
    if run.trace is None:
        return None
    us = max((sum(us for name, (_, us) in run.trace.kernels(card).items()
                  if K1 in name) for card in run.trace.busy_by_card),
             default=0)
    if not us:
        return None
    least = yardstick.bound_s(*yardstick.k1_work(run.cfg, run.traffic))
    return 100.0 * least / run.chips / (us / 1e6 / run.trace.steps)
