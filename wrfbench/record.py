"""What a finished run hands the metric readers."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RunRecord:
    cfg: dict                   # the configuration file
    traffic: dict               # the traffic mix file
    setup_s: float
    window_s: float
    steps: int                  # large steps completed in the window
    step_s: list                # seconds of each large step in the window
    #: the fullest card's peak over set-up and warm-up; None off the card
    program_peak_bytes: int | None
    chips: int = 1              # the cards the run's program uses
    trace: object = None        # wrfbench.trace.Trace of a --trace 1 run
