"""The check: a sound run comes out correct, and the control and every
fault a closed step can have come out not correct.  The harness's look for
a card is skipped; the rest of a run is driven on the CPU, with the timed
path broken underneath."""

import time

import pytest
import torch

from wrfbench_tiny import tiny_checkout

from wrfbench.check import FAULTS, Control, Fault
from wrfbench.program import ClosedStep
from wrfbench.run import run_cell

torch.set_num_threads(2)


def _run(root, make_program=None):
    return run_cell(root, "tiny.step", 123456789012, 0.3, False, "cpu",
                    time.perf_counter(), make_program=make_program)


def test_sound_run_is_correct(tmp_path):
    res = _run(tiny_checkout(tmp_path))
    assert res["correct"] is True, res["compared"]


def test_control_is_not_correct(tmp_path):
    res = _run(tiny_checkout(tmp_path), Control)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("kind", FAULTS)
def test_fault_is_not_correct(tmp_path, kind):
    def make(cfg, mix, host, devices):
        return Fault(ClosedStep(cfg, mix, host, devices), kind)

    res = _run(tiny_checkout(tmp_path), make)
    assert res["correct"] is False, res["compared"]
    # the window's sample catches it, not only the first step
    assert (res["compared"]["window_err"]["value"]
            > res["compared"]["window_err"]["limit"])
