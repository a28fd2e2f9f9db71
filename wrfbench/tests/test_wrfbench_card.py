"""On the card (marked ``cuda``; skips without one): a cell's run at a
reduced grid is correct, its bfloat16 control is not, and the trace's
device metrics are read.  The cells' own sizes are read by
``python -m wrfbench.control`` (PERF.md)."""

import time

import pytest
import torch

from wrfbench_tiny import tiny_checkout

from wrfbench.check import Control
from wrfbench.run import run_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 3 * 2**31 + 13])
def test_program_correct_control_not(tmp_path, card, seed):
    root = tiny_checkout(tmp_path, grid={"e_we": 201, "e_sn": 151,
                                         "e_vert": 35})
    res = run_cell(root, "tiny.step", seed, 1.0, True, card,
                   time.perf_counter())
    assert res["correct"] is True, res["compared"]
    m = res["metrics"]
    assert 0 < m["k1_roofline_pct"]["value"] <= 105
    assert m["launches_per_step"]["value"] > 7
    assert res["device"]["busy_s"] > 0
    ctl = run_cell(root, "tiny.step", seed, 1.0, False, card,
                   time.perf_counter(), make_program=Control)
    assert ctl["correct"] is False, ctl["compared"]
