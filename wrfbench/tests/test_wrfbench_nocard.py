"""The command fails, and prints no result, where there is no card."""

import subprocess
import sys

import pytest
import torch

from wrfbench_tiny import REPO


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, "-m", "wrfbench.run", "--workload", "conus2p5km.step",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no fallback" in proc.stderr


def test_unknown_cell_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "wrfbench.run", "--workload", "nope.step",
         "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
