"""The plain reference against the port's plain path (the kernels' plain
PyTorch versions, which the port holds bit for bit against its CUDA
kernels) over a few closed large steps at a small slice of each
configuration, and the bfloat16 control far from both."""

import pytest
import torch

from wrfbench_tiny import cfg_of, mix_of

from wrfbench import inputs
from wrfbench.check import Control, scaled_error
from wrfbench.program import ClosedStep
from wrfbench.reference import Reference

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["conus2p5km", "conus12km"])
def test_reference_follows_the_program(name):
    cfg = cfg_of(name, e_we=26, e_sn=22, e_vert=12)
    host = {n: x.numpy() for n, x in
            inputs.make_domain(cfg, 77, "cpu").items()}
    prog = ClosedStep(cfg, mix_of(), host, ["cpu"])
    ref = Reference(cfg, host, "cpu")
    state, want = prog.state, ref.initial(host)
    start = {n: x.clone() for n, x in prog.evolved(state).items()}
    for _ in range(4):
        state, _ = prog.step(state)
        want = ref.step(want)
    got = prog.evolved(state)
    errs = scaled_error(got, want)
    assert set(errs) == {"ww", "mu", "t", "t_ave", "u", "v", "w", "pp"}
    assert max(errs.values()) < 2e-5, errs
    # every field moved
    assert all((got[n] - start[n]).abs().max() > 0 for n in got)


def test_control_is_far():
    cfg = cfg_of("conus12km", e_we=26, e_sn=22, e_vert=12)
    host = {n: x.numpy() for n, x in
            inputs.make_domain(cfg, 78, "cpu").items()}
    ctl = Control(cfg, mix_of(), host, ["cpu"])
    ref = Reference(cfg, host, "cpu")
    got, _ = ctl.step(ctl.state)
    errs = scaled_error(got, ref.step(ref.initial(host)))
    assert max(errs.values()) > 1e-3, errs
