"""The frozen traffic model equals the program's at the cells' shapes."""

import dataclasses

import pytest

from wrfbench_tiny import cfg_of

from wrf_tpu_torch.utils import traffic as program
from wrfbench import traffic as frozen
from wrfbench.inputs import grid


def test_tables_equal():
    assert frozen.STREAMS == program.STREAMS
    assert frozen.W_STREAMS == program.W_STREAMS
    assert frozen.BF16_NARROWED == program.BF16_NARROWED
    assert frozen.OPS_PER_CELL == program.OPS_PER_CELL


@pytest.mark.parametrize("name", ["conus2p5km", "conus12km"])
def test_bytes_equal(name):
    nx, ny, nz = grid(cfg_of(name))
    block = frozen.padded_block(nx, ny, nz)
    assert block == program.padded_block(nx, ny, nz)
    for form in frozen.STREAMS:
        for with_w in (False, True):
            for bf16 in (False, True) if form in frozen.BF16_NARROWED else (False,):
                assert (frozen.stream_bytes(form, block, with_w=with_w,
                                            bf16=bf16)
                        == program.stream_bytes(form, block, with_w=with_w,
                                                bf16=bf16))
    for coupled, with_w, S in ((True, False, 1), (True, True, 1),
                               (False, False, 1), (False, False, 8)):
        a = frozen.substep_traffic(nx, ny, nz, coupled=coupled,
                                   with_w=with_w, S=S)
        b = program.substep_traffic(nx, ny, nz, coupled=coupled,
                                    with_w=with_w, S=S)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
