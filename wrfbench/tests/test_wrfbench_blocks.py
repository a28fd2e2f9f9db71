"""The blocked reference: a domain stepped in blocks of rows, each block
with its halo, equals the whole-domain reference bit for bit, and the
check's scaled errors combine over the blocks to the whole domain's
exactly."""

import time

import pytest
import torch

from wrfbench_tiny import cfg_of, mix_of, tiny_checkout

from wrfbench import check, inputs, reference
from wrfbench.check import Control
from wrfbench.program import ClosedStep
from wrfbench.reference import EVOLVED, Reference, blocks, halo_width
from wrfbench.run import run_cell

torch.set_num_threads(2)

CFG = cfg_of("conus2p5km", e_we=30, e_sn=26, e_vert=9)


def _whole(host, start, steps):
    ref = Reference(CFG, host, "cpu")
    s = ref.initial(host) if start is None else ref.state(start)
    for _ in range(steps):
        s = ref.step(s)
    return s


@pytest.mark.parametrize("steps", [1, 2])
def test_blocks_equal_the_whole_domain(steps):
    """Four blocks of rows, each stepped alone from the inputs and from an
    evolved state, put together: the whole domain's state, bit for bit."""
    host = inputs.make_host(CFG, 2**35 + 1, "cpu")
    shape = inputs.ring_shape(CFG)
    # a start state that is not the inputs': one whole step on
    start = _whole(host, None, 1)
    halo = halo_width(CFG, steps)
    parts = blocks(shape, 4, halo)
    assert len(parts) == 4
    for first in (None, start):
        want = _whole(host, first, steps)
        got = {n: torch.full_like(want[n], float("nan")) for n in EVOLVED}
        for own, span in parts:
            ref = Reference(CFG, host, "cpu", span=span)
            s = (ref.initial(host) if first is None else
                 ref.state({n: check.region(first[n], *span)
                            for n in EVOLVED}))
            for _ in range(steps):
                s = ref.step(s)
            j0, j1, i0, i1 = own
            for n in EVOLVED:
                got[n][j0:j1, ..., i0:i1] = s[n][
                    j0 - span[0]:j1 - span[0], ..., i0 - span[2]:i1 - span[2]]
        for n in EVOLVED:
            assert torch.equal(got[n], want[n]), n


def test_too_narrow_a_halo_is_caught():
    """The halo is what keeps a block exact: a block with one row less of
    it than a step reaches differs from the whole domain."""
    host = inputs.make_host(CFG, 5, "cpu")
    want = _whole(host, None, 1)
    halo = halo_width(CFG, 1)
    ns = max(n for _, n in reference.rk3_stages(CFG["time_step_sound"]))
    own, span = blocks(inputs.ring_shape(CFG), 3, ns - 1)[1]
    s = Reference(CFG, host, "cpu", span=span).initial(host)
    ref = Reference(CFG, host, "cpu", span=span)
    s = ref.step(s)
    j0, j1 = own[0] - span[0], own[1] - span[0]
    assert not torch.equal(s["t"][j0:j1], want["t"][own[0]:own[1]])
    assert halo > ns - 1


def test_call_errors_combine_exactly(monkeypatch):
    host = inputs.make_host(CFG, 77, "cpu")
    prog = ClosedStep(CFG, mix_of(), host, ["cpu"])
    a, _ = prog.step(prog.state)
    b, _ = prog.step(a)
    calls = [(None, prog.evolved(a)), (prog.evolved(a), prog.evolved(b))]
    whole = check.call_errors(CFG, host, calls, 1, ["cpu"])
    monkeypatch.setattr(reference, "BLOCK_CELLS", 2000)
    assert reference.block_count(inputs.ring_shape(CFG), 7) >= 3
    cut = check.call_errors(CFG, host, calls, 1, ["cpu"] * 2)
    assert whole == cut
    assert whole[0] == check.scaled_error(calls[0][1],
                                          _whole(host, None, 1))
    assert set(whole[1]) == set(EVOLVED)


def test_block_count_follows_the_budget():
    assert reference.block_count((1203, 35, 1503), 7) == 1
    nj = reference.block_count((2244, 101, 2244), 7)
    assert nj == 4
    J, K, I = 2244, 101, 2244
    assert (-(-J // nj) + 14) * K * I <= reference.BLOCK_CELLS


def test_run_in_blocks_gives_the_same_check(tmp_path, monkeypatch):
    root = tiny_checkout(tmp_path)
    whole = run_cell(root, "tiny.step", 9, 0.2, False, "cpu",
                     time.perf_counter())
    monkeypatch.setattr(reference, "BLOCK_CELLS", 1500)
    shape = inputs.ring_shape(cfg_of("conus12km", e_we=24, e_sn=20,
                                     e_vert=10))
    assert reference.block_count(shape, halo_width(CFG, 1)) >= 3
    cut = run_cell(root, "tiny.step", 9, 0.2, False, "cpu",
                   time.perf_counter())
    assert cut["correct"] is True
    assert (cut["compared"]["step1_err"]["value"]
            == whole["compared"]["step1_err"]["value"])


def test_control_in_blocks_equals_the_whole(monkeypatch):
    """The bfloat16 control steps in the same blocks: bit for bit the
    whole-domain control's state and checksum."""
    host = inputs.make_host(CFG, 4, "cpu")
    whole = Control(CFG, mix_of(), host, ["cpu"])
    assert len(whole.refs) == 1
    a, ca = whole.step(whole.state)
    monkeypatch.setattr(reference, "BLOCK_CELLS", 2000)
    cut = Control(CFG, mix_of(), host, ["cpu"] * 2)
    assert len(cut.refs) >= 3
    b, cb = cut.step(cut.state)
    assert ca == cb
    assert all(torch.equal(a[n], b[n]) for n in EVOLVED)
    ref = Reference(CFG, host, "cpu", dtype=torch.bfloat16)
    want = ref.step(ref.initial(host))
    assert all(torch.equal(a[n], want[n]) for n in EVOLVED)
