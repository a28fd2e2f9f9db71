"""On the card (marked ``cuda``; skips without one): a cell's run at a
reduced grid is correct, its bfloat16 control is not, and the trace's
device metrics are read; a mesh's four shards on the card check as one
shard; the blocked reference is the whole one bit for bit there too.
The cells' own sizes are read by ``python -m wrfbench.control``
(PERF.md)."""

import time

import pytest
import torch

from wrfbench_tiny import cfg_of, tiny_checkout

from wrfbench import inputs
from wrfbench.check import Control
from wrfbench.reference import Reference, blocks, halo_width
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


def test_mesh_on_one_card_checks_as_one_shard(tmp_path, card):
    """``mesh2x2`` with its four shards on one card: correct, the first
    step's error the one-shard cell's to the digit, the trace read."""
    root = tiny_checkout(tmp_path, grid={"e_we": 201, "e_sn": 151,
                                         "e_vert": 35})
    seed = 2**31 + 77
    one = run_cell(root, "tiny.step", seed, 1.0, False, card,
                   time.perf_counter())
    mesh = run_cell(root, "tiny.mesh2x2", seed, 1.0, True, [card] * 4,
                    time.perf_counter())
    assert one["correct"] is True and mesh["correct"] is True
    assert (mesh["compared"]["step1_err"]["value"]
            == one["compared"]["step1_err"]["value"])
    assert 0 < mesh["metrics"]["k1_roofline_pct"]["value"] <= 105


def test_blocks_equal_the_whole_domain_on_the_card(card):
    cfg = cfg_of("conus2p5km", e_we=301, e_sn=251)
    host = inputs.make_host(cfg, 2**31 + 5, card)
    ref = Reference(cfg, host, card)
    want = ref.step(ref.initial(host))
    shape = inputs.ring_shape(cfg)
    for own, span in blocks(shape, 3, halo_width(cfg, 1)):
        r = Reference(cfg, host, card, span=span)
        got = r.step(r.initial(host))
        j0, j1 = own[0] - span[0], own[1] - span[0]
        for n in want:
            assert torch.equal(got[n][j0:j1], want[n][own[0]:own[1]]), n
