"""The trace reduction and the metric readers, on synthetic records."""

import pytest

from wrfbench_tiny import REPO, cfg_of, mix_of

from wrfbench import trace, yardstick
from wrfbench.record import RunRecord
from wrfbench.run import Spec

K1 = "void wrfk1::advance_mu_t_kernel<true>(Args)"


def _events():
    ann = "user_annotation"
    ev = [{"cat": ann, "name": "wrfbench.traced_call", "ts": 0, "dur": 100},
          {"cat": ann, "name": "wrfbench.step", "ts": 1, "dur": 60},
          {"cat": ann, "name": "wrfbench.readback", "ts": 61, "dur": 39},
          {"cat": ann, "name": "wrfbench.traced_call", "ts": 100, "dur": 100},
          {"cat": ann, "name": "wrfbench.step", "ts": 101, "dur": 60},
          {"cat": ann, "name": "wrfbench.readback", "ts": 161, "dur": 39}]
    for base in (0, 100):
        ev += [{"cat": "kernel", "name": K1, "ts": base + 10, "dur": 30},
               {"cat": "kernel", "name": "fill", "ts": base + 30, "dur": 20},
               {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": base + 80,
                "dur": 5}]
    ev.append({"cat": "kernel", "name": K1, "ts": 500, "dur": 9})  # outside
    return ev


def _run(tr):
    cfg = cfg_of("conus12km")
    return RunRecord(cfg=cfg, traffic=mix_of(), setup_s=3.0, window_s=2.0,
                     steps=400, step_s=[0.005] * 400,
                     program_peak_bytes=2**31, trace=tr)


def test_reduce():
    tr = trace.reduce(_events(), steps=2)
    assert tr.calls == 2 and tr.window_us == 200
    assert len(tr.device) == 6
    # busy: [10, 50) and [80, 85) per call
    assert tr.busy_us == pytest.approx(2 * 45)
    assert tr.idle_by_span == pytest.approx({
        "wrfbench.step": 60, "wrfbench.readback": 40,
        "wrfbench.traced_call": 10})
    assert sum(tr.idle_by_span.values()) == pytest.approx(200 - 90)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][1] == pytest.approx(60e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers():
    spec = Spec(REPO)
    run = _run(trace.reduce(_events(), steps=2))
    val = {m["name"]: spec.reader(m["name"])(run)
           for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    assert val["step_ms"] == pytest.approx(5.0)
    assert val["step_ms_p95"] == pytest.approx(5.0)
    assert val["setup_s"] == 3.0
    assert val["launches_per_step"] == 3
    assert val["other_kernels_ms"] == pytest.approx(25e-3)
    # busy 45 us a step against the untraced 5 ms
    assert val["device_idle_pct"] == pytest.approx(100 * (1 - 45e-6 / 5e-3))
    assert val["peak_mem_gib"] == 2.0
    least = yardstick.bound_s(*yardstick.k1_work(run.cfg, run.traffic))
    assert val["k1_roofline_pct"] == pytest.approx(100 * least / 30e-6)
    step = yardstick.bound_s(*yardstick.step_work(run.cfg, run.traffic))
    assert val["step_mfu_pct"] == pytest.approx(100 * step / 5e-3)


def test_device_readers_read_nothing_off_the_card():
    spec = Spec(REPO)
    run = _run(None)
    run.program_peak_bytes = None
    for m in spec.bench["per_layer"]:
        assert spec.reader(m["name"])(run) is None, m["name"]


def test_yardstick_counts_follow_the_grid_not_the_kernels():
    cfg, mix = cfg_of("conus2p5km"), mix_of()
    assert yardstick.k1_forms(cfg, mix) == {"scan": 4, "final": 3}
    # blocking moves K1's launches but not the step's work
    blocked = dict(mix, inner_steps=2)
    assert yardstick.k1_forms(cfg, blocked) == {"scan": 2, "final": 3}
    assert yardstick.step_work(cfg, blocked) == yardstick.step_work(cfg, mix)
    b, ops = yardstick.step_work(cfg, mix)
    # memory-bound: the bytes set the bound
    assert b / yardstick.PEAK_BYTES_PER_S > 10 * ops / yardstick.PEAK_FLOP_PER_S


def test_reduce_puts_a_gap_on_the_innermost_span():
    ann = "user_annotation"
    ev = [{"cat": ann, "name": "wrfbench.traced_call", "ts": 0, "dur": 100},
          {"cat": ann, "name": "wrfbench.multi_step", "ts": 1, "dur": 90},
          {"cat": ann, "name": "wrfbench.inner", "ts": 20, "dur": 30},
          {"cat": "kernel", "name": K1, "ts": 0, "dur": 20},
          {"cat": "kernel", "name": K1, "ts": 60, "dur": 40}]
    tr = trace.reduce(ev, steps=1)
    # the gap [20, 60): opened inside wrfbench.inner, which sits inside
    # wrfbench.multi_step
    assert tr.idle_by_span == {"wrfbench.inner": 40}


def _two_cards():
    """The synthetic call of :func:`_events` on card 0, and on card 1 a
    K1 twice as long and one fill."""
    ev = _events()
    for e in ev:
        if e["cat"] != "user_annotation":
            e["args"] = {"device": 0}
    for base in (0, 100):
        ev += [{"cat": "kernel", "name": K1, "ts": base + 10, "dur": 60,
                "args": {"device": 1}},
               {"cat": "kernel", "name": "fill", "ts": base + 70, "dur": 10,
                "args": {"device": 1}}]
    return ev


def test_reduce_keeps_each_card():
    tr = trace.reduce(_two_cards(), steps=2, n_cards=2)
    assert tr.busy_by_card == pytest.approx({0: 90, 1: 140})
    assert tr.busy_us == pytest.approx(115)
    assert {r[3] for r in tr.device} == {0, 1}
    assert tr.kernels(1) == {K1: (2, 120.0), "fill": (2, 20.0)}
    # card 1 idles [0, 10), [80, 110), [180, 200): its share is half of it
    assert sum(tr.idle_by_span.values()) == pytest.approx(
        ((200 - 90) + (200 - 140)) / 2)
    # a card of the run with no record is idle all through
    tr3 = trace.reduce(_two_cards(), steps=2, n_cards=3)
    assert tr3.busy_us == pytest.approx(230 / 3)


def test_readers_over_cards():
    spec = Spec(REPO)
    run = _run(trace.reduce(_two_cards(), steps=2, n_cards=2))
    run.chips = 2
    val = {m["name"]: spec.reader(m["name"])(run)
           for m in spec.bench["per_layer"]}
    least = yardstick.bound_s(*yardstick.k1_work(run.cfg, run.traffic))
    # the work over two cards' peaks, against the slower card's K1
    assert val["k1_roofline_pct"] == pytest.approx(100 * least / 2 / 60e-6)
    step = yardstick.bound_s(*yardstick.step_work(run.cfg, run.traffic))
    assert val["step_mfu_pct"] == pytest.approx(100 * step / 2 / 5e-3)
    assert val["device_idle_pct"] == pytest.approx(
        100 * (1 - 57.5e-6 / 5e-3))
    assert val["other_kernels_ms"] == pytest.approx(25e-3)
    assert val["launches_per_step"] == 5
