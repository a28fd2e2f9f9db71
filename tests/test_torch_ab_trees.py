"""The parent-vs-change timing tool (``wrf_tpu_torch.tools.ab_trees``) on
the CPU: how it reads the rounds' results and summarises them, and what it
refuses.  The rounds themselves need a CUDA card."""

import pytest

from wrf_tpu_torch.tools import ab_trees


def test_leaves_average_reading_lists_and_skip_flags():
    res = {"k1": {"(516, 50, 516) | scan": {"cuda": [0.4, 0.2],
                                             "plain": [7.0]}},
           "k6": {"ceiling": 2900.0, "probe": "ab", "ok": True},
           "slice": {"S=1": {"launches": {"k1": 21},
                             "step_ms": [40.0, 12.0, 10.0]}}}
    got = dict(ab_trees.leaves(res))
    assert got[("k1", "(516, 50, 516) | scan", "cuda")] == pytest.approx(0.3)
    assert got[("k1", "(516, 50, 516) | scan", "plain")] == 7.0
    assert got[("k6", "ceiling")] == 2900.0
    assert ("k6", "ok") not in got and ("k6", "probe") not in got
    assert got[("slice", "S=1", "step_ms")] == pytest.approx(62.0 / 3)


def test_summary_means_per_tree_and_ratio_to_the_first():
    rounds = [("parent", {"card": "H100", "k1": {"scan": [0.4, 0.4]}}),
              ("change", {"card": "H100", "k1": {"scan": [0.2, 0.3]}}),
              ("change", {"card": "H100", "k1": {"scan": [0.3]}}),
              ("parent", {"card": "H100", "k1": {"scan": [0.6]},
                          "slice": {"S=1": {"step_ms": [1.0]}}})]
    lines = ab_trees.summary(rounds, ["parent", "change"])
    assert lines == ["k1 / scan: parent 0.5000, change 0.2750 (0.550x)"]


def test_order_must_name_known_trees(capsys):
    with pytest.raises(SystemExit):
        ab_trees.main(["--tree", "parent=.", "--order", "parent,change",
                       "--out", "unused/ab"])
    assert "unknown trees ['change']" in capsys.readouterr().err


@pytest.mark.parametrize("text,want", [
    ("k3", ["k3"]),
    ("k3,slice", ["k3", "slice"]),
    ("k1,k6,slice", ["k1", "k6", "slice"]),
    ("trace", ["trace"]),
    ("k2", ["k2"]),
    ("k5", ["k5"]),
    ("k2,k5", ["k2", "k5"]),
    ("k7", ["k7"]),
    ("k8", ["k8"]),
    ("k7,k8", ["k7", "k8"]),
    ("k5,mesh", ["k5", "mesh"]),
])
def test_phase_list_accepts_the_known_phases(text, want):
    assert ab_trees.phase_list(text) == want


def test_unknown_phase_is_refused(capsys):
    with pytest.raises(SystemExit):
        ab_trees.main(["--tree", "parent=.", "--order", "parent",
                       "--phases", "k3,k9", "--out", "unused/ab"])
    assert "unknown phases ['k9']" in capsys.readouterr().err


def test_round_lines_give_each_k7_form_and_k8_rung_its_ms():
    res = {"card": "H100",
           "k7": {"130x50x1664 | 4 | 1d": {"ms": 0.05, "host_ms": 0.06,
                                           "bound_by": "bytes"},
                  "130x50x1664 | 4 | 2d ti 128": {"ms": 0.04}},
           "k8": {"d": {"ms": 0.06, "plain_ms": 0.43}},
           "k1": {"scan": {"cuda": [0.31]}}}
    assert ab_trees.round_lines(res) == [
        "k7 / 130x50x1664 | 4 | 1d: 0.0500 ms",
        "k7 / 130x50x1664 | 4 | 2d ti 128: 0.0400 ms",
        "k8 / d: 0.0600 ms"]
    assert ab_trees.round_lines({"card": "H100", "k1": {}}) == []
