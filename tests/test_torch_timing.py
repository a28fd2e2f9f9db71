"""The port's timing utilities against the JAX package's
(``wrf_tpu.utils.timing``): the same counts, the same arithmetic under one
fake clock, and a ``torch.profiler`` trace written where it is asked to go."""

import json
import tempfile
import time

import pytest
import torch

from wrf_tpu.utils import timing as jax_timing
from wrf_tpu_torch.utils import timing

torch.set_num_threads(1)


@pytest.mark.parametrize("n1,n2,min_passes", [
    (50, 250, 8), (65, 257, 8), (129, 513, 8), (9, 33, 8), (20, 100, 3),
    (1, 2, 1)])
def test_blocked_counts_match_jax(n1, n2, min_passes):
    for S in range(1, 97):
        assert timing.blocked_counts(S, n1, n2, min_passes) == \
            jax_timing.blocked_counts(S, n1, n2, min_passes), S
    assert timing.blocked_counts(8) == jax_timing.blocked_counts(8)


class FakeClock:
    """``time.perf_counter`` that only moves when a timed callable runs:
    ``work(n)`` advances it by a fixed cost plus a cost per step, with a
    jitter that repeats every few calls, so best-of-N has work to do."""

    def __init__(self):
        self.now = 0.0
        self.calls = 0

    def __call__(self):
        return self.now

    def work(self, n):
        self.calls += 1
        self.now += 0.0125 + 0.00037 * n + 0.0031 * (self.calls % 3)


def _results(module, clock):
    clock.now, clock.calls = 0.0, 0

    def make_fn(n):
        return lambda: clock.work(n)

    return (module.timed(make_fn(7)), module.timed(make_fn(7), repeats=9),
            module.per_step_time(make_fn),
            module.per_step_time(make_fn, n1=20, n2=100, repeats=12),
            clock.calls)


def test_timed_and_per_step_time_match_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    assert jax_timing.time.perf_counter is clock   # one clock for both
    assert timing.time.perf_counter is clock
    want = _results(jax_timing, clock)
    got = _results(timing, clock)
    assert got == want
    # the marginal is the per-step cost; warm-up + repeats calls each
    assert got[2] == pytest.approx(0.00037, rel=1e-9)
    assert got[4] == 5 + 10 + 2 * 5 + 2 * 13


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "tr"
    with timing.trace(str(log_dir)) as d:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(log_dir) and float(y[0, 0]) == 64.0
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with timing.trace(str(log_dir)):
        torch.ones(3).sum()
    assert len(list(log_dir.glob("trace_*.json"))) == 2


def test_trace_default_goes_to_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with timing.trace() as d:
        torch.ones(3).sum()
    assert d == str(tmp_path / "wrf_tpu_trace")
    assert list((tmp_path / "wrf_tpu_trace").glob("trace_*.json"))
