"""The program's spans (``utils/timing.py::span``): nothing while no profiler
records; under a CPU profiler one closed RK3 step with the nudging closure
makes the spans the layers promise, nested as they are called, with the
bytes of the blocks the pad built as its count and the state bit-equal to
an untraced step; the Chrome trace holds them inside the caller's span;
and the benchmark's readers of them (``wrfbench/spans.py``,
``wrfbench/metrics/``) on a fake recorder."""

import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.tendencies import NudgingTendencies
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain, pad_local
from wrf_tpu_torch.utils import timing
from wrfbench import spans as bench_spans
from wrfbench.run import ROOT, Spec

torch.set_num_threads(1)

#: spans a closed large step makes, and how many of each
PER_STEP = {"wrf.rk3.step": 1, "wrf.closure.tendency": 3, "wrf.loop.pad": 3,
            "wrf.loop.inputs": 3, "wrf.loop.substeps": 3, "wrf.rk3.merge": 1,
            "wrf.closure.damp": 1}
#: each span's parent in a step run from the top level
PARENT = {"wrf.rk3.step": None, "wrf.closure.tendency": "wrf.rk3.step",
          "wrf.loop.pad": "wrf.rk3.step", "wrf.loop.inputs": "wrf.rk3.step",
          "wrf.loop.substeps": "wrf.rk3.step", "wrf.rk3.merge": None,
          "wrf.closure.damp": None}

#: (kernel, inner_steps, mesh shape): the fused path, the blocked path
#: (K3 blocks and K1 substeps in one call), the eager path, a 2x2 mesh
PATHS = [("cuda", 1, None), ("cuda", 2, None), ("eager", 1, None),
         ("cuda", 1, (2, 2))]


@pytest.fixture(scope="module")
def case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)


@pytest.fixture(autouse=True)
def no_spans():
    timing.SPANS.clear()
    yield
    timing.SPANS.clear()


def _integrator(case, kernel, inner, shape):
    b = case.bounds
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape) if shape else None
    return RK3Integrator(b.ide, b.jde, b.kdim, case.flags, acoustic_steps=6,
                         kernel=kernel, snapshot="base", device="cpu",
                         inner_steps=inner, with_w=True,
                         smdiv=0.1 if inner == 1 else 0.0, mesh=mesh)


def _closed_step(case, rk3, steps=1):
    """run_sim's loop body: step with the closure, merge, wind damping."""
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    for _ in range(steps):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
    return rk3.unprepare(arrays, [n for n in rk3._EVOLVED if n in arrays])


def _traced_step(case, path):
    rk3 = _integrator(case, *path)
    with profile(activities=[ProfilerActivity.CPU]):
        state = _closed_step(case, rk3)
    return rk3, state, list(timing.SPANS)


def test_off_records_nothing_and_enters_no_record_function(case,
                                                          monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(timing, "record_function", refuse)
    assert timing.span("a") is timing.span("b", count=3, device="cpu")
    with timing.span("a") as sp:
        assert sp is None
    _closed_step(case, _integrator(case, "cuda", 1, None))
    assert timing.SPANS == [] and timing._OPEN == []


@pytest.mark.parametrize("path", PATHS)
def test_span_names_and_calls_per_step(case, path):
    _, _, made = _traced_step(case, path)
    calls = {}
    for s in made:
        calls[s.name] = calls.get(s.name, 0) + 1
    assert calls == PER_STEP
    assert timing._OPEN == []


@pytest.mark.parametrize("path", PATHS)
def test_span_parents(case, path):
    _, _, made = _traced_step(case, path)
    for s in made:
        assert (s.parent.name if s.parent else None) == PARENT[s.name], s.name
        assert s.t1 >= s.t0 and s.device_ms() is None   # no events off CUDA
    step = next(s for s in made if s.name == "wrf.rk3.step")
    inside = [s for s in made if s.parent is step]
    assert all(step.t0 <= s.t0 and s.t1 <= step.t1 for s in inside)


#: the inputs a closed step gives new tensors: the evolved state and the
#: closure's tendencies
CHANGED = ("ww", "u", "v", "t", "t_ave", "w", "pp", "ft", "mu", "mu_tend")
#: what stages 2 and 3 pad again, by path: K1 writes the state it carries
#: to fresh buffers and K3 works on its own copies, so nothing, but on the
#: mesh, where the first substep refreshes mu's and v's halos in place
REPADS = {PATHS[0]: ((), ()),
          PATHS[1]: ((), ()),
          PATHS[2]: ((), ()),
          PATHS[3]: (("mu", "v"), ("mu", "v"))}


@pytest.mark.parametrize("path", PATHS)
def test_pad_count_is_the_bytes_pad_local_writes(case, path):
    """The count is the bytes of the blocks the pad built: every block at a
    step's first stage, then only what the memo could not give back."""
    rk3 = _integrator(case, *path)
    with profile(activities=[ProfilerActivity.CPU]):
        _closed_step(case, rk3, steps=2)
    made = list(timing.SPANS)
    loop = rk3.loops[0]
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    blocks = {n: arrays[n] if loop._blocks else {(0, 0): arrays[n]}
              for n in loop._names}
    local = pad_local(blocks, loop.mesh, loop._j_sh, loop._i_sh)

    def nbytes(names):
        return sum(p[n].nbytes for p in local.values() for n in names)

    new = sum(x.nbytes for p in local.values() for x in p.values()
              if all(x is not b[c] for b in blocks.values() for c in b))
    again = [nbytes(names) for names in REPADS[path]]
    pads = [s.count for s in made if s.name == "wrf.loop.pad"]
    assert pads == [new, *again, nbytes(CHANGED), *again]
    assert 0 < nbytes(CHANGED) < new
    assert timing.span_totals()["wrf.loop.pad"]["count"] == sum(pads)


@pytest.mark.parametrize("path", PATHS)
def test_state_bit_equal_with_spans_on_and_off(case, path):
    off = _closed_step(case, _integrator(case, *path))
    assert timing.SPANS == []
    _, on, made = _traced_step(case, path)
    assert made
    assert off.keys() == on.keys()
    for n in off:
        assert torch.equal(off[n], on[n]), n


def test_span_totals_self_time_and_counts(monkeypatch):
    """Device self ms is a span less its children; a name any of whose
    spans took no events reads None; counts add."""
    fake = {"outer": 10.0, "a": 3.0, "b": 2.5, "bare": None}
    monkeypatch.setattr(timing.Span, "device_ms",
                        lambda self: fake[self.name])
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("outer"):
            with timing.span("a", count=4):
                pass
            with timing.span("b") as sp:
                sp.count = 6
            with timing.span("a", count=1):
                pass
        with timing.span("bare"):
            pass
    tot = timing.span_totals()
    assert tot["outer"]["device_ms"] == 10.0
    assert tot["outer"]["device_self_ms"] == pytest.approx(10.0 - 3 - 2.5 - 3)
    assert (tot["a"]["calls"], tot["a"]["device_ms"],
            tot["a"]["device_self_ms"], tot["a"]["count"]) == (2, 6.0, 6.0, 5)
    assert tot["b"]["count"] == 6 and tot["outer"]["count"] == 0
    assert tot["bare"]["device_ms"] is None
    assert tot["bare"]["device_self_ms"] is None
    assert all(t["host_ms"] >= 0 for t in tot.values())


def test_trace_holds_the_spans_inside_the_callers_span(case, tmp_path):
    timing.SPANS.append("left over")
    rk3 = _integrator(case, "cuda", 1, None)
    with timing.trace(str(tmp_path)):
        assert timing.SPANS == []          # cleared when the trace opens
        with record_function("caller.step"):
            _closed_step(case, rk3)
    events = json.loads(next(tmp_path.glob("trace_*.json")).read_text())
    ann = [e for e in events["traceEvents"]
           if e.get("cat") == "user_annotation"]
    caller = next(e for e in ann if e["name"] == "caller.step")
    ours = [e for e in ann if e["name"].startswith("wrf.")]
    assert {e["name"] for e in ours} == set(PER_STEP)
    assert len(ours) == sum(PER_STEP.values())
    lo, hi = caller["ts"], caller["ts"] + caller["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ours)


# ----------------------------------------------------------------------
# the benchmark's readers, on a fake recorder
# ----------------------------------------------------------------------
def _fake_totals(steps):
    def t(calls, host, dev, count=0):
        return {"calls": calls, "host_ms": host, "device_ms": dev,
                "device_self_ms": dev, "count": count}

    return {"wrf.rk3.step": t(steps, 20.0, 80.0),
            "wrf.closure.tendency": t(3 * steps, 0.5, 1.0),
            "wrf.loop.pad": t(3 * steps, 1.0, 16.0, count=3 * 2**30),
            "wrf.loop.inputs": t(3 * steps, 2.0, 12.0),
            "wrf.loop.substeps": t(3 * steps, 6.0, 34.0),
            "wrf.rk3.merge": t(steps, 3.0, 8.0),
            "wrf.closure.damp": t(steps, 1.0, 2.0)}


#: each reader's value on :func:`_fake_totals` over 2 traced steps
WANT = {"pad_ms": 8.0, "pad_gib": 1.5, "stage_inputs_ms": 6.0,
        "substeps_ms": 17.0, "merge_ms": 4.0, "closure_ms": 1.5,
        "host_issue_ms": 12.0}


def _run(steps=2, traced=True):
    trace = types.SimpleNamespace(steps=steps) if traced else None
    return types.SimpleNamespace(trace=trace)


def test_readers_have_their_entries_in_benchmark_json():
    spec = Spec(ROOT)
    entries = {m["name"]: m for m in spec.bench["per_layer"]}
    assert set(WANT) <= set(entries)
    assert all(entries[n]["source"].startswith("program_") for n in WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_fake_recorder(name, monkeypatch):
    read = Spec(ROOT).reader(name)
    monkeypatch.setattr(timing, "span_totals", lambda: _fake_totals(2))
    assert read(_run()) == pytest.approx(WANT[name])
    # the spans cover other steps than the trace's, or there is no trace
    assert read(_run(steps=3)) is None
    assert read(_run(traced=False)) is None


def test_spans_reader_without_the_programs_spans(monkeypatch):
    """A program without ``span_totals``, or one whose spans have no
    device time (a CPU run), gives no number and raises nothing."""
    monkeypatch.setattr(timing, "span_totals",
                        lambda: {"wrf.rk3.step": {"calls": 2, "host_ms": 1.0,
                                                  "device_ms": None,
                                                  "count": 0}})
    assert bench_spans.per_step(_run(), ["wrf.rk3.step"], "device_ms") is None
    assert bench_spans.per_step(_run(), ["wrf.missing"], "host_ms") is None
    assert bench_spans.per_step(_run(), ["wrf.rk3.step"], "host_ms") == 0.5
    monkeypatch.delattr(timing, "span_totals")
    assert bench_spans.totals(_run()) is None
