"""A new configuration, cell and per-layer metric are picked up from new
files and entries in BENCHMARK.json alone, and every named file exists."""

import json
import time

import pytest
import torch

from wrfbench_tiny import REPO, tiny_checkout

from wrfbench.run import Spec, run_cell

torch.set_num_threads(2)


def test_benchmark_names_resolve():
    spec = Spec(REPO)
    for cell in spec.bench["workloads"]:
        cfg = spec.config(cell)
        assert cfg["name"] == cell["config"]
        assert spec.traffic(cell)["with_w"] is True
        assert set(spec.limits(cell)) == {"step1_err", "window_err"}
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_and_metric_from_data(tmp_path, trace):
    root = tiny_checkout(tmp_path)
    (root / "wrfbench/metrics/steps_seen.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "step_ms",
        "workloads": ["tiny.step"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "tiny.step", 2**33 + 7, 0.3, trace, "cpu",
                   time.perf_counter())
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    if trace:
        assert res["metrics"]["steps_seen"]["value"] >= res["attempted"]
        # device metrics are never read from a CPU run
        assert "k1_roofline_pct" not in res["metrics"]
        assert "breakdown" in res
    else:
        assert set(res["metrics"]) == {"step_ms", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("mix", [{"steps_per_sync": 2},
                                 {"const_dtype": "bf16"},
                                 {"inner_steps": 2}])
def test_traffic_options_from_data(tmp_path, mix):
    """A mix is a data file: a new one reaches the program's options."""
    root = tiny_checkout(tmp_path)
    step = json.loads((root / "wrfbench/traffic/step.json").read_text())
    (root / "wrfbench/traffic/other.json").write_text(
        json.dumps({**step, **mix}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.other", "config": "tiny",
                               "traffic": "other", "chips": 1, "why": "t"})
    if "inner_steps" in mix:        # the blocked loop refuses damping
        cfg = json.loads((root / "wrfbench/configs/tiny.json").read_text())
        (root / "wrfbench/configs/tiny.json").write_text(
            json.dumps({**cfg, "smdiv": 0.0}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "wrfbench/limits/tiny.other.json").write_text(
        (root / "wrfbench/limits/tiny.step.json").read_text())
    res = run_cell(root, "tiny.other", 9, 0.3, False, "cpu",
                   time.perf_counter())
    assert res["attempted"] > 0
    assert set(res["compared"]) == {"step1_err", "window_err",
                                    "nonfinite_calls"}
    if "const_dtype" not in mix:    # the float32 paths hold the limits
        assert res["correct"] is True, res["compared"]
