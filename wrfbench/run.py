"""The benchmark's one command: a cell of ``BENCHMARK.json`` on the card.

    python3 -m wrfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``wrf_tpu_torch``).
Everything about a cell is data, found by the names in ``BENCHMARK.json``:
its configuration (the file the entry names, under ``wrfbench/configs/``),
its traffic mix (``wrfbench/traffic/<traffic>.json``), its limits
(``wrfbench/limits/<cell>.json``) and one reader per metric
(``wrfbench/metrics/<metric>.py``).

A cell runs on as many cards as its ``chips`` (the program's mesh, if its
traffic names one, takes them in turn).  A run: the seeded inputs, made
field by field on the first card and moved to the host
(:mod:`wrfbench.inputs`), the program's ``prepare`` and closed large
steps (:mod:`wrfbench.program`),
the warm-up, then a closed loop of calls for ``--seconds``, each waiting
for the one before; with ``--trace 1`` a ``torch.profiler`` window of
steady calls after it (:mod:`wrfbench.trace`).  Then the check
(:mod:`wrfbench.check`): the first step and a seeded sample of the window's
calls against the plain reference, once the program's state is freed,
block by block on the run's cards.  Memory readings are the fullest
card's; standard error gives every card's.

It prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted`` (calls in the window), ``failed`` (calls whose
checksum was not finite), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``.  It exits with another code than 0,
and prints no result, without a CUDA device (no fallback), without the
program, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``wrf_tpu`` is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    import os
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: process start on the perf_counter clock
_START = _T0 - _process_age()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the process may not hold once the window closed
BANNED = ("jax", "jaxlib", "flax", "wrf_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The program builds its kernel library in ``wrf_tpu_torch/_build/``."""
    base = root / ".wrfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def banned_modules() -> list[str]:
    """The :data:`BANNED` top-level names in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Spec:
    """``BENCHMARK.json`` and the data files its names lead to."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key, name):
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise SystemExit(f"wrfbench: no {key[:-1]} named {name!r} in "
                         f"BENCHMARK.json")

    def _data(self, *parts):
        return json.loads(self.root.joinpath("wrfbench", *parts).read_text())

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, cell: dict) -> dict:
        entry = self._entry("configs", cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return self._data("traffic", f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return self._data("limits", f"{cell['name']}.json")

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metric entries a run of ``cell`` reports."""
        return [m for m in self.bench["per_layer" if trace else "end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        path = self.root / "wrfbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"wrfbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device, start: float, make_program=None, log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result object.  ``device`` is
    the run's device or list of devices (the program's mesh takes them in
    turn, so one device may hold every shard).  ``start`` is the process
    start on the ``perf_counter`` clock.  ``make_program`` builds the
    system under test from ``(cfg, traffic, host_inputs, devices)``
    (default: the program's closed step)."""
    import numpy as np
    import torch

    from . import check, inputs
    from . import trace as tracing
    from .record import RunRecord

    def say(msg):
        print(f"[wrfbench] {msg}", file=log, flush=True)

    spec = Spec(root)
    cell = spec.cell(name)
    cfg, mix, limits = spec.config(cell), spec.traffic(cell), spec.limits(cell)
    devices = [torch.device(d) for d in
               ([device] if isinstance(device, (str, torch.device))
                else device)]
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if make_program is None:
        from .program import ClosedStep as make_program
    marks = [("imports", time.perf_counter())]

    def peaks():
        return [torch.cuda.max_memory_allocated(d) for d in cards]

    host = inputs.make_host(cfg, seed, devices[0])
    marks.append(("inputs", time.perf_counter()))
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    prog = make_program(cfg, mix, host, devices)
    state = prog.state
    marks.append(("prepare", time.perf_counter()))

    # warm-up: the first call is checked from the inputs; the program's
    # peak is read after the second (nothing of the harness held yet)
    state, _ = prog.step(state)
    first = state
    marks.append(("first call", time.perf_counter()))
    state, _ = prog.step(state)
    program_peaks = peaks()
    for _ in range(mix["warmup_calls"] - 2):
        state, _ = prog.step(state)
    # rehearse what the window holds for the check (two disjoint pairs of
    # states), so that the allocator has grown before it opens
    held = []
    for i in range(4):
        prev = state
        state, _ = prog.step(state)
        if i % 2 == 0:
            held.append((prev, state))
    del held, prev
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - start

    # the window: a closed loop of calls; a seeded reservoir of (start,
    # end) state pairs is kept for the check
    rng = np.random.default_rng(int(seed) % 2**64)
    k = mix["check_calls"]
    sample, times, failed = [], [], 0
    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        prev = state
        state, checksum = prog.step(state)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        failed += not math.isfinite(checksum)
        n = len(times)
        if n <= k:
            sample.append((prev, state))
        elif (r := int(rng.integers(n))) < k:
            sample[r] = (prev, state)
        if t1 - t_open >= seconds:
            break
    window_s = t1 - t_open
    del prev
    per_call = prog.steps_per_call
    record = RunRecord(
        cfg=cfg, traffic=mix, setup_s=setup_s, window_s=window_s,
        steps=len(times) * per_call,
        step_s=[t / per_call for t in times for _ in range(per_call)],
        program_peak_bytes=max(program_peaks) if cards else None,
        chips=max(1, len(cards)))
    if trace:
        state, record.trace = tracing.profile(prog, state, mix["trace_calls"],
                                              cards)
    run_peaks = peaks()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)

    # the check, once the program's state is freed: the reference in
    # blocks, on the run's devices in turn, reading the program's evolved
    # states where they lie
    calls = [(None, prog.evolved(first))]
    calls += [(prog.evolved(a), prog.evolved(b)) for a, b in sample]
    prog.close()
    del prog, state, first, sample
    t_check = time.perf_counter()
    errs = check.call_errors(cfg, host, calls, per_call,
                             list(dict.fromkeys(devices)))
    del calls
    check_s = time.perf_counter() - t_check
    check_peaks = peaks()
    err_first, err_window = errs[0], {}
    for e in errs[1:]:
        for f, v in e.items():
            err_window[f] = max(err_window.get(f, 0.0), v)

    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if cards:
        dev = {"platform": "gpu",
               "kind": torch.cuda.get_device_name(cards[0]),
               "count": cell["chips"],
               "memory_peak_bytes": int(max(run_peaks))}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": None, "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        tr = record.trace
        dev.update(busy_s=tr.busy_us / 1e6, window_s=tr.window_us / 1e6)
        result["breakdown"] = tracing.breakdown(tr)

    prev_t = start
    for label, t in marks:
        say(f"set-up {label}: {t - prev_t:.3f} s")
        prev_t = t
    tenth = max(1, len(times) // 10)
    say("window ms a call, by tenths: " + " ".join(
        f"{1e3 * float(np.mean(times[i:i + tenth])):.3f}"
        for i in range(0, len(times) - tenth + 1, tenth)))
    say(f"window: {len(times)} calls of {per_call} large step(s) in "
        f"{window_s:.3f} s; the check took {check_s:.3f} s")
    for i, d in enumerate(cards):
        say(f"{d}: program peak {program_peaks[i]} B, run peak "
            f"{run_peaks[i]} B, check peak {check_peaks[i]} B")
    if trace and cards:
        step_s = window_s / record.steps
        for d, us in tr.busy_by_card.items():
            busy_s = us / 1e6 / tr.steps
            say(f"card {d}: busy {1e3 * busy_s:.3f} ms a large step in the "
                f"trace, idle {100 * (1 - busy_s / step_s):.3f} % of the "
                "untraced step")
    for label, errs in (("step 1", err_first), ("window", err_window)):
        say(f"{label} scaled errors: " + ", ".join(
            f"{f} {e:.3e}" for f, e in errs.items()))
    compared = {
        "step1_err": {"value": max(err_first.values()),
                      "limit": limits["step1_err"]},
        "window_err": {"value": max(err_window.values()),
                       "limit": limits["window_err"]},
        "nonfinite_calls": {"value": failed, "limit": 0},
    }
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in compared.values())
    result["compared"] = compared
    for key, c in compared.items():
        print(f"{key} {c['value']} limit {c['limit']}", file=log, flush=True)
    return result


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cache_dirs(ROOT)
    spec = Spec(ROOT)
    chips = spec.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"wrfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible (no fallback)",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), [f"cuda:{i}" for i in range(chips)],
                      _START)
    found = banned_modules()
    if found:
        print(f"wrfbench: the process holds {found} after the window "
              "(the benchmark may not load JAX or the JAX package)",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
