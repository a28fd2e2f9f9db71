"""Time the same ``chip_smoke.py`` phases in several source trees, in turns.

Two versions of a kernel are compared inside one run on one card: each
tree (a checkout of the repository, e.g. the parent commit unpacked with
``git archive`` beside the working tree) runs the phases in a process of
its own, from its own directory, so each builds and loads its own kernels.
The rounds follow ``--order`` (e.g. ``parent,change,change,parent``), so a
drift of the card's clocks shows as a difference between a tree's two
readings rather than between the trees.

    python -m wrf_tpu_torch.tools.ab_trees --tree parent=_ab/parent \\
        --tree change=. --order parent,change,change,parent \\
        --phases k1,k6,slice --out results/ab

The phases are those of the trees' ``chip_smoke.py`` (their signatures
are the same in every tree compared):

* ``k1``: K1 against its plain version and timed at 516x50x516 in every
  mode of ``MODES`` and, with ``fuse_w``, of ``W_MODES``; at 259x50x259
  (one 2x2 shard's block); with ``smdiv``, with ``capture``, with
  ``overlap`` on the 2x2 shards at 512x512x50, and the bf16 forms;
* ``k3``: K3 (and the K4 pair) against its plain version and timed at
  512x512x50 in every mode of ``K3_MODES``, also with ``fuse_w``; exact
  S=2, 4, 8 with bf16 constant streams; four K1 fused-scan launches on the
  same timer; ``phase_k3_overlap`` at 512x512x50 (one 2x2 shard's block,
  261x50x261, S=2 timed); ``python -m wrf_tpu_torch.driver --tier coupled
  --inner-steps 4`` for 17 steps at 512x512x50, twice (ms per step);
* ``k2``: K2 against its plain version and timed at 512x512x50
  (``phase_k2_vs_plain``: exact S=2, S=8, fast S=8, S=32; exact S=8 and
  fast S=32 timed), exact S=8 with bf16 constant streams timed, K2 exact
  S=8 against 8 K1 launches (``phase_k2_vs_k1``), and the driver's
  ``--tier sharded-cuda --inner-steps 8`` loop (17 steps at 512x512x50,
  built as the driver builds it) under ``torch.profiler`` for the
  driver's two calls (warm-up and timed): K2's and K1's launches and
  device time, the device's busy time, the ten kernels and host
  operations that take the most;
* ``k5``: ``phase_k5_vs_plain`` (its checks, launch counts and printed
  times), then one 2x2 exchange at the 512x512x50 loop's row size (every
  shard's mu rows both ways and v row up, as a substep of the mesh loop)
  timed the same way in every tree, per exchange: through the wrapper, its
  plain version, the ``ppermute`` refresh and the bare launch of one plan
  of all twelve segments (marginal ms between chains of 50 and 250, CUDA
  events and the host clock), and ``run_sim --mesh 2x2 --halo-backend
  rdma`` for 3 large steps through ``chip_smoke.run_sim_launches``;
* ``k6``: ``phase_copy_ceiling``;
* ``mesh``: the one-process (2,2) mesh's host costs at 512x512x50, every
  shard on ``cuda:0``: the ppermute exchanges (a j refresh of mu's and
  v's blocks, an i refresh of mu's, a 1-cell j exchange of mu's unpadded
  blocks; marginal ms per call between chains of 50 and 250, CUDA events
  and the host clock), then ``run_sim --mesh 2x2 --closure nudge`` for 10
  large steps under ppermute and ``rdma_overlap`` (mean ms of steps 2-10;
  the unclosed shell diverges within 10 steps);
* ``trace``: the driver's ``--tier coupled --inner-steps 4`` loop (17
  steps at 512x512x50, built as the driver builds it): the host span of
  two warm runs, then one run under ``torch.profiler``: the device's busy
  time, K3's and K1's launches and device time, the ten kernels and the
  ten host operations that take the most;
* ``k7``: ``phase_k7`` (both forms against their plain versions, the
  entry point, then each form timed at ``K7_TIMED`` for tj 2, 4 and ti
  64, 128, marginal two-count on ``probe_2d.chain_ms``);
* ``k8``: ``phase_k8`` (every rung against its plain version, the entry
  points, then every rung timed at ``K8_TIMED``, tj 4, ti 128, on the same
  timer);
* ``host``: the host's time per K1 launch (the fused scan substep at
  259x50x259, 100 submissions without a synchronise, best of 5);
* ``slice``: ``python -m wrf_tpu_torch.run_sim`` for 3 large steps at
  512x512x50 through ``chip_smoke.run_sim_launches`` (the runner of
  ``phase_slice``), by default, ``--inner-steps 2``, ``--mesh 2x2
  --halo-backend rdma_overlap``, ``--namelist`` with ``smdiv`` 0.1 and
  ``--precision bf16-const``.

Every tree's kernels are timed by the same ``cuda_ms`` (the calls queued
behind ~10 ms of spinning on the stream, so CUDA events read the card's
time even where a launch costs the host as much as the card); K7 and K8
keep their phases' own timer.  Each round's output goes to
``<out>_<tree>_<n>.txt`` and every reading to ``<out>.json``; after each
round of ``k7`` or ``k8`` one ``[ab] round`` line per form or rung gives its
ms, and the summary printed at the end gives, per timing, each tree's
mean and the ratio of each tree to the first.  It needs a CUDA card (the
phases refuse to run without one).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: what a round runs in a tree's directory: argv[1] the phases, argv[2] the
#: JSON file to write
ROUND = r'''
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, ".")
import chip_smoke as c

def keyed(x):
    if isinstance(x, dict):
        return {(" | ".join(map(str, k)) if isinstance(k, tuple) else str(k)):
                keyed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [keyed(v) for v in x]
    return x

def primed_cuda_ms(fn, reps):
    # every tree's kernels timed the same way: the launches queue behind
    # ~10 ms of spinning, so the events read the card's time, not the host's
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps

def profile_run(run, kinds):
    # one torch.profiler trace of run(): the host span, the device's busy
    # time, each kind's launches and device time, the ten kernels and host
    # operations that take the most
    import time, torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    row = {"profiled span ms": span, "busy ms": 0.0, "other ms": 0.0,
           **{f"{k} {x}": 0 for k in kinds for x in ("n", "ms")}}
    device, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            row["busy ms"] += ms
            kind = next((k for k, w in kinds.items()
                         if any(x in e.key for x in w)), "other")
            row[kind + " ms"] += ms
            if kind != "other":
                row[kind + " n"] += e.count
            device[e.key[:70]] = {"n": e.count, "ms": ms}
        else:
            host[e.key[:70]] = {"n": e.count,
                                "self ms": e.self_cpu_time_total / 1e3}
    if not row["busy ms"] > 0:
        raise SystemExit("torch.profiler traced no device time")
    row["device"] = dict(sorted(device.items(),
                                key=lambda kv: -kv[1]["ms"])[:10])
    row["host"] = dict(sorted(host.items(),
                              key=lambda kv: -kv[1]["self ms"])[:10])
    for k, v in row["device"].items():
        print(f"[trace device] {k}: {v}")
    for k, v in row["host"].items():
        print(f"[trace host] {k}: {v}")
    return row

c.cuda_ms = primed_cuda_ms
phases = sys.argv[1].split(",")
name, smi = c.phase_env()
c.phase_build()
res = {"card": smi}
big = ((c.BIG_GRID, "specified"),)
if "k1" in phases:
    res["k1"] = keyed(c.phase_kernel_vs_plain(
        cases=big, time_grids=(c.BIG_GRID,), card=smi)[1])
    res["k1+w"] = keyed(c.phase_kernel_vs_plain(
        cases=big, time_grids=(c.BIG_GRID,), card=smi, with_w=True)[1])
    res["k1 shard"] = keyed(c.phase_kernel_vs_plain(
        cases=((c.SHARD_GRID, "specified"),), time_grids=(c.SHARD_GRID,),
        card=smi)[1])
    res["k1 smdiv"] = keyed(c.phase_k1_damping(cases=big, card=smi))
    res["k1 capture"] = keyed(c.phase_k1_capture(cases=big, card=smi))
    res["k1 overlap"] = keyed(c.phase_k1_overlap(cases=big, card=smi))
    res["bf16"] = keyed(c.phase_bf16(cases=big, card=smi))
if "k2" in phases:
    import torch
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep)
    from wrf_tpu_torch.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain)
    res["k2"] = keyed(c.phase_k2_vs_plain(cases=big, card=smi)[1])
    c.phase_k2_vs_k1()
    arr, static = c.padded_inputs(c.case_at(c.BIG_GRID), "cuda")
    a = c.fresh_state(c.narrowed(c.k2_inputs(arr, static),
                                 ("u", "v", "t_1", "tconst", "dvdxi_const")))
    mkw = dict(c.K2_MODES["exact S=8"], wind_scale_step=c.DW)
    res["k2 bf16"] = {"exact S=8": [c.cuda_ms(
        lambda: advance_mu_t_multistep(**a, **static, **mkw), 20) / 8
        for _ in range(2)]}
    print(f"[k2 bf16 time exact S=8] ms per substep: "
          f"{res['k2 bf16']['exact S=8']} ({smi})")
    del arr, a
    torch.cuda.empty_cache()
    # the driver's sharded-cuda S=8 loop as the driver builds it: its two
    # calls (warm-up, then the timed one with its readback) under the
    # profiler, after one unprofiled call
    case = c.case_at(c.BIG_GRID, balanced=True)
    b = case.bounds
    loop = ShardedAdvanceMuT(b.ide, b.jde, b.kdim, case.flags, n_steps=17,
                             kernel="cuda", inner_steps=8, device="cuda")
    prepared = loop.prepare(case_to_domain(case))

    def call():
        return loop(prepared, case.rdx, case.rdy, case.dts, case.epssm)

    def driver_calls():
        call()
        torch.cuda.synchronize()
        arrays_to_numpy(call())

    driver_calls()
    row = profile_run(driver_calls, {
        "k2": ("msteps_exact", "msteps_fast"),
        "k1": ("advance_mu_t_kernel",)})
    res["trace k2"] = row
    print(f"[trace driver sharded-cuda S=8] two calls, {row['profiled span ms']:.3f}"
          f" ms profiled; device busy {row['busy ms']:.3f} ms: K2 "
          f"{row['k2 n']} launches {row['k2 ms']:.4f} ms, K1 {row['k1 n']} "
          f"{row['k1 ms']:.4f} ms, other {row['other ms']:.3f} ms ({smi})")
if "k5" in phases:
    import torch
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.io import fixtures
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.mesh import make_mesh
    c.phase_k5_vs_plain(card=smi)
    nx, ny, K = c.BIG_GRID
    mesh = make_mesh(["cuda:0"] * 4, (2, 2))
    njl, nil = (ny + 2) // 2, (nx + 2) // 2
    mu = c.ring_blocks(mesh, (njl + 2, nil + 2), 5)
    v = c.ring_blocks(mesh, (njl + 2, K, nil + 2), 6)
    segs = []
    for co in mesh.coords():
        up, down = (mesh.neighbour(co, "j", s) for s in (1, -1))
        segs += [(mu[co], njl, mu[up], 0), (mu[co], 1, mu[down], njl + 1),
                 (v[co], 1, v[down], njl + 1)]
    plan = k5.plan_put(segs)   # 12 segments: one launch in every tree
    fns = {
        "kernel": lambda: k5.remote_refresh_multi(
            [mu, v], "j", mesh, njl, recv_only=("", "hi")),
        "plain": lambda: k5.remote_refresh_multi_plain(
            [mu, v], "j", mesh, njl, recv_only=("", "hi")),
        "library": lambda: (halo.refresh_axis(mu, 0, "j", mesh, njl),
                            halo.refresh_axis(v, 0, "j", mesh, njl)),
        "bare": lambda: k5.put(plan)}
    n0 = k5.LAUNCHES
    fns["kernel"]()
    row = {"launches per exchange": k5.LAUNCHES - n0,
           "events ms": {k: [] for k in fns},
           "host ms": {k: [] for k in fns}}
    for name in ("plain", "library", "kernel", "bare", "bare", "kernel",
                 "library", "plain"):
        ev, hc = c.chain_marginal_ms(lambda i: fns[name](), n1=50, n2=250,
                                     repeats=5)
        row["events ms"][name].append(ev)
        row["host ms"][name].append(hc)
    res["k5 exchange 2x2"] = row
    print(f"[k5 exchange 2x2] {row['launches per exchange']} launch(es) per "
          f"exchange; marginal ms per exchange, events / host clock: "
          + ", ".join(f"{k} {sum(row['events ms'][k]) / 2:.5f} / "
                      f"{sum(row['host ms'][k]) / 2:.5f}" for k in fns)
          + f" ({smi})")
    with tempfile.TemporaryDirectory(prefix="ab_k5_") as tmp:
        tmp = Path(tmp)
        fx = fixtures.write_case(c.case_at(c.BIG_GRID, balanced=True),
                                 tmp / "big", steps=1)
        launches, step_ms, _ = c.run_sim_launches(
            tmp, fx, "2x2_rdma", "--mesh", "2x2", "--halo-backend", "rdma")
        res["slice 2x2 rdma"] = {"launches": launches, "step_ms": step_ms,
                                 "step3_ms": step_ms[2]}
        print(f"[slice] run_sim 2x2 rdma: launches {launches}, step 3 alone "
              f"{step_ms[2]:.3f} ms ({smi})")
if "mesh" in phases:
    from wrf_tpu_torch.io import fixtures
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.mesh import make_mesh
    nx, ny, K = c.BIG_GRID
    mesh = make_mesh(["cuda:0"] * 4, (2, 2))
    njl, nil = (ny + 2) // 2, (nx + 2) // 2
    mu = c.ring_blocks(mesh, (njl + 2, nil + 2), 5)
    v = c.ring_blocks(mesh, (njl + 2, K, nil + 2), 6)
    mu_in = c.ring_blocks(mesh, (njl, nil), 7)
    fns = {"refresh j mu+v": lambda: (halo.refresh_axis(mu, 0, "j", mesh, njl),
                                      halo.refresh_axis(v, 0, "j", mesh, njl)),
           "refresh i mu": lambda: halo.refresh_axis(mu, 1, "i", mesh, nil),
           "exchange j mu": lambda: halo.exchange_axis(mu_in, 0, "j", mesh)}
    row = {"events ms": {k: [] for k in fns}, "host ms": {k: [] for k in fns}}
    for name in list(fns) + list(fns)[::-1]:
        ev, hc = c.chain_marginal_ms(lambda i: fns[name](), n1=50, n2=250,
                                     repeats=5)
        row["events ms"][name].append(ev)
        row["host ms"][name].append(hc)
    res["mesh exchange 2x2"] = row
    print("[mesh exchange 2x2] marginal ms per call, events / host clock: "
          + ", ".join(f"{k} {sum(row['events ms'][k]) / 2:.5f} / "
                      f"{sum(row['host ms'][k]) / 2:.5f}" for k in fns)
          + f" ({smi})")
    with tempfile.TemporaryDirectory(prefix="ab_mesh_") as tmp:
        tmp = Path(tmp)
        fx = fixtures.write_case(c.case_at(c.BIG_GRID, balanced=True),
                                 tmp / "big", steps=1)
        runs = {"2x2 ppermute closed": ("--mesh", "2x2", "--closure",
                                        "nudge"),
                "2x2 overlap closed": ("--mesh", "2x2", "--halo-backend",
                                       "rdma_overlap", "--closure", "nudge")}
        res["mesh run_sim"] = {}
        for run, flags in runs.items():
            launches, step_ms, _ = c.run_sim_launches(
                tmp, fx, run.replace(" ", "_"), *flags, steps=10)
            later = sum(step_ms[1:]) / len(step_ms[1:])
            res["mesh run_sim"][run] = {"launches": launches,
                                        "step_ms": step_ms,
                                        "steps 2-10 ms": later}
            print(f"[mesh] run_sim {run}: steps 2-10 {later:.3f} ms a step "
                  f"({smi})")
if "k6" in phases:
    res["k6"] = keyed(c.phase_copy_ceiling(card=smi)[0])
if "k7" in phases:
    res["k7"] = keyed(c.phase_k7(card=smi)[0])
if "k8" in phases:
    res["k8"] = keyed(c.phase_k8(card=smi)[0])
if "host" in phases:
    # what one K1 launch costs the host: the fused scan substep at one 2x2
    # shard's block, 100 submissions without a synchronise, best of 5
    import time, torch
    from wrf_tpu_torch.ops.advance_mu_t_cuda import advance_mu_t_fused
    arr, static = c.padded_inputs(c.case_at(c.SHARD_GRID), "cuda")
    a, m = arr, c.mode_kwargs("scan", arr, static)
    best = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            advance_mu_t_fused(**a, **static, **m)
        best.append((time.perf_counter() - t0) * 10.0)
    torch.cuda.synchronize()
    res["host"] = {"k1 submit ms": min(best[1:])}
    print(f"[host] K1 scan substep at 259x50x259: {min(best[1:]):.4f} ms of "
          f"host time per launch ({smi})")
if "k3" in phases:
    # K3 exact at S=2, 4, 8 (and fast S=4, the K4 pair) against its plain
    # version and timed, float32 and with fuse_w; the bf16 streams; four K1
    # fused scans on the same timer; the in-kernel exchange on one 2x2
    # shard's block (261x50x261, S=2); the driver's coupled S=4 main path
    import contextlib, io, re
    from wrf_tpu_torch import driver
    from wrf_tpu_torch.io import fixtures
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import coupled_multistep
    from wrf_tpu_torch.ops.advance_mu_t_cuda import advance_mu_t_fused
    res["k3"] = keyed(c.phase_k3_vs_plain(cases=big, card=smi)[1])
    res["k3+w"] = keyed(c.phase_k3_vs_plain(cases=big, card=smi,
                                            with_w=True)[1])
    arr, static = c.padded_inputs(c.case_at(c.BIG_GRID), "cuda")
    res["k3 bf16"] = {}
    for S in (2, 4, 8):
        ins, st = c.k3_inputs(arr, static, S)
        a = c.fresh_k3(c.narrowed(ins, ("t_1", "tconst", "dvdxi_const")))
        res["k3 bf16"][f"exact S={S}"] = [c.cuda_ms(
            lambda: coupled_multistep(**a, **st, n_inner=S), 10) / S
            for _ in range(2)]
        print(f"[k3 bf16 time exact S={S}] ms per substep: "
              f"{res['k3 bf16'][f'exact S={S}']} ({smi})")
        del ins, a
    a1, m1 = arr, c.mode_kwargs("scan", arr, static)

    def four_k1():
        for _ in range(4):
            advance_mu_t_fused(**a1, **static, **m1)

    res["k1 x4"] = [c.cuda_ms(four_k1, 10) for _ in range(2)]
    print(f"[k1 x4 time] ms per 4 fused-scan launches: {res['k1 x4']} "
          f"({smi})")
    del arr, a1
    res["k3 overlap"] = keyed(c.phase_k3_overlap(cases=big, card=smi))
    with tempfile.TemporaryDirectory(prefix="ab_k3_") as tmp:
        fx = fixtures.write_case(c.case_at(c.BIG_GRID, balanced=True),
                                 Path(tmp) / "big", steps=17)
        ms = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = driver.main([str(fx), "--tier", "coupled",
                                  "--inner-steps", "4", "--steps", "17",
                                  "--device", "cuda"])
            if rc != 0:
                raise SystemExit(f"driver coupled S=4 returned {rc}")
            ms.append(float(re.search(r"\(([0-9.]+) ms/step",
                                      buf.getvalue()).group(1)))
        res["driver coupled S=4"] = {"ms per step": ms}
        print(f"[driver coupled S=4] ms per step: {ms} ({smi})")
if "trace" in phases:
    # the driver's coupled S=4 loop (--tier coupled --inner-steps 4, 17
    # steps at 512x512x50) as the driver builds it: two host spans of a
    # warm run, then one run under torch.profiler, read by kernel
    import time, torch
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.sharded import case_to_domain
    case = c.case_at(c.BIG_GRID, balanced=True)
    b = case.bounds
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=17,
                         kernel="cuda", inner_steps=4, device="cuda")
    prepared = loop.prepare(case_to_domain(case))

    def run():
        return arrays_to_numpy(loop(prepared, case.rdx, case.rdy, case.dts,
                                    case.epssm))

    run()
    spans = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        spans.append((time.perf_counter() - t0) * 1e3)
    row = profile_run(run, {"k3": ("staged_kernel", "coupled_kernel"),
                            "k1": ("advance_mu_t_kernel",)})
    row["span ms"] = spans
    res["trace"] = row
    print(f"[trace driver coupled S=4] span {spans} ms unprofiled, "
          f"{row['profiled span ms']:.3f} ms profiled; device busy "
          f"{row['busy ms']:.3f} ms: K3 {row['k3 n']} launches "
          f"{row['k3 ms']:.3f} ms, K1 {row['k1 n']} {row['k1 ms']:.3f} ms, "
          f"other {row['other ms']:.3f} ms ({smi})")
if "slice" in phases:
    from wrf_tpu_torch.io import fixtures
    with tempfile.TemporaryDirectory(prefix="ab_slice_") as tmp:
        tmp = Path(tmp)
        case = c.case_at(c.BIG_GRID, balanced=True)
        fx = fixtures.write_case(case, tmp / "big", steps=1)
        nml = {"dx": round(1.0 / case.rdx, 3), "dy": round(1.0 / case.rdy, 3),
               "time_step": round(case.dts * 4), "time_step_sound": 4,
               "epssm": case.epssm, "smdiv": c.SMDIV, "specified": True}
        (tmp / "smdiv.json").write_text(json.dumps(nml))
        runs = {"S=1": (), "S=2": ("--inner-steps", "2"),
                "2x2 overlap": ("--mesh", "2x2", "--halo-backend",
                                "rdma_overlap"),
                "smdiv": ("--namelist", str(tmp / "smdiv.json")),
                "bf16": ("--precision", "bf16-const")}
        res["slice"] = {}
        for run, flags in runs.items():
            launches, step_ms, _ = c.run_sim_launches(
                tmp, fx, run.replace(" ", "_").replace("=", ""), *flags)
            res["slice"][run] = {"launches": launches, "step_ms": step_ms,
                                 "step3_ms": step_ms[2]}
            print(f"[slice] run_sim {run}: step 3 alone {step_ms[2]:.3f} ms "
                  f"({smi})")
Path(sys.argv[2]).write_text(json.dumps(res))
'''


#: the phases a round can run (see the module docstring)
PHASES = ("k1", "k2", "k3", "k5", "k6", "k7", "k8", "host", "trace",
          "slice", "mesh")


def phase_list(text: str) -> list[str]:
    """The comma-separated ``--phases`` value as a list; a ValueError
    names any phase the rounds do not know."""
    phases = [p for p in text.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        raise ValueError(f"unknown phases {unknown}; known: {list(PHASES)}")
    return phases


def leaves(x, path=()):
    """``(path, value)`` for every number in a nested dict / list."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, path + (k,))
    elif isinstance(x, list):
        if x and all(isinstance(v, (int, float)) for v in x):
            yield path, sum(x) / len(x)
        else:
            for n, v in enumerate(x):
                yield from leaves(v, path + (str(n),))
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield path, float(x)


def round_lines(res: dict) -> list[str]:
    """One line per K7 form and K8 rung of a round's results: its ms."""
    return [" / ".join(path[:-1]) + f": {v:.4f} ms"
            for key in ("k7", "k8") if key in res
            for path, v in leaves({key: res[key]}) if path[-1] == "ms"]


def summary(rounds: list, names: list) -> list[str]:
    """One line per timing: each tree's mean over its rounds, and its ratio
    to the first tree's."""
    per = {}
    for tree, res in rounds:
        for path, v in leaves({k: v for k, v in res.items() if k != "card"}):
            per.setdefault(path, {}).setdefault(tree, []).append(v)
    lines = []
    for path, by_tree in per.items():
        if any(p in ("launches", "step_ms") for p in path):
            continue
        means = {t: sum(v) / len(v) for t, v in by_tree.items()}
        base = means.get(names[0])
        cells = []
        for t in names:
            if t not in means:
                continue
            ratio = (f" ({means[t] / base:.3f}x)" if base and t != names[0]
                     else "")
            cells.append(f"{t} {means[t]:.4f}{ratio}")
        lines.append(" / ".join(path) + ": " + ", ".join(cells))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout holding chip_smoke.py")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one round each")
    ap.add_argument("--phases", default="k1,k6,slice")
    ap.add_argument("--out", required=True,
                    help="path prefix of the logs and results (its "
                         "directory is made)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a round may take")
    args = ap.parse_args(argv)
    try:
        phase_list(args.phases)
    except ValueError as e:
        ap.error(str(e))
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",")
    unknown = sorted(set(order) - set(trees))
    if unknown:
        ap.error(f"--order names unknown trees {unknown}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    # build every tree's kernels at once, before the first round
    builds = {name: subprocess.Popen(
        [sys.executable, "-c",
         "from wrf_tpu_torch import _build; _build.build()"],
        cwd=trees[name]) for name in dict.fromkeys(order)}
    for name, proc in builds.items():
        if proc.wait() != 0:
            print(f"[ab] build in {name} failed (rc {proc.returncode})")
    rounds, failed = [], []
    for n, name in enumerate(order):
        res_file = out.with_name(f"{out.name}_{name}_{n}.json")
        log = out.with_name(f"{out.name}_{name}_{n}.txt")
        t0 = time.perf_counter()
        with open(log, "w") as fh:
            try:
                rc = subprocess.run(
                    [sys.executable, "-c", ROUND, args.phases,
                     str(res_file.resolve())],
                    cwd=trees[name], stdout=fh, stderr=subprocess.STDOUT,
                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        print(f"[ab] round {n}: {name}, rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s, log {log}", flush=True)
        if rc != 0:
            failed.append((n, name))
            print(log.read_text()[-3000:])
            continue
        rounds.append((name, json.loads(res_file.read_text())))
        for line in round_lines(rounds[-1][1]):
            print(f"[ab] round {n} {name} {line}", flush=True)
    out.with_suffix(".json").write_text(json.dumps(
        [{"tree": t, **r} for t, r in rounds]))
    cards = sorted({r["card"] for _, r in rounds})
    print(f"[ab] card(s): {cards}; order {order}")
    for line in summary(rounds, list(dict.fromkeys(order))):
        print(f"[ab] {line}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
