#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wrf_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
not 0 and no result line is printed):

1. environment: the card's name and power limit; a GPU is required;
2. build: the port's CUDA kernels from ``wrf_tpu_torch/csrc`` (nvcc);
3. K1 kernel vs its plain PyTorch version on the card, in the three modes
   of the run_sim path (reference call, scan substep, final substep) and
   the two of the mu/t loop (lean lite substep and final substep, winds
   scaled on load by ``wind_scale``) at 74x61x32 (specified, periodic and
   open lateral BCs) and 512x512x50, held to rtol 2e-5, atol_scale 1e-6,
   and the ``wind_scale`` modes to bit-equality; all timed with CUDA
   events at both sizes;
4. K2 kernel vs its plain version at the same grids and BCs: exact S=2
   and S=8 with the wind ramp started at substep 16 (bit-equality), fast
   S=8 and S=32 (rtol 2e-5, atol_scale 1e-6); exact S=8 and fast S=32
   timed at 512x512x50; then K2 exact S=8 against 8 K1 lite launches with
   the ramp's wind scales (bit-equality on t, mu and ww_row);
5. the reference's golden-file check: 5 plain-call steps at 74x61x32
   through the kernel against the C++ oracle's golden outputs
   (rtol 5e-5, atol_scale 2e-6);
6. the run_sim slice through its entry point: ``wrf_tpu_torch.run_sim``
   for 3 large steps at 512x512x50 (balanced fixture, amplitude 1e-2),
   which must launch K1 exactly 21 times and stay finite; then one RK3
   step at 74x61x32 against the oracle's RK3 golden;
7. the verification driver through its entry point,
   ``wrf_tpu_torch.driver``: tiers cuda and sharded-cuda (S=1, S=8, S=8
   --fast) at 74x61x32 for 1 and 100 steps under the three lateral BCs,
   then the mu/t slice's main path, sharded-cuda --inner-steps 8 at
   512x512x50 for 17 steps, which must launch K2 4 times and K1 twice;
   every run against the C++ oracle's goldens at the driver's gate;
8. the mu/t loop's marginal ms per substep (``ShardedAdvanceMuT``, two
   step counts, as ``bench.py`` measures it): S=1 and exact S=8 at
   n=65/257 and fast S=32 at n=129/513 at 512x512x50, exact S=8 at
   74x61x32.

The last two lines of standard output are the kernel table
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.  The script
uses torch, the port and the jax-free modules of wrf_tpu (fixtures,
comparators, the C++ oracle), and checks at the end that jax was never
imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REF_GRID = (74, 61, 32)      # the reference's fixture grid
BIG_GRID = (512, 512, 50)    # the main path's benchmark grid
KERNEL_TOL = dict(rtol=2e-5, atol_scale=1e-6)
DEVICE_TOL = dict(rtol=5e-5, atol_scale=2e-6)
#: lateral-BC variants checked at the reference grid (the window reaches
#: the ring under open BCs and spans the i extent under periodic ones)
BC_VARIANTS = {
    "specified": dict(specified=True),
    "periodic": dict(periodic_x=True, specified=True),
    "open": dict(specified=False, nested=False),
}
#: a wind scale the mu/t loop passes: 1 + 1e-7*97 in float32 (substep 97)
WS = 1.0000096559524536
MODES = {
    "full": dict(),
    "scan": dict(fuse_uv=True, lean=True, ww_mode="lite", with_tave=False),
    "final": dict(fuse_uv=True, ww_mode="final", with_tave=True),
    # the mu/t loop's two K1 calls: read-only winds scaled on load
    "lite_ws": dict(lean=True, ww_mode="lite", with_tave=False,
                    wind_scale=WS),
    "final_ws": dict(ww_mode="final", with_tave=True, wind_scale=WS),
}
#: K2's modes: the ramp starts past 0, as in a loop's later passes
K2_MODES = {
    "exact S=2": dict(n_inner=2, wind_step0=16),
    "exact S=8": dict(n_inner=8, wind_step0=16),
    "fast S=8": dict(n_inner=8, wind_step0=16, fast=True),
    "fast S=32": dict(n_inner=32, wind_step0=32, fast=True),
}
K2_TIMED = ("exact S=8", "fast S=32")
DW = 1e-7   # the loop's wind ramp per substep


def phase_env():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); device 0: {name}")
    print(smi)
    return name, smi


def phase_build():
    from wrf_tpu_torch import _build

    t0 = time.perf_counter()
    path, log = _build.build(ptxas_info=True)
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print(f"[build]   {line.strip()}")
    return secs


def padded_inputs(case, device):
    """The arrays one K1 call receives on the main path: ring-shaped
    domain arrays, zero-padded by one cell, with the loop's window and
    offsets (wrf_tpu_torch.models.small_step)."""
    from wrf_tpu_torch.convert import arrays_from_numpy
    from wrf_tpu_torch.parallel.sharded import (
        FIELDS_1D, FIELDS_2D, FIELDS_3D, case_to_domain, domain_window,
        pad_halo,
    )

    dom = arrays_from_numpy(case_to_domain(case), device)
    arr = {n: pad_halo(dom[n]) for n in FIELDS_3D + FIELDS_2D}
    arr.update({n: dom[n] for n in FIELDS_1D})
    b = case.bounds
    i0, i1, j0, j1, k0, k1 = domain_window(b.ide, b.jde, b.kdim, case.flags)
    static = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0, k1=k1,
                  kde=b.kdim - 1, rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                  epssm=case.epssm)
    return arr, static


def mode_kwargs(mode, arr, static):
    from wrf_tpu_torch.models.small_step import DEFAULT_CS2
    from wrf_tpu_torch.ops.advance_mu_t_cuda import lean_kwargs

    kw = dict(MODES[mode])
    k0 = static["k0"]
    if kw.get("fuse_uv"):
        kw["cs2"] = DEFAULT_CS2
    if kw.get("lean"):
        kw.update(lean_kwargs(arr, static["rdx"], static["rdy"],
                              static["dts"], k0, static["k1"]))
    if kw.get("ww_mode") in ("lite", "final"):
        kw["ww_row"] = (arr["ww"][:, k0, :]
                        + 0.01 * arr["ww_1"][:, k0 + 1, :]).contiguous()
    return kw


def fresh(arr, mkw):
    """Copies of what a call updates in place (t, t_ave, ww, ww_row)."""
    arr = dict(arr)
    for n in ("t", "t_ave", "ww"):
        arr[n] = arr[n].clone()
    mkw = dict(mkw)
    if "ww_row" in mkw:
        mkw["ww_row"] = mkw["ww_row"].clone()
    return arr, mkw


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_pair(arr, static, mkw):
    """CUDA-event ms per call of the kernel and of the plain version on the
    same inputs, two readings each, taken in the order plain, kernel,
    kernel, plain."""
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain,
    )

    a_k, m_k = fresh(arr, mkw)
    a_p, m_p = fresh(arr, mkw)

    def kern():
        advance_mu_t_fused(**a_k, **static, **m_k)

    def plain():
        advance_mu_t_fused_plain(**a_p, **static, **m_p)

    out = {"cuda": [], "plain": []}
    for name, fn, reps in (("plain", plain, 3), ("cuda", kern, 20),
                           ("cuda", kern, 20), ("plain", plain, 3)):
        out[name].append(cuda_ms(fn, reps))
    return out


def phase_kernel_vs_plain(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")),
        time_grids=(REF_GRID, BIG_GRID), card=""):
    import torch
    from wrf_tpu.grid import ConfigFlags
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain,
    )

    max_abs = 0.0
    timings = {}
    for grid, bc in cases:
        case = make_case(*grid, halo=3, seed=2026,
                         flags=ConfigFlags(**BC_VARIANTS[bc]))
        arr, static = padded_inputs(case, "cuda")
        J, K, I = arr["t"].shape
        for mode in MODES:
            mkw = mode_kwargs(mode, arr, static)
            a_k, m_k = fresh(arr, mkw)
            a_p, m_p = fresh(arr, mkw)
            got = advance_mu_t_fused(**a_k, **static, **m_k)
            want = advance_mu_t_fused_plain(**a_p, **static, **m_p)
            torch.cuda.synchronize()
            tag = f"{grid[0]}x{grid[1]}x{grid[2]} {bc} {mode}"
            if sorted(got) != sorted(want):
                raise AssertionError(f"K1 {tag}: outputs {sorted(got)}, "
                                     f"plain version {sorted(want)}")
            # the mu/t loop's modes are held to bits: K2 exact must equal
            # K1, and K1 its plain version
            max_abs = max(max_abs, check_fields(
                f"k1 {tag}", got, want, bit_exact=mode.endswith("_ws")))
            if grid in time_grids and bc == "specified":
                timings[grid, mode] = time_pair(arr, static, mkw)
                t = timings[grid, mode]
                print(f"[k1 time {J}x{K}x{I} {mode}] kernel "
                      f"{t['cuda'][0]:.4f} / {t['cuda'][1]:.4f} ms, plain "
                      f"{t['plain'][0]:.3f} / {t['plain'][1]:.3f} ms "
                      f"(order plain, kernel, kernel, plain; {card})")
        del arr
        torch.cuda.empty_cache()
    return max_abs, timings


def check_fields(tag, got, want, bit_exact=False):
    """Compare two dicts of CUDA tensors field by field at KERNEL_TOL (and
    to the bit with ``bit_exact``); prints one line per field and raises
    on a failure.  Returns the largest max_abs error."""
    from wrf_tpu.compare import compare

    max_abs = 0.0
    for name in sorted(want):
        r = compare(got[name].cpu().numpy(), want[name].cpu().numpy(), name,
                    **KERNEL_TOL)
        print(f"[{tag}] {name:7s} max_abs={r.max_abs_err:.3e} "
              f"max_rel={r.max_rel_err:.3e} scaled={r.max_scaled_err:.3f} "
              f"different={r.different}")
        if not r.passed or (bit_exact and r.different):
            raise AssertionError(f"{tag}: {r}")
        max_abs = max(max_abs, r.max_abs_err)
    return max_abs


def k2_inputs(arr, static):
    """What a K2 pass of the mu/t loop receives: the padded fields, the
    lean constants and a scan-seed row."""
    from wrf_tpu_torch.ops.advance_mu_t_cuda import lean_kwargs

    k0 = static["k0"]
    ins = {n: arr[n] for n in ("u", "v", "t", "t_1", "mu", "mu_tend", "msftx",
                               "msfty", "dnw", "fnm", "fnp", "rdnw")}
    ins.update(lean_kwargs(arr, static["rdx"], static["rdy"], static["dts"],
                           k0, static["k1"]))
    ins["ww_row"] = (arr["ww"][:, k0, :]
                     + 0.01 * arr["ww_1"][:, k0 + 1, :]).contiguous()
    return ins


def fresh_state(ins):
    """A copy of K2's inputs with its own t, mu and ww_row (updated in
    place by a call)."""
    return {**ins, **{n: ins[n].clone() for n in ("t", "mu", "ww_row")}}


def phase_k2_vs_plain(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")), card=""):
    import torch
    from wrf_tpu.grid import ConfigFlags
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep, advance_mu_t_multistep_plain,
    )

    max_abs = 0.0
    timings = {}
    for grid, bc in cases:
        case = make_case(*grid, halo=3, seed=2026,
                         flags=ConfigFlags(**BC_VARIANTS[bc]))
        arr, static = padded_inputs(case, "cuda")
        ins = k2_inputs(arr, static)
        J, K, I = arr["t"].shape
        for mode, mkw in K2_MODES.items():
            mkw = dict(mkw, wind_scale_step=DW)
            got = advance_mu_t_multistep(**fresh_state(ins), **static, **mkw)
            want = advance_mu_t_multistep_plain(**fresh_state(ins), **static,
                                                **mkw)
            torch.cuda.synchronize()
            tag = f"k2 {grid[0]}x{grid[1]}x{grid[2]} {bc} {mode}"
            max_abs = max(max_abs, check_fields(
                tag, got, want, bit_exact=not mkw.get("fast")))
            if grid == BIG_GRID and mode in K2_TIMED:
                a_k, a_p = fresh_state(ins), fresh_state(ins)
                out = {"cuda": [], "plain": []}
                for name, fn, reps in (
                        ("plain", advance_mu_t_multistep_plain, 2),
                        ("cuda", advance_mu_t_multistep, 20),
                        ("cuda", advance_mu_t_multistep, 20),
                        ("plain", advance_mu_t_multistep_plain, 2)):
                    a = a_k if name == "cuda" else a_p
                    out[name].append(cuda_ms(
                        lambda: fn(**a, **static, **mkw), reps)
                        / mkw["n_inner"])
                timings[mode] = out
                print(f"[k2 time {J}x{K}x{I} {mode}] ms per substep: kernel "
                      f"{out['cuda'][0]:.4f} / {out['cuda'][1]:.4f}, plain "
                      f"{out['plain'][0]:.3f} / {out['plain'][1]:.3f} "
                      f"(order plain, kernel, kernel, plain; {card})")
        del arr, ins
        torch.cuda.empty_cache()
    return max_abs, timings


def phase_k2_vs_k1(grid=BIG_GRID, n_inner=8, step0=16):
    """K2 exact against n_inner K1 lean/lite launches with the ramp's
    wind scales: the blocked loop's bit-compatibility contract."""
    import torch
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.ops.advance_mu_t_cuda import advance_mu_t_fused
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep, wind_ramp,
    )

    arr, static = padded_inputs(make_case(*grid, halo=3, seed=2026), "cuda")
    ins = k2_inputs(arr, static)
    got = advance_mu_t_multistep(**fresh_state(ins), **static,
                                 n_inner=n_inner, wind_step0=step0,
                                 wind_scale_step=DW)
    lean = {n: ins[n] for n in ("tconst", "dvdxi_const", "ww1_k0")}
    state = {n: ins[n].clone() for n in ("t", "mu", "ww_row")}
    const = {k: v for k, v in arr.items() if k not in state}
    for s in range(n_inner):
        out = advance_mu_t_fused(
            **const, **state, **lean, **static, with_tave=False,
            ww_mode="lite", lean=True,
            wind_scale=wind_ramp(step0, DW, s))
        state = {n: out[n] for n in state}
    torch.cuda.synchronize()
    check_fields(f"k2 vs {n_inner} k1 {grid[0]}x{grid[1]}x{grid[2]}",
                 got, state, bit_exact=True)


def phase_golden_file(tmp: Path):
    import torch
    from wrf_tpu.compare import compare
    from wrf_tpu.io import fixtures
    from wrf_tpu_torch.convert import arrays_from_numpy
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.ops.advance_mu_t_cuda import advance_mu_t_fused

    d = fixtures.write_case(make_case(*REF_GRID), tmp / "ref", steps=5)
    case, steps = fixtures.read_case(d)
    golden = fixtures.read_golden(d, case.bounds)
    kw = case.kernel_kwargs()
    arr = arrays_from_numpy({k: v for k, v in kw.items()
                             if hasattr(v, "ndim")}, "cuda")
    b = case.bounds
    i0, i1, j0, j1, k0, k1 = b.loop_bounds(case.flags)
    static = dict(window=(i0, i1, j0, j1), k0=k0, k1=k1,
                  kde=b.mem(b.kde, "k"),
                  **{k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")})
    for _ in range(steps):
        out = advance_mu_t_fused(**arr, **static)
        arr.update({k: out[k] for k in ("ww", "mu", "t", "t_ave")})
    torch.cuda.synchronize()
    for name in ("ww", "t", "t_ave", "mu", "muave", "muts", "mudf"):
        r = compare(out[name].cpu().numpy(), golden[name], name, **DEVICE_TOL)
        print(f"[golden {steps} steps] {r}")
        if not r.passed:
            raise AssertionError(f"golden-file check: {r}")


def rk3_golden_native(case, acoustic_steps: int, dt: float, snapshot: str):
    """One RK3 large step on memory-window arrays with the C++ oracle's
    wind and mu/t substeps — the structure of
    ``wrf_tpu.models.rk3.rk3_golden`` (which lives in a jax module)."""
    from wrf_tpu.native import advance_mu_t_native, advance_uv_native
    from wrf_tpu_torch.models.rk3 import rk3_stages
    from wrf_tpu_torch.models.small_step import DEFAULT_CS2

    f0 = case.fields
    start = {"u": f0["grid_u_2"], "v": f0["grid_v_2"], "t": f0["grid_t_2"],
             "ww": f0["grid_ww"], "mu": f0["grid_mu_2"],
             "t_ave": f0["t_2save"]}
    out = None
    for frac, n_sub in rk3_stages(acoustic_steps):
        fields = dict(f0)
        if snapshot == "stage":
            fields.update(grid_u_save=start["u"], grid_v_save=start["v"],
                          grid_t_save=start["t"], ww1=start["ww"])
        kw = dataclasses.replace(case, fields=fields,
                                 dts=(frac * dt) / n_sub).kernel_kwargs()
        state = dict(start)
        for _ in range(n_sub):
            u, v = advance_uv_native(
                u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
                muv=kw["muv"], msfuy=kw["msfuy"],
                msfvx_inv=kw["msfvx_inv"], rdx=kw["rdx"], rdy=kw["rdy"],
                dts=kw["dts"], cs2=DEFAULT_CS2, flags=case.flags,
                bounds=case.bounds)
            out = advance_mu_t_native(**{**kw, **state, "u": u, "v": v})
            state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                     "u": u, "v": v}
        out = {**out, "u": state["u"], "v": state["v"]}
    return out


def phase_slice(tmp: Path, fx: Path):
    import numpy as np
    import torch
    from wrf_tpu.compare import compare
    from wrf_tpu.io import checkpoint
    from wrf_tpu_torch import run_sim
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.parallel.sharded import case_to_domain, embed_outputs

    buf = io.StringIO()
    k1.LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main([str(fx), "--steps", "3", "--device", "cuda",
                           "--diagnostics", "--checkpoint-dir",
                           str(tmp / "ck"), "--checkpoint-every", "3"])
    launches = k1.LAUNCHES
    for line in buf.getvalue().splitlines():
        print(f"[run_sim] {line}")
    if rc != 0:
        raise AssertionError(f"run_sim returned {rc}")
    if launches != 3 * (1 + 2 + 4):
        raise AssertionError(f"run_sim launched K1 {launches} times, "
                             "expected 21")
    state, step, _ = checkpoint.load_checkpoint(tmp / "ck" / "step_000003")
    if step != 3 or not all(np.isfinite(v).all() for v in state.values()):
        raise AssertionError("run_sim's final state is not finite")
    checksum = float(np.sum(state["t"], dtype=np.float64))
    step_ms = [float(m.group(1)) for m in
               re.finditer(r"^step \d+: ([0-9.]+) ms", buf.getvalue(), re.M)]
    print(f"[slice] run_sim 3 large steps at {BIG_GRID}: K1 launches "
          f"{launches}, checksum {checksum:.6e}, step ms {step_ms}")

    case = make_case(*REF_GRID, halo=3, seed=2026)
    b = case.bounds
    dt = case.dts * 4
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, acoustic_steps=4,
                        kernel="cuda", snapshot="stage", device="cuda")
    before = k1.LAUNCHES
    out = rk3.step(rk3.prepare(case_to_domain(case)), case.rdx, case.rdy,
                   dt, case.epssm)
    torch.cuda.synchronize()
    if k1.LAUNCHES - before != 7:
        raise AssertionError(f"one RK3 step launched K1 "
                             f"{k1.LAUNCHES - before} times, expected 7")
    got = embed_outputs(case, arrays_to_numpy(out))
    gold = rk3_golden_native(case, 4, dt, "stage")
    for name in sorted(got):
        r = compare(got[name], gold[name], name, **DEVICE_TOL)
        print(f"[rk3 vs oracle] {r}")
        if not r.passed:
            raise AssertionError(f"RK3 step vs oracle: {r}")
    return launches, step_ms


def run_driver(tag, *argv):
    """``python -m wrf_tpu_torch.driver`` in this process, its report
    condensed to one line; raises unless it returns 0."""
    from wrf_tpu_torch import driver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main([*map(str, argv), "--device", "cuda"])
    text = buf.getvalue()
    timing = next((ln for ln in text.splitlines()
                   if ln.startswith("advance_mu_t [")), "")
    worst = max(float(x) for x in re.findall(r"scaled_err=([0-9.]+)", text))
    print(f"[driver {tag}] rc={rc} worst scaled_err={worst:.3f}: {timing}")
    if rc != 0:
        raise AssertionError(f"driver {tag} returned {rc}:\n{text}")


DRIVER_TIERS = {
    "cuda": ("--tier", "cuda"),
    "sharded-cuda S=1": ("--tier", "sharded-cuda"),
    "sharded-cuda S=8": ("--tier", "sharded-cuda", "--inner-steps", "8"),
    "sharded-cuda S=8 fast": ("--tier", "sharded-cuda", "--inner-steps", "8",
                              "--fast"),
}


def phase_driver(tmp: Path, fx_big: Path, big_steps: int):
    """The driver's tiers against the oracle's goldens: 1 and 100 steps at
    the reference grid under every lateral BC, then the mu/t slice's main
    path at 512x512x50; returns the K1 and K2 launches of that run."""
    from wrf_tpu.grid import ConfigFlags
    from wrf_tpu.io import fixtures
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2

    for bc, flags in BC_VARIANTS.items():
        case = make_case(*REF_GRID, halo=3, seed=2026,
                         flags=ConfigFlags(**flags))
        for steps in (1, 100):
            fx = fixtures.write_case(case, tmp / f"ref_{bc}_{steps}",
                                     steps=steps)
            for tier, args in DRIVER_TIERS.items():
                run_driver(f"{bc} {steps} steps {tier}", fx, *args)

    k1.LAUNCHES = k2.LAUNCHES = 0
    run_driver("x".join(map(str, BIG_GRID)) + f" {big_steps} steps "
               "sharded-cuda S=8", fx_big, *DRIVER_TIERS["sharded-cuda S=8"])
    launches = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES}
    # a warm-up and a timed loop call, each (steps-1)//8 K2 passes, the
    # remaining single substeps and the final substep on K1
    expected = {"k1": 2 * (1 + (big_steps - 1) % 8),
                "k2": 2 * ((big_steps - 1) // 8)}
    if launches != expected:
        raise AssertionError(f"the mu/t main path launched {launches}, "
                             f"expected {expected}")
    print(f"[driver] mu/t main path launches: {launches}")
    return launches


def loop_marginal_ms(case, counts, reps=5, **kw):
    """ms per substep of ShardedAdvanceMuT by the difference of two step
    counts (host clock around a call that ends in a synchronise; best of
    ``reps``), so the per-call set-up cancels."""
    import math

    import torch
    from wrf_tpu_torch.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain,
    )

    b = case.bounds
    best = {}
    for n in counts:
        loop = ShardedAdvanceMuT(b.ide, b.jde, b.kdim, case.flags,
                                 n_steps=n, vary_winds=True, device="cuda",
                                 **kw)
        arrays = loop.prepare(case_to_domain(case))
        checksum = float(loop(arrays, case.rdx, case.rdy, case.dts,
                              case.epssm)["t"].sum())
        if not math.isfinite(checksum):
            raise AssertionError(f"non-finite loop state at n={n} {kw}")
        best[n] = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
            torch.cuda.synchronize()
            best[n] = min(best[n], time.perf_counter() - t0)
        del arrays, loop
    n1, n2 = counts
    return (best[n2] - best[n1]) / (n2 - n1) * 1e3


LOOP_ROWS = {
    "512x512x50 S=1": (BIG_GRID, (65, 257), dict()),
    "512x512x50 exact S=8": (BIG_GRID, (65, 257), dict(inner_steps=8)),
    "512x512x50 fast S=32": (BIG_GRID, (129, 513),
                             dict(inner_steps=32, fast=True)),
    "74x61x32 exact S=8": (REF_GRID, (65, 257), dict(inner_steps=8)),
}


def phase_loop_timings(card=""):
    from wrf_tpu_torch.io.fixtures import make_case

    cases = {g: make_case(*g, halo=3, seed=2026, amplitude=1e-2,
                          balanced=True) for g in (BIG_GRID, REF_GRID)}
    out = {}
    for name, (grid, counts, kw) in LOOP_ROWS.items():
        out[name] = loop_marginal_ms(cases[grid], counts, **kw)
        print(f"[loop {name}] n={counts[0]}/{counts[1]}: "
              f"{out[name]:.4f} ms per substep ({card})")
    return out


def main() -> int:
    import torch

    name, smi = phase_env()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import wrf_tpu_torch  # noqa: F401  (fails outside the repository)
    from wrf_tpu.io import fixtures
    from wrf_tpu_torch.io.fixtures import make_case

    phase_build()
    k1_abs, k1_times = phase_kernel_vs_plain(card=smi)
    k2_abs, k2_times = phase_k2_vs_plain(card=smi)
    phase_k2_vs_k1()
    big_steps = 17
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        phase_golden_file(tmp)
        # the repo's long-horizon fixture (balanced, calm): the degenerate
        # stage-snapshot shell run_sim drives amplifies the state ~5e4x
        # per large step, and the noise fixture overflows by step 3.  Its
        # goldens are the oracle's 17 small steps, for the driver.
        fx_big = fixtures.write_case(make_case(
            *BIG_GRID, halo=3, seed=2026, amplitude=1e-2, balanced=True),
            tmp / "big", steps=big_steps)
        sim_launches, _ = phase_slice(tmp, fx_big)
        mut_launches = phase_driver(tmp, fx_big, big_steps)
    phase_loop_timings(card=smi)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    def mean(xs):
        return sum(xs) / len(xs)

    print(json.dumps({"kernels": [{
        "name": "advance_mu_t_fused",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t.cu",
        "replaces": "wrf_tpu/ops/advance_mu_t_pallas.py:114",
        "launches": mut_launches["k1"],
        "launches_by_path": {"run_sim": sim_launches,
                             "driver sharded-cuda S=8": mut_launches["k1"]},
        "max_abs_err": k1_abs,
        # ms per launch at 516x50x516: the mu/t loop's lite substep
        "ms": mean(k1_times[BIG_GRID, "lite_ws"]["cuda"]),
        "plain_ms": mean(k1_times[BIG_GRID, "lite_ws"]["plain"]),
    }, {
        "name": "advance_mu_t_multistep",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t_msteps.cu",
        "replaces": "wrf_tpu/ops/advance_mu_t_msteps.py:391",
        "launches": mut_launches["k2"],
        "max_abs_err": k2_abs,
        # ms per substep at 516x50x516, exact S=8
        "ms": mean(k2_times["exact S=8"]["cuda"]),
        "plain_ms": mean(k2_times["exact S=8"]["plain"]),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
