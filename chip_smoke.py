#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wrf_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code is
not 0 and no result line is printed):

1. environment: the card's name and power limit; a GPU is required;
2. build: the port's CUDA kernels from ``wrf_tpu_torch/csrc`` (nvcc)
   (and every K1, K2, K3, K6, K7 and K8 instance's registers, spills and
   static shared memory from ptxas: a spill fails the run; for K7 and K8,
   from ``cuobjdump -sass``, the global loads placed before the first
   float add);
3. K1 kernel vs its plain PyTorch version on the card, in the three modes
   of the run_sim path (reference call, scan substep, final substep) and
   the two of the mu/t loop (lean lite substep and final substep, winds
   scaled on load by ``wind_scale``) at 74x61x32 (specified, periodic and
   open lateral BCs) and 512x512x50, every mode held to bit-equality; all
   timed with CUDA events at both sizes.  Then the same three run_sim
   modes with ``fuse_w`` (the w/pp solve), bit-equal, timed at
   512x512x50;
3b. K1 with divergence damping (``mudf_in``, ``smdiv=0.1``): the fused scan
   and final substeps, with and without ``fuse_w``, and a chain of 6
   launches that hands each ``mudf`` on as the next ``mudf_in``, against
   the plain version bit for bit at the same grids and BCs; the damped
   scan substep timed beside the undamped one.  K1 with ``capture`` (the
   reference's plain full call plus the five ``*_before_theta`` outputs)
   against its plain version bit for bit, each capture equal to the output
   it is named after, timed with and without;
4. K2 kernel vs its plain version at the same grids and BCs: exact S=2
   and S=8 with the wind ramp started at substep 16 (bit-equality), fast
   S=8 and S=32 (rtol 2e-5, atol_scale 1e-6); exact S=8 and fast S=32
   timed at 512x512x50; then K2 exact S=8 against 8 K1 lite launches with
   the ramp's wind scales (bit-equality on t, mu and ww_row);
5. K3, the coupled trapezoid, vs its plain version on the ring-S inputs
   the blocked ``SmallStepLoop`` builds, at the same grids and BCs: exact
   S=2 to 8 (bit-equality) and fast S=4 (rtol 2e-5, atol_scale 1e-6),
   and K4 (``coupled_two_step``, K3's S=2 instance) bit-equal to its plain
   version; S=2, 4, 8 and fast S=4 timed at 512x512x50 (ms per
   substep); the same with ``fuse_w``; every launch prints the plan it
   took (the staged form, whose tile's 3-D operands sit in shared memory
   for all S substeps, at S=2-5 on both grids, S=6 and 7 at 74x61x32 and
   S=8 there with bf16 streams; the streaming form at S=6-8 otherwise and
   for every ``fuse_w`` launch); then K3 S=4 against 4
   K1 fused-scan launches at 512x512x50, without and with ``fuse_w`` (the
   ``different=`` counts, counted on the card; a nonzero count is held to
   rtol 2e-5, atol_scale 1e-6), the K3 launch timed beside the four K1
   launches on the same queued timer;
5b. K1's and K3's ``overlap`` (the j exchange inside the kernel) on the
   shards' blocks a mesh loop builds, the halo rows (ring rows) of mu, v,
   mudf_in (mu, u, v) in memory POISONED with 1e30: against the plain
   version and against the same kernel on rows that the ``rdma`` (width-S
   ``ppermute``) refresh restored, bit for bit: K1's scan and final
   substep with and without ``fuse_w`` and ``smdiv``, K3 exact S=2, 3, 4,
   8 (fast S=4 against its plain version at rtol 2e-5, atol_scale 1e-6) with
   and without ``fuse_w``, on rings of 1, 2 and 4 and on the (2,2) mesh at
   74x61x32 under the three BCs and on (2,2) at 512x512x50, where one
   shard's launch is timed with and without;
5c. K1, K2, K3 and K4 with bf16 constant streams: against the plain
   version on the same narrow inputs, against the float32 kernel on the
   rounded inputs and a mixed set against its rounded inputs, all bit for
   bit; a bf16 state operand must raise; at 512x512x50 every form the
   loops run is timed beside its float32 form;
6. K6, the copy kernel: each probe (ab, ab_plus1, aliased) equal to its
   plain version, also on an unaligned and on a ragged array; then the
   copy ceiling at 512x50x514, 1024x50x1502 and 516x50x516 with every
   probe's GB/s and ``Tensor.copy_`` on the same chain as the library
   yardstick;
6b. K7, the tiling probe: ``run_1d`` and ``run_2d`` equal to their plain
   versions bit for bit over the whole array (NaN outside the written
   region) at 130x50x1664 (the JAX defaults, ti 512), 516x50x516 (halo 2)
   and small shapes that run every instance (K 8, 16, 50 and run-time
   depths 33 and 7; both staging paths; one and two slabs in flight), and
   to each other on the lanes both wrote; the entry point ``python -m
   wrf_tpu_torch.tools.probe_2d --time`` at the JAX defaults and at
   516x50x516 (every 2-D launch there on the bulk path); both forms timed
   at 130x50x1664 and 516x50x516 for tj 2, 4 and ti 64, 128, 256
   (``utils.timing.per_step_time`` on the host clock and CUDA events on
   the same chains);
6c. K8, the feature ladder: each of the nine rungs equal to its plain
   version bit for bit at 26x16x512, 258x50x1280 and three small shapes
   (run-time depths 7 and 33, where rung j must refuse; two row slots; ti
   100) (rung e's second output and rung i's aliased operand too; h == j,
   d == a on d's region);
   the entry point ``python -m wrf_tpu_torch.tools.probe_2d_bisect
   <rung>`` for every rung (and rung d with ``--time``); every rung timed
   at 258x50x1280 beside its plain version;
7a. K5, the ring-neighbour row exchange: ``rdma_rows``,
   ``remote_refresh_axis`` and ``remote_refresh_multi`` against their plain
   versions and against the ``ppermute`` refresh on rings of 1, 2, 4 and 8
   blocks and on a 2x2 mesh, all on the one card, at the 512x512x50 loop's
   row sizes (bit-equality), one launch per exchange on the one card; K5
   per 2x2 exchange (one launch) timed beside its plain version, the
   ``ppermute`` refresh (``Tensor.copy_``) and the bare launch from a
   prebuilt plan, marginal ms between two chain lengths on CUDA events
   with the host clock's reading beside;
7b. the loops on a mesh at 512x512x50 (four shards on the one card): the
   coupled loop on (2,2) and (4,1) under ``ppermute`` and ``rdma``
   (bit-equal to each other; against the 1x1 loop at rtol 5e-5, atol_scale
   2e-6 with ``different=`` printed), once with ``with_w``, blocked S=2 and
   S=4 on (2,2), 1x1 with ``force_exchange`` under both backends, and the
   mu/t loop on (2,2); with ``smdiv=0.1`` the 1x1 loop against the
   oracle's golden loop (rtol 5e-5, atol_scale 2e-6) and (2,2) and (4,1)
   under both backends against it and each other bit for bit; under
   ``rdma_overlap`` every one of these loops (S=1, ``smdiv``, ``with_w``,
   blocked S=2 and S=4 on (2,2) and (4,1), 1x1 with ``force_exchange``)
   equal to its ``ppermute`` and ``rdma`` twins and to 1x1 bit for bit,
   with one K1 (K3) launch per shard per substep (block) and no K5
   launch; K1 against its plain version, and timed, at 259x50x259, one
   shard's block of the 2x2 mesh;
7c. the stage memo's pads (``models/stage_memo.py``): 3 closed RK3 steps
   at 512x512x50 with one integrator bit-equal to a cold one
   (``memo.keep = False``) that pads every stage anew (1x1 with w and
   damping, blocked S=2, bf16 constants; (2,2) and (2,1) under ``rdma``,
   (2,2) under ``rdma_overlap``), and the blocks built and reused at 1x1
   (31/32 on the first step, 20/43 on each later one);
7d. the stage memo's lean constants: 3 closed RK3 steps at 301x251x35
   (acoustic steps 4, with w and damping) with one integrator bit-equal
   to a cold one, the cached ``tconst``, ``dvdxi_const`` and ``ww1_k0``
   after them bit-equal to a fresh ``lean_kwargs`` of the memo's padded
   blocks, and ``stage_memo.LEAN`` per step: every part built
   once on step 1, then one ``tconst`` built and every other block reused;
   the last step traced, its ``wrf.loop.inputs`` counts 0, one
   ``tconst``'s bytes, 0;
7. the reference's golden-file check: 5 plain-call steps at 74x61x32
   through the kernel against the C++ oracle's golden outputs
   (rtol 5e-5, atol_scale 2e-6);
8. the run_sim slice through its entry point: ``wrf_tpu_torch.run_sim``
   for 3 large steps at 512x512x50 (balanced fixture, amplitude 1e-2):
   by default it must launch K1 exactly 21 times, with ``--inner-steps 2``
   (and ``--fast``) K3 3 times and K1 15 times, the same counts with
   ``--with-w`` and ``--with-w --inner-steps 2`` (whose checkpoints must
   carry finite w and pp), and stay finite; with ``--mesh 2x2
   --halo-backend rdma`` K1 84 times (4 shards x 7 substeps x 3 steps)
   and K5 21 times (one launch per device per substep: the four shards
   share the one card) and with ``--mesh 2x2`` alone K1 84 times, the
   final states equal to each other bit for bit and to the 1x1 run's at
   rtol 5e-5, atol_scale 2e-6; with ``--namelist`` (a JSON record that
   sets ``smdiv`` 0.1) K1 21 times, and with ``--mesh 2x2 --halo-backend
   rdma`` too K1 84 and K5 21 times, the mesh run equal to the 1x1 run bit
   for bit and the 1x1 run's first large step within the driver's gate
   (rtol 1e-4, atol_scale 1e-5) of the oracle's damped RK3 step; with
   ``--mesh 2x2 --halo-backend rdma_overlap`` K1 84 times and K5 never
   (plain and with ``--namelist``; with ``--inner-steps 2`` K1 60 and K3
   12 times), step 3 equal to the ``rdma`` run's and the 1x1 run's bit for
   bit; with ``--precision bf16-const`` (1x1, and once with ``--mesh 2x2
   --halo-backend rdma_overlap``) the float32 runs' launches, large step
   1 within 2e-2 of field scale of the float32 run's and the mesh run
   equal to the 1x1 run bit for bit; one large step of ``--kernel eager``
   (no kernel launched) within the driver's gate of the fused run; then
   one RK3 step at 74x61x32
   against the oracle's RK3 golden, with and without ``inner_steps=2``
   (acoustic_steps 4 and 8), with and without ``with_w`` (the oracle
   composition advance_uv -> advance_mu_t -> advance_w) and with
   ``smdiv=0.1``;
8b. the long-horizon path through the same entry point, ``run_sim
   --closure nudge`` on the balanced 512x512x50 fixture: 100 large steps
   (K1 exactly 700 launches, the largest |total-dry-mass drift| below
   2e-6, ms per large step), the same with ``--steps-per-sync 10``
   (final state bit-equal, perturbation sums within rtol 1e-5, ms per
   large step), one 10-step chunk under ``set_sync_debug_mode("error")``
   at 1x1 S=1 (required) and at S=2, with ``--with-w`` and on 2x2 under
   ``rdma`` and ``rdma_overlap`` (reported), 10 closed steps on 2x2 under
   ``rdma_overlap`` (K1 280, K5 0) and ``rdma`` (K1 280, K5 70) bit-equal
   to 1x1, 10 closed RK3 steps at 74x61x32 (acoustic_steps 6, smdiv 0.1)
   against the oracle's closed run (rtol 2e-4, atol_scale 2e-5), and
   ``--profile`` of 3 closed steps at S=1 and ``--inner-steps 2``: step
   3's device busy share, K1's and K3's launches and device ms, the other
   kernels by name;
9. the verification driver through its entry point,
   ``wrf_tpu_torch.driver``: tiers cuda and sharded-cuda (S=1, S=8, S=8
   --fast) at 74x61x32 for 1 and 100 steps and coupled (S=1, 2, 4, 4
   --fast) for 100 steps under the three lateral BCs, coupled --with-w
   (S=1, 2, 4) and coupled-eager --with-w for 100 steps (specified BC),
   coupled --mesh 2x2 --halo-backend rdma (and rdma_overlap) and
   sharded-cuda --mesh 2x2 for 100 steps under the three BCs, sharded-cuda
   and coupled with --precision bf16-const for 1 and 100 steps (specified
   BC; gate 2e-2 of field scale),
   then the blocked main paths at 512x512x50: sharded-cuda --inner-steps 8
   for 17 steps (K2 4 launches, K1 2), coupled --inner-steps 4 for 9
   steps (K3 4 launches, K1 2) and the same with --with-w; every run
   against the C++ oracle's goldens or the numpy golden loop at the
   driver's gate;
9b. ``driver --dump-intermediates`` at 74x61x32 on the cuda, eager and
   numpy tiers: the five files exist, the cuda tier's equal K1's plain
   version's bit for bit and both device tiers' agree with the numpy
   tier's at the driver's gate; then the native CLI executable, built with
   g++ from ``wrf_tpu_torch/native`` and run on the same fixture (return
   code 0, ``diff=0`` on its eight rows);
10. the loops' marginal ms per substep (two step counts, as ``bench.py``
    measures it): the mu/t loop (``ShardedAdvanceMuT``) S=1 and exact S=8
    at n=65/257 and fast S=32 at n=129/513 at 512x512x50, exact S=8 at
    74x61x32; the coupled loop (``SmallStepLoop``) S=1, exact S=2, 4, 8
    and fast S=4 at n=65/257 at 512x512x50, with ``with_w`` S=1, 2, 4, and
    on the (2,2) and (4,1) meshes under ``ppermute``, ``rdma`` and
    ``rdma_overlap``, with ``smdiv=0.1`` on 1x1 and on both meshes under
    the three backends, blocked S=2 on (2,2) under ``ppermute`` and
    ``rdma_overlap``, and both loops with bf16 constant streams; every row
    on the host clock and on CUDA events;
11. one ``torch.profiler`` trace per halo backend of the damped (2,2)
    loop: per substep the device's busy share, the copy kernels, K1's and
    K5's launches and K5's device time.
12. the loops across processes (``parallel/distributed.py``, through
    ``wrf_tpu_torch.tools.multihost_check``): at 512x512x50 on the (2,2) mesh, with every shard on ``cuda:0``,
    2 processes of 2 shards and 4 of 1, over gloo (rows and blocks staged
    through pinned host memory): the coupled loop at S=1 (9 substeps) and
    ``inner_steps=2``, ``ShardedAdvanceMuT(inner_steps=8)`` for 17 steps,
    3 closed RK3 large steps (4 acoustic substeps, nudging) and the
    transport alone (one j refresh of v and of mu, an i refresh of mu, a
    gather of t), every field bit-equal (``different=0``) to the
    one-process (2,2) run on the same card, every rank's K1, K2 and K3
    launches as its shards' share, the ms per large step and per
    exchange; each worker checks that it imported neither jax nor the JAX
    package.

13. the in-loop exchange's cost, ``wrf_tpu_torch.tools.bench_halo``: the
    coupled loop on a (1,1) mesh with and without ``force_exchange`` under
    each backend, S=1 and the depth-4 trapezoid, at 128x128x50 and
    512x512x50 (ms per substep, host clock; overhead in us);
14. the weak-scaling ladders, ``wrf_tpu_torch.tools.weak_scaling``, over
    every visible card (rung n on ``cuda:0`` .. ``cuda:n-1``; rung 1 alone
    on one card) at tiles of 256 and 512 under each backend at S=1 and
    S=4, one JSON line each;
15. the mesh over several cards in one process (shard s on ``cuda:s``):
    placement and ``scatter``/``gather``, the peer-access table and the
    refusal of a pair without it; K5 on the (2,2) mesh over four cards
    against its plain version, ``ppermute`` and the one-card mesh (one
    launch per card per exchange); both loops on (2,1), (3,1) and (2,2)
    over 2-4 cards under every backend (S=1, ``smdiv``, ``with_w``, S=2,
    S=4; the mu/t loop at S=1 and S=8) bit-equal to the same mesh on one
    card and to 1x1; ``run_sim --mesh 2x2`` under each backend and the
    closed 10-step run in one chunk bit-equal to 1x1; the mu/t loop on
    (3,1) over three cards at 74x61x32 timed beside BASELINE.md's 0.051
    ms; a profile of the damped (2,2) substep per card.  A check that
    needs more cards than are visible prints ``[multicard] not run: N
    CUDA device(s) visible`` and is not passed.

The last three lines of standard output are the card's name and power
limit (again), the kernel table ``{"kernels": [...]}`` (eight kernels,
each with its launches on the main paths, its time, its plain version's
time, its bound from the compulsory bytes at the data-sheet rate and, for
K6 and K5, the library call's time; K3 also its plan and staged bytes per
depth) and ``{"ok": true, "device": {...}}``.  The
script uses torch and the port alone, and checks at the end that neither
jax nor any module of the JAX package was imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
#: the domain whose padded ring-shaped array is one shard's block of BIG_GRID
#: on a 2x2 mesh: (512 + 2) / 2 + 2 = 259 = 255 + 2 + 2
SHARD_GRID = (255, 255, 50)
KERNEL_TOL = dict(rtol=2e-5, atol_scale=1e-6)
DEVICE_TOL = dict(rtol=5e-5, atol_scale=2e-6)
#: the verification driver's gate, for a whole large step at 512x512x50:
#: seven substeps amplify the state ~5e4x and the rounding noise with it,
#: and one or two of 13.4 M theta cells land at 1.05-1.2 of DEVICE_TOL
DRIVER_TOL = dict(rtol=1e-4, atol_scale=1e-5)
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
#: K1's modes on the --with-w path (scan and final: run_sim's; full: the
#: reference's single call), each with fuse_w
W_MODES = ("scan", "final", "full")
#: K2's modes: the ramp starts past 0, as in a loop's later passes
K2_MODES = {
    "exact S=2": dict(n_inner=2, wind_step0=16),
    "exact S=8": dict(n_inner=8, wind_step0=16),
    "fast S=8": dict(n_inner=8, wind_step0=16, fast=True),
    "fast S=32": dict(n_inner=32, wind_step0=32, fast=True),
}
K2_TIMED = ("exact S=8", "fast S=32")
DW = 1e-7   # the loop's wind ramp per substep
#: K3's modes: (depth S, fast)
K3_MODES = {
    "exact S=2": (2, False),
    "exact S=4": (4, False),
    "exact S=8": (8, False),
    "fast S=4": (4, True),
}
#: the other depths the loops accept, held to the plain version bit for bit
#: and timed nowhere: at 74x61x32 (K=32) the plan stages each of them, at
#: 512x512x50 (K=50) it stages S=3 and 5 and streams S=6 and 7
K3_CHECKED = {f"exact S={S}": (S, False) for S in (3, 5, 6, 7)}


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


#: K1's template parameters in mangled order (csrc/advance_mu_t_kernel.cuh)
K1_PARAMS = ("uv", "lean", "ww", "tave", "w", "damp", "cap", "overlap")


def ptxas_instances(log):
    """``{entry: (registers, spill bytes stored + loaded, static shared
    bytes)}`` from ``nvcc -Xptxas -v`` output."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = [0, 0, 0]
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[entry][2] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def instance_name(entry):
    """A readable name for a K1, K2, K3, K6, K7 or K8 entry (None for
    other kernels): K1's set template flags and stream type, K2's mode and
    stream type, K3's depth, form, flags and stream type, K6's probe arm,
    K7's form, depth and lanes a thread, K8's rung and depth."""
    if "advance_mu_t_kernel" in entry:
        args = re.findall(r"L([bi])(\d+)E", entry)
        flags = [f"{p}={v}" if p == "ww" else p
                 for p, (_, v) in zip(K1_PARAMS, args)
                 if p == "ww" or v != "0"]
        ww = {"ww=0": "full", "ww=1": "lite", "ww=2": "final"}
        flags = [ww.get(f, f) for f in flags]
        ct = "bf16" if "bfloat16" in entry else "f32"
        return "k1 " + " ".join(flags + [ct])
    if "msteps_exact" in entry or "msteps_fast" in entry:
        mode = "exact" if "msteps_exact" in entry else "fast"
        bf16 = "bfloat16" in entry or "bf16" in entry
        return f"k2 {mode} {'bf16' if bf16 else 'f32'}"
    if "staged_kernel" in entry or "coupled_kernel" in entry:
        # staged_kernel<S, OVERLAP, CT>, coupled_kernel<S, FUSE_W, OVERLAP,
        # CT>
        args = [v for _, v in re.findall(r"L([bi])(\d+)E", entry)]
        form = "staged" if "staged_kernel" in entry else "streaming"
        S, ov = args[0], args[-1]
        w = args[1] if form == "streaming" else "0"
        flags = [f"S={S}", form] + (["w"] if w == "1" else []) + (
            ["overlap"] if ov == "1" else [])
        ct = "bf16" if "bfloat16" in entry else "f32"
        return "k3 " + " ".join(flags + [ct])
    if "copy_kernel" in entry:
        plus1 = re.findall(r"L([bi])(\d+)E", entry)[0][1] == "1"
        return f"k6 copy{' plus1' if plus1 else ''}"
    args = [int(v) for _, v in re.findall(r"L([bi])(\d+)E", entry)]
    if "probe_1d_regs" in entry:     # probe_1d_regs<KT, V>
        return f"k7 1d K={args[0]} lanes={args[1]}"
    if "probe_1d_smem" in entry:
        return "k7 1d K=run-time"
    if "probe_2d_staged" in entry:   # probe_2d_staged<KT>
        return f"k7 2d K={args[0] or 'run-time'}"
    if "rung_a_kernel" in entry or "rung_b_kernel" in entry:
        return f"k8 rung {entry[entry.index('rung_') + 5]}"
    if "rung_tile_kernel" in entry:  # rung_tile_kernel<R, KT>
        return f"k8 rung {chr(args[0])}" + (f" K={args[1]}" if args[1]
                                             else "")
    return None


def loads_ahead(sass):
    """``{entry: (LDGs before its first FADD, LDGs)}`` for every function
    in ``cuobjdump -sass`` output: how many of a kernel's global loads the
    compiler placed ahead of the first use of any."""
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m.group(1)
            out[entry] = [0, 0, False]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if entry is None or m is None:
            continue
        rec = out[entry]
        if re.search(r"\bFADD\b", m.group(1)):
            rec[2] = True
        if re.search(r"\bLDG\b", m.group(1)):
            rec[1] += 1
            rec[0] += not rec[2]
    return {k: (v[0], v[1]) for k, v in out.items()}


def phase_build():
    from wrf_tpu_torch import _build

    t0 = time.perf_counter()
    path, log = _build.build(ptxas_info=True)
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print(f"[build]   {line.strip()}")
    # K1, K2, K3, K6, K7 and K8 must not spill (ptxas's view; dynamic
    # shared memory is the launch's: K1 takes it under fuse_w only, K3
    # always, K7's 2-D form and run-time-K 1-D form, K8's rungs h and j)
    spilled = []
    for entry, (regs, spill, smem) in sorted(ptxas_instances(log).items()):
        name = instance_name(entry)
        if name is None:
            continue
        print(f"[ptxas] {name}: {regs} registers, {spill} spill bytes, "
              f"{smem} static shared bytes")
        if spill:
            spilled.append(name)
    if spilled:
        raise AssertionError(f"K1-K3/K6-K8 instances spill: {spilled}")
    # the probes' loads ahead, read from the SASS (informational)
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        print(f"[sass] no {cuobjdump}: loads ahead not counted")
        return secs
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    for entry, (ahead, total) in sorted(loads_ahead(sass).items()):
        name = instance_name(entry)
        if name and name.startswith(("k7", "k8")):
            print(f"[sass] {name}: {ahead} of its {total} LDGs come before "
                  "its first FADD")
    return secs


@functools.lru_cache(maxsize=None)
def case_at(grid, bc="specified", balanced=False):
    """The phases' fixture case at ``grid`` under the lateral BC ``bc``
    (seed 2026; ``balanced``: the calm long-horizon fixture, amplitude
    1e-2), made once per run: a 512x512x50 case takes seconds to make,
    and nothing writes to its arrays (the port copies them to the card,
    the oracle copies what it updates)."""
    from wrf_tpu_torch.grid import ConfigFlags
    from wrf_tpu_torch.io.fixtures import make_case

    extra = dict(amplitude=1e-2, balanced=True) if balanced else {}
    return make_case(*grid, halo=3, seed=2026,
                     flags=ConfigFlags(**BC_VARIANTS[bc]), **extra)


def padded_inputs(case, device, with_w=False):
    """The arrays one K1 call receives on the main path: ring-shaped
    domain arrays, zero-padded by one cell, with the loop's window and
    offsets (wrf_tpu_torch.models.small_step).  ``with_w`` adds the w/pp
    state, ``rdn`` and the ``fuse_w`` arguments of the --with-w path."""
    from wrf_tpu_torch.convert import arrays_from_numpy
    from wrf_tpu_torch.parallel.sharded import (
        FIELDS_1D, FIELDS_2D, FIELDS_3D, case_to_domain, domain_window,
        pad_halo,
    )

    dom = arrays_from_numpy(case_to_domain(case, with_w=with_w), device)
    arr = {n: pad_halo(x) for n, x in dom.items()}   # 1-D fields as they are
    assert set(arr) >= set(FIELDS_3D + FIELDS_2D + FIELDS_1D)
    b = case.bounds
    i0, i1, j0, j1, k0, k1 = domain_window(b.ide, b.jde, b.kdim, case.flags)
    static = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0, k1=k1,
                  kde=b.kdim - 1, rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                  epssm=case.epssm)
    if with_w:
        from wrf_tpu_torch.ops.advance_w import DEFAULT_CW, DEFAULT_GW
        from wrf_tpu_torch.ops.thomas import thomas_vectors

        # the loop computes the Thomas K-vectors once per call and hands
        # them to every launch; so do the phases (fast: with the plain
        # version's cumsum vectors)
        static.update(fuse_w=True, cw=DEFAULT_CW, gw=DEFAULT_GW,
                      thomas=thomas_vectors(
                          rdn=arr["rdn"], rdnw=arr["rdnw"], dts=case.dts,
                          epssm=case.epssm, cw=DEFAULT_CW, gw=DEFAULT_GW,
                          k0=k0, k1=k1, fast=True))
    return arr, static


def mode_kwargs(mode, arr, static):
    from wrf_tpu_torch.ops.advance_uv import DEFAULT_CS2
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


def snapshot(*dicts):
    """Every tensor operand of ``dicts`` by name, with a copy of it: what
    :func:`check_kept` holds a K1 launch's operands to."""
    return {n: (x, x.clone()) for d in dicts for n, x in d.items()
            if hasattr(x, "is_cuda")}


def check_kept(tag, snap):
    """K1 writes none of its operands: each tensor of ``snap``
    (:func:`snapshot`) still holds its copy's bits, counted on the card.
    Prints one line and raises on a change."""
    changed = [n for n, (x, copy) in snap.items() if count_different(x, copy)]
    print(f"[{tag}] operands unchanged: {len(snap) - len(changed)} of "
          f"{len(snap)}")
    if changed:
        raise AssertionError(f"{tag}: the launch wrote {changed}")


#: GPU clock cycles the stream spins before a timed chain (about 10 ms):
#: the chain's launches queue up behind it, so the events time the card's
#: work and not the host's submission (a K1 launch at 259x50x259 takes the
#: card about as long as the wrapper takes the host)
PRIME_CYCLES = 20_000_000


def cuda_ms(fn, reps):
    """CUDA-event ms per call of ``fn`` over ``reps`` calls, after one
    untimed call; the calls are queued behind PRIME_CYCLES of spinning."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(PRIME_CYCLES)
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

    def kern():
        advance_mu_t_fused(**arr, **static, **mkw)

    def plain():
        advance_mu_t_fused_plain(**arr, **static, **mkw)

    out = {"cuda": [], "plain": []}
    for name, fn, reps in (("plain", plain, 3), ("cuda", kern, 20),
                           ("cuda", kern, 20), ("plain", plain, 3)):
        out[name].append(cuda_ms(fn, reps))
    return out


def phase_kernel_vs_plain(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")),
        time_grids=(REF_GRID, BIG_GRID), card="", with_w=False):
    """K1 against its plain version in every mode of MODES, bit for bit,
    timed beside it; ``with_w``: in the three modes of W_MODES with
    ``fuse_w`` (w and pp included).  Every operand is unchanged after both
    calls."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain,
    )

    max_abs = 0.0
    timings = {}
    name = "k1+w" if with_w else "k1"
    for grid, bc in cases:
        arr, static = padded_inputs(case_at(grid, bc), "cuda", with_w=with_w)
        J, K, I = arr["t"].shape
        for mode in (W_MODES if with_w else MODES):
            mkw = mode_kwargs(mode, arr, static)
            snap = snapshot(arr, mkw, static)
            got = advance_mu_t_fused(**arr, **static, **mkw)
            want = advance_mu_t_fused_plain(**arr, **static, **mkw)
            torch.cuda.synchronize()
            tag = f"{grid[0]}x{grid[1]}x{grid[2]} {bc} {mode}"
            check_kept(f"{name} {tag}", snap)
            del snap
            if sorted(got) != sorted(want) or (
                    with_w and not {"w", "pp"} <= set(got)):
                raise AssertionError(f"{name} {tag}: outputs {sorted(got)}, "
                                     f"plain version {sorted(want)}")
            # every mode is held to bits: the kernel keeps the plain
            # version's expressions and dmdt order (and K2 exact must equal
            # K1, K3 K1)
            max_abs = max(max_abs, check_fields(
                f"{name} {tag}", got, want, bit_exact=True))
            if grid in time_grids and bc == "specified":
                timings[grid, mode] = time_pair(arr, static, mkw)
                t = timings[grid, mode]
                print(f"[{name} time {J}x{K}x{I} {mode}] kernel "
                      f"{t['cuda'][0]:.4f} / {t['cuda'][1]:.4f} ms, plain "
                      f"{t['plain'][0]:.3f} / {t['plain'][1]:.3f} ms "
                      f"(order plain, kernel, kernel, plain; {card})")
        del arr
        torch.cuda.empty_cache()
    return max_abs, timings


def abba_ms(variants, reps=20):
    """CUDA-event ms per call of each ``{name: fn}`` variant, two readings
    each, taken in the order a, b, ..., b, a."""
    out = {name: [] for name in variants}
    order = list(variants) + list(variants)[::-1]
    for name in order:
        out[name].append(cuda_ms(variants[name], reps))
    return out


#: divergence damping as a namelist sets it (WRF's default)
SMDIV = 0.1


def phase_k1_damping(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")), card=""):
    """K1 with divergence damping (``mudf_in``, ``smdiv``) against its plain
    version, bit for bit: the fused scan substep and the final substep,
    with and without ``fuse_w``, ``mudf_in`` being the ``mudf`` of an
    undamped substep on the same inputs; then a chain of 6 launches (5 scan
    substeps and the final one) that hands each ``mudf`` on as the next
    ``mudf_in``, against the same chain of the plain version, bit for bit.
    At the big grid the damped scan substep is timed beside the undamped
    one (CUDA events, order undamped, damped, damped, undamped), and its
    plain version.  Returns the timings."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain,
    )

    timings = {}
    for grid, bc in cases:
        gtag = f"{grid[0]}x{grid[1]}x{grid[2]} {bc}"
        for with_w in (False, True):
            name = "k1+w smdiv" if with_w else "k1 smdiv"
            arr, static = padded_inputs(case_at(grid, bc), "cuda",
                                        with_w=with_w)
            scan = mode_kwargs("scan", arr, static)
            mudf = advance_mu_t_fused_plain(**arr, **static, **scan)["mudf"]
            if not float(mudf.abs().max()) > 0:
                raise AssertionError(f"{name} {gtag}: mudf is all zero")
            damp = dict(mudf_in=mudf, smdiv=SMDIV)
            for mode in ("scan", "final"):
                mkw = dict(mode_kwargs(mode, arr, static), **damp)
                snap = snapshot(arr, mkw)
                got = advance_mu_t_fused(**arr, **static, **mkw)
                want = advance_mu_t_fused_plain(**arr, **static, **mkw)
                off = advance_mu_t_fused(**arr, **static,
                                         **dict(mkw, smdiv=0.0))
                torch.cuda.synchronize()
                check_kept(f"{name} {gtag} {mode}", snap)
                del snap
                check_bits(f"{name} {gtag} {mode}", got, want)
                if not count_different(got["u"], off["u"]):
                    raise AssertionError(f"{name} {gtag} {mode}: damping "
                                         f"changed nothing")
            # the chain: mudf -> mudf_in, nothing copied
            final = mode_kwargs("final", arr, static)
            carry = ("ww_row", "mu", "t", "u", "v") + (
                ("w", "pp") if with_w else ())
            ends = {}
            for which, fn in (("kernel", advance_mu_t_fused),
                              ("plain", advance_mu_t_fused_plain)):
                state = {k: (scan if k == "ww_row" else arr)[k]
                         for k in carry}
                const = {k: v for k, v in arr.items() if k not in carry}
                lean = {k: v for k, v in scan.items() if k != "ww_row"}
                prev = torch.zeros_like(arr["mu"])
                for _ in range(5):
                    out = fn(**const, **state, **static, **lean,
                             mudf_in=prev, smdiv=SMDIV)
                    state = {k: out[k] for k in carry}
                    prev = out["mudf"]
                fkw = {k: v for k, v in final.items() if k != "ww_row"}
                ends[which] = fn(**const, **state, **static, **fkw,
                                 mudf_in=prev, smdiv=SMDIV)
            torch.cuda.synchronize()
            check_bits(f"{name} {gtag} chain of 6", ends["kernel"],
                       ends["plain"])
            if grid == BIG_GRID and not with_w:
                mkw = dict(scan, **damp)
                t = abba_ms({
                    "undamped": lambda: advance_mu_t_fused(
                        **arr, **static, **scan),
                    "damped": lambda: advance_mu_t_fused(
                        **arr, **static, **mkw)})
                t["plain"] = [cuda_ms(lambda: advance_mu_t_fused_plain(
                    **arr, **static, **mkw), 3)]
                timings["scan"] = t
                J, K, I = arr["t"].shape
                print(f"[k1 smdiv time {J}x{K}x{I} scan] kernel undamped "
                      f"{t['undamped'][0]:.4f} / {t['undamped'][1]:.4f} ms, "
                      f"damped {t['damped'][0]:.4f} / {t['damped'][1]:.4f} "
                      f"ms, plain damped {t['plain'][0]:.3f} ms (order "
                      f"undamped, damped, damped, undamped; {card})")
            del arr
            torch.cuda.empty_cache()
    return timings


def phase_k1_capture(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")), card=""):
    """K1's ``capture`` (the reference's plain full call plus the five
    ``*_before_theta`` outputs) against its plain version, bit for bit on
    every output; then what the capture exists to show: each capture equals
    the output it is named after (rows 0 and J-1, zero in the captures,
    left out); every operand is unchanged after the calls.  At the big
    grid the call is timed with and without ``capture`` (order without,
    with, with, without), and its plain version.  Returns the timings."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        CAPTURE_NAMES, advance_mu_t_fused, advance_mu_t_fused_plain,
    )

    timings = {}
    for grid, bc in cases:
        tag = f"k1 capture {grid[0]}x{grid[1]}x{grid[2]} {bc}"
        arr, static = padded_inputs(case_at(grid, bc), "cuda")
        snap = snapshot(arr)
        got = advance_mu_t_fused(**arr, **static, capture=True)
        want = advance_mu_t_fused_plain(**arr, **static, capture=True)
        torch.cuda.synchronize()
        check_kept(tag, snap)
        del snap
        if not set(CAPTURE_NAMES) <= set(got):
            raise AssertionError(f"{tag}: outputs {sorted(got)}")
        check_bits(tag, got, want)
        inner = slice(1, -1)
        for cap in CAPTURE_NAMES:
            out = cap.removesuffix("_before_theta")
            n = count_different(got[cap][inner], got[out][inner])
            edge = int((got[cap][0] != 0).sum() + (got[cap][-1] != 0).sum())
            print(f"[{tag}] {cap} vs {out}: different={n}, nonzero on rows "
                  f"0 and J-1: {edge}")
            if n or edge:
                raise AssertionError(f"{tag}: {cap} is not the {out} output")
        if grid == BIG_GRID:
            t = abba_ms({
                "without": lambda: advance_mu_t_fused(**arr, **static),
                "with": lambda: advance_mu_t_fused(**arr, **static,
                                                   capture=True)})
            t["plain"] = [cuda_ms(lambda: advance_mu_t_fused_plain(
                **arr, **static, capture=True), 3)]
            timings["full"] = t
            J, K, I = arr["t"].shape
            print(f"[k1 capture time {J}x{K}x{I} full] kernel without "
                  f"{t['without'][0]:.4f} / {t['without'][1]:.4f} ms, with "
                  f"{t['with'][0]:.4f} / {t['with'][1]:.4f} ms, plain with "
                  f"{t['plain'][0]:.3f} ms (order without, with, with, "
                  f"without; {card})")
        del arr
        torch.cuda.empty_cache()
    return timings


def count_different(got, want):
    """Elements of two CUDA tensors that differ (NaN equals NaN), counted
    on the card."""
    return int(((got != want) & ~(got.isnan() & want.isnan())).sum())


def check_bits(tag, got, want):
    """Two dicts of CUDA tensors must hold the same fields and agree bit
    for bit; prints one ``different=`` line per field (counted on the
    card) and raises on any difference."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag}: outputs {sorted(got)}, plain version "
                             f"{sorted(want)}")
    for name in sorted(want):
        n = count_different(got[name], want[name])
        print(f"[{tag}] {name:7s} different={n}")
        if n:
            raise AssertionError(f"{tag}: {name} differs in {n} elements")


def check_fields(tag, got, want, bit_exact=False, diffs=None):
    """Compare two dicts of CUDA tensors field by field at KERNEL_TOL, or
    to the bit with ``bit_exact`` (:func:`check_bits`, on the card); prints
    one line per field and raises on a failure.  Returns the largest
    max_abs error; ``diffs`` collects each field's count of differing
    elements."""
    from wrf_tpu_torch.compare import compare

    if bit_exact:
        check_bits(tag, got, want)
        return 0.0
    max_abs = 0.0
    for name in sorted(want):
        if not count_different(got[name], want[name]):
            # equal bit for bit (counted on the card): nothing to copy back
            if diffs is not None:
                diffs[name] = 0
            print(f"[{tag}] {name:7s} max_abs=0.000e+00 different=0")
            continue
        r = compare(got[name].cpu().numpy(), want[name].cpu().numpy(), name,
                    **KERNEL_TOL)
        if diffs is not None:
            diffs[name] = r.different
        print(f"[{tag}] {name:7s} max_abs={r.max_abs_err:.3e} "
              f"max_rel={r.max_rel_err:.3e} scaled={r.max_scaled_err:.3f} "
              f"different={r.different}")
        if not r.passed:
            raise AssertionError(f"{tag}: {r}")
        max_abs = max(max_abs, r.max_abs_err)
    return max_abs


def check_state(tag, got, want, bit_exact=False, tol=None):
    """Two dicts of numpy arrays (or tensors), field by field at ``tol``
    (DEVICE_TOL, the loops' tolerance, unless given), with the count of
    differing elements printed; ``bit_exact`` raises on any difference.
    Two CUDA tensors are counted on the card first, and copied back only if
    they differ.  Returns the counts."""
    import numpy as np
    from wrf_tpu_torch.compare import compare

    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag}: fields {sorted(got)} vs {sorted(want)}")
    tol = tol or DEVICE_TOL
    diffs, worst = {}, 0.0
    for name in sorted(want):
        if (getattr(got[name], "is_cuda", False)
                and getattr(want[name], "is_cuda", False)
                and not count_different(got[name], want[name])):
            diffs[name] = 0
            continue
        a, b = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
                for x in (got[name], want[name]))
        r = compare(a, b, name, **tol)
        diffs[name] = r.different
        worst = max(worst, r.max_scaled_err)
        if not r.passed or (bit_exact and r.different):
            raise AssertionError(f"{tag}: {r}")
    print(f"[{tag}] different= " + ", ".join(f"{k} {v}"
                                             for k, v in diffs.items())
          + (" (bit for bit)" if bit_exact else
             f" (rtol {tol['rtol']}, atol_scale {tol['atol_scale']}: worst "
             f"scaled error {worst:.3f} of 1)"))
    return diffs


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
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep, advance_mu_t_multistep_plain,
    )

    max_abs = 0.0
    timings = {}
    for grid, bc in cases:
        arr, static = padded_inputs(case_at(grid, bc), "cuda")
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
    from wrf_tpu_torch.ops.advance_mu_t_cuda import advance_mu_t_fused
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep, wind_ramp,
    )

    arr, static = padded_inputs(case_at(grid), "cuda")
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


def k3_inputs(arr, static, S):
    """What one K3 launch of the blocked coupled loop receives: the padded
    fields widened to ring S, the lean and coupled constants computed on
    the widened fields, and a scan-seed row; plus its static arguments."""
    from wrf_tpu_torch.ops.advance_uv import DEFAULT_CS2
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import (
        coupled_lean_kwargs,
    )
    from wrf_tpu_torch.ops.advance_mu_t_cuda import lean_kwargs
    from wrf_tpu_torch.parallel.halo import widen_ring_to

    k0, k1 = static["k0"], static["k1"]
    sc = (static["rdx"], static["rdy"], static["dts"])
    src = dict(arr, ww_row=(arr["ww"][:, k0, :]
                            + 0.01 * arr["ww_1"][:, k0 + 1, :]).contiguous())
    wide = {k: widen_ring_to(v, 0, S) if v.ndim > 1 else v
            for k, v in src.items()}
    ins = {k: wide[k] for k in ("u", "v", "t", "t_1", "mu", "mu_tend",
                                "msftx", "msfty", "ww_row", "dnw", "fnm",
                                "fnp", "rdnw")}
    ins.update(lean_kwargs(wide, *sc, k0, k1))
    ins.update(coupled_lean_kwargs(wide, *sc))
    if static.get("fuse_w"):
        ins.update(w=wide["w"], pp=wide["pp"], rdn=wide["rdn"])
    return ins, dict(static, cs2=DEFAULT_CS2)


def k3_form(ins, S, with_w=False, bf16=False):
    """The launch plan K3 takes for these inputs (``bf16``: with the
    constant streams narrowed), as a phrase: its form, tile and dynamic
    shared memory."""
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import plan

    J2, K, I = ins["t"].shape
    p = plan(S, K, with_w, 2 if bf16 else 4, False, J2, I)
    return f"form={p.form} tile={p.tile[0]}x{p.tile[1]} smem={p.smem}"


def fresh_k3(ins):
    """A copy of K3's inputs with its own t and ww_row, and w and pp where
    present (updated in place)."""
    return {**ins, **{n: ins[n].clone() for n in ("t", "ww_row", "w", "pp")
                      if n in ins}}


def phase_k3_vs_plain(
        cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
               (REF_GRID, "open"), (BIG_GRID, "specified")), card="",
        with_w=False):
    """K3 (and K4, its S=2 instance) against the plain version: exact modes
    bit for bit, the fast mode at KERNEL_TOL (the plain version's fast
    mode runs the log-depth cumsums, the kernel scans and solves
    sequentially); every mode timed at the big grid, ms per substep (per
    launch / S) with CUDA events in the order plain, kernel, kernel,
    plain.  ``with_w``: the same with ``fuse_w``."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import (
        coupled_multistep, coupled_multistep_plain, coupled_two_step,
    )

    runs = {m: (coupled_multistep, S, dict(n_inner=S, fast=fast))
            for m, (S, fast) in {**K3_MODES, **K3_CHECKED}.items()}
    runs["k4 pair"] = (coupled_two_step, 2, {})
    max_abs = {"k3": 0.0, "k4": 0.0}
    timings = {}
    name = "k3+w" if with_w else "k3"
    for grid, bc in cases:
        arr, static = padded_inputs(case_at(grid, bc), "cuda", with_w=with_w)
        for mode, (fn, S, mkw) in runs.items():
            kern = "k4" if fn is coupled_two_step else "k3"
            ins, st = k3_inputs(arr, static, S)
            pkw = dict(mkw, n_inner=S)
            got = fn(**fresh_k3(ins), **st, **mkw)
            want = coupled_multistep_plain(**fresh_k3(ins), **st, **pkw)
            torch.cuda.synchronize()
            tag = f"{name} {grid[0]}x{grid[1]}x{grid[2]} {bc} {mode}"
            print(f"[{tag}] {k3_form(ins, S, with_w)}")
            max_abs[kern] = max(max_abs[kern], check_fields(
                tag, got, want, bit_exact=not mkw.get("fast")))
            if grid == BIG_GRID and mode not in K3_CHECKED:
                a_k, a_p = fresh_k3(ins), fresh_k3(ins)
                out = {"cuda": [], "plain": []}
                for who, f, kw, reps in (
                        ("plain", coupled_multistep_plain, pkw, 2),
                        ("cuda", fn, mkw, 20), ("cuda", fn, mkw, 20),
                        ("plain", coupled_multistep_plain, pkw, 2)):
                    a = a_k if who == "cuda" else a_p
                    out[who].append(cuda_ms(
                        lambda: f(**a, **st, **kw), reps) / S)
                timings[mode] = out
                J, K, I = ins["t"].shape
                print(f"[{name} time {J}x{K}x{I} {mode}] ms per substep: kernel "
                      f"{out['cuda'][0]:.4f} / {out['cuda'][1]:.4f}, plain "
                      f"{out['plain'][0]:.3f} / {out['plain'][1]:.3f} "
                      f"(order plain, kernel, kernel, plain; {card})")
            del ins, got, want
        del arr
        torch.cuda.empty_cache()
    return max_abs, timings


def phase_k3_vs_k1(grid=BIG_GRID, S=4, with_w=False, card=""):
    """K3 exact against S K1 fused-scan launches (fuse_uv, lean, lite) on
    the ring-1 layout: the blocked loop against the loop it replaces;
    ``with_w``: both with ``fuse_w``, w and pp compared too.  Bit-equality
    is the goal: the ``different=`` counts (counted on the card) are
    printed, and a nonzero count is held to KERNEL_TOL.  Then one K3
    launch and the S K1 launches are timed on the same queued timer, in the
    order K1, K3, K3, K1.  Returns ``{"different": counts, "k3_ms": [...],
    "k1_ms": [...]}`` (ms per launch of K3, per S launches of K1)."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import coupled_multistep
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, lean_kwargs,
    )
    from wrf_tpu_torch.parallel.halo import strip_ring

    arr, static = padded_inputs(case_at(grid), "cuda", with_w=with_w)
    ins, st = k3_inputs(arr, static, S)
    got = coupled_multistep(**fresh_k3(ins), **st, n_inner=S)
    got = {k: strip_ring(v, 0, S) for k, v in got.items()}
    carry = ("ww_row", "mu", "t", "u", "v") + (("w", "pp") if with_w else ())
    state = {k: strip_ring(ins[k], 0, S).clone() for k in carry}
    const = {k: v for k, v in arr.items() if k not in carry}
    lean = lean_kwargs(arr, static["rdx"], static["rdy"], static["dts"],
                       static["k0"], static["k1"])
    for _ in range(S):
        out = advance_mu_t_fused(**const, **state, **lean, **st,
                                 fuse_uv=True, with_tave=False,
                                 ww_mode="lite", lean=True)
        state = {k: out[k] for k in carry}
    torch.cuda.synchronize()
    w_tag = "+w" if with_w else ""
    tag = f"k3{w_tag} vs {S} k1{w_tag} {grid[0]}x{grid[1]}x{grid[2]}"
    diffs = {k: count_different(got[k], state[k]) for k in carry}
    for k, n in diffs.items():
        print(f"[{tag}] {k:7s} different={n}")
    if any(diffs.values()):
        check_fields(tag, got, state)
    a3 = fresh_k3(ins)
    s1 = {k: strip_ring(ins[k], 0, S).clone() for k in carry}

    def k1_chain():
        for _ in range(S):
            advance_mu_t_fused(**const, **s1, **lean, **st, fuse_uv=True,
                               with_tave=False, ww_mode="lite", lean=True)

    def k3_launch():
        coupled_multistep(**a3, **st, n_inner=S)

    times = {"k1_ms": [], "k3_ms": []}
    for who in ("k1_ms", "k3_ms", "k3_ms", "k1_ms"):
        times[who].append(cuda_ms(k1_chain if who == "k1_ms" else k3_launch,
                                  10))
    print(f"[{tag} time] ms per launch of K3 {times['k3_ms'][0]:.4f} / "
          f"{times['k3_ms'][1]:.4f}, per {S} K1 fused-scan launches "
          f"{times['k1_ms'][0]:.4f} / {times['k1_ms'][1]:.4f} (per substep "
          f"{sum(times['k3_ms']) / 2 / S:.4f} against "
          f"{sum(times['k1_ms']) / 2 / S:.4f}; order K1, K3, K3, K1; "
          f"{card})")
    return {"different": diffs, **times}


def chain_marginal_ms(step, n1=20, n2=100, repeats=12):
    """Marginal ms per call of ``step(i)`` between chains of n1 and n2
    calls, best of ``repeats`` each: the method of ``measure_copy_gbps``.
    Every chain is read on two clocks, CUDA events around it and the host
    clock around it and the synchronise that ends it; returns ``(events_ms,
    host_ms)``.  The two agree when the card is the bottleneck; the host
    clock reads more when the chain is bound by what the host submits and
    the events' own records wait behind it."""
    import torch

    def chain(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for i in range(n):
            step(i)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3

    chain(2)
    best = {n: [min(x) for x in zip(*(chain(n) for _ in range(repeats)))]
            for n in (n1, n2)}
    return tuple((b2 - b1) / (n2 - n1) for b1, b2 in zip(best[n1], best[n2]))


POISON = 1e30
#: the meshes the in-kernel exchange is checked on: a ring of one (the loop's
#: ``force_exchange``: the neighbour is the shard itself), of two, of four,
#: and two rings of two with sharded i (corners through the i refresh)
OVERLAP_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))


def loop_shards(case, shape, prepared, backend="rdma_overlap", **kw):
    """A ``SmallStepLoop`` on a mesh of ``shape`` shards on the one card and
    what its first substep starts from, built by the loop's own glue: the
    loop, every shard's padded fields, the launches' common keywords, the
    carried state and ``(nj_loc, ni_loc)``.  ``prepared``: a dict that
    keeps the last layout's scattered arrays on the card (the loops leave
    them alone)."""
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import (
        case_to_domain, pad_local, shard_offsets,
    )

    b = case.bounds
    mesh = make_mesh(["cuda:0"] * (shape[0] * shape[1]), shape)
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=2,
                         device="cuda", mesh=mesh, halo_backend=backend,
                         force_exchange=shape == (1, 1), **kw)
    key = (id(case), shape, loop.with_w)
    if key not in prepared:
        prepared.clear()   # one layout on the card at a time
        prepared[key] = loop.prepare(case_to_domain(case, with_w=loop.with_w))
    arrays = prepared[key]
    nj_loc, _, ni_loc = arrays["t"][0, 0].shape
    local = pad_local({n: arrays[n] for n in loop._names}, mesh, loop._j_sh,
                      loop._i_sh)
    offs = {c: shard_offsets(c, nj_loc, ni_loc) for c in local}
    scalars = dict(rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                   epssm=case.epssm)
    common, state = loop._fused_inputs(local, scalars, offs)
    return loop, local, common, state, (nj_loc, ni_loc)


def rdma_twin(loop, case):
    """The same loop under the ``rdma`` backend: its ``_refresh_fused`` is
    the exchange-then-compute refresh (K5, then the i copies)."""
    from wrf_tpu_torch.models.small_step import SmallStepLoop

    b = case.bounds
    return SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=2,
                         device="cuda", mesh=loop.mesh, halo_backend="rdma",
                         force_exchange=loop.mesh.shape == (1, 1),
                         with_w=loop.with_w, smdiv=loop.smdiv)


def random_mudf(loop, case, seed=7):
    """A previous substep's ``mudf`` for every shard: one random ring-shaped
    field, scattered and given its halos by the loop's own glue, so that
    neighbouring blocks agree where they overlap."""
    import torch
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.sharded import pad_to_mesh, scatter

    b = case.bounds
    g = torch.Generator(device="cuda").manual_seed(seed)
    field = torch.randn((b.jde + 2, b.ide + 2), device="cuda", generator=g)
    return halo.halo2(scatter(pad_to_mesh(field, loop.mesh), loop.mesh),
                      loop.mesh, j_sharded=loop._j_sh, i_sharded=loop._i_sh)


def cloned(state):
    return {c: {k: v.clone() for k, v in st.items()}
            for c, st in state.items()}


def check_interior(tag, got, want, ring, bit_exact=True):
    """Every shard's outputs away from the ``ring`` pass-through rows on
    either side (stale under the in-kernel exchange, refreshed otherwise);
    one ``different=`` line for all shards and fields.  A poisoned row that
    a kernel read shows as a difference from the launch on refreshed rows."""
    n = 0
    for c in want:
        if sorted(got[c]) != sorted(want[c]):
            raise AssertionError(f"{tag}: outputs {sorted(got[c])} vs "
                                 f"{sorted(want[c])}")
        for name in want[c]:
            n += count_different(got[c][name][ring:-ring],
                                 want[c][name][ring:-ring])
    print(f"[{tag}] different={n}")
    if n and bit_exact:
        raise AssertionError(f"{tag}: {n} elements differ")
    return n


K1_LOOP_MODES = {
    "scan": dict(fuse_uv=True, with_tave=False, ww_mode="lite", lean=True),
    "final": dict(fuse_uv=True, with_tave=True, ww_mode="final"),
}


def phase_k1_overlap(cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
                            (REF_GRID, "open"), (BIG_GRID, "specified")),
                     card=""):
    """K1's ``overlap`` (the j exchange inside the kernel) on the shards'
    blocks a mesh loop builds, the memory halo rows of mu, v and mudf_in
    POISONED: against its plain version, and against K1 fed halos that the
    ``rdma`` refresh (K5, then the i copies) restored, bit for bit away
    from the pass-through rows; the scan and the final substep, with and
    without ``fuse_w`` and ``smdiv``, on rings of 1, 2 and 4 and on the
    (2,2) mesh at the reference grid under the three BCs, and on (2,2) at
    512x512x50 (a shard's block: 259x50x259), where the fused scan substep
    is also timed with and without, beside the plain version (CUDA events,
    order plain, without, with, with, without, plain; every launch of a
    chain starts from the same state, which K1 does not write).
    Returns the timings."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain, lean_kwargs,
    )

    timings, prepared = {}, {}
    for grid, bc in cases:
        case = case_at(grid, bc, balanced=grid == BIG_GRID)
        for shape in (OVERLAP_MESHES if grid == REF_GRID else ((2, 2),)):
            for with_w, damp in ((False, False), (False, True), (True, False),
                                 (True, True)):
                kw = dict(with_w=with_w, smdiv=SMDIV if damp else 0.0)
                loop, local, common, state, n_loc = loop_shards(
                    case, shape, prepared, **kw)
                refresher = rdma_twin(loop, case)
                if damp:
                    for c, blk in random_mudf(loop, case).items():
                        state[c]["mudf"] = blk
                lean = {c: lean_kwargs(p, case.rdx, case.rdy, case.dts,
                                       *loop.window[4:])
                        for c, p in local.items()}
                carry = loop.carry_keys
                const = {c: {k: v for k, v in p.items() if k not in carry}
                         for c, p in local.items()}

                def launch(fn, st, mode, ov):
                    out = {}
                    for c in st:
                        ins = dict(st[c])
                        if damp:
                            ins.update(mudf_in=ins.pop("mudf"), smdiv=SMDIV)
                        out[c] = fn(**const[c], **ins, **common[c], **ov[c],
                                    **K1_LOOP_MODES[mode],
                                    **(lean[c] if mode == "scan" else {}))
                    return out

                def poisoned():
                    st = cloned(state)
                    for s_ in st.values():
                        for n in ("mu", "v") + (("mudf",) if damp else ()):
                            s_[n][0] = s_[n][-1] = POISON
                    return st

                tag0 = (f"k1 overlap {grid[0]}x{grid[1]}x{grid[2]} {bc} mesh "
                        f"{shape[0]}x{shape[1]}{' +w' if with_w else ''}"
                        f"{' smdiv' if damp else ''}")
                for mode in K1_LOOP_MODES:
                    st = poisoned()   # restored by K5 and the i copies
                    none = refresher._refresh_fused(st, n_loc)
                    ref = launch(advance_mu_t_fused, st, mode, none)
                    st = poisoned()
                    ov = loop._refresh_fused(st, n_loc)
                    got = launch(advance_mu_t_fused, st, mode, ov)
                    st = poisoned()
                    ov = loop._refresh_fused(st, n_loc)
                    want = launch(advance_mu_t_fused_plain, st, mode, ov)
                    torch.cuda.synchronize()
                    check_interior(f"{tag0} {mode} vs plain", got, want, 1)
                    check_interior(f"{tag0} {mode} vs rdma-refreshed halos",
                                   got, ref, 1)
                if grid == BIG_GRID and not with_w:
                    c = (0, 0)
                    st = cloned(state)
                    none = refresher._refresh_fused(st, n_loc)
                    ov = loop._refresh_fused(st, n_loc)
                    one = {c: st[c]}
                    t = abba_ms({
                        "plain": lambda: launch(advance_mu_t_fused_plain,
                                                one, "scan", ov),
                        "without": lambda: launch(advance_mu_t_fused, one,
                                                  "scan", none),
                        "with": lambda: launch(advance_mu_t_fused, one,
                                               "scan", ov)},
                        reps=10)
                    timings["smdiv" if damp else "scan"] = t
                    J, K, I = st[c]["t"].shape
                    print(f"[k1 overlap time {J}x{K}x{I} scan"
                          f"{' smdiv' if damp else ''}] kernel without "
                          f"{t['without'][0]:.4f} / {t['without'][1]:.4f} ms, "
                          f"with {t['with'][0]:.4f} / {t['with'][1]:.4f} ms, "
                          f"plain with {t['plain'][0]:.3f} / "
                          f"{t['plain'][1]:.3f} ms (one shard of 2x2; order "
                          f"plain, without, with, with, without, plain; "
                          f"{card})")
                del loop, local, common, state, const, lean, refresher
                torch.cuda.empty_cache()
    return timings


def phase_k3_overlap(cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
                            (REF_GRID, "open"), (BIG_GRID, "specified")),
                     card=""):
    """K3's ``overlap`` (the j leg of the width-S exchange inside the
    kernel) on the ring-S blocks the blocked mesh loop builds, the ring rows
    of mu, u and v POISONED: against its plain version (exact bit for bit,
    fast at KERNEL_TOL) and against K3 on ring rows that the width-S
    ``ppermute`` refresh restored (bit for bit), at S=2, 3, 4 and 8 (S=3:
    odd, so the staged boxes are widened to 16 bytes), with and without
    ``fuse_w``; meshes and grids as :func:`phase_k1_overlap`.  At
    512x512x50 the S=2 launch is timed with and without, beside the plain
    version.  Returns the timings (ms per substep)."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import (
        coupled_multistep, coupled_multistep_plain,
    )
    from wrf_tpu_torch.parallel import halo

    timings, prepared = {}, {}
    for grid, bc in cases:
        case = case_at(grid, bc, balanced=grid == BIG_GRID)
        for shape in (OVERLAP_MESHES if grid == REF_GRID else ((2, 2),)):
            for with_w in (False, True):
                for S, fast in ((2, False), (3, False), (4, False),
                                (8, False), (4, True)):
                    if (case.bounds.jde + 2) // shape[0] < S:
                        continue   # fewer rows per shard than the ring
                    loop, local, common, state, n_loc = loop_shards(
                        case, shape, prepared, inner_steps=S, fast=fast,
                        with_w=with_w)
                    const, st0, com = loop._block_inputs(local, state, common,
                                                         n_loc)
                    mesh = loop.mesh

                    def launch(fn, st, ov, keep=True):
                        out = {}
                        for c in st:
                            ins = dict(st[c])
                            for n in ("t", "ww_row", "w", "pp"):
                                if keep and n in ins:   # updated in place
                                    ins[n] = ins[n].clone()
                            out[c] = fn(**const[c], **ins, **com[c], **ov[c],
                                        n_inner=S, fast=fast)
                        return out

                    def poisoned():
                        st = cloned(st0)
                        for s_ in st.values():
                            for n in ("mu", "u", "v"):
                                s_[n][:S] = POISON
                                s_[n][-S:] = POISON
                        return st

                    def refresh(st, j_leg):
                        for n in ("mu", "u", "v"):
                            blocks = {c: s_[n] for c, s_ in st.items()}
                            if j_leg:
                                halo.refresh_axis_w(blocks, 0, "j", mesh,
                                                    n_loc[0], S)
                            if loop._i_sh:
                                halo.refresh_axis_w(blocks, blocks[0, 0].ndim
                                                    - 1, "i", mesh, n_loc[1],
                                                    S)
                        return st

                    def rows(st):
                        return {c: {"overlap": r} for c, r in
                                loop._k3_overlap_rows(st, n_loc[0]).items()}

                    none = {c: {} for c in st0}
                    tag0 = (f"k3 overlap {grid[0]}x{grid[1]}x{grid[2]} {bc} "
                            f"mesh {shape[0]}x{shape[1]} "
                            f"{'fast' if fast else 'exact'} S={S}"
                            f"{' +w' if with_w else ''}")
                    print(f"[{tag0}] "
                          f"{k3_form(next(iter(st0.values())), S, with_w)}")
                    ref = launch(coupled_multistep,
                                 refresh(poisoned(), True), none)
                    st = refresh(poisoned(), False)
                    got = launch(coupled_multistep, st, rows(st))
                    st = refresh(poisoned(), False)
                    want = launch(coupled_multistep_plain, st, rows(st))
                    torch.cuda.synchronize()
                    n = check_interior(f"{tag0} vs plain", got, want, S,
                                       bit_exact=not fast)
                    if n:   # fast: the plain version runs the cumsums
                        for c in want:
                            check_fields(
                                f"{tag0} vs plain, shard {c}",
                                {k: v[S:-S] for k, v in got[c].items()},
                                {k: v[S:-S] for k, v in want[c].items()})
                    check_interior(f"{tag0} vs refreshed ring rows", got, ref,
                                   S)
                    if grid == BIG_GRID and S == 2 and not with_w:
                        c = (0, 0)
                        st = refresh(cloned(st0), True)
                        one, ov = {c: st[c]}, rows(st)
                        t = abba_ms({
                            "plain": lambda: launch(coupled_multistep_plain,
                                                    one, ov, keep=False),
                            "without": lambda: launch(coupled_multistep, one,
                                                      none, keep=False),
                            "with": lambda: launch(coupled_multistep, one,
                                                   ov, keep=False)}, reps=10)
                        timings["S=2"] = {k: [x / S for x in v]
                                          for k, v in t.items()}
                        t = timings["S=2"]
                        J, K, I = st[c]["t"].shape
                        print(f"[k3 overlap time {J}x{K}x{I} exact S=2] ms "
                              f"per substep: kernel without "
                              f"{t['without'][0]:.4f} / {t['without'][1]:.4f}"
                              f", with {t['with'][0]:.4f} / "
                              f"{t['with'][1]:.4f}, plain with "
                              f"{t['plain'][0]:.3f} / {t['plain'][1]:.3f} "
                              f"(one shard of 2x2; order plain, without, "
                              f"with, with, without, plain; {card})")
                    del loop, local, common, state, const, st0, com
                    torch.cuda.empty_cache()
    return timings


def narrowed(d, names):
    """``d`` with the tensors ``names`` as bf16 (rounded to nearest even)."""
    import torch

    return {k: (v.to(torch.bfloat16) if k in names else v)
            for k, v in d.items()}


def rounded(d, names):
    """``d`` with the tensors ``names`` rounded to bf16 and widened back:
    what a kernel that widens on load computes on."""
    import torch

    return {k: (v.to(torch.bfloat16).float() if k in names else v)
            for k, v in d.items()}


def expect_bf16_state_refused(tag, fn, kwargs, name):
    import torch

    bad = dict(kwargs, **{name: kwargs[name].to(torch.bfloat16)})
    try:
        fn(**bad)
    except ValueError as e:
        if f"bf16 {name!r} is not a constant stream" not in str(e):
            raise
        print(f"[{tag}] bf16 {name!r} (state) raises ValueError")
        return
    raise AssertionError(f"{tag}: a bf16 {name!r} was accepted")


#: K1's modes with bf16 constant streams: the eligible operands each one
#: reads (the loops narrow the whole set)
K1_BF16_MODES = {
    "scan": ("t_1", "tconst", "dvdxi_const"),
    "final": ("t_1", "ww_1", "u_1", "v_1", "ft"),
    "full": ("t_1", "ww_1", "u_1", "v_1", "ft", "u", "v"),
    "lite_ws": ("t_1", "tconst", "dvdxi_const", "u", "v"),
    "final_ws": ("t_1", "ww_1", "u_1", "v_1", "ft", "u", "v"),
}


def phase_bf16(cases=((REF_GRID, "specified"), (REF_GRID, "periodic"),
                      (REF_GRID, "open"), (BIG_GRID, "specified")), card=""):
    """K1, K2, K3 and K4 with bf16 constant streams: against their plain
    versions on the same narrow inputs and against the float32 kernels on
    the rounded inputs, bit for bit (widening is exact); a mixed set (the
    wrapper widens the minority) likewise; a bf16 state operand raises.
    K1 in the five modes of MODES (the fused ones also with ``fuse_w``), K2
    exact S=8 and fast S=8, K3 exact S=2 to 8 (also with ``fuse_w``) and
    K4.  At 512x512x50 every form the loops run is timed beside its float32
    form (CUDA events, order float32, bf16, bf16, float32).  Returns the
    timings."""
    import torch
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import (
        coupled_multistep, coupled_multistep_plain, coupled_two_step,
    )
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        advance_mu_t_fused, advance_mu_t_fused_plain,
    )
    from wrf_tpu_torch.ops.advance_mu_t_msteps_cuda import (
        advance_mu_t_multistep, advance_mu_t_multistep_plain,
    )

    timings = {}

    def pair_ms(name, f32, bf16, per=1):
        t = abba_ms({"f32": f32, "bf16": bf16})
        timings[name] = {k: [x / per for x in v] for k, v in t.items()}
        t = timings[name]
        print(f"[bf16 time {name}] ms{' per substep' if per > 1 else ''}: "
              f"float32 {t['f32'][0]:.4f} / {t['f32'][1]:.4f}, bf16 "
              f"{t['bf16'][0]:.4f} / {t['bf16'][1]:.4f} (order float32, "
              f"bf16, bf16, float32; {card})")

    for grid, bc in cases:
        gtag = f"{grid[0]}x{grid[1]}x{grid[2]} {bc}"
        big = grid == BIG_GRID
        for with_w in (False, True):
            arr, static = padded_inputs(case_at(grid, bc), "cuda",
                                        with_w=with_w)
            for mode, names in K1_BF16_MODES.items():
                if with_w and mode not in W_MODES:
                    continue
                mkw = mode_kwargs(mode, arr, static)
                both = {**arr, **mkw}
                tag = f"k1{'+w' if with_w else ''} bf16 {gtag} {mode}"

                def call(fn, src):
                    return fn(**src, **static)

                got = call(advance_mu_t_fused, narrowed(both, names))
                want = call(advance_mu_t_fused_plain, narrowed(both, names))
                wide = call(advance_mu_t_fused, rounded(both, names))
                mixed = call(advance_mu_t_fused, narrowed(both, names[::2]))
                mixed_w = call(advance_mu_t_fused, rounded(both, names[::2]))
                f32 = call(advance_mu_t_fused, both)
                torch.cuda.synchronize()
                check_bits(f"{tag} vs plain", got, want)
                check_bits(f"{tag} vs float32 kernel on rounded inputs", got,
                           wide)
                check_bits(f"{tag} mixed set vs rounded inputs", mixed,
                           mixed_w)
                if not count_different(got["t"], f32["t"]):
                    raise AssertionError(f"{tag}: bf16 changed nothing")
                if not with_w:
                    expect_bf16_state_refused(
                        tag, advance_mu_t_fused, {**both, **static}, "t")
                if big and mode in ("scan", "lite_ws", "final"):
                    nb = narrowed(both, names)
                    pair_ms(f"k1{'+w' if with_w else ''} {mode}",
                            lambda: advance_mu_t_fused(**both, **static),
                            lambda: advance_mu_t_fused(**nb, **static))
            if not with_w:
                ins = k2_inputs(arr, static)
                names = ("u", "v", "t_1", "tconst", "dvdxi_const")
                for mode in ("exact S=8", "fast S=8"):
                    mkw = dict(K2_MODES[mode], wind_scale_step=DW)
                    tag = f"k2 bf16 {gtag} {mode}"
                    got = advance_mu_t_multistep(
                        **fresh_state(narrowed(ins, names)), **static, **mkw)
                    want = advance_mu_t_multistep_plain(
                        **fresh_state(narrowed(ins, names)), **static, **mkw)
                    wide = advance_mu_t_multistep(
                        **fresh_state(rounded(ins, names)), **static, **mkw)
                    mixed = advance_mu_t_multistep(
                        **fresh_state(narrowed(ins, names[::2])), **static,
                        **mkw)
                    mixed_w = advance_mu_t_multistep(
                        **fresh_state(rounded(ins, names[::2])), **static,
                        **mkw)
                    torch.cuda.synchronize()
                    check_fields(f"{tag} vs plain", got, want,
                                 bit_exact=not mkw.get("fast"))
                    check_bits(f"{tag} vs float32 kernel on rounded inputs",
                               got, wide)
                    check_bits(f"{tag} mixed set vs rounded inputs", mixed,
                               mixed_w)
                expect_bf16_state_refused(
                    f"k2 bf16 {gtag}", advance_mu_t_multistep,
                    {**fresh_state(ins), **static, "n_inner": 2}, "t")
                if big:
                    mkw = dict(K2_MODES["exact S=8"], wind_scale_step=DW)
                    a_f = fresh_state(ins)
                    a_b = fresh_state(narrowed(ins, names))
                    pair_ms("k2 exact S=8",
                            lambda: advance_mu_t_multistep(**a_f, **static,
                                                           **mkw),
                            lambda: advance_mu_t_multistep(**a_b, **static,
                                                           **mkw), per=8)
                del ins
            names = ("t_1", "tconst", "dvdxi_const")
            runs = {f"exact S={S}": (coupled_multistep, S, dict(n_inner=S))
                    for S in range(2, 9)}
            runs["k4 pair"] = (coupled_two_step, 2, {})
            for mode, (fn, S, mkw) in runs.items():
                ins, st = k3_inputs(arr, static, S)
                tag = f"k3{'+w' if with_w else ''} bf16 {gtag} {mode}"
                print(f"[{tag}] {k3_form(ins, S, with_w, bf16=True)}; "
                      f"float32 {k3_form(ins, S, with_w)}")
                got = fn(**fresh_k3(narrowed(ins, names)), **st, **mkw)
                want = coupled_multistep_plain(
                    **fresh_k3(narrowed(ins, names)), **st, n_inner=S)
                wide = fn(**fresh_k3(rounded(ins, names)), **st, **mkw)
                mixed = fn(**fresh_k3(narrowed(ins, names[:1])), **st, **mkw)
                mixed_w = fn(**fresh_k3(rounded(ins, names[:1])), **st, **mkw)
                torch.cuda.synchronize()
                check_bits(f"{tag} vs plain", got, want)
                check_bits(f"{tag} vs float32 kernel on rounded inputs", got,
                           wide)
                check_bits(f"{tag} mixed set vs rounded inputs", mixed,
                           mixed_w)
                if not with_w:
                    expect_bf16_state_refused(tag, fn,
                                              {**fresh_k3(ins), **st, **mkw},
                                              "u")
                if big and not with_w and S in (2, 4, 8):
                    a_f = fresh_k3(ins)
                    a_b = fresh_k3(narrowed(ins, names))
                    pair_ms(f"k3 {mode}",
                            lambda: fn(**a_f, **st, **mkw),
                            lambda: fn(**a_b, **st, **mkw), per=S)
                del ins, got, want, wide, mixed, mixed_w
            del arr
            torch.cuda.empty_cache()
    return timings


def phase_copy_ceiling(card=""):
    """K6: every probe against its plain version (exactly; also on an
    unaligned odd-sized array, which takes the scalar path, and on a
    ragged tail), then the copy ceiling at the three shapes with every
    probe printed, and ``Tensor.copy_`` on the same ping-pong chain as the
    library yardstick.  Returns per shape the ceiling, its probe, each
    probe's GB/s and the library's GB/s, plus the launches the ceiling
    measurement made."""
    import torch
    from wrf_tpu_torch.utils import copy_ceiling as k6

    g = torch.Generator(device="cuda").manual_seed(2026)
    base = torch.randn(105 + 516 * 50 * 516 + 3, device="cuda", generator=g)
    views = {"516x50x516": base[:516 * 50 * 516].view(516, 50, 516),
             "unaligned 7x5x3": base[1:106].view(7, 5, 3),
             "tail 1x1x1027": base[4:1031].view(1, 1, 1027)}
    for vname, x in views.items():
        for probe, (plus1, in_place) in k6.PROBES.items():
            xa, xb = x.clone(), x.clone()
            if vname.startswith("unaligned"):   # clone() realigns: re-offset
                pad_a = torch.empty(x.numel() + 1, device="cuda")
                pad_b = torch.empty(x.numel() + 1, device="cuda")
                xa = pad_a[1:].view(x.shape).copy_(x)
                xb = pad_b[1:].view(x.shape).copy_(x)
                assert xa.data_ptr() % 16 != 0
            got = k6.copy_probe(xa, xa if in_place else torch.empty_like(xa),
                                plus1)
            want = k6.copy_probe_plain(
                xb, xb if in_place else torch.empty_like(xb), plus1)
            torch.cuda.synchronize()
            n = count_different(got, want)
            print(f"[k6 {vname} {probe}] different={n}")
            if n or not torch.equal(want, x + 1 if plus1 else x):
                raise AssertionError(f"k6 {vname} {probe}: {n} elements "
                                     f"differ from the plain version")
    del base, views

    out = {}
    k6.LAUNCHES = 0
    for shape in k6.SHAPES:
        J, K, I = shape
        nbytes = 2 * J * K * I * 4
        rates = {}
        best, src, err = k6.measure_copy_ceiling(shape, readings=rates)
        if err:
            print(f"[k6 {J}x{K}x{I}] probe error: {err}")
        a = torch.ones(shape, device="cuda")
        b = torch.empty_like(a)
        bufs = (a, b)
        lib_ms, _ = chain_marginal_ms(
            lambda i: bufs[(i + 1) % 2].copy_(bufs[i % 2]))
        lib = nbytes / (lib_ms * 1e-3) / 1e9
        over = [p for p, r in rates.items() if r > k6.HBM_SPEC_GBPS]
        print(f"[k6 ceiling {J}x{K}x{I}, {nbytes / 1e6:.1f} MB moved per "
              f"copy] " + ", ".join(f"{p} {r:.1f}" for p, r in rates.items())
              + f" GB/s; ceiling {best:.1f} GB/s ({src}); Tensor.copy_ "
              f"{lib:.1f} GB/s; above the {k6.HBM_SPEC_GBPS:.0f} GB/s data "
              f"sheet (discarded): {over or 'none'} ({card})")
        if not best > 0:
            raise AssertionError(f"k6 {shape}: no plausible probe reading")
        out[shape] = dict(ceiling=best, probe=src, rates=rates, library=lib,
                          library_ms=lib_ms, nbytes=nbytes)
        del a, b, bufs
        torch.cuda.empty_cache()
    return out, k6.LAUNCHES


def bits_different(got, want):
    """Elements of two float32 CUDA tensors whose bits differ (a NaN equals
    only a NaN of the same bits), counted on the card."""
    import torch

    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def probe_main(module, tag, argv):
    """``module.main(argv)`` (a probe's entry point) in this process, its
    lines printed under ``[tag]``; raises unless it returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"[{tag}] {line}")
    if rc != 0:
        raise AssertionError(f"{tag} {' '.join(argv)} returned {rc}")
    return buf.getvalue()


#: K7's checked shapes (shape, tj, ti, halo): the JAX probe's defaults (ti
#: 512 covers 1024 of the 1408 interior lanes), the port's padded
#: 512x512x50 block with a 2-lane halo, and small ones that between them
#: run every instance (K 8, 16, 50 and two run-time depths, 33 and 7), the
#: K = 8 1-D instance with its four lanes a thread (a partial last warp)
#: and with one (a pitch four lanes do not divide), each 2-D instance on
#: both staging paths (bulk where I*4 is a multiple of 16, cp.async
#: elsewhere), and one and two slabs in flight
K7_CHECKS = (((10, 8, 520), 4, 128, 128), ((10, 8, 514), 4, 128, 128),
             ((10, 16, 516), 4, 128, 128), ((10, 16, 515), 3, 100, 2),
             ((130, 50, 1664), 4, 512, 128), ((516, 50, 516), 2, 128, 2),
             ((6, 50, 1281), 2, 1024, 128), ((6, 50, 1280), 2, 1024, 128),
             ((12, 33, 515), 3, 100, 2), ((9, 7, 264), 2, 64, 4))
#: K7's timed shapes (shape, halo); tj in (2, 4), ti in (64, 128, 256)
#: (256 divides 512 of the 1408 interior lanes: its bound is its own)
K7_TIMED = (((130, 50, 1664), 128), ((516, 50, 516), 2))
#: K8's checked shapes (shape, tj, ti): the JAX probe's defaults, a
#: 256x1024-interior block, and run-time depths only the run-time k loops
#: take (rung j refuses them), one with a tile of two row slots (a thread
#: takes two rows) and one with ti not a multiple of a warp
K8_CHECKS = (((26, 16, 512), 4, 128), ((258, 50, 1280), 4, 128),
             ((10, 7, 512), 4, 128), ((14, 16, 768), 4, 256),
             ((11, 33, 556), 3, 100))
K8_TIMED = (258, 50, 1280)


def probe_input(shape, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=g)


def k7_ops(shape, tj, ti=None, halo=128):
    """float32 operations K7 does on its written region: the stencil's 4
    per cell, then one add per cell and doubling pass (ceil(log2 K))."""
    from wrf_tpu_torch.tools import probe_2d as k7

    rows, _, lanes = k7.written(shape, tj, ti, halo)
    K = shape[1]
    cells = (rows.stop - rows.start) * K * (lanes.stop - lanes.start)
    return cells * (4 + max(0, (K - 1).bit_length()))


def phase_k7(card=""):
    """K7, the tiling probe: ``run_1d`` and ``run_2d`` against their plain
    versions bit for bit over the whole array (the NaN left outside the
    written region included) at K7_CHECKS, and against each other on the
    lanes both wrote; then the probe's entry point, ``python -m
    wrf_tpu_torch.tools.probe_2d --time``, at the JAX defaults and at the
    port's padded block, with every launch count set to 0 just before;
    then both forms timed at K7_TIMED for tj 2, 4 and ti 64, 128, 256 (the
    1-D form does not depend on ti), marginal ms per call on the host clock
    (``utils.timing.per_step_time``) and CUDA events around the same
    ping-pong chains, beside the plain versions at tj 4 (2 at the padded
    block), ti 128.  Returns the results and the entry point's launches."""
    import torch
    from wrf_tpu_torch.tools import probe_2d as k7

    ran = set()
    for shape, tj, ti, halo in K7_CHECKS:
        x = probe_input(shape, 7)
        tag = "x".join(map(str, shape)) + f" tj {tj} ti {ti} halo {halo}"
        plans = {"1d": k7.plan_1d(shape, tj),
                 "2d": k7.plan_2d(shape, tj, ti, halo)}
        ran |= {("1d", plans["1d"]["kt"], plans["1d"]["vec"]),
                ("2d", plans["2d"]["kt"], plans["2d"]["path"]),
                ("2d stages", plans["2d"]["stages"])}
        outs = {}
        for form, fn, plain, args in (
                ("1d", k7.run_1d, k7.run_1d_plain, (tj,)),
                ("2d", k7.run_2d, k7.run_2d_plain, (tj, ti, halo))):
            got, want = fn(x, *args), plain(x, *args)
            torch.cuda.synchronize()
            n = bits_different(got, want)
            region = k7.written(shape, *args)
            finite = bool(torch.isfinite(got[region]).all())
            nan_out = int(torch.isnan(got).sum()) == (
                got.numel() - got[region].numel())
            print(f"[k7 {tag} {form}] different={n} (whole array, NaN "
                  f"outside the region: {nan_out}; region finite: {finite}; "
                  f"plan {plans[form]})")
            if n or not (finite and nan_out):
                raise AssertionError(f"k7 {tag} {form}: {n} elements differ "
                                     f"from the plain version")
            outs[form] = got
        region = k7.written(shape, tj, ti, halo)
        n = bits_different(outs["1d"][region], outs["2d"][region])
        print(f"[k7 {tag} 1d vs 2d] different={n} on the "
              f"{region[2].stop - region[2].start} lanes both wrote")
        if n:
            raise AssertionError(f"k7 {tag}: the forms differ in {n}")
        del x, outs
    torch.cuda.empty_cache()
    built = ({("1d", kt, v) for kt in (0, *k7.UNROLLED_K)
              for v in {1, k7.LANES_1D.get(kt, 1)}}
             | {("2d", kt, p) for kt in (0, *k7.UNROLLED_K)
                for p in k7.STAGING} | {("2d stages", 1), ("2d stages", 2)})
    print(f"[k7 instances] held to bits: {len(built & ran)} of {len(built)}"
          f"; not run: {sorted(built - ran, key=str) or 'none'}")
    if built - ran:
        raise AssertionError(f"k7: instances not checked: {built - ran}")

    for counts in (k7.LAUNCHES, k7.STAGING):
        for key in counts:
            counts[key] = 0
    probe_main(k7, "k7 main", ["--time"])
    probe_main(k7, "k7 main", ["--shape", "516", "50", "516", "--halo", "2",
                               "--tj", "2", "--ti", "128", "--time"])
    launches = dict(k7.LAUNCHES)
    print(f"[k7 main] launches {launches}; the 2-D form's slabs by path "
          f"{dict(k7.STAGING)}")
    if k7.STAGING["bulk"] != launches["2d"]:
        raise AssertionError("k7 main: a 2-D launch at a 16-byte pitch did "
                             f"not take the bulk path: {dict(k7.STAGING)}")

    out = {}
    for shape, halo in K7_TIMED:
        x = probe_input(shape, 8)
        J, K, I = shape
        tag = "x".join(map(str, shape))
        jax_bytes = 2 * J * K * I * 4
        tj_plain = 2 if halo == 2 else 4
        for tj in (2, 4):
            for ti in (None, 64, 128, 256):
                def step(s, d, tj=tj, ti=ti, plain=False):
                    if ti is None:
                        fn = k7.run_1d_plain if plain else k7.run_1d
                        return fn(s, tj, out=d)
                    fn = k7.run_2d_plain if plain else k7.run_2d
                    return fn(s, tj, ti, halo, out=d)

                host, ev = k7.chain_ms(step, lambda: (x.clone(), x.clone()))
                nbytes = k7.compulsory_bytes(shape, tj, ti, halo)
                bound = bound_ms(nbytes, k7_ops(shape, tj, ti, halo))
                form = "1d" if ti is None else f"2d ti {ti}"
                r = dict(ms=ev, host_ms=host, bytes=nbytes, bound_ms=bound[0],
                         bound_by=bound[1], share=bound[0] / ev,
                         gbps=jax_bytes / (ev * 1e-3) / 1e9,
                         bytes_gbps=nbytes / (ev * 1e-3) / 1e9)
                if tj == tj_plain and ti in (None, 128):
                    r["plain_ms"], _ = k7.chain_ms(
                        functools.partial(step, plain=True),
                        lambda: (x.clone(), x.clone()), 3, 9, 2)
                out[tag, tj, form] = r
                print(f"[k7 time {tag} tj {tj} {form}] {ev:.4f} ms/call "
                      f"(host clock {host:.4f}), {r['gbps']:.0f} GB/s as the "
                      f"JAX probe counts (2*J*K*I*4), {r['bytes_gbps']:.0f} "
                      f"GB/s of its {nbytes / 1e6:.1f} MB compulsory, "
                      f"{100 * r['share']:.1f} % of the {bound[0]:.4f} ms "
                      f"bound" + (f"; plain {r['plain_ms']:.3f} ms"
                                  if "plain_ms" in r else "")
                      + (" (above the data sheet: an L2 artefact)"
                         if r["bytes_gbps"] > HBM_BYTES_PER_S / 1e9 else "")
                      + f" ({card})")
        del x
        torch.cuda.empty_cache()
    return out, launches


def phase_k8(card=""):
    """K8, the feature ladder: every rung against its plain version bit for
    bit over the whole array (NaN outside its region included) at
    K8_CHECKS (rung j only at its unrolled depths, and refused at the
    others), rung e's second output (kernel vs plain, and
    2*x on its region), rung i's aliased operand (kernel vs plain, x + 1 on
    its region, x elsewhere, the caller's x unchanged), h == j and d == a on
    d's region; then each rung's entry point, ``python -m
    wrf_tpu_torch.tools.probe_2d_bisect <rung>`` at its defaults (and rung
    d with ``--time`` at K8_TIMED), with every launch count set to 0 just
    before; then every rung timed at K8_TIMED (marginal ms per call, host
    clock and CUDA events on the same chains) beside its plain version.
    Returns the results and the entry points' launches."""
    import torch
    from wrf_tpu_torch.tools import probe_2d as k7
    from wrf_tpu_torch.tools import probe_2d_bisect as k8

    for shape, tj, ti in K8_CHECKS:
        x = probe_input(shape, 9)
        x0 = x.clone()
        tag = "x".join(map(str, shape)) + f" tj {tj} ti {ti}"
        got = {}
        for rung in k8.RUNGS:
            if rung == "j" and shape[1] not in k8.UNROLLED_K:
                try:
                    k8.rung_j(x, tj, ti)
                except ValueError as e:
                    print(f"[k8 {tag} rung j] refused: {e}")
                    continue
                raise AssertionError(f"k8 {tag}: rung j ran at K={shape[1]}")
            ops_k, ops_p = k8.operands(rung, x), k8.operands(rung, x)
            got[rung] = k8.FUNCS[rung](x, tj, ti, **ops_k)
            want = k8.PLAIN[rung](x, tj, ti, **ops_p)
            torch.cuda.synchronize()
            n = bits_different(got[rung], want)
            for name in ("out1", "t"):
                if name in ops_k:
                    n += bits_different(ops_k[name], ops_p[name])
            region = k8.written_region(rung, shape, tj, ti)
            finite = bool(torch.isfinite(got[rung][region]).all())
            second = {"e": ", out1 too", "i": ", t too"}.get(rung, "")
            print(f"[k8 {tag} rung {rung}] different={n} (whole array"
                  f"{second}; region finite: {finite}; plan "
                  f"{k8.plan(rung, shape, tj, ti)})")
            if n or not finite:
                raise AssertionError(f"k8 {tag} rung {rung}: {n} elements "
                                     "differ from the plain version")
            outside = torch.ones(shape, dtype=torch.bool, device="cuda")
            outside[region] = False
            if rung == "e":
                ok = (torch.equal(ops_k["out1"][region], 2 * x[region])
                      and bool(torch.isnan(ops_k["out1"][outside]).all()))
            elif rung == "i":
                ok = (torch.equal(ops_k["t"][region], x[region] + 1)
                      and torch.equal(ops_k["t"][outside], x[outside])
                      and torch.equal(x, x0))
            else:
                ok = True
            if not ok:
                raise AssertionError(f"k8 {tag} rung {rung}: its second "
                                     "output is wrong")
        region = k8.written_region("d", shape, tj, ti)
        n_hj = bits_different(got["h"], got["j"]) if "j" in got else 0
        n_da = bits_different(got["d"][region], got["a"][region])
        print(f"[k8 {tag}] h vs j different="
              f"{n_hj if 'j' in got else '(no j)'}; d vs a on d's region "
              f"different={n_da}; rung e's 2*x and rung i's x + 1 on their "
              "regions, x unchanged: ok")
        if n_hj or n_da:
            raise AssertionError(f"k8 {tag}: h vs j {n_hj}, d vs a {n_da}")
        del x, x0, got
    torch.cuda.empty_cache()

    for rung in k8.LAUNCHES:
        k8.LAUNCHES[rung] = 0
    for rung in k8.RUNGS:
        probe_main(k8, "k8 main", [rung])
    probe_main(k8, "k8 main", ["d", "--shape", *map(str, K8_TIMED),
                               "--time"])
    launches = dict(k8.LAUNCHES)

    out = {}
    x = probe_input(K8_TIMED, 10)
    tag = "x".join(map(str, K8_TIMED))
    tj, ti = 4, 128
    for rung in k8.RUNGS:
        ops = k8.operands(rung, x)
        fn, plain = k8.FUNCS[rung], k8.PLAIN[rung]
        host, ev = k7.chain_ms(
            lambda s, d: fn(s, tj, ti, out=d, **ops),
            lambda: (x.clone(), x.clone()))
        plain_ms, _ = k7.chain_ms(
            lambda s, d: plain(s, tj, ti, out=d, **ops),
            lambda: (x.clone(), x.clone()), 3, 9, 2)
        nbytes = k8.compulsory_bytes(rung, K8_TIMED, tj, ti)
        rows, _, lanes = k8.written_region(rung, K8_TIMED, tj, ti)
        cells = (rows.stop - rows.start) * K8_TIMED[1] * (lanes.stop
                                                          - lanes.start)
        # _compute's 4 operations per cell; e's and f's multiply and add,
        # i's add, the k scan's add
        bound = bound_ms(nbytes, cells * (4 + (2 if rung in "ef" else 0)
                                          + (1 if rung in "hij" else 0)))
        out[rung] = dict(ms=ev, host_ms=host, plain_ms=plain_ms,
                         bytes=nbytes, bound_ms=bound[0], bound_by=bound[1],
                         share=bound[0] / ev)
        print(f"[k8 time {tag} tj {tj} ti {ti} rung {rung}] {ev:.4f} ms/call "
              f"(host clock {host:.4f}), {nbytes / (ev * 1e-3) / 1e9:.0f} "
              f"GB/s of its {nbytes / 1e6:.1f} MB compulsory, "
              f"{100 * bound[0] / ev:.1f} % of the {bound[0]:.4f} ms bound; "
              f"plain {plain_ms:.3f} ms ({card})")
    del x
    torch.cuda.empty_cache()
    a_ms = out["a"]["ms"]
    print("[k8 ladder] ms over rung a: " + ", ".join(
        f"{r} {v['ms'] - a_ms:+.4f}" for r, v in out.items()) + f" ({card})")
    return out, launches


def ring_blocks(mesh, shape, seed):
    """Random float32 blocks of ``shape`` for every shard of ``mesh``, on
    the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return {c: torch.randn(shape, device="cuda", generator=g)
            for c in mesh.coords()}


def clone_blocks(blocks):
    return {c: x.clone() for c, x in blocks.items()}


def blocks_different(tag, got, want):
    """Two dicts of blocks must agree bit for bit (counted on the card)."""
    n = sum(count_different(got[c], want[c]) for c in want)
    print(f"[{tag}] different={n}")
    if n:
        raise AssertionError(f"{tag}: {n} elements differ")


def k5_checks(tag, mesh, make, njl, nil, launch):
    """K5's entries on ``mesh`` (its blocks' rows at the 512x512x50 loop's
    size, ``njl`` x ``nil`` owned cells a shard) bit for bit against their
    plain versions and the ``ppermute`` refresh: ``rdma_rows``,
    ``remote_refresh_axis`` and ``remote_refresh_multi`` (3-D and 2-D
    fields mixed, one ``recv_only="hi"``).  ``make(shape, seed)`` gives a
    field's blocks; ``launch(fn, *args, **kw)`` calls an entry.  Returns
    the fields ``remote_refresh_multi`` refreshed."""
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel import halo

    K = BIG_GRID[2]
    J, I = njl + 2, nil + 2
    rows = make((2, K * I + I), 1)
    blocks_different(f"{tag} rdma_rows", launch(k5.rdma_rows, rows, "j", mesh),
                     k5.rdma_rows_plain(rows, "j", mesh))
    a3, b2, c3 = (make(sh, seed) for seed, sh in
                  ((2, (J, K, I)), (3, (J, I)), (4, (J, K, I))))
    got = launch(k5.remote_refresh_axis, clone_blocks(a3), "j", mesh, njl)
    blocks_different(f"{tag} refresh_axis vs plain", got,
                     k5.remote_refresh_axis_plain(clone_blocks(a3), "j",
                                                  mesh, njl))
    blocks_different(f"{tag} refresh_axis vs ppermute", got,
                     halo.refresh_axis(clone_blocks(a3), 0, "j", mesh, njl))
    ro = ("", "", "hi")
    got = launch(k5.remote_refresh_multi,
                 [clone_blocks(x) for x in (a3, b2, c3)], "j", mesh, njl,
                 recv_only=ro)
    want = k5.remote_refresh_multi_plain(
        [clone_blocks(x) for x in (a3, b2, c3)], "j", mesh, njl,
        recv_only=ro)
    perm = [halo.refresh_axis(clone_blocks(x), 0, "j", mesh, njl)
            for x in (a3, b2, c3)]
    for c in mesh.coords():   # a recv-only field keeps its LOW halo
        perm[2][c][0] = c3[c][0]
    for name, g, w, p in zip("abc", got, want, perm):
        blocks_different(f"{tag} refresh_multi {name} vs plain", g, w)
        blocks_different(f"{tag} refresh_multi {name} vs ppermute", g, p)
    return got


def phase_k5_vs_plain(card=""):
    """K5, the ring exchange, against its plain version and against the
    ``ppermute`` refresh: ``rdma_rows``, ``remote_refresh_axis`` and
    ``remote_refresh_multi`` (3-D and 2-D fields mixed, one
    ``recv_only="hi"``) on rings of 1, 2, 4 and 8 blocks on the one card at
    the 512x512x50 loop's row sizes on an (m, 1) mesh, and on the 2x2 mesh
    (two rings of two; rows of 259 floats, which start unaligned and take
    the scalar path); every comparison bit for bit, and every exchange one
    launch (the blocks share the one card).  Then the times at the 2x2 row
    size, per exchange (the loop's substep: every shard's mu rows both
    ways and v row up, one launch): K5 through its wrapper, its plain
    version, the ``ppermute`` refresh of the same fields (``Tensor.copy_``,
    the library yardstick) and the bare launch from a prebuilt plan:
    marginal ms between chains of 50 and 250 calls on CUDA events, the
    host clock's reading of the same chains beside it, in the order plain,
    library, kernel, bare, bare, kernel, library, plain.  Returns the
    events' readings, the host clock's and the bytes an exchange moves."""
    import torch
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.mesh import make_mesh

    nx, ny, K = BIG_GRID
    meshes = [((m, 1), make_mesh(["cuda:0"] * m, (m, 1)))
              for m in (1, 2, 4, 8)]
    meshes.append(((2, 2), make_mesh(["cuda:0"] * 4, (2, 2))))
    def one_launch(tag, fn, *args, **kw):
        before = k5.LAUNCHES
        out = fn(*args, **kw)
        if k5.LAUNCHES - before != 1:
            raise AssertionError(f"{tag}: {k5.LAUNCHES - before} K5 "
                                 f"launches for one exchange on one card")
        return out

    for (nj, ni), mesh in meshes:
        njl, nil = -(-(ny + 2) // nj), -(-(nx + 2) // ni)
        tag = f"k5 ring {nj}x{ni} {njl + 2}x{K}x{nil + 2}"
        k5_checks(tag, mesh, functools.partial(ring_blocks, mesh), njl,
                  nil, functools.partial(one_launch, tag))
        torch.cuda.synchronize()

    # times on the 2x2 mesh: what one substep of the mesh loop exchanges
    (nj, ni), mesh = meshes[-1]
    njl, nil = (ny + 2) // nj, (nx + 2) // ni
    mu = ring_blocks(mesh, (njl + 2, nil + 2), 5)
    v = ring_blocks(mesh, (njl + 2, K, nil + 2), 6)

    def kern():
        k5.remote_refresh_multi([mu, v], "j", mesh, njl, recv_only=("", "hi"))

    def plain():
        k5.remote_refresh_multi_plain([mu, v], "j", mesh, njl,
                                      recv_only=("", "hi"))

    def library():   # the ppermute backend's refresh of the same fields
        halo.refresh_axis(mu, 0, "j", mesh, njl)
        halo.refresh_axis(v, 0, "j", mesh, njl)

    # the same launch without the wrapper's per-call work (its checks, the
    # address reads and the plan lookup): one plan holding every shard's
    # segments, what the wrapper launches
    segs = []
    for c in mesh.coords():
        up, down = (mesh.neighbour(c, "j", s) for s in (1, -1))
        segs += [(mu[c], njl, mu[up], 0), (mu[c], 1, mu[down], njl + 1),
                 (v[c], 1, v[down], njl + 1)]
    plan = k5.plan_put(segs)

    def bare():
        k5.put(plan)

    one_launch("k5 2x2 exchange", kern)
    # two-count marginals (50 and 250 calls, best of 5), each chain on both
    # clocks: the wrapper's rows are bound by what the host submits
    out = {"cuda": [], "plain": [], "library": [], "bare": []}
    host = {name: [] for name in out}
    for name, fn in (("plain", plain), ("library", library), ("cuda", kern),
                     ("bare", bare), ("bare", bare),
                     ("cuda", kern), ("library", library), ("plain", plain)):
        ev, hc = chain_marginal_ms(lambda i: fn(), n1=50, n2=250, repeats=5)
        out[name].append(ev)
        host[name].append(hc)
    nbytes = 4 * sum(n for _, _, n in k5.addresses(segs))
    names = {"cuda": "kernel", "plain": "plain", "library": "ppermute "
             "refresh (Tensor.copy_)", "bare": "kernel launched from a "
             "prebuilt plan"}
    print(f"[k5 time 2x2, rows of {nil + 2} (4 shards' mu both ways and v "
          f"up, {len(segs)} segments: {nbytes} bytes)] marginal ms per "
          f"exchange, CUDA events (host clock): " + ", ".join(
              f"{names[k]} {out[k][0]:.5f} / {out[k][1]:.5f} "
              f"({host[k][0]:.5f} / {host[k][1]:.5f})" for k in names)
          + f" (order plain, library, kernel, prebuilt, prebuilt, kernel, "
          f"library, plain; {card})")
    return out, host, nbytes


def phase_ipc_vs_plain(card="", rounds=3):
    """The two kernels of the exchange across processes
    (``csrc/halo_ipc.cu``: the signalled put and the wait) in this process,
    through ``loopback``: every ring message of the (2,2) mesh on cuda:0
    goes through this process's own mailbox, as if every neighbour sat in
    another process, at the 512x512x50 loop's row sizes.  Over ``rounds``
    exchanges (both slot parities, and the releases), bit for bit: the
    ``rdma`` form (the wait scatters mu's rows both ways and v's up into
    the halo rows) against its plain version, K5 and the ``ppermute``
    refresh; the ``rdma_overlap`` form (the rows stay in the mailbox) of
    K1's rows and of K3's S=2 slabs against its plain version and the rows
    where they lie.  Every loopback exchange is one put and one wait launch
    and no K5 launch, and no error word is set.  Then the times per
    exchange (CUDA events, host clock beside; order plain, library,
    kernel, kernel, library, plain): the ``rdma`` form, its plain version,
    the ``ppermute`` refresh (``Tensor.copy_``) and ``torch.cat`` of the
    same rows (one call that packs what the put packs); the ``rdma_overlap``
    form and its plain version; and each kernel's device time per launch
    in a ``torch.profiler`` trace of 40 exchanges of each form.  Returns
    ``{"ms": ..., "host_ms": ..., "device_us": ..., "bytes": ...}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.mesh import make_mesh

    nx, ny, K = BIG_GRID
    mesh = make_mesh(["cuda:0"] * 4, (2, 2))
    njl, nil = (ny + 2) // 2, (nx + 2) // 2
    S = 2

    def counted(tag, fn):
        before = (k5.LAUNCHES, k5.PUT_LAUNCHES, k5.WAIT_LAUNCHES)
        out = fn()
        got = tuple(a - b for a, b in zip(
            (k5.LAUNCHES, k5.PUT_LAUNCHES, k5.WAIT_LAUNCHES), before))
        if got != (0, 1, 1):
            raise AssertionError(f"{tag}: K5, put, wait launches {got} for "
                                 "one loopback exchange (expected 0, 1, 1)")
        return out

    ro = ("", "hi")
    for r in range(rounds):
        mu = ring_blocks(mesh, (njl + 2, nil + 2), 10 + r)
        v = ring_blocks(mesh, (njl + 2, K, nil + 2), 20 + r)
        got = counted("ipc rdma", lambda: k5.remote_refresh_multi(
            [clone_blocks(mu), clone_blocks(v)], "j", mesh, njl,
            recv_only=ro, loopback=True))
        plain = k5.remote_refresh_multi_plain(
            [clone_blocks(mu), clone_blocks(v)], "j", mesh, njl,
            recv_only=ro, loopback=True)
        inproc = k5.remote_refresh_multi([clone_blocks(mu), clone_blocks(v)],
                                         "j", mesh, njl, recv_only=ro)
        perm = [halo.refresh_axis(clone_blocks(x), 0, "j", mesh, njl)
                for x in (mu, v)]
        for c in mesh.coords():   # a recv-only field keeps its LOW halo
            perm[1][c][0] = v[c][0]
        for name, g, pl, k, pp in zip(("mu", "v"), got, plain, inproc, perm):
            blocks_different(f"ipc rdma {name} round {r} vs plain", g, pl)
            blocks_different(f"ipc rdma {name} round {r} vs K5", g, k)
            blocks_different(f"ipc rdma {name} round {r} vs ppermute", g, pp)
        # the overlap form: K1's rows, then K3's S=2 slabs on ring-2 blocks
        k1_spec = ([("mu_lo", mu, njl, 1)],
                   [("mu_hi", mu, 1, 1), ("v_hi", v, 1, 1)])
        wide = {n: ring_blocks(mesh, (njl + 2 * S,) + ((K,) if n != "mu"
                                                     else ())
                               + (nil + 2 * S,), 30 + 3 * r + q)
                for q, n in enumerate(("mu", "u", "v"))}
        k3_spec = ([(n + "_lo", wide[n], njl, S) for n in wide],
                   [(n + "_hi", wide[n], S, S) for n in wide])
        for form, (to_next, to_prev) in (("k1 rows", k1_spec),
                                         ("k3 S=2 slabs", k3_spec)):
            got = counted(f"ipc overlap {form}",
                          lambda: k5.Mailbox.neighbour_rows(
                              mesh, "j", to_next, to_prev, loopback=True))
            plain = k5.Mailbox.neighbour_rows(mesh, "j", to_next, to_prev,
                                              plain=True, loopback=True)
            where = {c: {} for c in mesh.coords()}
            for shift, lst in ((-1, to_next), (1, to_prev)):
                for c in mesh.coords():
                    nb = mesh.neighbour(c, "j", shift)
                    for name, blocks, row, n in lst:
                        where[c][name] = blocks[nb][row:row + n]
            for name in where[0, 0]:
                blocks_different(
                    f"ipc overlap {form} {name} round {r} vs plain",
                    {c: g[name] for c, g in got.items()},
                    {c: g[name] for c, g in plain.items()})
                blocks_different(
                    f"ipc overlap {form} {name} round {r} vs the rows",
                    {c: g[name] for c, g in got.items()},
                    {c: w[name] for c, w in where.items()})
    torch.cuda.synchronize()
    for box in mesh.mailboxes.values():
        box.raise_if_failed()

    # times: what one substep of the (2,2) loop exchanges
    mu = ring_blocks(mesh, (njl + 2, nil + 2), 5)
    v = ring_blocks(mesh, (njl + 2, K, nil + 2), 6)
    rows = [x[c][r] for c in mesh.coords()
            for x, r in ((mu, njl), (mu, 1), (v, 1))]
    nbytes = 4 * sum(x.numel() for x in rows)
    forms = {
        "rdma": lambda: k5.remote_refresh_multi(
            [mu, v], "j", mesh, njl, recv_only=ro, loopback=True),
        "rdma plain": lambda: k5.remote_refresh_multi_plain(
            [mu, v], "j", mesh, njl, recv_only=ro, loopback=True),
        "ppermute": lambda: [halo.refresh_axis(x, 0, "j", mesh, njl)
                             for x in (mu, v)],
        "cat": lambda: torch.cat([x.reshape(-1) for x in rows]),
        "overlap": lambda: k5.Mailbox.neighbour_rows(
            mesh, "j", [("mu_lo", mu, njl, 1)],
            [("mu_hi", mu, 1, 1), ("v_hi", v, 1, 1)], loopback=True),
        "overlap plain": lambda: k5.Mailbox.neighbour_rows(
            mesh, "j", [("mu_lo", mu, njl, 1)],
            [("mu_hi", mu, 1, 1), ("v_hi", v, 1, 1)], plain=True,
            loopback=True)}
    ms = {k: [] for k in forms}
    host = {k: [] for k in forms}
    order = ("rdma plain", "overlap plain", "ppermute", "cat", "rdma",
             "overlap")
    for name in order + order[::-1]:
        ev, hc = chain_marginal_ms(lambda i: forms[name](), n1=20, n2=100,
                                   repeats=5)
        ms[name].append(ev)
        host[name].append(hc)
    device_us = {}
    for form in ("rdma", "overlap"):
        forms[form]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(40):
                forms[form]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for kern in ("mailbox_put", "mailbox_wait"):
                if kern in e.key and e.count:
                    us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                    device_us[form, kern] = us / e.count
    torch.cuda.synchronize()
    for box in mesh.mailboxes.values():
        box.raise_if_failed()
    mesh.mailboxes.clear()
    print(f"[ipc time 2x2 loopback, rows of {nil + 2}, {nbytes} bytes an "
          f"exchange] marginal ms per exchange, CUDA events (host clock): "
          + ", ".join(f"{k} " + " / ".join(f"{x:.5f}" for x in ms[k])
                      + " (" + " / ".join(f"{x:.5f}" for x in host[k]) + ")"
                      for k in order)
          + "; device us per launch (profile of 40): " + ", ".join(
              f"{f} {k} {u:.2f}" for (f, k), u in device_us.items())
          + f" ({card})")
    if not all((f, k) in device_us for f in ("rdma", "overlap")
               for k in ("mailbox_put", "mailbox_wait")):
        raise AssertionError(f"the profile saw {sorted(device_us)}")
    return {"ms": ms, "host_ms": host, "device_us": device_us,
            "bytes": nbytes}


def phase_mesh_loops():
    """The loops on a mesh at the full 512x512x50 width, four (or one)
    shards on the one card: the coupled loop on (2,2) and (4,1) under both
    backends, once with ``with_w``, blocked S=2 and S=4 on (2,2), and 1x1 with
    ``force_exchange`` under both backends; the mu/t loop on (2,2).
    ``rdma`` must equal ``ppermute`` bit for bit; every mesh is held
    against the 1x1 loop at DEVICE_TOL with the ``different=`` counts
    printed (per-column arithmetic does not depend on the block, so 0 is
    expected).  With divergence damping (``smdiv``) the 1x1 loop is held
    against the oracle's golden loop at DEVICE_TOL, and (2,2) and (4,1)
    under both backends against it and each other bit for bit.  Under
    ``rdma_overlap`` (the j exchange inside K1 and K3) every one of these
    loops, also blocked S=2 and S=4 on (4,1), must equal its ``ppermute``
    and ``rdma`` twins and the 1x1 loop bit for bit, with one K1 (K3)
    launch per shard per substep (block) and no K5 launch.  Returns the K5
    launches of the (2,2) rdma loop and the launches of the (2,2)
    rdma_overlap loops."""
    import torch
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain,
    )

    case = case_at(BIG_GRID, balanced=True)
    b = case.bounds
    n = 5
    prepared = {}

    def run(cls, shape, with_w=False, n_steps=n, **kw):
        mesh = (make_mesh(["cuda:0"] * (shape[0] * shape[1]), shape)
                if shape else None)
        loop = cls(b.ide, b.jde, b.kdim, case.flags, n_steps=n_steps,
                   device="cuda", mesh=mesh,
                   **({"with_w": True} if with_w else {}), **kw)
        # the loops leave their prepared arrays alone: one copy to the card
        # per layout (with_w's field set holds the other's)
        if (shape, with_w) not in prepared:
            prepared.pop((shape, not with_w), None)
            prepared[shape, with_w] = loop.prepare(
                case_to_domain(case, with_w=with_w))
        out = loop(prepared[shape, with_w], case.rdx, case.rdy, case.dts,
                   case.epssm)
        torch.cuda.synchronize()
        return out

    ref = run(SmallStepLoop, None)
    ref_blk = {S: run(SmallStepLoop, None, inner_steps=S) for S in (2, 4)}
    ref_mut = run(ShardedAdvanceMuT, None, n_steps=9, inner_steps=4)
    check_state("1x1 force_exchange rdma vs ppermute",
                run(SmallStepLoop, None, force_exchange=True,
                    halo_backend="rdma"),
                run(SmallStepLoop, None, force_exchange=True), bit_exact=True)
    # divergence damping: mudf joins the carry and every exchange mu rides
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.parallel.sharded import embed_outputs

    ref_d = run(SmallStepLoop, None, smdiv=SMDIV)
    if not count_different(ref_d["u"], ref["u"]):
        raise AssertionError("1x1 smdiv: damping changed nothing")
    got = embed_outputs(case, arrays_to_numpy(ref_d))
    gold = golden_loop_native(case, n, smdiv=SMDIV)
    check_state(f"1x1 smdiv={SMDIV} vs the oracle's golden loop, {n} substeps",
                got, {k: gold[k] for k in got})
    ref_w = run(SmallStepLoop, None, with_w=True)
    launches, ov_launches = None, {}

    def overlap(tag, shape, twins, **kw):
        """The loop under rdma_overlap against its ``twins`` (bit for bit),
        with its launches: K1 (and K3) once per shard per substep (block),
        K5 never."""
        shards = shape[0] * shape[1] if shape else 1
        S = kw.get("inner_steps", 1)
        blocks = (n - 1) // S if S > 1 else 0
        k1.LAUNCHES = k3.LAUNCHES = k5.LAUNCHES = 0
        got = run(SmallStepLoop, shape, halo_backend="rdma_overlap", **kw)
        counts = {"k1": k1.LAUNCHES, "k3": k3.LAUNCHES, "k5": k5.LAUNCHES}
        want = {"k1": shards * (n - blocks * S), "k3": shards * blocks,
                "k5": 0}
        print(f"[mesh {shape} rdma_overlap {tag}] launches {counts}")
        if counts != want:
            raise AssertionError(f"mesh {shape} rdma_overlap {tag}: launches "
                                 f"{counts}, expected {want}")
        for name, twin in twins.items():
            check_state(f"mesh {shape} rdma_overlap {tag} vs {name}", got,
                        twin, bit_exact=True)
        return counts

    overlap("1x1 force_exchange", None,
            {"ppermute": run(SmallStepLoop, None, force_exchange=True)},
            force_exchange=True)
    for shape in ((2, 2), (4, 1)):
        perm_d = run(SmallStepLoop, shape, smdiv=SMDIV)
        k5.LAUNCHES = 0
        rdma_d = run(SmallStepLoop, shape, smdiv=SMDIV, halo_backend="rdma")
        if k5.LAUNCHES != n:   # one per device per substep
            raise AssertionError(f"mesh {shape} smdiv rdma loop: "
                                 f"{k5.LAUNCHES} K5 launches for {n} substeps")
        check_state(f"mesh {shape} smdiv rdma vs ppermute", rdma_d, perm_d,
                    bit_exact=True)
        check_state(f"mesh {shape} smdiv vs 1x1 smdiv", perm_d, ref_d,
                    bit_exact=True)
        ov_launches[shape, "smdiv"] = overlap(
            "smdiv", shape, {"ppermute": perm_d, "rdma": rdma_d,
                             "1x1": ref_d}, smdiv=SMDIV)
        del perm_d, rdma_d
        perm = run(SmallStepLoop, shape)
        k5.LAUNCHES = 0
        rdma = run(SmallStepLoop, shape, halo_backend="rdma")
        if k5.LAUNCHES != n:   # one per device per substep
            raise AssertionError(f"mesh {shape} rdma loop: {k5.LAUNCHES} K5 "
                                 f"launches for {n} substeps")
        if shape == (2, 2):
            launches = k5.LAUNCHES
        for S in (2, 4):   # K3 on blocks that are ring-S in i too on (2,2)
            blk = run(SmallStepLoop, shape, inner_steps=S)
            check_state(f"mesh {shape} blocked S={S} vs 1x1 blocked S={S}",
                        blk, ref_blk[S])
            ov_launches[shape, f"S={S}"] = overlap(
                f"blocked S={S}", shape,
                {"ppermute": blk, "1x1": ref_blk[S]}, inner_steps=S)
            del blk
        if shape == (2, 2):
            check_state("mu/t mesh (2, 2) vs 1x1",
                        run(ShardedAdvanceMuT, shape, n_steps=9,
                            inner_steps=4), ref_mut)
        check_state(f"mesh {shape} rdma vs ppermute", rdma, perm,
                    bit_exact=True)
        check_state(f"mesh {shape} vs 1x1", perm, ref)
        ov_launches[shape, "S=1"] = overlap(
            "S=1", shape, {"ppermute": perm, "rdma": rdma, "1x1": ref})
        del perm, rdma
    rdma_w = run(SmallStepLoop, (2, 2), with_w=True, halo_backend="rdma")
    check_state("mesh (2, 2) rdma +w vs 1x1 +w", rdma_w, ref_w)
    ov_launches[(2, 2), "+w"] = overlap(
        "+w", (2, 2), {"rdma": rdma_w, "1x1": ref_w}, with_w=True)
    return launches, ov_launches


def phase_pad_memo():
    """The loops' pad memo on the card, where K3 updates its state and K5
    the halos through device pointers (K3's wrapper marks its writes; K5's
    rewrite the rows the pad wrote) and K1 writes fresh buffers: 3 closed
    RK3 steps at 512x512x50 with one integrator, whose stages reuse the
    pads of unchanged inputs, must equal bit for bit a cold one
    (``memo.keep = False``) that pads every stage anew, at 1x1 (with w and
    damping, blocked S=2, bf16 constants) and on (2,2) and (2,1) meshes on
    the one card under ``rdma`` and on (2,2) under ``rdma_overlap``; and
    ``stage_memo.PADS`` must read 21 blocks built and 42 reused on the
    first 1x1 step with w, 10 and 53 on each later one (stages 2 and 3
    build nothing).  Returns those counts."""
    import torch
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.models.stage_memo import PADS
    from wrf_tpu_torch.models.tendencies import NudgingTendencies
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    case = case_at(BIG_GRID, balanced=True)
    b = case.bounds
    dt = case.dts * 6

    def integrator(shape, keep, **kw):
        mesh = (make_mesh(["cuda:0"] * (shape[0] * shape[1]), shape)
                if shape else None)
        rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags,
                            acoustic_steps=6, kernel="cuda",
                            snapshot="base", device="cuda", mesh=mesh,
                            **dict(dict(with_w=True, smdiv=SMDIV), **kw))
        rk3.loops[0].memo.keep = keep
        return rk3

    def closed(shape, keep, steps=3, **kw):
        rk3 = integrator(shape, keep, **kw)
        arrays = rk3.prepare(case_to_domain(case,
                                            with_w=kw.get("with_w", True)))
        fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
        outs, counts = [], []
        for _ in range(steps):
            before = dict(PADS)
            out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                           tendency_fn=fn)
            counts.append(tuple(PADS[k] - before.get(k, 0)
                                for k in ("built", "reused")))
            arrays = rk3.merge_evolved(arrays, out)
            fn.damp_winds(arrays)
            outs.append(out)
        torch.cuda.synchronize()
        return outs, counts

    paths = {"1x1": (None, {}),
             "1x1 S=2": (None, dict(inner_steps=2, smdiv=0.0)),
             "1x1 bf16": (None, dict(const_dtype=torch.bfloat16)),
             "(2,2) rdma": ((2, 2), dict(halo_backend="rdma")),
             "(2,1) rdma": ((2, 1), dict(halo_backend="rdma")),
             "(2,2) rdma_overlap": ((2, 2),
                                    dict(halo_backend="rdma_overlap"))}
    counts = None
    for tag, (shape, kw) in paths.items():
        got, c = closed(shape, True, **kw)
        want, _ = closed(shape, False, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            check_bits(f"pad memo {tag} step {i + 1}", g, w)
        counts = c if tag == "1x1" else counts
        del got, want
    print(f"[pad memo] blocks built/reused at 1x1 with w, steps 1-3: "
          f"{counts}")
    if counts != [(21, 42), (10, 53), (10, 53)]:
        raise AssertionError(f"pad memo: built/reused {counts}, expected "
                             "(21, 42) then (10, 53)")
    return counts


LEAN_GRID = (301, 251, 35)   # the lean cache's phase


def phase_lean_cache():
    """The loops' lean cache on the card: 3 closed RK3 steps at 301x251x35
    (acoustic steps 4, as the benchmark's cell: stage 1 has no scan
    substep, stages 2 and 3 share dts; with w and damping) with one
    integrator must equal, bit for bit, a cold one whose memo keeps
    nothing (``memo.keep = False``); after them the cached ``tconst``,
    ``dvdxi_const`` and ``ww1_k0`` must equal a fresh ``lean_kwargs`` of
    the memo's padded blocks bit for bit; ``stage_memo.LEAN`` must read every part built once and reused once on
    step 1, then one ``tconst`` built and ``dvdxi_const``, ``ww1_k0`` and
    ``vert`` reused twice and ``tconst`` once on each later step; and the
    last step, traced, must give ``wrf.loop.inputs`` the counts 0, one
    ``tconst`` block's bytes, 0.  Returns the per-step counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.models.tendencies import NudgingTendencies
    from wrf_tpu_torch.models.stage_memo import LEAN
    from wrf_tpu_torch.ops.advance_mu_t_cuda import lean_kwargs
    from wrf_tpu_torch.parallel.sharded import case_to_domain
    from wrf_tpu_torch.utils import timing

    case = case_at(LEAN_GRID, balanced=True)
    b = case.bounds
    ns = 4
    dt = case.dts * ns

    def integrator(keep):
        rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags,
                            acoustic_steps=ns, kernel="cuda",
                            snapshot="base", device="cuda", with_w=True,
                            smdiv=SMDIV)
        rk3.loops[0].memo.keep = keep
        return rk3

    def closed(keep, steps=3):
        rk3 = integrator(keep)
        arrays = rk3.prepare(case_to_domain(case, with_w=True))
        fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
        outs, counts, made = [], [], []
        for step in range(steps):
            before = dict(LEAN)
            timing.SPANS.clear()
            with (profile(activities=[ProfilerActivity.CPU])
                  if step == steps - 1 else contextlib.nullcontext()):
                out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                               tendency_fn=fn)
            made = [s.count for s in timing.SPANS
                    if s.name == "wrf.loop.inputs"]
            timing.SPANS.clear()
            counts.append({f"{w} {p}": n - before.get((w, p), 0)
                           for (w, p), n in sorted(LEAN.items())
                           if n != before.get((w, p), 0)})
            arrays = rk3.merge_evolved(arrays, out)
            fn.damp_winds(arrays)
            outs.append(out)
        torch.cuda.synchronize()
        return outs, counts, made, rk3

    got, counts, made, rk3 = closed(True)
    want, _, _, _ = closed(False)
    for i, (g, w) in enumerate(zip(got, want)):
        check_bits(f"lean cache step {i + 1}", g, w)
    del got, want
    loop = rk3.loops[-1]
    padded = {n: b[0, 0] for n, b in loop.memo.held("pad").items()}
    for n, x in rk3.prepare(case_to_domain(case, with_w=True)).items():
        padded.setdefault(n, x)             # the 1-D vectors pass as they are
    lean = loop.memo.held("lean")
    cached = {n: lean[n][0, 0] for n in ("tconst", "dvdxi_const", "ww1_k0")}
    fresh = lean_kwargs(padded, case.rdx, case.rdy, dt / ns, *loop.window[4:])
    check_bits("lean cache cached vs fresh lean_kwargs", cached, fresh)
    block = cached["tconst"].nbytes
    for i, c in enumerate(counts):
        print(f"[lean cache] step {i + 1}: {c}")
    print(f"[lean cache] step 3 wrf.loop.inputs counts: {made} (one tconst "
          f"block: {block} B)")
    first = {f"{w} {p}": 1 for w in ("built", "reused")
             for p in ("dvdxi_const", "tconst", "vert", "ww1_k0")}
    warm = {"built tconst": 1, "reused dvdxi_const": 2, "reused tconst": 1,
            "reused vert": 2, "reused ww1_k0": 2}
    if counts != [first, warm, warm] or made != [0, block, 0]:
        raise AssertionError(f"lean cache: counts {counts}, inputs counts "
                             f"{made}; expected {first}, then {warm}, and "
                             f"[0, {block}, 0]")
    return counts


def phase_golden_file(tmp: Path):
    import torch
    from wrf_tpu_torch.compare import compare
    from wrf_tpu_torch.convert import arrays_from_numpy
    from wrf_tpu_torch.io import fixtures
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


def oracle_substeps(case, kw, state, n_sub: int, smdiv: float = 0.0,
                    wpp=None):
    """``n_sub`` coupled substeps of the C++ oracle on memory-window arrays:
    the wind update, the mu/t substep and, given ``wpp = (w, pp)``, the w/pp
    substep on each substep's new theta.  With ``smdiv`` the wind update is
    damped by the previous substep's mudf (none before the first).  Returns
    the last substep's outputs with u and v, and ``(w, pp)``."""
    from wrf_tpu_torch.native import (
        advance_mu_t_native, advance_uv_native, advance_w_native,
    )
    from wrf_tpu_torch.ops.advance_uv import DEFAULT_CS2
    from wrf_tpu_torch.ops.advance_w import DEFAULT_CW, DEFAULT_GW

    mudf, out = None, None
    for _ in range(n_sub):
        u, v = advance_uv_native(
            u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
            muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"], cs2=DEFAULT_CS2,
            flags=case.flags, bounds=case.bounds, mudf=mudf, smdiv=smdiv)
        out = advance_mu_t_native(**{**kw, **state, "u": u, "v": v})
        if smdiv:
            mudf = out["mudf"]
        if wpp is not None:
            wpp = advance_w_native(
                w=wpp[0], pp=wpp[1], t=out["t"], rdn=case.fields["grid_rdn"],
                rdnw=kw["rdnw"], dts=kw["dts"], epssm=kw["epssm"],
                cw=DEFAULT_CW, gw=DEFAULT_GW, flags=case.flags,
                bounds=case.bounds)
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    return {**out, "u": state["u"], "v": state["v"]}, wpp


#: the coupled state and the fixture field each one starts from
START_FIELDS = {"u": "grid_u_2", "v": "grid_v_2", "t": "grid_t_2",
                "ww": "grid_ww", "mu": "grid_mu_2", "t_ave": "t_2save"}


def golden_loop_native(case, steps: int, smdiv: float = 0.0):
    """The golden acoustic loop (``small_step_golden``) with the C++
    oracle's substeps: fast enough for the 512x512x50 grid."""
    start = {k: case.fields[f] for k, f in START_FIELDS.items()}
    return oracle_substeps(case, case.kernel_kwargs(), start, steps, smdiv)[0]


def rk3_golden_native(case, acoustic_steps: int, dt: float, snapshot: str,
                      with_w: bool = False, smdiv: float = 0.0):
    """One RK3 large step on memory-window arrays with the C++ oracle's
    wind and mu/t substeps — the structure of
    the JAX package's ``rk3_golden``; ``with_w`` adds the oracle's w/pp substep
    on each substep's new theta, ``smdiv`` divergence damping from the
    previous substep's mudf (every stage starts from a zero mudf)."""
    from wrf_tpu_torch.models.rk3 import rk3_stages

    f0 = case.fields
    start = {k: f0[f] for k, f in START_FIELDS.items()}
    out = None
    for frac, n_sub in rk3_stages(acoustic_steps):
        fields = dict(f0)
        if snapshot == "stage":
            fields.update(grid_u_save=start["u"], grid_v_save=start["v"],
                          grid_t_save=start["t"], ww1=start["ww"])
        kw = dataclasses.replace(case, fields=fields,
                                 dts=(frac * dt) / n_sub).kernel_kwargs()
        # every stage restarts from the step's start state
        out, wpp = oracle_substeps(
            case, kw, dict(start), n_sub, smdiv,
            (f0["grid_w"], f0["grid_pp"]) if with_w else None)
        if with_w:
            out.update(w=wpp[0], pp=wpp[1])
    return out


def run_sim_text(tmp: Path, fx: Path, name: str, *flags, steps: int = 3,
                 echo: bool = True):
    """``python -m wrf_tpu_torch.run_sim`` for ``steps`` large steps in this
    process, with every launch count set to 0 just before; returns the K1,
    K3, K4 and K5 launches, what it printed and the final checkpoint's
    state, after checking that it is finite.  ``flags`` may set
    ``--checkpoint-every`` (default: ``steps``)."""
    import numpy as np
    from wrf_tpu_torch import run_sim
    from wrf_tpu_torch.io import checkpoint
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5

    buf = io.StringIO()
    k1.LAUNCHES = k3.LAUNCHES = k3.PAIR_LAUNCHES = k5.LAUNCHES = 0
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main([str(fx), "--steps", str(steps), "--device",
                           "cuda", "--diagnostics", "--checkpoint-dir",
                           str(tmp / name), "--checkpoint-every", str(steps),
                           *flags])
    launches = {"k1": k1.LAUNCHES, "k3": k3.LAUNCHES,
                "k4": k3.PAIR_LAUNCHES, "k5": k5.LAUNCHES}
    text = buf.getvalue()
    if echo:
        for line in text.splitlines():
            print(f"[run_sim {name}] {line}")
    if rc != 0:
        raise AssertionError(f"run_sim {name} returned {rc}")
    state, step, _ = checkpoint.load_checkpoint(
        tmp / name / f"step_{steps:06d}")
    if step != steps or not all(np.isfinite(v).all() for v in state.values()):
        raise AssertionError(f"run_sim {name}: final state is not finite")
    if ("--with-w" in flags) != ({"w", "pp"} <= state.keys()):
        raise AssertionError(f"run_sim {name}: checkpoint fields "
                             f"{sorted(state)} do not match --with-w")
    return launches, text, state


def run_sim_launches(tmp: Path, fx: Path, name: str, *flags, steps: int = 3):
    """:func:`run_sim_text`, with the ms of each large step in place of the
    text."""
    import numpy as np

    launches, text, state = run_sim_text(tmp, fx, name, *flags, steps=steps)
    checksum = float(np.sum(state["t"], dtype=np.float64))
    step_ms = [float(m.group(1)) for m in
               re.finditer(r"^step \d+: ([0-9.]+) ms", text, re.M)]
    print(f"[slice] run_sim {name} {steps} large step(s) at {BIG_GRID}: "
          f"launches {launches}, checksum {checksum:.6e}, step ms {step_ms}")
    return launches, step_ms, state


def rk3_vs_oracle(acoustic_steps: int, inner_steps: int, expected: dict,
                  with_w: bool = False, smdiv: float = 0.0):
    """One RK3 step at the reference grid against the C++ oracle's RK3
    golden (``with_w``: the composition advance_uv -> advance_mu_t ->
    advance_w per substep), with the launches it must make."""
    import torch
    from wrf_tpu_torch.compare import compare
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.parallel.sharded import case_to_domain, embed_outputs

    case = case_at(REF_GRID)
    b = case.bounds
    dt = case.dts * acoustic_steps
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags,
                        acoustic_steps=acoustic_steps, kernel="cuda",
                        snapshot="stage", device="cuda",
                        inner_steps=inner_steps, with_w=with_w, smdiv=smdiv)
    arrays = rk3.prepare(case_to_domain(case, with_w=with_w))
    k1.LAUNCHES = k3.LAUNCHES = 0
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)
    torch.cuda.synchronize()
    launches = {"k1": k1.LAUNCHES, "k3": k3.LAUNCHES}
    tag = (f"rk3 ns={acoustic_steps} S={inner_steps}"
           f"{' +w' if with_w else ''}{f' smdiv={smdiv}' if smdiv else ''}")
    if launches != expected:
        raise AssertionError(f"{tag} launched {launches}, expected "
                             f"{expected}")
    got = embed_outputs(case, arrays_to_numpy(out))
    gold = rk3_golden_native(case, acoustic_steps, dt, "stage", with_w=with_w,
                             smdiv=smdiv)
    if with_w and not {"w", "pp"} <= got.keys():
        raise AssertionError(f"{tag}: no w/pp in {sorted(got)}")
    for name in sorted(got):
        r = compare(got[name], gold[name], name, **DEVICE_TOL)
        print(f"[{tag} vs oracle] {r}")
        if not r.passed:
            raise AssertionError(f"{tag} vs oracle: {r}")


def cards_2x2():
    """The cards ``run_sim --mesh 2x2`` spreads its shards over (the visible
    ones in order, wrapping round): one on a one-card machine, where K5
    launches once per substep; one launch per card otherwise."""
    from wrf_tpu_torch.parallel.mesh import mesh_from_spec

    return len(mesh_from_spec("2x2", "cuda").unique_devices())


def phase_slice(tmp: Path, fx: Path):
    """run_sim at 512x512x50 through its entry point, by default and with
    the coupled trapezoid (acoustic_steps=4: stages of 1, 2 and 4
    substeps; at S=2 only the last blocks, one K3 launch, one lite and the
    final K1 substep), then RK3 steps against the oracle.  Returns the
    launches and ms per large step of each run."""
    runs = {"S=1": (("--checkpoint-every", "1"),
                    {"k1": 21, "k3": 0, "k4": 0}),
            "S=2": (("--inner-steps", "2"), {"k1": 15, "k3": 3, "k4": 0}),
            "S=2 fast": (("--inner-steps", "2", "--fast"),
                         {"k1": 15, "k3": 3, "k4": 0}),
            # the --with-w path: the same launches, each with the w solve
            "S=1 +w": (("--with-w",), {"k1": 21, "k3": 0, "k4": 0}),
            "S=2 +w": (("--with-w", "--inner-steps", "2"),
                       {"k1": 15, "k3": 3, "k4": 0}),
            # the mesh path: four shards on the one card, each launching
            # K1 per substep (7 substeps x 3 steps), and under rdma K5 once
            # per device per substep
            "2x2 rdma": (("--mesh", "2x2", "--halo-backend", "rdma"),
                         {"k1": 84, "k3": 0, "k4": 0,
                          "k5": 21 * cards_2x2()}),
            "2x2 ppermute": (("--mesh", "2x2"),
                             {"k1": 84, "k3": 0, "k4": 0}),
            # the j exchange inside the kernels: the same K1 launches and
            # no K5 launch; blocked, K3 once per shard per block
            "2x2 overlap": (("--mesh", "2x2", "--halo-backend",
                             "rdma_overlap"),
                            {"k1": 84, "k3": 0, "k4": 0, "k5": 0}),
            "S=2 2x2 overlap": (("--mesh", "2x2", "--halo-backend",
                                 "rdma_overlap", "--inner-steps", "2"),
                                {"k1": 60, "k3": 12, "k4": 0, "k5": 0}),
            # bf16 constant streams: the launches of the float32 runs
            "bf16": (("--precision", "bf16-const", "--checkpoint-every",
                      "1"), {"k1": 21, "k3": 0, "k4": 0}),
            "bf16 2x2 overlap": (("--precision", "bf16-const", "--mesh",
                                  "2x2", "--halo-backend", "rdma_overlap",
                                  "--checkpoint-every", "1"),
                                 {"k1": 84, "k3": 0, "k4": 0, "k5": 0})}
    # a namelist record with divergence damping (and the fixture's own
    # dynamics: dts = time_step / time_step_sound), every step checkpointed
    case = case_at(BIG_GRID, balanced=True)
    nml = {"dx": round(1.0 / case.rdx, 3), "dy": round(1.0 / case.rdy, 3),
           "time_step": round(case.dts * 4), "time_step_sound": 4,
           "epssm": case.epssm, "smdiv": SMDIV, "specified": True}
    if (1.0 / nml["dx"], nml["time_step"] / 4) != (case.rdx, case.dts):
        raise AssertionError(f"the namelist {nml} is not the fixture's "
                             f"dynamics (rdx {case.rdx}, dts {case.dts})")
    (tmp / "smdiv.json").write_text(json.dumps(nml))
    damped = ("--namelist", str(tmp / "smdiv.json"))
    runs["smdiv"] = (damped + ("--checkpoint-every", "1"),
                     {"k1": 21, "k3": 0, "k4": 0})
    runs["smdiv 2x2 rdma"] = (
        damped + ("--mesh", "2x2", "--halo-backend", "rdma"),
        {"k1": 84, "k3": 0, "k4": 0, "k5": 21 * cards_2x2()})
    runs["smdiv 2x2 overlap"] = (
        damped + ("--mesh", "2x2", "--halo-backend", "rdma_overlap"),
        {"k1": 84, "k3": 0, "k4": 0, "k5": 0})
    out, states = {}, {}
    for name, (flags, expected) in runs.items():
        launches, step_ms, states[name] = run_sim_launches(
            tmp, fx, name.replace(" ", "_").replace("+", "with_"), *flags)
        if launches != {"k5": 0, **expected}:
            raise AssertionError(f"run_sim {name} launched {launches}, "
                                 f"expected {expected}")
        out[name] = launches, step_ms
    for name in ("2x2 rdma", "2x2 ppermute"):
        check_state(f"run_sim {name} vs 1x1", states[name], states["S=1"])
    check_state("run_sim 2x2 rdma vs ppermute", states["2x2 rdma"],
                states["2x2 ppermute"], bit_exact=True)
    # this slice's path: step 3 under rdma_overlap equals the rdma run's and
    # the 1x1 run's bit for bit; blocked, the 1x1 blocked run's
    for name, twins in (("2x2 overlap", ("2x2 rdma", "S=1")),
                        ("S=2 2x2 overlap", ("S=2",)),
                        ("smdiv 2x2 overlap", ("smdiv 2x2 rdma", "smdiv")),
                        ("bf16 2x2 overlap", ("bf16",))):
        for twin in twins:
            check_state(f"run_sim {name} vs {twin}, step 3", states[name],
                        states[twin], bit_exact=True)
    slice_bf16(tmp, states)
    slice_damped(tmp, fx, case, damped, states)
    for name in runs:   # steps 2 and 3: step 1 includes the allocations
        step_ms = out[name][1]
        print(f"[slice] run_sim {name}: {sum(step_ms[1:]) / 2:.3f} ms per "
              f"large step (mean of steps 2-3; step 3 alone {step_ms[2]:.3f})")
    rk3_vs_oracle(4, 1, {"k1": 7, "k3": 0})
    # stages of 1, 4 and 8 substeps: K3 1 + 3, K1 1 + 2 + 2
    rk3_vs_oracle(8, 2, {"k1": 5, "k3": 4})
    rk3_vs_oracle(4, 1, {"k1": 7, "k3": 0}, with_w=True)
    rk3_vs_oracle(8, 2, {"k1": 5, "k3": 4}, with_w=True)
    rk3_vs_oracle(4, 1, {"k1": 7, "k3": 0}, smdiv=SMDIV)
    rk3_vs_oracle(4, 1, {"k1": 7, "k3": 0}, with_w=True, smdiv=SMDIV)
    return out


def embed_checkpoint(case, state):
    """A ``run_sim`` checkpoint's ring-shaped arrays as memory-window arrays
    (the boundary ring passes through every step, so the fixture's own
    values stand there)."""
    from wrf_tpu_torch.parallel.sharded import RING, embed_outputs

    inner = slice(RING, -RING)
    return embed_outputs(case, {k: v[inner, ..., inner]
                                for k, v in state.items()})


#: the contract of the bf16 constant-stream mode against float32 inputs
BF16_TOL = dict(rtol=2e-2, atol_scale=2e-2)


def slice_bf16(tmp: Path, states):
    """``run_sim --precision bf16-const``: large step 1 against the float32
    run's at the mode's gate (2e-2 of field scale; later steps of the
    closure-less shell are amplified noise on either side), different from
    it, and the mesh run's step 1 equal to the 1x1 run's bit for bit."""
    import numpy as np
    from wrf_tpu_torch.io import checkpoint

    first = {name: checkpoint.load_checkpoint(
        tmp / name.replace(" ", "_") / "step_000001")[0]
        for name in ("S=1", "bf16", "bf16 2x2 overlap")}
    check_state("run_sim --precision bf16-const vs float32, large step 1",
                first["bf16"], first["S=1"], tol=BF16_TOL)
    if np.array_equal(first["bf16"]["t"], first["S=1"]["t"]):
        raise AssertionError("run_sim --precision bf16-const changed nothing")
    check_state("run_sim bf16 2x2 overlap vs bf16 1x1, large step 1",
                first["bf16 2x2 overlap"], first["bf16"], bit_exact=True)


def slice_damped(tmp: Path, fx: Path, case, damped, states):
    """The damped ``run_sim --namelist`` runs: the 1x1 run's first large
    step against ``rk3_golden_native(smdiv=)`` (DRIVER_TOL; past it the
    closure-less shell's state is amplified rounding noise, ww what is left
    of cancelling terms 1e8 times its size, and no tolerance against
    another implementation means anything), the 2x2 rdma run's third step
    equal to the 1x1 run's bit for bit, a state that differs from the
    undamped run's, and one large step of ``--kernel eager`` (no kernel
    launched) against the fused run's first step (DRIVER_TOL)."""
    import numpy as np
    from wrf_tpu_torch.io import checkpoint

    check_state("run_sim smdiv 2x2 rdma vs 1x1 smdiv",
                states["smdiv 2x2 rdma"], states["smdiv"], bit_exact=True)
    if np.array_equal(states["smdiv"]["u"], states["S=1"]["u"]):
        raise AssertionError("run_sim --namelist: smdiv changed nothing")
    first, _, _ = checkpoint.load_checkpoint(tmp / "smdiv" / "step_000001")
    got = embed_checkpoint(case, first)
    gold = rk3_golden_native(case, 4, case.dts * 4, "stage", smdiv=SMDIV)
    check_state("run_sim smdiv, large step 1 vs the oracle's RK3", got,
                {k: gold[k] for k in got}, tol=DRIVER_TOL)
    launches, _, eager = run_sim_launches(
        tmp, fx, "smdiv_eager", *damped, "--kernel", "eager", steps=1)
    if any(launches.values()):
        raise AssertionError(f"run_sim --kernel eager launched {launches}")
    check_state("run_sim smdiv --kernel eager vs cuda, 1 large step", eager,
                first, tol=DRIVER_TOL)


#: the closed loop against the oracle: 10 large steps at the reference
#: grid (tests/test_closure.py's tolerance for that horizon)
CLOSED_TOL = dict(rtol=2e-4, atol_scale=2e-5)
#: the drift gate of 100 closed large steps (tests/test_closure.py)
DRIFT_GATE = 2e-6


def rk3_golden_native_run(case, n_large: int, acoustic_steps: int, dt: float,
                          smdiv: float, tendency_fn, rayleigh_uv: float):
    """``n_large`` closed RK3 large steps with the C++ oracle's substeps: the
    structure of ``models/rk3.py::rk3_golden_run`` (tendencies once per
    step from ``tendency_fn(fields)``, the base snapshot, the evolved state
    folded back, the winds damped by ``1 - rayleigh_uv``) over
    :func:`rk3_golden_native`.  Returns the last step's outputs."""
    import numpy as np

    fields = dict(case.fields)
    out = None
    for _ in range(n_large):
        fields.update(tendency_fn(fields))
        out = rk3_golden_native(dataclasses.replace(case, fields=fields),
                                acoustic_steps, dt, "base", smdiv=smdiv)
        for key, name in START_FIELDS.items():
            fields[name] = out[key]
        d = np.float32(1.0 - rayleigh_uv)
        fields["grid_u_2"] = fields["grid_u_2"] * d
        fields["grid_v_2"] = fields["grid_v_2"] * d
    return out


def closure_vs_oracle(n_large=10, acoustic_steps=6):
    """(d): ``n_large`` closed large steps at the reference grid (balanced,
    smdiv 0.1) through RK3Integrator + NudgingTendencies on the card,
    against the oracle's closed run over the domain region (the memory
    window's frame is fixture halo the port's state never carries)."""
    import torch
    from wrf_tpu_torch.compare import compare
    from wrf_tpu_torch.convert import arrays_to_numpy
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.models.tendencies import (
        NudgingTendencies, golden_nudging_fn,
    )
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    case = case_at(REF_GRID, balanced=True)
    b = case.bounds
    dt = case.dts * acoustic_steps
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags,
                        acoustic_steps=acoustic_steps, kernel="cuda",
                        smdiv=SMDIV, snapshot="base", device="cuda")
    arrays = rk3.prepare(case_to_domain(case))
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    k1.LAUNCHES = 0
    for _ in range(n_large):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
    torch.cuda.synchronize()
    n_sub = sum(n for _, n in rk3.stages)
    if k1.LAUNCHES != n_large * n_sub:
        raise AssertionError(f"closed loop at {REF_GRID} launched K1 "
                             f"{k1.LAUNCHES} times, not {n_large * n_sub}")
    got = arrays_to_numpy(out)
    gold = rk3_golden_native_run(case, n_large, acoustic_steps, dt, SMDIV,
                                 golden_nudging_fn(case, dt, 5.0), 0.1)
    j0, j1 = b.mem(b.jds, "j"), b.mem(b.jde, "j")
    i0, i1 = b.mem(b.ids, "i"), b.mem(b.ide, "i")
    worst = 0.0
    for name in ("ww", "mu", "t", "t_ave", "u", "v"):
        g = gold[name]
        want = (g[j0:j1 + 1, :, i0:i1 + 1] if g.ndim == 3
                else g[j0:j1 + 1, i0:i1 + 1])
        r = compare(got[name], want, name, **CLOSED_TOL)
        print(f"[closure vs oracle, {n_large} closed steps at {REF_GRID}] {r}")
        if not r.passed:
            raise AssertionError(f"closed loop vs oracle: {r}")
        worst = max(worst, r.max_scaled_err)
    return worst


def closure_sync(case, tag, required=False, mesh_shape=None, n=10, **kw):
    """(b): one closed chunk of ``n`` large steps (``multi_step`` with the
    readback left out) under ``torch.cuda.set_sync_debug_mode("error")``,
    after a warm-up chunk of one step (the library's build, K3's plans and
    the Thomas vectors happen there).  Returns None when no host
    synchronisation happened between the chunk's first launch and its
    readback, else the first line of the error; raises if ``required``."""
    import numpy as np
    import torch
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.models.tendencies import NudgingTendencies
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    b = case.bounds
    dt = case.dts * 4
    mesh = (make_mesh(["cuda:0"] * (mesh_shape[0] * mesh_shape[1]),
                      mesh_shape) if mesh_shape else None)
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, acoustic_steps=4,
                        kernel="cuda", snapshot="base", device="cuda",
                        mesh=mesh, **kw)
    arrays = rk3.prepare(case_to_domain(case, with_w=kw.get("with_w", False)))
    fn = NudgingTendencies(arrays, dt)
    args = (case.rdx, case.rdy, dt, case.epssm)
    arrays, _ = rk3.multi_step(arrays, 1, *args, tendency_fn=fn)
    torch.cuda.synchronize()
    k1.LAUNCHES = k3.LAUNCHES = 0
    err = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        arrays, diags = rk3.multi_step(arrays, n, *args, tendency_fn=fn,
                                       readback=False)
    except RuntimeError as e:
        err = str(e).strip().splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = {"k1": k1.LAUNCHES, "k3": k3.LAUNCHES}
    if err is None:
        diags = diags.cpu().numpy()
        if diags.shape != (n, 2) or not np.isfinite(diags).all():
            raise AssertionError(f"closure sync {tag}: diagnostics {diags}")
        print(f"[closure sync] {tag}: {n} closed large steps in one chunk, "
              f"launches {launches}, no host synchronisation between the "
              "first launch and the readback")
    elif required:
        raise AssertionError(f"closure sync {tag}: {err}")
    else:
        print(f"[closure sync] {tag}: a host synchronisation remains inside "
              f"the chunk (ROADMAP M6): {err}")
    return err


def profile_step(trace_dir: Path, step: int = 3):
    """Step ``step`` of a ``run_sim --profile`` trace: the host span of its
    ``run_sim step N`` annotation, the device's busy time inside it (the
    union of the kernels, copies and fills that start there), and each
    kernel's count and device ms."""
    files = sorted(Path(trace_dir).glob("trace_*.json"))
    if not files:
        raise AssertionError(f"run_sim --profile wrote no trace in {trace_dir}")
    events = json.loads(files[-1].read_text())["traceEvents"]
    span = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == f"run_sim step {step}"]
    if len(span) != 1:
        raise AssertionError(f"{files[-1]}: {len(span)} spans of step {step}")
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    dev = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
    if not dev:
        raise AssertionError("torch.profiler traced no device time in "
                             f"step {step}")
    busy, end = 0.0, lo
    kernels = {}
    for e in dev:
        a, z = max(e["ts"], end), e["ts"] + e["dur"]
        busy += max(0.0, z - a)
        end = max(end, z)
        n, us = kernels.get(e["name"], (0, 0.0))
        kernels[e["name"]] = (n + 1, us + e["dur"])
    return {"span_ms": span[0]["dur"] / 1e3, "busy_ms": busy / 1e3,
            "kernels": {k: (n, us / 1e3) for k, (n, us) in kernels.items()}}


#: the profile's kernel families: K1, K3, and what else the step launches
PROFILE_KINDS = {"K1": ("advance_mu_t_kernel",),
                 "K3": ("coupled_kernel", "staged_kernel")}


def profile_lines(tag, prof, card):
    """Prints a step's profile: busy over span, K1's and K3's count and
    device ms, the share that is neither, and the eight other kernels that
    take most.  Returns the row PERF.md keeps."""
    kinds = {k: [0, 0.0] for k in PROFILE_KINDS}
    other = {}
    for name, (n, ms) in prof["kernels"].items():
        kind = next((k for k, words in PROFILE_KINDS.items()
                     if any(w in name for w in words)), None)
        if kind:
            kinds[kind][0] += n
            kinds[kind][1] += ms
        else:
            other[name] = (n, ms)
    total = sum(ms for _, ms in prof["kernels"].values())
    # the functor a plain PyTorch kernel was instantiated for names the op
    short = {}
    for name, (n, ms) in other.items():
        key = re.sub(r"\bvoid |at::native::|\(anonymous namespace\)::|std::",
                     "", name)[:110]
        n0, ms0 = short.get(key, (0, 0.0))
        short[key] = (n0 + n, ms0 + ms)
    other = short
    rest = total - sum(ms for _, ms in kinds.values())
    print(f"[closure profile {tag}] step 3: host span {prof['span_ms']:.3f} "
          f"ms, device busy {prof['busy_ms']:.3f} ms "
          f"({100 * prof['busy_ms'] / prof['span_ms']:.1f} %); "
          + "; ".join(f"{k} {n} launches {ms:.3f} ms"
                      for k, (n, ms) in kinds.items())
          + f"; not K1/K3 {rest:.3f} ms of {total:.3f} "
          f"({100 * rest / total:.1f} %) ({card})")
    top = sorted(other.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        print(f"[closure profile {tag}]   {ms:.3f} ms, {n} x {name}")
    return {"span_ms": prof["span_ms"], "busy_ms": prof["busy_ms"],
            **{k: {"launches": n, "ms": ms} for k, (n, ms) in kinds.items()},
            "other_ms": rest, "other_share": rest / total,
            "top_other": {name: {"launches": n, "ms": ms}
                          for name, (n, ms) in top}}


def chunk_ms(text):
    """``ms/large-step`` of every chunk a ``--steps-per-sync`` run printed."""
    return [float(m.group(1)) for m in re.finditer(
        r"^steps \d+-\d+: [0-9.]+ ms \(([0-9.]+) ms/large-step", text, re.M)]


def mass_series(text):
    """The (total dry mass, perturbation sum) of every step a
    ``--diagnostics`` run printed, and its drifts."""
    rows = re.findall(r"total dry mass ([-+0-9.e]+) \(drift ([-+0-9.e]+)\),"
                      r" mass perturbation sum ([-+0-9.e]+)", text)
    return ([(float(m), float(p)) for m, _, p in rows],
            [float(d) for _, d, _ in rows])


def phase_closure(tmp: Path, fx: Path, card=""):
    """The long-horizon path at 512x512x50 (balanced fixture) through
    ``run_sim --closure nudge``: (a) 100 closed large steps, K1 exactly 700
    launches, the total-dry-mass drift below the gate; (b) the same with
    ``--steps-per-sync 10``, its final state bit-equal to (a)'s, its
    diagnostics within rtol 1e-5 of (a)'s, and a 10-step chunk at 1x1 S=1
    free of host synchronisation (the mesh, ``--with-w`` and S=2 chunks
    report theirs); (c) 10 closed steps on a 2x2 mesh under
    ``rdma_overlap`` and ``rdma``, bit-equal to 1x1; (d) 10 closed steps
    at the reference grid against the oracle's closed run; (e) a
    ``--profile`` trace of 3 closed steps at S=1 and ``--inner-steps 2``,
    step 3 broken down.  Returns the readings."""
    import numpy as np

    t_start = time.perf_counter()
    nudge = ("--closure", "nudge")
    res = {}
    # (a) 100 closed large steps, host-stepped
    launches, text, final = run_sim_text(tmp, fx, "closed", *nudge,
                                         steps=100, echo=False)
    step_ms = [float(m.group(1)) for m in
               re.finditer(r"^step \d+: ([0-9.]+) ms", text, re.M)]
    series, drift = mass_series(text)
    if launches != {"k1": 700, "k3": 0, "k4": 0, "k5": 0}:
        raise AssertionError(f"run_sim --closure nudge --steps 100 launched "
                             f"{launches}, expected K1 700")
    if len(step_ms) != 100 or len(drift) != 100:
        raise AssertionError(f"run_sim closed: {len(step_ms)} step lines, "
                             f"{len(drift)} mass lines of 100")
    worst = max(abs(d) for d in drift)
    res["launches"] = {"closed": launches}
    res["drift"] = worst
    res["host_ms"] = float(np.mean(step_ms[1:]))
    print(f"[closure] run_sim --closure nudge --steps 100 at {BIG_GRID}: "
          f"K1 {launches['k1']} launches, largest |total-dry-mass drift| "
          f"{worst:.3e} (gate {DRIFT_GATE:g}; the JAX package's README "
          f"records < 1e-6 on a TPU, a record, not this run), drift at step "
          f"100 {drift[-1]:+.3e}, {res['host_ms']:.3f} ms per large step "
          f"(mean of steps 2-100; steps 11-100 "
          f"{np.mean(step_ms[10:]):.3f}) ({card})")
    if not worst < DRIFT_GATE:
        raise AssertionError(f"100 closed steps drifted {worst:.3e}")
    # (b) the same run in chunks of 10 large steps
    launches, text, chunked = run_sim_text(
        tmp, fx, "closed_chunks", *nudge, "--steps-per-sync", "10",
        steps=100, echo=False)
    res["launches"]["chunks"] = launches
    ms = chunk_ms(text)
    series_b, _ = mass_series(text)
    if launches["k1"] != 700 or len(ms) != 10 or len(series_b) != 100:
        raise AssertionError(f"run_sim --steps-per-sync 10: launches "
                             f"{launches}, {len(ms)} chunks, "
                             f"{len(series_b)} mass lines")
    check_state("run_sim --closure nudge --steps-per-sync 10 vs host "
                "stepping, step 100", chunked, final, bit_exact=True)
    # the diagnostics series: the per-step mass-perturbation sums (float32
    # on the card in a chunk, float64 host-stepped).  The printed totals
    # differ by construction, as in the JAX package's run_sim: sum(muts)
    # host-stepped (muts is written in the compute window only), the ring
    # interior's sum(mut) plus the perturbation sum in a chunk.
    a, b_ = np.array(series), np.array(series_b)
    rel = np.abs(b_[:, 1] - a[:, 1]) / np.abs(a[:, 1])
    print(f"[closure] diagnostics series, chunked vs host-stepped: largest "
          f"relative difference of the perturbation sums {rel.max():.3e} "
          f"(float32 on the card against float64); the totals' "
          f"definitions differ by {np.abs(b_[:, 0] - a[:, 0]).max():.6e}")
    if not (rel < 1e-5).all():
        raise AssertionError("chunked diagnostics differ from host stepping "
                             "beyond rtol 1e-5")
    res["chunk_ms"] = float(np.mean(ms[1:]))
    print(f"[closure] --steps-per-sync 10: {res['chunk_ms']:.3f} ms per "
          f"large step (mean of chunks 2-10) beside host stepping's "
          f"{np.mean(step_ms[10:]):.3f} (steps 11-100) and "
          f"{res['host_ms']:.3f} (steps 2-100) ({card})")
    case = case_at(BIG_GRID, balanced=True)
    res["sync"] = {"1x1 S=1": closure_sync(case, "1x1 S=1", required=True)}
    for tag, kw in (("1x1 --with-w", dict(with_w=True)),
                    ("1x1 --inner-steps 2", dict(inner_steps=2)),
                    ("2x2 rdma", dict(mesh_shape=(2, 2),
                                      halo_backend="rdma")),
                    ("2x2 rdma_overlap", dict(mesh_shape=(2, 2),
                                              halo_backend="rdma_overlap"))):
        res["sync"][tag] = closure_sync(case, tag, **kw)
    # (c) the mesh: four shards on the one card, 10 closed steps
    launches, _, ref = run_sim_text(tmp, fx, "closed_10", *nudge, steps=10,
                                    echo=False)
    for backend, k5 in (("rdma_overlap", 0), ("rdma", 70 * cards_2x2())):
        launches, _, got = run_sim_text(
            tmp, fx, f"closed_2x2_{backend}", *nudge, "--mesh", "2x2",
            "--halo-backend", backend, steps=10, echo=False)
        if launches != {"k1": 280, "k3": 0, "k4": 0, "k5": k5}:
            raise AssertionError(f"closed 2x2 {backend} launched {launches}")
        res["launches"][f"2x2 {backend}"] = launches
        check_state(f"run_sim --closure nudge --mesh 2x2 --halo-backend "
                    f"{backend} vs 1x1, step 10", got, ref, bit_exact=True)
    # (d) against the oracle
    res["oracle_worst"] = closure_vs_oracle()
    # (e) the profile M6(a) starts from
    res["profile"] = {}
    for tag, flags, expected in (
            ("S=1", (), {"k1": 21, "k3": 0}),
            ("S=2", ("--inner-steps", "2"), {"k1": 15, "k3": 3})):
        trace_dir = tmp / f"profile_{tag.replace('=', '')}"
        launches, _, _ = run_sim_text(tmp, fx, f"closed_profile_{tag}",
                                      *nudge, *flags, "--profile",
                                      str(trace_dir), steps=3, echo=False)
        if {k: launches[k] for k in expected} != expected:
            raise AssertionError(f"profiled run {tag} launched {launches}")
        res["launches"][f"profile {tag}"] = launches
        res["profile"][tag] = profile_lines(tag, profile_step(trace_dir),
                                            card)
    res["wall_s"] = time.perf_counter() - t_start
    print(f"[closure] phase wall time {res['wall_s']:.1f} s")
    return res


def run_driver(tag, *argv, device="cuda"):
    """``python -m wrf_tpu_torch.driver`` in this process, its report
    condensed to one line; raises unless it returns 0.  Returns its ms per
    step (the host clock around its timed loop call)."""
    from wrf_tpu_torch import driver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main([*map(str, argv), "--device", device])
    text = buf.getvalue()
    timing = next((ln for ln in text.splitlines()
                   if ln.startswith("advance_mu_t [")), "")
    worst = max(float(x) for x in re.findall(r"scaled_err=([0-9.]+)", text))
    print(f"[driver {tag}] rc={rc} worst scaled_err={worst:.3f}: {timing}")
    if rc != 0:
        raise AssertionError(f"driver {tag} returned {rc}:\n{text}")
    return float(re.search(r"\(([0-9.]+) ms/step", timing).group(1))


DRIVER_TIERS = {
    "cuda": ("--tier", "cuda"),
    "sharded-cuda S=1": ("--tier", "sharded-cuda"),
    "sharded-cuda S=8": ("--tier", "sharded-cuda", "--inner-steps", "8"),
    "sharded-cuda S=8 fast": ("--tier", "sharded-cuda", "--inner-steps", "8",
                              "--fast"),
}
#: the coupled tiers, verified against the numpy golden loop (100 steps)
COUPLED_TIERS = {
    "coupled S=1": ("--tier", "coupled"),
    "coupled S=2": ("--tier", "coupled", "--inner-steps", "2"),
    "coupled S=4": ("--tier", "coupled", "--inner-steps", "4"),
    "coupled S=4 fast": ("--tier", "coupled", "--inner-steps", "4", "--fast"),
}


#: the loop tiers on a mesh of four shards on the one card (100 steps)
MESH_TIERS = {
    "coupled 2x2 rdma": ("--tier", "coupled", "--mesh", "2x2",
                         "--halo-backend", "rdma"),
    "coupled 2x2 rdma_overlap": ("--tier", "coupled", "--mesh", "2x2",
                                 "--halo-backend", "rdma_overlap"),
    "sharded-cuda 2x2": ("--tier", "sharded-cuda", "--mesh", "2x2"),
}

#: the two loop tiers with bf16 constant streams, gated at 2e-2 / 2e-2
#: (one lateral BC, 1 and 100 steps)
BF16_TIERS = {
    "sharded-cuda bf16": ("--tier", "sharded-cuda", "--precision",
                          "bf16-const"),
    "coupled bf16": ("--tier", "coupled", "--precision", "bf16-const"),
}


#: the --with-w coupled tiers (one lateral BC, 100 steps)
COUPLED_W_TIERS = {f"{k} +w": v + ("--with-w",)
                   for k, v in COUPLED_TIERS.items() if "fast" not in k}
COUPLED_W_TIERS["coupled-eager +w"] = ("--tier", "coupled-eager", "--with-w")


def phase_driver(tmp: Path, fx_big: Path, big_steps: int,
                 coupled_steps: int = 9):
    """The driver's tiers at the reference grid under every lateral BC
    (against the oracle's goldens, 1 and 100 steps; the coupled tiers
    against the numpy golden loop, 100 steps), then the two blocked main
    paths at 512x512x50: the mu/t loop (sharded-cuda S=8) and the coupled
    loop (coupled S=4).  Returns the launches of each."""
    from wrf_tpu_torch.io import fixtures
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2

    t0 = time.perf_counter()
    for bc in BC_VARIANTS:
        case = case_at(REF_GRID, bc)
        for steps in (1, 100):
            fx = fixtures.write_case(case, tmp / f"ref_{bc}_{steps}",
                                     steps=steps)
            tiers = {**DRIVER_TIERS,
                     **(BF16_TIERS if bc == "specified" else {}),
                     **({**COUPLED_TIERS, **MESH_TIERS} if steps == 100
                        else {}),
                     **(COUPLED_W_TIERS
                        if steps == 100 and bc == "specified" else {})}
            for tier, args in tiers.items():
                run_driver(f"{bc} {steps} steps {tier}", fx, *args)
    print(f"[time] driver at {REF_GRID}: {time.perf_counter() - t0:.1f} s")

    big = "x".join(map(str, BIG_GRID))
    paths = {
        "mu/t": (f"{big} {big_steps} steps sharded-cuda S=8",
                 DRIVER_TIERS["sharded-cuda S=8"], 8, big_steps),
        "coupled": (f"{big} {coupled_steps} steps coupled S=4",
                    COUPLED_TIERS["coupled S=4"]
                    + ("--steps", str(coupled_steps)), 4, coupled_steps),
        "coupled +w": (f"{big} {coupled_steps} steps coupled S=4 +w",
                       COUPLED_W_TIERS["coupled S=4 +w"]
                       + ("--steps", str(coupled_steps)), 4, coupled_steps),
    }
    out = {}
    for path, (tag, args, S, steps) in paths.items():
        t0 = time.perf_counter()
        k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0
        run_driver(tag, fx_big, *args)
        launches = {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES, "k3": k3.LAUNCHES}
        # a warm-up and a timed loop call, each (steps-1)//S blocked passes
        # (K2 or K3), the remaining single substeps and the final substep
        # on K1
        blocked = 2 * ((steps - 1) // S)
        expected = {"k1": 2 * (1 + (steps - 1) % S),
                    "k2": blocked if path == "mu/t" else 0,
                    "k3": blocked if path.startswith("coupled") else 0}
        if launches != expected:
            raise AssertionError(f"the {path} main path launched "
                                 f"{launches}, expected {expected}")
        print(f"[driver] {path} main path launches: {launches} "
              f"({time.perf_counter() - t0:.1f} s)")
        out[path] = launches
    return out


def phase_capture_driver(tmp: Path, steps: int = 5, device="cuda"):
    """``driver --dump-intermediates`` at the reference grid on the cuda,
    eager and numpy tiers: the five files exist on each; the cuda tier's
    equal, bit for bit, the captures of the same ``steps`` calls of K1's
    plain version on the card; the cuda and eager tiers' agree with the
    numpy tier's at the driver's gate away from rows 0 and J-1 (zero in the
    cuda tier's).  Then the native CLI executable: built with g++ from
    ``wrf_tpu_torch/native``, run on the same fixture, return code 0 and
    ``diff=0`` on all eight report rows."""
    import torch
    from wrf_tpu_torch import driver, native
    from wrf_tpu_torch.compare import compare
    from wrf_tpu_torch.convert import arrays_from_numpy
    from wrf_tpu_torch.io import codec, fixtures
    from wrf_tpu_torch.ops.advance_mu_t_cuda import (
        CAPTURE_NAMES, advance_mu_t_fused_plain,
    )

    case = case_at(REF_GRID)
    b = case.bounds
    fx = fixtures.write_case(case, tmp / "capture_fx", steps=steps)
    caps = {}
    for tier in ("cuda", "eager", "numpy"):
        d = tmp / f"dump_{tier}"
        run_driver(f"{tier} --dump-intermediates", fx, "--tier", tier,
                   "--dump-intermediates", d, device=device)
        if sorted(f.name for f in d.iterdir()) != sorted(
                f"{n}.bin" for n in CAPTURE_NAMES):
            raise AssertionError(f"driver {tier} --dump-intermediates wrote "
                                 f"{sorted(f.name for f in d.iterdir())}")
        caps[tier] = {n: codec.read_field(
            d / f"{n}.bin", b.shape3 if n.startswith("ww") else b.shape2)
            for n in CAPTURE_NAMES}
    # the same calls through K1's plain version
    kw = case.kernel_kwargs()
    arr = arrays_from_numpy({k: v for k, v in kw.items()
                             if hasattr(v, "ndim")}, device)
    i0, i1, j0, j1, k0, k1 = b.loop_bounds(case.flags)
    static = dict(window=(i0, i1, j0, j1), k0=k0, k1=k1,
                  kde=b.mem(b.kde, "k"),
                  **{k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")})
    for step in range(steps):
        out = advance_mu_t_fused_plain(**arr, **static,
                                       capture=step == steps - 1)
        arr.update({k: out[k] for k in ("ww", "mu", "t", "t_ave")})
    check_bits(f"driver cuda --dump-intermediates vs plain, {steps} steps",
               {n: torch.as_tensor(caps["cuda"][n]) for n in CAPTURE_NAMES},
               {n: out[n].cpu() for n in CAPTURE_NAMES})
    inner = slice(1, -1)
    for tier in ("cuda", "eager"):
        for n in CAPTURE_NAMES:
            r = compare(caps[tier][n][inner], caps["numpy"][n][inner], n,
                        rtol=driver.RTOL, atol_scale=driver.ATOL_SCALE)
            print(f"[driver {tier} --dump-intermediates vs numpy] {r}")
            if not r.passed:
                raise AssertionError(f"{tier} capture vs numpy: {r}")

    t0 = time.perf_counter()
    exe = native.build_driver()
    proc = subprocess.run([str(exe), str(fx)], capture_output=True, text=True,
                          timeout=300)
    print(f"[native driver] {exe.name} built and run in "
          f"{time.perf_counter() - t0:.1f} s: rc={proc.returncode}, "
          f"{proc.stdout.splitlines()[0] if proc.stdout else proc.stderr}")
    if proc.returncode != 0 or proc.stdout.count("diff=0 ") != 8:
        raise AssertionError(f"native driver: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")


def loop_marginal_ms(case, counts, reps=5, coupled=False, mesh_shape=None,
                     prepared=None, devices=None, **kw):
    """ms per substep of ShardedAdvanceMuT (the coupled SmallStepLoop with
    ``coupled``) by the difference of two step counts, best of ``reps``
    each, so the per-call set-up cancels; every call is read on two
    clocks, the host clock around the call and the synchronise that ends
    it, and CUDA events around the call.  Returns ``(host_ms, events_ms)``.
    ``mesh_shape``: that many shards, all on the one card (on ``devices``,
    one shard each, when they are given).  ``prepared``:
    a dict that keeps the last layout's arrays on the card between calls
    (the loops leave their prepared arrays alone, and a copy of a
    512x512x50 case to the card costs more than the timed substeps)."""
    import math

    import torch
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain,
    )

    b = case.bounds
    best = {}
    if mesh_shape:
        kw["mesh"] = make_mesh(
            devices or ["cuda:0"] * (mesh_shape[0] * mesh_shape[1]),
            mesh_shape)
    for n in counts:
        if coupled:
            loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=n,
                                 device="cuda", **kw)
        else:
            loop = ShardedAdvanceMuT(b.ide, b.jde, b.kdim, case.flags,
                                     n_steps=n, vary_winds=True,
                                     device="cuda", **kw)
        with_w = bool(kw.get("with_w"))
        key = (id(case), mesh_shape, with_w)
        if prepared is None or key not in prepared:
            if prepared is not None:
                prepared.clear()   # one layout on the card at a time
            arrays = loop.prepare(case_to_domain(case, with_w=with_w))
            if prepared is not None:
                prepared[key] = arrays
        else:
            arrays = prepared[key]
        checksum = float(loop(arrays, case.rdx, case.rdy, case.dts,
                              case.epssm)["t"].sum())
        if not math.isfinite(checksum):
            raise AssertionError(f"non-finite loop state at n={n} {kw}")
        best[n] = [float("inf")] * 2
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
            stop.record()
            torch.cuda.synchronize()
            best[n] = [min(best[n][0], (time.perf_counter() - t0) * 1e3),
                       min(best[n][1], start.elapsed_time(stop))]
        del arrays, loop
    n1, n2 = counts
    return tuple((b2 - b1) / (n2 - n1) for b1, b2 in zip(best[n1], best[n2]))


MESH_BACKENDS = ("ppermute", "rdma", "rdma_overlap")
LOOP_ROWS = {
    "512x512x50 S=1": (BIG_GRID, (65, 257), dict()),
    "512x512x50 exact S=8": (BIG_GRID, (65, 257), dict(inner_steps=8)),
    "512x512x50 fast S=32": (BIG_GRID, (129, 513),
                             dict(inner_steps=32, fast=True)),
    "74x61x32 exact S=8": (REF_GRID, (65, 257), dict(inner_steps=8)),
    "coupled 512x512x50 S=1": (BIG_GRID, (65, 257), dict(coupled=True)),
    **{f"coupled 512x512x50 {m}": (BIG_GRID, (65, 257), dict(
        coupled=True, inner_steps=S, fast=fast))
       for m, (S, fast) in K3_MODES.items()},
    "coupled +w 512x512x50 S=1": (BIG_GRID, (65, 257),
                                  dict(coupled=True, with_w=True)),
    **{f"coupled +w 512x512x50 exact S={S}": (BIG_GRID, (65, 257), dict(
        coupled=True, with_w=True, inner_steps=S)) for S in (2, 4)},
    # the coupled loop on a mesh: four shards on the one card
    **{f"coupled 512x512x50 mesh {nj}x{ni} {backend}": (
        BIG_GRID, (65, 257), dict(coupled=True, mesh_shape=(nj, ni),
                                  halo_backend=backend))
       for nj, ni in ((2, 2), (4, 1)) for backend in MESH_BACKENDS},
    # the same with divergence damping: mudf carried and exchanged
    "coupled smdiv 512x512x50 S=1": (BIG_GRID, (65, 257),
                                     dict(coupled=True, smdiv=SMDIV)),
    **{f"coupled smdiv 512x512x50 mesh {nj}x{ni} {backend}": (
        BIG_GRID, (65, 257), dict(coupled=True, mesh_shape=(nj, ni),
                                  halo_backend=backend, smdiv=SMDIV))
       for nj, ni in ((2, 2), (4, 1)) for backend in MESH_BACKENDS},
    # blocked on the mesh: the width-S exchange per block, its j leg by
    # copies or inside K3
    **{f"coupled 512x512x50 exact S=2 mesh 2x2 {backend}": (
        BIG_GRID, (65, 257), dict(coupled=True, mesh_shape=(2, 2),
                                  halo_backend=backend, inner_steps=2))
       for backend in ("ppermute", "rdma_overlap")},
    # bf16 constant streams
    "512x512x50 bf16 S=1": (BIG_GRID, (65, 257), dict(const_dtype="bf16")),
    "512x512x50 bf16 exact S=8": (BIG_GRID, (65, 257),
                                  dict(inner_steps=8, const_dtype="bf16")),
    "coupled 512x512x50 bf16 S=1": (BIG_GRID, (65, 257),
                                    dict(coupled=True, const_dtype="bf16")),
    "coupled 512x512x50 bf16 exact S=2": (
        BIG_GRID, (65, 257), dict(coupled=True, inner_steps=2,
                                  const_dtype="bf16")),
}


def phase_loop_timings(card=""):
    """Every row of LOOP_ROWS: ``{row: host-clock ms per substep}`` and the
    same from CUDA events."""
    import torch

    cases = {g: case_at(g, balanced=True) for g in (BIG_GRID, REF_GRID)}
    host, events, prepared = {}, {}, {}
    # rows of one layout (grid, mesh, with_w) side by side: they share
    # the arrays on the card
    rows = sorted(LOOP_ROWS.items(), key=lambda r: (
        r[1][0], r[1][2].get("mesh_shape") or (), bool(r[1][2].get("with_w"))))
    for name, (grid, counts, kw) in rows:
        kw = dict(kw)
        if kw.get("const_dtype") == "bf16":
            kw["const_dtype"] = torch.bfloat16
        host[name], events[name] = loop_marginal_ms(
            cases[grid], counts, prepared=prepared, **kw)
        print(f"[loop {name}] n={counts[0]}/{counts[1]}: "
              f"{host[name]:.4f} ms per substep on the host clock, "
              f"{events[name]:.4f} on CUDA events ({card})")
    return host, events


def phase_mesh_profile(card="", counts=(9, 33), shapes=((2, 2),)):
    """One ``torch.profiler`` trace per halo backend of the damped coupled
    loop at 512x512x50 on the meshes ``shapes`` ((2,2); pass (4,1) too for
    the mesh with an unsharded i), four shards on the one card, at two
    step counts; per substep (the difference of the two traces over the
    difference of the counts, so the per-call set-up cancels): the host
    span, the device's busy time and its share of the span, the K1
    launches, the copy kernels (``Tensor.copy_`` between blocks: the
    ``ppermute`` rows and columns), and K5's launches and device time.  The
    host span is read under the profiler, which slows a host-bound loop:
    the share is a lower bound of the unprofiled one.  Returns the rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    case = case_at(BIG_GRID, balanced=True)
    b = case.bounds
    kinds = {"k1": ("advance_mu_t_kernel",), "k5": ("put_kernel",),
             "copy": ("copy", "Memcpy")}

    def trace(shape, backend, n):
        mesh = make_mesh(["cuda:0"] * 4, shape)
        loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=n,
                             device="cuda", mesh=mesh, halo_backend=backend,
                             smdiv=SMDIV)
        arrays = loop.prepare(case_to_domain(case))
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
            torch.cuda.synchronize()
            span = (time.perf_counter() - t0) * 1e3
        row = {"span_ms": span, "busy_ms": 0.0}
        for k in kinds:
            row[k + "_n"], row[k + "_ms"] = 0, 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue   # a host-side row; the kernels have their own
            ms = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            row["busy_ms"] += ms
            for k, words in kinds.items():
                if any(w in e.key for w in words):
                    row[k + "_n"] += e.count
                    row[k + "_ms"] += ms
                    break
        if not row["busy_ms"] > 0:
            raise AssertionError("torch.profiler traced no device time")
        return row

    n1, n2 = counts
    out = {}
    for shape in shapes:
        for backend in MESH_BACKENDS:
            lo, hi = trace(shape, backend, n1), trace(shape, backend, n2)
            r = {k: (hi[k] - lo[k]) / (n2 - n1) for k in lo}
            r["busy_share"] = r["busy_ms"] / r["span_ms"]
            r["k5_us_each"] = (1e3 * r["k5_ms"] / r["k5_n"] if r["k5_n"]
                               else 0.0)
            out[shape, backend] = r
            print(f"[profile smdiv {shape[0]}x{shape[1]} {backend}] per "
                  f"substep (n={n1}/{n2}): host span {r['span_ms']:.4f} ms "
                  f"under the profiler, device busy {r['busy_ms']:.4f} ms "
                  f"({100 * r['busy_share']:.1f} %); K1 {r['k1_n']:.2f} "
                  f"launches, {r['k1_ms']:.4f} ms; copy kernels "
                  f"{r['copy_n']:.2f}, {r['copy_ms']:.4f} ms; K5 "
                  f"{r['k5_n']:.2f} launches, {r['k5_us_each']:.2f} us each "
                  f"({card})")
    return out


#: K1, K2 and K3 launches per shard of each program of the multi-process
#: phase (multihost_check's "chip" suite): S=1 9 substeps; S=2 4 blocks
#: and the final substep; the mu/t loop's 2 blocks of 8 and its final
#: substep; 3 large steps of 1 + 2 + 4 substeps
MULTIPROCESS_LAUNCHES = {
    "coupled S=1": {"k1": 9, "k2": 0, "k3": 0},
    "coupled S=2": {"k1": 1, "k2": 0, "k3": 4},
    "mu_t S=8": {"k1": 1, "k2": 2, "k3": 0},
    "rk3": {"k1": 21, "k2": 0, "k3": 0},
    "exchange": {"k1": 0, "k2": 0, "k3": 0},
    "coupled S=1 rdma": {"k1": 9, "k2": 0, "k3": 0},
    "coupled S=1 rdma_overlap": {"k1": 9, "k2": 0, "k3": 0},
    "coupled S=2 rdma_overlap": {"k1": 1, "k2": 0, "k3": 4},
    "rk3 rdma_overlap": {"k1": 21, "k2": 0, "k3": 0},
    "rdma exchange": {"k1": 0, "k2": 0, "k3": 0},
}
#: the j exchanges of each program through the rdma backends: one K5
#: launch per card each in one process under ``rdma`` (none under
#: ``rdma_overlap``, whose K1 and K3 read the rows in place); across
#: processes on (2,2) every j neighbour sits in another process, so one put
#: and one wait launch per process each, and no K5.  S=2: 4 slab exchanges
#: and the final substep's rows; the transport alone: 21 ``rdma_rows`` and
#: 21 ``remote_refresh_multi``
MULTIPROCESS_EXCHANGES = {
    "coupled S=1 rdma": ("rdma", 9),
    "coupled S=1 rdma_overlap": ("rdma_overlap", 9),
    "coupled S=2 rdma_overlap": ("rdma_overlap", 5),
    "rk3 rdma_overlap": ("rdma_overlap", 21),
    "rdma exchange": ("rdma", 42),
}


def expected_launches(tag, n_shards, n_cards, across):
    """What a process of the multi-process phase launches for program
    ``tag``: K1-K3 per shard, K5 per card and exchange in one process, the
    signalled put and the wait per exchange across processes."""
    want = {k: n * n_shards for k, n in MULTIPROCESS_LAUNCHES[tag].items()}
    backend, n = MULTIPROCESS_EXCHANGES.get(tag, ("ppermute", 0))
    want["k5"] = n * n_cards if backend == "rdma" and not across else 0
    want["put"] = want["wait"] = n if across else 0
    return want


def describe_reports(reports):
    """One line of a process's programs: launches, ms, step ms."""
    out = []
    for tag, r in reports.items():
        line = f"{tag} {r['launches']} {r['ms']:.1f} ms"
        if "step_ms" in r:
            line += (" (ms per large step "
                     + ", ".join(f"{x:.2f}" for x in r["step_ms"]) + ")")
        if tag == "exchange":
            line += " (" + ", ".join(
                f"{k} {r[k + ' ms']:.4f} ms, {r[k + ' bytes sent']} B"
                for k in ("v j", "mu j", "mu i", "t gather")) + ")"
        if tag == "rdma exchange":
            line += " (" + ", ".join(
                f"{k} {r[k + ' ms']:.4f} ms"
                for k in ("rdma_rows", "remote_refresh_multi")) + ")"
        out.append(line)
    return "; ".join(out)


def check_launches(what, reports, n_shards, n_cards, across):
    for tag, r in reports.items():
        want = expected_launches(tag, n_shards, n_cards, across)
        if r["launches"] != want:
            raise AssertionError(f"{what} {tag}: launches {r['launches']}, "
                                 f"expected {want}")


def multiprocess_runs(label, nprocs, backend, ref, doms, grid, timeout,
                      card):
    """``multihost_check.run`` of the "chip" suite at each process count
    against the one-process ``ref``: a ``different=`` line per program, each
    rank's launches against its share and its programs' ms; raises on any
    difference.  Returns ``{nproc: result}``."""
    from wrf_tpu_torch.tools import multihost_check as mh

    out = {}
    for nproc in nprocs:
        r = mh.run(nproc, "cuda", suite_name="chip", grid=grid,
                   mesh_shape=(2, 2), backend=backend, timeout=timeout,
                   doms=doms, ref=ref)
        for tag in dict.fromkeys(k.split("/")[0] for k in r["different"]):
            diff = {k.split("/")[1]: d for k, d in r["different"].items()
                    if k.split("/")[0] == tag}
            print(f"[multiprocess {nproc} {label}] {tag}: different= "
                  f"{json.dumps(diff)}")
        for rep in r["ranks"]:
            check_launches(f"{nproc} {label} rank {rep['rank']}",
                           rep["programs"], len(rep["shards"]), 1, True)
            print(f"[multiprocess {nproc} {label} rank {rep['rank']} "
                  f"shards {rep['shards']}] "
                  f"{describe_reports(rep['programs'])} ({card})")
        bad = {k: d for k, d in r["different"].items() if d}
        if bad:
            raise AssertionError(f"{nproc} {label} differ from one "
                                 f"process: {bad}")
        out[nproc] = r
    return out


def phase_multiprocess(card="", grid=BIG_GRID, nprocs=(2, 4),
                       timeout=400.0):
    """The loops across processes: the main path's programs
    (``multihost_check``'s "chip" suite: the loops under ``ppermute``, then
    under ``rdma`` and ``rdma_overlap``, whose j exchange crosses processes
    through the mailboxes, and the rdma transport alone) on the (2,2) mesh
    at ``grid`` in 2 and 4 gloo processes on ``cuda:0``, each field held
    bit for bit against the one-process (2,2) run in this process; every
    rank's K1-K3 launches must be its shards' share and its put and wait
    launches one per exchange.  Where four cards are visible, the same over
    4 NCCL ranks, one card each, against one process over the four cards.
    Returns ``{"reference": reports, nproc: multihost_check.run's result,
    "nccl": None or {"reference": ..., 4: ...}}``."""
    from wrf_tpu_torch.tools import multihost_check as mh

    progs = mh.suite("chip", grid)
    doms = mh.domains(progs)
    ref = mh.reference(progs, doms, "cuda", (2, 2), 1)
    check_launches("one process", ref[1], 4, 1, False)
    print(f"[multiprocess 1 process 2x2 {grid}] {describe_reports(ref[1])} "
          f"({card})")
    res = {"reference": ref[1]}
    res.update(multiprocess_runs("processes 2x2 gloo cuda:0", nprocs, "gloo",
                                 ref, doms, grid, timeout, card))
    res["nccl"] = None
    if cards_for("the loops over 4 NCCL ranks", 4) is not None:
        ref4 = mh.reference(progs, doms, "cuda", (2, 2), 4, "nccl")
        check_launches("one process on four cards", ref4[1], 4, 4, False)
        print(f"[multiprocess 1 process 2x2 four cards {grid}] "
              f"{describe_reports(ref4[1])} ({card})")
        res["nccl"] = {"reference": ref4[1], **multiprocess_runs(
            "NCCL ranks 2x2, a card each", (4,), "nccl", ref4, doms, grid,
            timeout, card)}
    return res


# ---------------------------------------------------------------------------
# the scaling tools, and the mesh over several cards in one process
# ---------------------------------------------------------------------------
#: the grids of the exchange-overhead rows
HALO_GRIDS = ((128, 128, 50), BIG_GRID)
#: the local tiles of the weak-scaling ladders
WEAK_TILES = (256, 512)


def phase_halo_overhead(card=""):
    """``python -m wrf_tpu_torch.tools.bench_halo``'s seven rows at
    128x128x50 and 512x512x50 on cuda:0: the coupled loop on a (1,1) mesh
    without an exchange, with ``force_exchange`` under ``ppermute``,
    ``rdma`` and ``rdma_overlap``, and the depth-4 trapezoid without and
    with its block exchange (``ppermute``, ``rdma_overlap``); ms per
    substep on the host clock (two counts, 100 and 400) and each row's
    overhead against its baseline.  Returns ``{grid: {row: (ms, us)}}``."""
    from wrf_tpu_torch.tools import bench_halo

    def echo(line, **kw):
        print(f"[halo overhead] {line} ({card})", **kw)

    return {grid: bench_halo.run(*grid, device="cuda:0", echo=echo)
            for grid in HALO_GRIDS}


def phase_weak_scaling(card=""):
    """``python -m wrf_tpu_torch.tools.weak_scaling`` over every visible
    card (rung n on ``cuda:0`` .. ``cuda:n-1``; on one card rung 1 alone)
    at tiles of 256 and 512 (nz 50), under each backend at S=1 and at
    ``inner_steps`` 4 (which runs ``ppermute`` under every backend, the
    JAX tool's rule, so its ladder is timed once and printed per backend
    with that backend's model): one JSON line per ladder.  Returns
    ``{(tile, S, backend): record}``."""
    import torch
    from wrf_tpu_torch.tools import weak_scaling

    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    out, timings = {}, {}
    for tile in WEAK_TILES:
        for S in (1, 4):
            for backend in MESH_BACKENDS:
                rec = weak_scaling.ladder(devices, (tile, tile), 50,
                                          inner_steps=S,
                                          halo_backend=backend,
                                          timings=timings)
                out[tile, S, backend] = rec
                print(f"[weak scaling tile {tile} S={S} {backend}] "
                      f"{json.dumps(rec)} ({card})")
    return out


def cards_for(check, need):
    """``cuda:0`` .. ``cuda:need-1``, or None after printing that ``check``
    was not run because fewer cards are visible (it is not passed)."""
    import torch

    n = torch.cuda.device_count()
    if n < need:
        print(f"[multicard] not run: {n} CUDA device(s) visible ({check} "
              f"needs {need})")
        return None
    return [f"cuda:{i}" for i in range(need)]


def multicard_placement(card=""):
    """Every shard of ``mesh_from_spec`` on its own card when enough are
    visible; ``scatter`` puts each block there and ``gather`` brings them
    back to ``cuda:0`` bit for bit; the peer-access table; a mesh whose
    neighbours lack peer access raises, naming both cards."""
    import torch
    from wrf_tpu_torch.parallel import mesh as mesh_mod
    from wrf_tpu_torch.parallel.sharded import gather, scatter

    n = torch.cuda.device_count()
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j)
              for j in range(n)] for i in range(n)]
    print(f"[multicard placement] peer access between the {n} card(s): "
          + "; ".join(f"cuda:{i} -> " + ",".join(
              str(j) for j in range(n) if peers[i][j] and i != j)
              for i in range(n)))
    for spec, need in (("2x1", 2), ("3x1", 3), ("2x2", 4)):
        if cards_for(f"placement {spec}", need) is None:
            continue
        mesh = mesh_mod.mesh_from_spec(spec, "cuda")
        placed = [str(mesh.device(c)) for c in mesh.coords()]
        if placed != [f"cuda:{s}" for s in range(need)]:
            raise AssertionError(f"mesh {spec}: shards on {placed}")
        nj, ni = mesh.shape
        g = torch.Generator(device="cuda:0").manual_seed(need)
        x = torch.randn((nj * 66, 8, ni * 70), device="cuda:0", generator=g)
        blocks = scatter(x, mesh)
        where = sorted({str(b.device) for b in blocks.values()})
        back = gather(blocks, mesh)
        diff = count_different(back, x)
        print(f"[multicard placement {spec}] {mesh_mod.describe(mesh)}; "
              f"blocks on {where}; gather on {back.device} different={diff}")
        if where != sorted(placed) or back.device != x.device or diff:
            raise AssertionError(f"mesh {spec}: scatter/gather moved the "
                                 "blocks wrongly")
    if cards_for("the peer-access refusal", 2) is None:
        return
    real = torch.cuda.can_device_access_peer
    torch.cuda.can_device_access_peer = lambda a, b: {a, b} != {0, 1}
    try:
        mesh_mod.make_mesh(["cuda:0", "cuda:1"], (2, 1))
    except RuntimeError as e:
        if "cuda:0" not in str(e) or "cuda:1" not in str(e):
            raise
        print(f"[multicard placement] a pair without peer access raises: "
              f"{e}")
    else:
        raise AssertionError("a mesh over cards without peer access was "
                             "built")
    finally:
        torch.cuda.can_device_access_peer = real


def multicard_k5(card=""):
    """K5 across four cards: the (2,2) mesh on ``cuda:0`` .. ``cuda:3``
    and the same mesh on ``cuda:0``, on identical blocks: every entry
    bit-equal to its plain version and to the ``ppermute`` refresh
    (:func:`k5_checks`, at the 512x512x50 loop's row sizes), and the four
    cards' refreshed fields to the one card's; launches per exchange: one
    per card (4), against 1 on one card.  Returns the launches of each
    exchange."""
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel.mesh import make_mesh

    devs = cards_for("k5 across cards", 4)
    if devs is None:
        return None
    nx, ny, _ = BIG_GRID
    one = make_mesh(["cuda:0"] * 4, (2, 2))
    launches, res = {}, {}
    for where, mesh in (("4 cards", make_mesh(devs, (2, 2))),
                        ("1 card", one)):
        def make(shape, seed, mesh=mesh):
            return {c: x.to(mesh.device(c))
                    for c, x in ring_blocks(one, shape, seed).items()}

        def counted(fn, *args, where=where, **kw):
            before = k5.LAUNCHES
            out = fn(*args, **kw)
            launches[f"{fn.__name__} {where}"] = k5.LAUNCHES - before
            return out

        res[where] = k5_checks(f"multicard k5 {where}", mesh, make,
                               (ny + 2) // 2, (nx + 2) // 2, counted)
    for name, g, w in zip("abc", res["4 cards"], res["1 card"]):
        blocks_different(f"multicard k5 refresh_multi {name} 4 cards vs 1 "
                         "card", {c: x.to("cuda:0") for c, x in g.items()}, w)
    print(f"[multicard k5] launches per exchange: {launches} (one per card)")
    cards = len(set(devs))
    want = {f"{fn} {where}": n for where, n in (("4 cards", cards),
                                               ("1 card", 1))
            for fn in ("rdma_rows", "remote_refresh_axis",
                       "remote_refresh_multi")}
    if launches != want:
        raise AssertionError(f"k5 launches {launches}, expected {want}")
    return launches


#: the coupled loop's configurations of the multi-card checks: (tag,
#: keywords, backends)
MULTICARD_LOOPS = (
    ("S=1", {}, MESH_BACKENDS),
    ("S=1 smdiv", dict(smdiv=SMDIV), MESH_BACKENDS),
    ("S=1 +w", dict(with_w=True), MESH_BACKENDS),
    ("S=2", dict(inner_steps=2), ("ppermute", "rdma_overlap")),
    ("S=4", dict(inner_steps=4), ("ppermute", "rdma_overlap")),
)
MULTICARD_MESHES = ((2, 1), (3, 1), (2, 2))


def multicard_loops(card="", grid=BIG_GRID, n=9):
    """Both loops on meshes over several cards at ``grid``: the coupled loop
    on (2,1), (3,1) and (2,2) over 2, 3 and 4 cards (one shard a card)
    under ``ppermute``, ``rdma`` and ``rdma_overlap`` at S=1 (plain, with
    ``smdiv``, with ``with_w``) and blocked S=2 and S=4 (``ppermute``,
    ``rdma_overlap``: ``rdma`` has no width-S exchange), ``n`` substeps;
    the mu/t loop (``ShardedAdvanceMuT``) at S=1 and S=8 (K2).  Every run
    bit-equal (``different=`` per field) to the same mesh on one card and
    to 1x1; K1, K3 and K5 launches as many as on one card but for K5, once
    per card per substep.  Returns the launches of each multi-card run."""
    import torch
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
    from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
    from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain,
    )

    case = case_at(grid, balanced=True)
    b = case.bounds
    prepared = {}

    def run(cls, devs, shape, with_w=False, **kw):
        mesh = make_mesh(devs, shape) if devs else None
        loop = cls(b.ide, b.jde, b.kdim, case.flags, device="cuda:0",
                   mesh=mesh, **({"with_w": True} if with_w else {}), **kw)
        key = (tuple(devs or ()), with_w)
        if key not in prepared:   # one layout of each kind on the cards
            for k in [k for k in prepared if k[0] == key[0]]:
                del prepared[k]
            prepared[key] = loop.prepare(case_to_domain(case,
                                                        with_w=with_w))
        k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = k5.LAUNCHES = 0
        out = loop(prepared[key], case.rdx, case.rdy, case.dts, case.epssm)
        torch.cuda.synchronize()
        return out, {"k1": k1.LAUNCHES, "k2": k2.LAUNCHES, "k3": k3.LAUNCHES,
                     "k5": k5.LAUNCHES}

    mut = {"mu/t S=1": dict(n_steps=n), "mu/t S=8": dict(n_steps=n,
                                                         inner_steps=8)}
    meshes = [(shape, cards_for(f"the loops on {shape[0]}x{shape[1]} over "
                                f"{shape[0] * shape[1]} cards",
                                shape[0] * shape[1]))
              for shape in MULTICARD_MESHES]
    out = {}
    if all(devs is None for _, devs in meshes):
        return out
    ref = {tag: run(SmallStepLoop, None, None, n_steps=n, **kw)[0]
           for tag, kw, _ in MULTICARD_LOOPS}
    ref.update({tag: run(ShardedAdvanceMuT, None, None, **kw)[0]
                for tag, kw in mut.items()})
    for shape, devs in meshes:
        if devs is None:
            continue
        shards = shape[0] * shape[1]
        for tag, kw, backends in MULTICARD_LOOPS:
            one, one_n = run(SmallStepLoop, ["cuda:0"] * shards, shape,
                             n_steps=n, **kw)
            for backend in backends:
                got, counts = run(SmallStepLoop, devs, shape, n_steps=n,
                                  halo_backend=backend, **kw)
                name = f"{shape[0]}x{shape[1]} {backend} {tag}"
                want = dict(one_n, k5=(n * len(set(devs))
                                       if backend == "rdma" else 0))
                print(f"[multicard loop {name}] launches {counts} (one card, "
                      f"ppermute: {one_n})")
                if counts != want:
                    raise AssertionError(f"multicard {name}: launches "
                                         f"{counts}, expected {want}")
                check_state(f"multicard loop {name} vs one card", got, one,
                            bit_exact=True)
                check_state(f"multicard loop {name} vs 1x1", got, ref[tag],
                            bit_exact=True)
                out[name] = counts
            del one
        for tag, kw in mut.items():
            one, one_n = run(ShardedAdvanceMuT, ["cuda:0"] * shards, shape,
                             **kw)
            got, counts = run(ShardedAdvanceMuT, devs, shape, **kw)
            name = f"{shape[0]}x{shape[1]} {tag}"
            print(f"[multicard loop {name}] launches {counts}")
            if counts != one_n:
                raise AssertionError(f"multicard {name}: launches {counts}, "
                                     f"one card {one_n}")
            check_state(f"multicard loop {name} vs one card", got, one,
                        bit_exact=True)
            check_state(f"multicard loop {name} vs 1x1", got, ref[tag],
                        bit_exact=True)
            out[name] = counts
    return out


def multicard_run_sim(tmp: Path, fx: Path):
    """The main path over four cards: ``run_sim --mesh 2x2`` (3 large steps
    at 512x512x50) under each backend bit-equal to 1x1, K1 84 launches and
    K5 84 under ``rdma`` (one per card per substep); ``run_sim --closure
    nudge --steps 10 --steps-per-sync 10 --mesh 2x2 --halo-backend
    rdma_overlap`` bit-equal to the 1x1 run in one chunk.  Returns the
    launches and ms per large step of each run."""
    if cards_for("run_sim --mesh 2x2 over four cards", 4) is None:
        return None
    res = {}
    _, ref = run_sim_launches(tmp, fx, "mc_1x1")[1:]
    for backend in MESH_BACKENDS:
        launches, step_ms, got = run_sim_launches(
            tmp, fx, f"mc_2x2_{backend}", "--mesh", "2x2", "--halo-backend",
            backend)
        want = {"k1": 84, "k3": 0, "k4": 0,
                "k5": 21 * cards_2x2() if backend == "rdma" else 0}
        if launches != want:
            raise AssertionError(f"run_sim --mesh 2x2 {backend} on four "
                                 f"cards launched {launches}, expected {want}")
        check_state(f"multicard run_sim --mesh 2x2 --halo-backend {backend} "
                    "vs 1x1, step 3", got, ref, bit_exact=True)
        res[backend] = launches, step_ms
    nudge = ("--closure", "nudge", "--steps-per-sync", "10")
    _, _, ref = run_sim_text(tmp, fx, "mc_closed_1x1", *nudge, steps=10,
                             echo=False)
    launches, text, got = run_sim_text(
        tmp, fx, "mc_closed_2x2", *nudge, "--mesh", "2x2", "--halo-backend",
        "rdma_overlap", steps=10, echo=False)
    if launches != {"k1": 280, "k3": 0, "k4": 0, "k5": 0}:
        raise AssertionError(f"closed run on four cards launched {launches}")
    check_state("multicard run_sim --closure nudge --steps-per-sync 10 "
                "--mesh 2x2 --halo-backend rdma_overlap vs 1x1, step 10",
                got, ref, bit_exact=True)
    res["closed rdma_overlap"] = launches, chunk_ms(text)
    print(f"[multicard run_sim] ms per large step (steps 1-3): " + "; ".join(
        f"{k} {', '.join(f'{x:.2f}' for x in v[1])}"
        for k, v in res.items()))
    return res


def multicard_reference(card=""):
    """The reference's own decomposition: the mu/t loop
    (``ShardedAdvanceMuT``, S=1, ``vary_winds``) on a (3,1) mesh over three
    cards at 74x61x32, ms per substep (two counts, host clock and CUDA
    events on cuda:0), beside the same mesh on one card and 1x1.  Returns
    ``{row: (host_ms, events_ms)}``."""
    devs = cards_for("the (3,1) reference decomposition over three cards",
                     3)
    if devs is None:
        return None
    case = case_at(REF_GRID, balanced=True)
    out = {}
    for tag, kw in (("3x1 over 3 cards", dict(mesh_shape=(3, 1),
                                              devices=devs)),
                    ("3x1 on one card", dict(mesh_shape=(3, 1))),
                    ("1x1", {})):
        out[tag] = loop_marginal_ms(case, (65, 257), **kw)
    print("[multicard reference] mu/t loop S=1 at 74x61x32, ms per substep, "
          "host clock (CUDA events): " + ", ".join(
              f"{k} {h:.4f} ({e:.4f})" for k, (h, e) in out.items())
          + f"; BASELINE.md: 0.051 on 3x GTX-680 ({card})")
    return out


def multicard_profile(card="", counts=(9, 33)):
    """``torch.profiler`` over the damped coupled loop (``smdiv``) at
    512x512x50 on the (2,2) mesh over four cards, per backend, at two step
    counts: per substep (the difference of the two traces over the
    difference of the counts) the host span and, for every card, its busy
    device ms, K1's launches and us, K5's launches and us and the copy
    kernels'.  Returns the rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.mesh import make_mesh
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    devs = cards_for("the profile over four cards", 4)
    if devs is None:
        return None
    case = case_at(BIG_GRID, balanced=True)
    b = case.bounds
    kinds = {"k1": ("advance_mu_t_kernel",), "k5": ("put_kernel",),
             "copy": ("copy", "Memcpy")}
    mesh = make_mesh(devs, (2, 2))
    arrays = None

    def trace(backend, n):
        nonlocal arrays
        loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=n,
                             device="cuda:0", mesh=mesh,
                             halo_backend=backend, smdiv=SMDIV)
        if arrays is None:
            arrays = loop.prepare(case_to_domain(case))
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
            for d in devs:
                torch.cuda.synchronize(d)
            span = (time.perf_counter() - t0) * 1e3
        row = {"span_ms": span}
        for d in range(len(devs)):
            row[d, "busy_ms"] = 0.0
            for k in kinds:
                row[d, k + "_n"], row[d, k + "_ms"] = 0, 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            d, ms = e.device_index, e.time_range.elapsed_us() / 1e3
            if (d, "busy_ms") not in row:
                continue
            row[d, "busy_ms"] += ms
            for k, words in kinds.items():
                if any(w in e.name for w in words):
                    row[d, k + "_n"] += 1
                    row[d, k + "_ms"] += ms
                    break
        if not sum(row[d, "busy_ms"] for d in range(len(devs))) > 0:
            raise AssertionError("torch.profiler traced no device time")
        return row

    n1, n2 = counts
    out = {}
    for backend in MESH_BACKENDS:
        lo, hi = trace(backend, n1), trace(backend, n2)
        r = {k: (hi[k] - lo[k]) / (n2 - n1) for k in lo}
        out[backend] = r
        for d in range(len(devs)):
            for k in ("k1", "k5"):
                r[d, k + "_us_each"] = (1e3 * r[d, k + "_ms"] / r[d, k + "_n"]
                                        if r[d, k + "_n"] else 0.0)
        print(f"[multicard profile smdiv 2x2 {backend}] per substep "
              f"(n={n1}/{n2}), four cards: host span {r['span_ms']:.4f} ms "
              "under the profiler; " + "; ".join(
                  f"cuda:{d} busy {r[d, 'busy_ms']:.4f} ms "
                  f"({100 * r[d, 'busy_ms'] / r['span_ms']:.1f} %), K1 "
                  f"{r[d, 'k1_n']:.2f} x {r[d, 'k1_us_each']:.1f} us, K5 "
                  f"{r[d, 'k5_n']:.2f} x {r[d, 'k5_us_each']:.2f} us, copies "
                  f"{r[d, 'copy_n']:.2f}, {r[d, 'copy_ms']:.4f} ms"
                  for d in range(len(devs))) + f" ({card})")
    return out


def phase_multicard(tmp: Path, fx: Path, card=""):
    """The mesh over several cards in one process (shard s on ``cuda:s``):
    placement, K5 across cards, both loops on (2,1), (3,1) and (2,2) under
    every backend, ``run_sim --mesh 2x2`` and its closed run, the
    reference's (3,1) decomposition and a profile of the damped (2,2)
    substep over four cards.  A check that needs more cards than are
    visible prints ``[multicard] not run: N CUDA device(s) visible`` and
    is not passed.  Returns the readings (None where not run)."""
    return {"placement": timed("multicard placement", multicard_placement,
                               card=card),
            "k5": timed("multicard k5", multicard_k5, card=card),
            "loops": timed("multicard loops", multicard_loops, card=card),
            "run_sim": timed("multicard run_sim", multicard_run_sim, tmp,
                             fx),
            "reference": timed("multicard reference", multicard_reference,
                               card=card),
            "profile": timed("multicard profile", multicard_profile,
                             card=card)}


#: the H100 SXM's data-sheet peaks the bounds are taken against: device
#: memory bytes/s and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(nbytes, ops):
    """The least ms the card could take: the larger of the compulsory bytes
    (each input read once, each output written once) over the memory rate
    and the operations over the float32 rate; and which of the two."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_bounds():
    """``{row: (bound_ms, bound_by)}`` for the rows of the kernels
    line, per launch (K1) or per substep (K2-K4), at the big grid's padded
    block (ring-S arrays for K3/K4).  The streams each kernel form moves
    and its operations per cell are ``wrf_tpu_torch/utils/traffic.py``'s;
    the bound counts each stream once, with no tile term."""
    from wrf_tpu_torch.utils.traffic import (
        OPS_PER_CELL, padded_block, stream_bytes,
    )

    nx, ny, K = BIG_GRID
    blk = padded_block(nx, ny, K)
    cells = blk[0] * blk[1] * blk[2]
    out = {}
    for w in (False, True):
        tag = "+w" if w else ""
        ops = OPS_PER_CELL["k1"] + (OPS_PER_CELL["w"] if w else 0)
        out["k1" + tag] = bound_ms(stream_bytes("k1 scan", blk, with_w=w),
                                   ops * cells)
        if not w:
            out["k1 smdiv"] = bound_ms(stream_bytes("k1 smdiv", blk),
                                       (ops + 1) * cells)
            out["k1 full"] = bound_ms(stream_bytes("k1 full", blk),
                                      ops * cells)
            out["k1 capture"] = bound_ms(stream_bytes("k1 capture", blk),
                                         ops * cells)
        for S in (2, 4, 8):
            ring = padded_block(nx, ny, K, S)
            nb = stream_bytes("k3", ring, with_w=w) / S
            out[f"k3 S={S}{tag}"] = bound_ms(
                nb, ops * ring[0] * ring[1] * ring[2])
    out["k2 S=8"] = bound_ms(stream_bytes("k2", blk) / 8,
                             OPS_PER_CELL["k2"] * cells)
    # the fast form at S=32: the same passes per launch, 1/32 per substep
    out["k2 fast S=32"] = bound_ms(stream_bytes("k2", blk) / 32,
                                   OPS_PER_CELL["k2 fast"] * cells / 32)
    # the mu/t loop's lean lite substep
    out["k1 lite_ws"] = bound_ms(stream_bytes("k1 lite", blk),
                                 OPS_PER_CELL["k2"] * cells)
    # bf16 constant streams: a narrow pass is half a float32 pass
    ops = OPS_PER_CELL["k1"]
    out["k1 bf16"] = bound_ms(stream_bytes("k1 scan", blk, bf16=True),
                              ops * cells)
    out["k1 lite_ws bf16"] = bound_ms(stream_bytes("k1 lite", blk,
                                                   bf16=True),
                                      OPS_PER_CELL["k2"] * cells)
    out["k2 S=8 bf16"] = bound_ms(stream_bytes("k2", blk, bf16=True) / 8,
                                  OPS_PER_CELL["k2"] * cells)
    for S in (2, 4, 8):
        ring = padded_block(nx, ny, K, S)
        out[f"k3 S={S} bf16"] = bound_ms(
            stream_bytes("k3", ring, bf16=True) / S,
            ops * ring[0] * ring[1] * ring[2])
    # one (2,2) shard's block, where the in-kernel exchange is timed: the
    # neighbours' rows are 2 (+2 under damping) more row reads, nothing
    # beside the block
    sh = ((ny + 2) // 2 + 2, K, (nx + 2) // 2 + 2)
    sh_cells = sh[0] * sh[1] * sh[2]
    out["k1 shard"] = bound_ms(stream_bytes("k1 scan", sh), ops * sh_cells)
    ring = (sh[0] + 2, K, sh[2] + 2)
    out["k3 S=2 shard"] = bound_ms(stream_bytes("k3", ring) / 2,
                                   ops * ring[0] * ring[1] * ring[2])
    return out


def k3_staged_bytes():
    """Prints K3's launch plan at the big grid's ring-S blocks, per depth,
    with and without fuse_w and bf16 constant streams, and the bytes the
    staged form reads into shared memory per launch (0 for the streaming
    form, which stages no 3-D operand), beside the byte bounds of
    kernel_bounds.  These are the plan's arithmetic, not measurements, so
    they stay off the ``kernels`` line."""
    from wrf_tpu_torch.ops.advance_mu_t_coupled_cuda import (
        plan, staged_bytes,
    )

    nx, ny, K = BIG_GRID
    nbytes, forms = {}, {}
    for S in (2, 4, 8):
        J2, I = ny + 4 + 2 * (S - 1), nx + 4
        for w in (False, True):
            for cb in (4, 2):
                row = f"S={S}{'+w' if w else ''}{' bf16' if cb == 2 else ''}"
                p = plan(S, K, w, cb, False, J2, I)
                nbytes[row] = staged_bytes(p, S, J2, K, I, cb)
                forms[row] = f"{p.form} {p.tile[0]}x{p.tile[1]}"
    print("[bounds] k3 staged bytes per launch (form, tile): " + ", ".join(
        f"{r} {n / 1e6:.1f} MB ({forms[r]})" for r, n in nbytes.items()))


def ipc_kernel_rows(ipc, multiprocess):
    """The ``kernels`` line's rows of the signalled put and the wait: their
    launches on the main path (rank 0 of the 4-process run, every program;
    each program and process count by path), their device time per launch
    in the loopback profile (the ``rdma`` form), the plain version's time
    per exchange (packing and scatter by indexing), the bound of the bytes
    one exchange moves (read once, written once), and ``torch.cat`` of the
    same rows (what the put packs) as the put's library yardstick."""
    def mean(xs):
        return sum(xs) / len(xs)

    by_path = {}
    for nproc in (2, 4):
        for rep in multiprocess[nproc]["ranks"]:
            for tag, r in rep["programs"].items():
                if r["launches"]["put"]:
                    by_path[f"{tag}, {nproc} processes, rank "
                            f"{rep['rank']}"] = {
                        k: r["launches"][k] for k in ("put", "wait")}
    rank0 = multiprocess[4]["ranks"][0]["programs"].values()
    bound = 2 * ipc["bytes"] / HBM_BYTES_PER_S * 1e3
    rows = []
    for kern, name, library in (("mailbox_put", "put", mean(ipc["ms"]["cat"])),
                                ("mailbox_wait", "wait", None)):
        rows.append({
            "name": {"put": "halo_ipc signalled put",
                     "wait": "halo_ipc wait"}[name],
            "route": "cuda",
            "source": "wrf_tpu_torch/csrc/halo_ipc.cu",
            "replaces": "wrf_tpu/parallel/halo.py:156",
            "launches": sum(r["launches"][name] for r in rank0),
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            "max_abs_err": 0.0,
            # device ms per launch in the loopback profile, rdma form
            # (the overlap form's wait copies nothing: overlap_ms)
            "ms": ipc["device_us"]["rdma", kern] / 1e3,
            "overlap_ms": ipc["device_us"]["overlap", kern] / 1e3,
            # the plain version of one loopback exchange (events)
            "plain_ms": mean(ipc["ms"]["rdma plain"]),
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": library,
            "bytes_per_exchange": ipc["bytes"],
            # the whole loopback exchange through the wrapper, put and wait
            "exchange_ms": mean(ipc["ms"]["rdma"]),
            "exchange_host_ms": mean(ipc["host_ms"]["rdma"]),
        })
    return rows


def timed(name, fn, *args, **kw):
    """``fn(*args, **kw)``, printing its wall time (host clock) as
    ``[time] name: N s``: where the script's run time goes."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    import torch

    name, smi = phase_env()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import wrf_tpu_torch  # noqa: F401  (fails outside the repository)
    from wrf_tpu_torch.io import fixtures

    timed("build", phase_build)
    k1_abs, k1_times = timed("k1 vs plain", phase_kernel_vs_plain, card=smi)
    _, k1w_times = timed("k1+w vs plain", phase_kernel_vs_plain, card=smi,
                         time_grids=(BIG_GRID,), with_w=True)
    k1d_times = timed("k1 smdiv vs plain", phase_k1_damping, card=smi)
    k1c_times = timed("k1 capture vs plain", phase_k1_capture, card=smi)
    k2_abs, k2_times = timed("k2 vs plain", phase_k2_vs_plain, card=smi)
    timed("k2 vs k1", phase_k2_vs_k1)
    k3_abs, k3_times = timed("k3 vs plain", phase_k3_vs_plain, card=smi)
    k3w_abs, k3w_times = timed("k3+w vs plain", phase_k3_vs_plain, card=smi,
                               with_w=True)
    k3_vs_k1 = timed("k3 vs k1", phase_k3_vs_k1, card=smi)
    print(f"[k3 vs k1] different= counts: {k3_vs_k1['different']}")
    k3w_vs_k1w = timed("k3+w vs k1+w", phase_k3_vs_k1, with_w=True,
                       card=smi)
    print(f"[k3+w vs k1+w] different= counts: {k3w_vs_k1w['different']}")
    k1o_times = timed("k1 overlap", phase_k1_overlap, card=smi)
    k3o_times = timed("k3 overlap", phase_k3_overlap, card=smi)
    bf16_times = timed("bf16 constant streams", phase_bf16, card=smi)
    k6, k6_launches = timed("copy ceiling", phase_copy_ceiling, card=smi)
    k7, k7_launches = timed("k7 probe_2d", phase_k7, card=smi)
    k8, k8_launches = timed("k8 probe_2d_bisect", phase_k8, card=smi)
    k5_times, k5_host, k5_bytes = timed("k5 vs plain", phase_k5_vs_plain,
                                        card=smi)
    ipc = timed("ipc kernels vs plain", phase_ipc_vs_plain, card=smi)
    k5_loop_launches, ov_launches = timed("mesh loops", phase_mesh_loops)
    timed("pad memo", phase_pad_memo)
    timed("lean cache", phase_lean_cache)
    _, k1_shard = timed("k1 at a 2x2 shard's block", phase_kernel_vs_plain,
                        cases=((SHARD_GRID, "specified"),),
                        time_grids=(SHARD_GRID,), card=smi)
    big_steps = 17
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        timed("golden file", phase_golden_file, tmp)
        # the repo's long-horizon fixture (balanced, calm): the degenerate
        # stage-snapshot shell run_sim drives amplifies the state ~5e4x
        # per large step, and the noise fixture overflows by step 3.  Its
        # goldens are the oracle's 17 small steps, for the driver.
        fx_big = timed("big fixture", fixtures.write_case,
                       case_at(BIG_GRID, balanced=True), tmp / "big",
                       steps=big_steps)
        sim = timed("run_sim slice", phase_slice, tmp, fx_big)
        closure = timed("closure", phase_closure, tmp, fx_big, card=smi)
        drv = timed("driver", phase_driver, tmp, fx_big, big_steps)
        timed("driver --dump-intermediates and the native executable",
              phase_capture_driver, tmp)
        multicard = timed("multicard", phase_multicard, tmp, fx_big,
                          card=smi)
    loops, loops_ev = timed("loop timings", phase_loop_timings, card=smi)
    profile = timed("profile of the damped 2x2 loop", phase_mesh_profile,
                    card=smi)
    multiprocess = timed("loops across processes", phase_multiprocess,
                         card=smi)
    halo_rows = timed("halo overhead", phase_halo_overhead, card=smi)
    weak = timed("weak scaling", phase_weak_scaling, card=smi)
    borrowed = [m for m in sys.modules
                if m == "jax" or m == "wrf_tpu" or m.startswith("wrf_tpu.")]
    if borrowed:
        raise AssertionError(f"jax or the JAX package was imported: "
                             f"{borrowed}")

    def mean(xs):
        return sum(xs) / len(xs)

    def ms_of(times, mode):
        return {k: mean(v) for k, v in times[mode].items()}

    def pair(times, mode):
        return {"ms": ms_of(times, mode)["cuda"],
                "plain_ms": ms_of(times, mode)["plain"]}

    bounds = kernel_bounds()
    k3_staged_bytes()
    port_shape = (BIG_GRID[1] + 4, BIG_GRID[2], BIG_GRID[0] + 4)
    ceil = k6[port_shape]
    k6_ms = ceil["nbytes"] / (ceil["rates"]["ab"] * 1e9) * 1e3
    # the ceiling to quote: the largest shape cannot sit in the 50 MB L2
    big_copy = max(k6, key=lambda sh: sh[0] * sh[1] * sh[2])
    print(f"[bounds] data sheet {HBM_BYTES_PER_S / 1e12:.2f} TB/s; measured "
          f"copy ceiling {k6[big_copy]['ceiling']:.1f} GB/s "
          f"({k6[big_copy]['probe']} at {big_copy}); ms at the data sheet: "
          + ", ".join(f"{k} {v[0]:.4f} ({v[1]})" for k, v in bounds.items()))
    print(f"[loops +w] marginal ms per substep: "
          + ", ".join(f"{k.split('50 ')[1]} {v:.4f}" for k, v in loops.items()
                      if "+w" in k))

    print("[loops mesh] marginal ms per substep, host clock (CUDA events) "
          f"(1x1: {loops['coupled 512x512x50 S=1']:.4f}): "
          + ", ".join(f"{k.split('50 ')[1]} {v:.4f} ({loops_ev[k]:.4f})"
                      for k, v in loops.items()
                      if "mesh" in k and "smdiv" not in k) + f" ({smi})")
    shard_ms = mean(k1_shard[SHARD_GRID, "scan"]["cuda"])
    print(f"[loops mesh] K1 fused scan substep on one 2x2 shard's block "
          f"(259x50x259): {shard_ms:.4f} ms per launch, {4 * shard_ms:.4f} "
          f"for the four; on the whole 516x50x516 "
          f"{mean(k1_times[BIG_GRID, 'scan']['cuda']):.4f} ({smi})")
    print("[loops smdiv] marginal ms per substep with divergence damping, "
          "host clock (CUDA events; host clock without): " + ", ".join(
              f"{k.split('50 ')[1]} {v:.4f} ({loops_ev[k]:.4f}; "
              f"{loops[k.replace(' smdiv', '')]:.4f})"
              for k, v in loops.items() if "smdiv" in k) + f" ({smi})")
    print("[loops bf16] marginal ms per substep with bf16 constant streams "
          "(float32): " + ", ".join(
              f"{k} {v:.4f} ({loops[k.replace(' bf16', '')]:.4f})"
              for k, v in loops.items() if "bf16" in k) + f" ({smi})")
    print(f"[closure] 100 closed large steps at {BIG_GRID}: drift "
          f"{closure['drift']:.3e}; ms per large step host-stepped "
          f"{closure['host_ms']:.3f}, device-resident (10 a chunk) "
          f"{closure['chunk_ms']:.3f}; 10 closed steps vs the oracle at "
          f"{REF_GRID}: worst scaled error {closure['oracle_worst']:.3f} of 1; "
          f"host syncs left in a chunk: "
          + ", ".join(f"{k} {'none' if v is None else 'yes'}"
                      for k, v in closure["sync"].items()) + f" ({smi})")
    print("[closure profile] " + json.dumps(closure["profile"]))
    runs = [("every shard on cuda:0, gloo staged through host memory",
             multiprocess, (2, 4))]
    if multiprocess["nccl"] is not None:
        runs.append(("four cards, NCCL, one rank a card",
                     multiprocess["nccl"], (4,)))
    for where, mp, counts in runs:
        for tag in ("rk3", "rk3 rdma_overlap"):
            mp_steps = {"1 process": mp["reference"][tag]["step_ms"]}
            for nproc in counts:
                for rep in mp[nproc]["ranks"]:
                    mp_steps[f"{nproc} processes rank {rep['rank']}"] = \
                        rep["programs"][tag]["step_ms"]
            print(f"[multiprocess] {tag}: ms per closed large step at "
                  f"{BIG_GRID} on the (2,2) mesh, {where} (steps 1-3): "
                  + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                              for k, v in mp_steps.items()) + f" ({smi})")
    for run in ("S=1", "2x2 ppermute", "2x2 rdma", "2x2 overlap", "S=2",
                "S=2 2x2 overlap", "smdiv", "smdiv 2x2 rdma",
                "smdiv 2x2 overlap", "bf16", "bf16 2x2 overlap"):
        print(f"[slice] run_sim {run}: step 3 alone {sim[run][1][2]:.3f} ms "
              f"({smi})")

    for grid, rows in halo_rows.items():
        print(f"[halo overhead] {'x'.join(map(str, grid))}, us per substep "
              "over the baseline: " + ", ".join(
                  f"{k} {us:.1f}" for k, (_, us) in rows.items())
              + f" ({smi})")
    for (tile, S, backend), rec in weak.items():
        print(f"[weak scaling] tile {tile} S={S} {backend}: " + ", ".join(
            f"{r['n_devices']} card(s) {r['ms_per_substep']:.4f} ms "
            f"(efficiency {r['efficiency']})" for r in rec["ladder"])
            + f"; pass_80pct {rec['pass_80pct']} ({smi})")
    mc_sim = multicard["run_sim"]
    mc_prof = multicard["profile"]

    def per_card(kind):
        """A kernel's launches and us per substep on each of the four cards
        in the profile of the damped (2,2) loop (None: not run)."""
        if mc_prof is None:
            return None
        return {backend: {f"cuda:{d}": {
            "launches": r[d, kind + "_n"], "us_each": r[d, kind + "_us_each"]}
            for d in range(4)} for backend, r in mc_prof.items()}

    print(smi)   # again, close to the end: the log is long
    print(json.dumps({"kernels": [{
        "name": "advance_mu_t_fused",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t_kernel.cuh",
        "replaces": "wrf_tpu/ops/advance_mu_t_pallas.py:114",
        "launches": sim["S=1"][0]["k1"],
        "launches_by_path": {
            "run_sim": sim["S=1"][0]["k1"],
            "run_sim --inner-steps 2": sim["S=2"][0]["k1"],
            "run_sim --with-w": sim["S=1 +w"][0]["k1"],
            "run_sim --with-w --inner-steps 2": sim["S=2 +w"][0]["k1"],
            "run_sim --mesh 2x2 --halo-backend rdma": sim["2x2 rdma"][0]["k1"],
            "run_sim --mesh 2x2 --halo-backend rdma_overlap":
                sim["2x2 overlap"][0]["k1"],
            "run_sim --mesh 2x2 --halo-backend rdma_overlap --inner-steps 2":
                sim["S=2 2x2 overlap"][0]["k1"],
            "run_sim --namelist (smdiv 0.1) --mesh 2x2 --halo-backend "
            "rdma_overlap": sim["smdiv 2x2 overlap"][0]["k1"],
            "run_sim --precision bf16-const": sim["bf16"][0]["k1"],
            "run_sim --precision bf16-const --mesh 2x2 --halo-backend "
            "rdma_overlap": sim["bf16 2x2 overlap"][0]["k1"],
            "SmallStepLoop 2x2 rdma_overlap, 5 substeps":
                ov_launches[(2, 2), "S=1"]["k1"],
            "run_sim --namelist (smdiv 0.1)": sim["smdiv"][0]["k1"],
            "run_sim --closure nudge --steps 100":
                closure["launches"]["closed"]["k1"],
            "run_sim --closure nudge --steps 100 --steps-per-sync 10":
                closure["launches"]["chunks"]["k1"],
            "run_sim --closure nudge --mesh 2x2 --halo-backend rdma_overlap, "
            "10 steps": closure["launches"]["2x2 rdma_overlap"]["k1"],
            "run_sim --namelist (smdiv 0.1) --mesh 2x2 --halo-backend rdma":
                sim["smdiv 2x2 rdma"][0]["k1"],
            "driver sharded-cuda S=8": drv["mu/t"]["k1"],
            "driver coupled S=4": drv["coupled"]["k1"],
            "driver coupled S=4 --with-w": drv["coupled +w"]["k1"]},
        "max_abs_err": k1_abs,
        # the (2,2) mesh over four cards, one shard a card (None where
        # fewer cards are visible): run_sim's launches and the profile
        "multicard": None if mc_sim is None else {
            "launches_by_path": {
                f"run_sim --mesh 2x2 --halo-backend {b}, four cards":
                    mc_sim[b][0]["k1"] for b in MESH_BACKENDS},
            "profile_smdiv_2x2_per_card": per_card("k1")},
        # ms per launch at 516x50x516: run_sim's fused scan substep
        "ms": mean(k1_times[BIG_GRID, "scan"]["cuda"]),
        "plain_ms": mean(k1_times[BIG_GRID, "scan"]["plain"]),
        "bound_ms": bounds["k1"][0], "bound_by": bounds["k1"][1],
        "library_ms": None,
        # the same substep with the w/pp solve (bit-equal to its plain
        # version in every mode, so its error is 0)
        "fuse_w": {**pair(k1w_times, (BIG_GRID, "scan")), "max_abs_err": 0.0,
                   "bound_ms": bounds["k1+w"][0],
                   "bound_by": bounds["k1+w"][1],
                   "ms_by_mode": {m: ms_of(k1w_times, (BIG_GRID, m))
                                  for m in W_MODES}},
        # the fused scan substep with divergence damping (mudf_in), beside
        # the same call without, timed in one order; bit-equal to its
        # plain version
        "smdiv": {"launches": sim["smdiv"][0]["k1"],
                  "ms": mean(k1d_times["scan"]["damped"]),
                  "undamped_ms": mean(k1d_times["scan"]["undamped"]),
                  "plain_ms": mean(k1d_times["scan"]["plain"]),
                  "max_abs_err": 0.0,
                  "bound_ms": bounds["k1 smdiv"][0],
                  "bound_by": bounds["k1 smdiv"][1]},
        # the reference's plain full call with the five phase-A captures,
        # beside the same call without; the driver's cuda tier launches it
        # once per --dump-intermediates run (and once in its warm-up)
        "capture": {"ms": mean(k1c_times["full"]["with"]),
                    "without_ms": mean(k1c_times["full"]["without"]),
                    "plain_ms": mean(k1c_times["full"]["plain"]),
                    "max_abs_err": 0.0,
                    "bound_ms": bounds["k1 capture"][0],
                    "bound_by": bounds["k1 capture"][1],
                    "without_bound_ms": bounds["k1 full"][0]},
        # the j exchange inside the kernel: the fused scan substep on one
        # (2,2) shard's block, its edge rows reading the neighbours' rows,
        # beside the same launch on refreshed halos; bit-equal to its plain
        # version and to that launch
        "overlap": {"launches": sim["2x2 overlap"][0]["k1"],
                    "ms": mean(k1o_times["scan"]["with"]),
                    "without_ms": mean(k1o_times["scan"]["without"]),
                    "plain_ms": mean(k1o_times["scan"]["plain"]),
                    "smdiv_ms": mean(k1o_times["smdiv"]["with"]),
                    "smdiv_without_ms": mean(k1o_times["smdiv"]["without"]),
                    "max_abs_err": 0.0,
                    "bound_ms": bounds["k1 shard"][0],
                    "bound_by": bounds["k1 shard"][1]},
        # bf16 constant streams, beside the float32 form in one order;
        # bit-equal to the plain version and to the float32 kernel on the
        # rounded inputs
        "bf16": {"launches": sim["bf16"][0]["k1"],
                 "max_abs_err": 0.0,
                 "ms_by_mode": {m: ms_of(bf16_times, f"k1 {m}")
                                for m in ("scan", "lite_ws", "final")},
                 "fuse_w_ms_by_mode": {m: ms_of(bf16_times, f"k1+w {m}")
                                       for m in ("scan", "final")},
                 "bound_ms": bounds["k1 bf16"][0],
                 "bound_by": bounds["k1 bf16"][1],
                 "lite_ws_bound_ms": bounds["k1 lite_ws bf16"][0],
                 "lite_ws_float32_bound_ms": bounds["k1 lite_ws"][0]},
    }, {
        "name": "advance_mu_t_multistep",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t_msteps.cu",
        "replaces": "wrf_tpu/ops/advance_mu_t_msteps.py:391",
        "launches": drv["mu/t"]["k2"],
        "launches_by_path": {"driver sharded-cuda S=8": drv["mu/t"]["k2"]},
        "max_abs_err": k2_abs,
        # ms per substep at 516x50x516, exact S=8
        "ms": mean(k2_times["exact S=8"]["cuda"]),
        "plain_ms": mean(k2_times["exact S=8"]["plain"]),
        "bound_ms": bounds["k2 S=8"][0], "bound_by": bounds["k2 S=8"][1],
        "library_ms": None,
        "bf16": {**ms_of(bf16_times, "k2 exact S=8"), "max_abs_err": 0.0,
                 "bound_ms": bounds["k2 S=8 bf16"][0],
                 "bound_by": bounds["k2 S=8 bf16"][1]},
        # the closed form at S=32, ms per substep
        "fast": {**pair(k2_times, "fast S=32"),
                 "bound_ms": bounds["k2 fast S=32"][0],
                 "bound_by": bounds["k2 fast S=32"][1]},
    }, {
        "name": "coupled_multistep",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t_coupled_kernel.cuh",
        "replaces": "wrf_tpu/ops/advance_mu_t_msteps.py:1273",
        "launches": sim["S=2"][0]["k3"],
        "launches_by_path": {
            "run_sim --inner-steps 2": sim["S=2"][0]["k3"],
            "run_sim --inner-steps 2 --fast": sim["S=2 fast"][0]["k3"],
            "run_sim --with-w --inner-steps 2": sim["S=2 +w"][0]["k3"],
            "run_sim --mesh 2x2 --halo-backend rdma_overlap --inner-steps 2":
                sim["S=2 2x2 overlap"][0]["k3"],
            "SmallStepLoop 2x2 rdma_overlap S=2, 5 substeps":
                ov_launches[(2, 2), "S=2"]["k3"],
            "driver coupled S=4": drv["coupled"]["k3"],
            "driver coupled S=4 --with-w": drv["coupled +w"]["k3"],
            "run_sim --closure nudge --inner-steps 2 --profile, 3 steps":
                closure["launches"]["profile S=2"]["k3"]},
        "max_abs_err": k3_abs["k3"],
        # the blocked loops over several cards (None where fewer cards are
        # visible): K3 launches of the (2,2) mesh over four cards, 9
        # substeps, S=2 and S=4 under rdma_overlap
        "multicard": None if "2x2 rdma_overlap S=2" not in multicard[
            "loops"] else {
            "launches_by_path": {
                f"SmallStepLoop 2x2 rdma_overlap {S}, four cards":
                    multicard["loops"][f"2x2 rdma_overlap {S}"]["k3"]
                for S in ("S=2", "S=4")}},
        # ms per substep (per launch / S) at 512x512x50, exact S=2 (the
        # run_sim path's depth); every mode in ms_by_mode
        "ms": ms_of(k3_times, "exact S=2")["cuda"],
        "plain_ms": ms_of(k3_times, "exact S=2")["plain"],
        "bound_ms": bounds["k3 S=2"][0], "bound_by": bounds["k3 S=2"][1],
        "library_ms": None,
        "ms_by_mode": {m: ms_of(k3_times, m) for m in K3_MODES},
        "bound_ms_by_depth": {f"S={S}": bounds[f"k3 S={S}"][0]
                              for S in (2, 4, 8)},
        # exact S=4: one launch against four K1 fused-scan launches
        "different_vs_k1": k3_vs_k1["different"],
        "s4_launch_ms": mean(k3_vs_k1["k3_ms"]),
        "four_k1_launches_ms": mean(k3_vs_k1["k1_ms"]),
        "fuse_w": {**pair(k3w_times, "exact S=2"),
                   "max_abs_err": k3w_abs["k3"],
                   "bound_ms": bounds["k3 S=2+w"][0],
                   "bound_by": bounds["k3 S=2+w"][1],
                   "ms_by_mode": {m: ms_of(k3w_times, m) for m in K3_MODES},
                   "different_vs_k1": k3w_vs_k1w["different"],
                   "s4_launch_ms": mean(k3w_vs_k1w["k3_ms"]),
                   "four_k1_launches_ms": mean(k3w_vs_k1w["k1_ms"])},
        # the j leg of the width-S exchange inside the kernel: S=2 on one
        # (2,2) shard's ring-2 block, ms per substep
        "overlap": {"launches": sim["S=2 2x2 overlap"][0]["k3"],
                    "ms": mean(k3o_times["S=2"]["with"]),
                    "without_ms": mean(k3o_times["S=2"]["without"]),
                    "plain_ms": mean(k3o_times["S=2"]["plain"]),
                    "max_abs_err": 0.0,
                    "bound_ms": bounds["k3 S=2 shard"][0],
                    "bound_by": bounds["k3 S=2 shard"][1]},
        "bf16": {"max_abs_err": 0.0,
                 "ms_by_mode": {f"exact S={S}":
                                ms_of(bf16_times, f"k3 exact S={S}")
                                for S in (2, 4, 8)},
                 "bound_ms_by_depth": {f"S={S}": bounds[f"k3 S={S} bf16"][0]
                                       for S in (2, 4, 8)},
                 "bound_by": bounds["k3 S=2 bf16"][1]},
    }, {
        "name": "coupled_two_step",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/advance_mu_t_coupled_kernel.cuh",
        "replaces": "wrf_tpu/ops/advance_mu_t_msteps.py:818",
        # no loop of the port calls it: the loop runs K3 at every depth,
        # S=2 included (the same template instance), so this reads 0
        "on_main_path": False,
        "launches": sim["S=2"][0]["k4"],
        "launches_by_path": {
            "run_sim --inner-steps 2": sim["S=2"][0]["k4"],
            "run_sim --with-w --inner-steps 2": sim["S=2 +w"][0]["k4"]},
        "max_abs_err": k3_abs["k4"],
        # ms per substep at 512x512x50
        "ms": ms_of(k3_times, "k4 pair")["cuda"],
        "plain_ms": ms_of(k3_times, "k4 pair")["plain"],
        "bound_ms": bounds["k3 S=2"][0], "bound_by": bounds["k3 S=2"][1],
        "library_ms": None,
        "fuse_w": {**pair(k3w_times, "k4 pair"),
                   "max_abs_err": k3w_abs["k4"],
                   "bound_ms": bounds["k3 S=2+w"][0],
                   "bound_by": bounds["k3 S=2+w"][1]},
        "bf16": {**ms_of(bf16_times, "k3 k4 pair"), "max_abs_err": 0.0,
                 "bound_ms": bounds["k3 S=2 bf16"][0],
                 "bound_by": bounds["k3 S=2 bf16"][1]},
    }, {
        "name": "remote_refresh_multi",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/halo_rdma.cu",
        "replaces": "wrf_tpu/parallel/halo.py:156",
        # one launch per device per substep on the 2x2 mesh
        "launches": sim["2x2 rdma"][0]["k5"],
        "launches_by_path": {
            "run_sim --mesh 2x2 --halo-backend rdma": sim["2x2 rdma"][0]["k5"],
            "run_sim --namelist (smdiv 0.1) --mesh 2x2 --halo-backend rdma":
                sim["smdiv 2x2 rdma"][0]["k5"],
            "run_sim --closure nudge --mesh 2x2 --halo-backend rdma, "
            "10 steps": closure["launches"]["2x2 rdma"]["k5"],
            "SmallStepLoop 2x2 rdma, 5 substeps": k5_loop_launches,
            # under rdma_overlap the exchange is inside K1 and K3
            "run_sim --mesh 2x2 --halo-backend rdma_overlap":
                sim["2x2 overlap"][0]["k5"],
            "SmallStepLoop 2x2 rdma_overlap, 5 substeps":
                ov_launches[(2, 2), "S=1"]["k5"]},
        "max_abs_err": 0.0,
        # the (2,2) mesh over four cards, one launch per card per exchange
        # writing into the peers' blocks (None where fewer are visible)
        "multicard": None if mc_sim is None else {
            "launches_by_path": {
                "run_sim --mesh 2x2 --halo-backend rdma, four cards":
                    mc_sim["rdma"][0]["k5"]},
            "launches_per_exchange": multicard["k5"],
            "profile_smdiv_2x2_per_card": per_card("k5")},
        # marginal ms per launch, one 2x2 exchange (every shard's mu rows
        # both ways and v row up, at the 2x2 mesh's row size), between two
        # chains of exchanges through the wrapper, on CUDA events (host_ms:
        # the host clock's reading of the same chains): bound by the
        # launch and the host's work to submit it, not the bytes
        "ms": mean(k5_times["cuda"]),
        "host_ms": {k: mean(v) for k, v in k5_host.items()},
        # its device time per launch in the damped (2,2) loop's profile
        "profiled_device_us": profile[(2, 2), "rdma"]["k5_us_each"],
        "plain_ms": mean(k5_times["plain"]),
        "bound_ms": 2 * k5_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        # the ppermute refresh of the same fields: Tensor.copy_ per row
        "library_ms": mean(k5_times["library"]),
        # the launch alone, from a prebuilt plan (no per-call wrapper work)
        "prebuilt_plan_ms": mean(k5_times["bare"]),
        "bytes_per_launch": 2 * k5_bytes,
    }, *ipc_kernel_rows(ipc, multiprocess), {
        "name": "copy_probe",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/copy.cu",
        "replaces": "bench.py:195",
        # its main path is the ceiling measurement itself
        "launches": k6_launches,
        "launches_by_path": {"copy ceiling, 3 shapes x 3 probes":
                             k6_launches},
        "max_abs_err": 0.0,
        # ms per copy of one 516x50x516 array (the ab probe); its plain
        # version is Tensor.copy_, which is also the library call
        "ms": k6_ms,
        "plain_ms": ceil["library_ms"],
        "bound_ms": ceil["nbytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": ceil["library_ms"],
        "gbps_by_shape": {"x".join(map(str, sh)): {
            "ceiling": v["ceiling"], "probe": v["probe"], **v["rates"],
            "Tensor.copy_": v["library"]} for sh, v in k6.items()},
    }, {
        "name": "probe_2d",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/probe_2d.cu",
        # kernel_1d; kernel_2d is :58
        "replaces": "tools/probe_2d.py:54",
        # its main path is the probe's entry point (python -m
        # wrf_tpu_torch.tools.probe_2d --time, at the JAX defaults and at the
        # port's padded block); no loop of the port runs it
        "on_main_path": False,
        "launches": sum(k7_launches.values()),
        "launches_by_form": k7_launches,
        "max_abs_err": 0.0,
        # ms per call of the 1-D form at the JAX probe's 130x50x1664, tj 4;
        # no single PyTorch call computes the stencil plus doubling scan
        **{k: k7["130x50x1664", 4, "1d"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "ms_by_form": {f"{tag} tj {tj} {form}": {
            k: r[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                              "share") if k in r}
            for (tag, tj, form), r in k7.items()},
    }, {
        "name": "probe_2d_bisect",
        "route": "cuda",
        "source": "wrf_tpu_torch/csrc/probe_2d_bisect.cu",
        # rung_a; the other rungs are :59, :73, :90, :112, :144, :178,
        # :211, :239
        "replaces": "tools/probe_2d_bisect.py:45",
        # its main path is the probe's entry point, once per rung
        "on_main_path": False,
        "launches": sum(k8_launches.values()),
        "launches_by_rung": k8_launches,
        "max_abs_err": 0.0,
        # ms per call of rung d at 258x50x1280, tj 4, ti 128
        **{k: k8["d"][k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
        "library_ms": None,
        "ms_by_rung": {r: {k: v[k] for k in ("ms", "host_ms", "plain_ms",
                                             "bound_ms", "share")}
                       for r, v in k8.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
