"""Simulation driver: namelist-configured RK3 integration with checkpoints.

The port's counterpart of ``python -m wrf_tpu.run_sim``, with every one of
its options:

    python -m wrf_tpu_torch.run_sim FIXTURE_DIR [--steps N] [--namelist NML] \\
        [--diagnostics] [--checkpoint-dir CK --checkpoint-every N] [--resume] \\
        [--with-w] [--inner-steps S [--fast]] [--kernel cuda|eager] \\
        [--device cuda|cpu] [--precision f32|bf16-const] \\
        [--mesh JxI [--halo-backend ppermute|rdma|rdma_overlap]] \\
        [--closure none|nudge [--tau-steps T] [--rayleigh-uv R]] \\
        [--steps-per-sync K] [--profile DIR]

* the grid/state comes from a fixture directory
  (``wrf_tpu_torch.io.fixtures``);
* dynamics parameters come from the WRF namelist record (a JSON dict of
  record fields or a namelist.input text file), else from the fixture; a
  record's ``smdiv`` turns on divergence damping in every substep (not
  with ``--inner-steps`` > 1: the loop refuses it, as the JAX loop does);
* ``--kernel cuda`` (the default; ``pallas`` is accepted as its name) runs
  the fused kernels, ``--kernel eager`` (or ``xla``) three whole-array
  PyTorch calls per substep with no hand-written kernel;
* each large step is one RK3 triple over the acoustic loop, whose every
  substep is one launch of the fused CUDA kernel (K1), or, with
  ``--inner-steps S``, S scan substeps per launch of the coupled
  trapezoid (K3); ``--with-w`` adds the vertically-implicit w/pp substep
  to every substep, inside those kernels; the state stays on the device
  and one scalar checksum syncs each step;
* ``--closure nudge`` holds the ``*_1`` advecting fields at the base state
  and recomputes ``ft``/``mu_tend`` every large step as nudging
  tendencies toward the run's original state, with ``--rayleigh-uv``
  damping of the winds (``models/tendencies.py``): the long-horizon
  configuration.  ``--closure none`` (the default) is the degenerate
  stage-snapshot shell, which amplifies the state ~5e4x per large step
  and so holds only a bounded horizon;
* ``--steps-per-sync K`` runs K large steps per host synchronisation
  (``RK3Integrator.multi_step``): the per-step mass diagnostics are
  reduced on the device and read back once per chunk, and checkpoints
  land on chunk boundaries (when a chunk crosses a multiple of
  ``--checkpoint-every``, and at the end);
* ``--mesh JxI`` decomposes the domain over a mesh of ``J*I`` shards, which
  take the visible CUDA devices in order and wrap round when there are
  fewer (four shards may share one card; the banner line says how many
  shards sit on how many devices); ``--halo-backend rdma`` moves the
  per-substep j halos with the hand-written exchange kernel (K5) instead
  of copies between the blocks, and ``--halo-backend rdma_overlap`` puts
  that exchange inside the substep kernels (K1 and K3 read their ring
  neighbours' edge rows themselves: no K5 launch, no row copy);
* ``--precision bf16-const`` narrows the never-written 3-D bases (t_1, u_1,
  v_1, ww_1, ft and the lean constants) to bf16 in device memory; the
  kernels widen them on load and the state and outputs stay float32;
* checkpoints use the fixture binary format
  (``wrf_tpu_torch.io.checkpoint``) and ``--resume`` continues from the
  newest one; checkpoints hold global arrays, so a run on one mesh
  resumes on another; a resumed nudged run relaxes toward the original
  fixture state, as the uninterrupted run does;
* ``--profile DIR`` wraps the run in a ``torch.profiler`` trace
  (``utils/timing.py::trace``; the card's kernels where CUDA is
  available), written as ``DIR/trace_*.json``; each large step (chunk) is
  a span named ``run_sim step N`` (``run_sim steps A-B``) in it, with the
  program's own spans inside (``utils/timing.py::span``: ``wrf.rk3.step``,
  ``wrf.closure.tendency``, each stage's ``wrf.loop.pad``,
  ``wrf.loop.inputs`` and ``wrf.loop.substeps``, ``wrf.rk3.merge``,
  ``wrf.closure.damp``); without ``--profile`` no span is made.

``--device`` is explicit: ``cuda`` (the default) fails when there is no
GPU, and ``cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import GridConfigRecord, dynamics_params, read_namelist
from .convert import arrays_to_numpy
from .io import checkpoint, fixtures
from .models.rk3 import RK3Integrator
from .models.tendencies import NudgingTendencies
from .parallel.mesh import describe, mesh_from_spec
from .parallel.sharded import case_to_domain
from .utils.timing import span, trace

#: the evolved large-step state — RK3Integrator is the source of truth
_EVOLVED = RK3Integrator._EVOLVED

#: --kernel values and the loop kernel each selects; the JAX CLI's names
#: (pallas, xla) stand for their counterparts
_KERNELS = {"cuda": "cuda", "eager": "eager", "pallas": "cuda",
            "xla": "eager"}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("fixture_dir")
    p.add_argument("--namelist", default=None,
                   help="GridConfigRecord overrides: a JSON dict, or a "
                        "WRF Fortran namelist.input text file")
    p.add_argument("--steps", type=int, default=1, help="RK3 large steps")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' requires a GPU (no fallback)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--diagnostics", action="store_true",
                   help="print per-step total dry mass and its drift")
    p.add_argument("--inner-steps", type=int, default=1,
                   help="temporal blocking: S coupled substeps per K3 "
                        "launch (the depth-S trapezoid; a stage with fewer "
                        "than S+1 substeps runs K1 only)")
    p.add_argument("--with-w", action="store_true",
                   help="also advance the vertically-implicit w/pp substep "
                        "(advance_w) every acoustic substep")
    p.add_argument("--kernel", default="cuda", choices=list(_KERNELS),
                   help="cuda: the fused kernels (K1, K3); eager: three "
                        "whole-array PyTorch calls per substep; pallas and "
                        "xla are accepted as their names")
    p.add_argument("--fast", action="store_true",
                   help="with --inner-steps: K3's fast mode (re-associated "
                        "float32 ww scan; a tolerance, not bits)")
    p.add_argument("--mesh", default=None,
                   help="JxI mesh of shards (default: one shard on --device)")
    p.add_argument("--halo-backend", default="ppermute",
                   choices=["ppermute", "rdma", "rdma_overlap"],
                   help="per-substep halo exchange: copies between the "
                        "blocks, the hand-written exchange kernel (K5), or "
                        "the j exchange inside the substep kernels "
                        "(rdma_overlap: K1 and K3 read the neighbours' "
                        "edge rows themselves)")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16-const"],
                   help="bf16-const narrows the never-written 3-D bases "
                        "(t_1/u_1/v_1/ww_1/ft and the lean constants) to "
                        "bf16 in device memory; state and outputs stay "
                        "float32")
    p.add_argument("--closure", default="none", choices=["none", "nudge"],
                   help="slow-forcing closure: 'nudge' holds the *_1 "
                        "advecting fields at the base state and recomputes "
                        "ft/mu_tend as nudging tendencies every large step "
                        "(models/tendencies.py), required for long "
                        "horizons; 'none' is the degenerate shell "
                        "(bounded horizons only)")
    # the closure's two parameters, at the JAX CLI's types and defaults;
    # without --closure nudge they are ignored, as there
    p.add_argument("--tau-steps", type=float, default=5.0,
                   help="nudging relaxation time in large steps (>= 3; "
                        "--closure nudge)")
    p.add_argument("--rayleigh-uv", type=float, default=0.1,
                   help="per-step Rayleigh damping factor on the "
                        "perturbation winds (--closure nudge)")
    p.add_argument("--steps-per-sync", type=int, default=1, metavar="K",
                   help="large steps per host synchronisation "
                        "(RK3Integrator.multi_step): the per-step mass "
                        "diagnostics are reduced on the device and read "
                        "back once per K steps; checkpoints land on those "
                        "boundaries")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "into DIR")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_sim: --device cuda, but torch.cuda.is_available() "
                         "is False (no GPU; pass --device cpu for the plain "
                         "PyTorch path)")

    case, _ = fixtures.read_case(args.fixture_dir)
    if args.namelist:
        text = Path(args.namelist).read_text()
        if text.lstrip().startswith("{"):
            rec = GridConfigRecord(**json.loads(text))
        else:
            rec = read_namelist(text)
        dyn = dynamics_params(rec)
        flags = dyn["flags"]
    else:
        dyn = dict(rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                   epssm=case.epssm, smdiv=0.0, acoustic_steps=4,
                   flags=case.flags)
        flags = case.flags
    dt = dyn["dts"] * dyn["acoustic_steps"]

    mesh = mesh_from_spec(args.mesh, device) if args.mesh else None
    if mesh is not None:
        print(f"{describe(mesh)}, halo backend {args.halo_backend}",
              flush=True)
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    rk3 = RK3Integrator(nx, ny, nz, flags,
                        acoustic_steps=dyn["acoustic_steps"],
                        kernel=_KERNELS[args.kernel],
                        snapshot="base" if args.closure == "nudge"
                        else "stage", device=device,
                        inner_steps=args.inner_steps, fast=args.fast,
                        with_w=args.with_w, smdiv=dyn["smdiv"], mesh=mesh,
                        halo_backend=args.halo_backend,
                        const_dtype=(torch.bfloat16
                                     if args.precision == "bf16-const"
                                     else None))

    dom = {k: np.array(v, copy=True)
           for k, v in case_to_domain(case, with_w=args.with_w).items()}
    # the nudging closure relaxes toward the run's ORIGINAL state: keep it
    # before any checkpoint is folded in, or a resumed run would nudge
    # toward the interrupted state
    base = dict(dom)
    start_step = 0
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.resume:
        def _step_no(p):
            try:
                return int(p.name.removeprefix("step_"))
            except ValueError:
                return None  # stray entry, not one of ours

        cks = [(n, p) for p in Path(args.checkpoint_dir).glob("step_*")
               if (n := _step_no(p)) is not None]
        if cks:
            newest = max(cks)[1]
            state, start_step, _ = checkpoint.load_checkpoint(newest)
            print(f"resuming from {newest} (step {start_step})")
            expected = {n for n in _EVOLVED if n in dom}
            missing = expected - state.keys()
            extra = state.keys() - expected
            if missing or extra:
                # e.g. resuming a --with-w checkpoint without --with-w (or
                # vice versa): continuity would silently differ
                raise SystemExit(
                    f"checkpoint field set differs from the configured "
                    f"state (missing from checkpoint: {sorted(missing)}; "
                    f"not configured: {sorted(extra)}) — rerun with the "
                    f"matching --with-w setting")
            dom.update(state)

    b = case.bounds
    n_pts = (b.ide - b.ids) * (b.jde - b.jds) * b.kdim
    n_sub = sum(n for _, n in rk3.stages)

    # the state stays on the device across large steps; only a scalar
    # checksum syncs each step (full readback at checkpoints only)
    arrays = rk3.prepare(dom)
    tendency_fn = None
    if args.closure == "nudge":
        # a resumed run rebuilds the reference from the original state
        # through prepare (continuity with the uninterrupted run)
        tendency_fn = NudgingTendencies(
            rk3.prepare(base) if start_step else arrays, dt,
            tau_steps=args.tau_steps, rayleigh_uv=args.rayleigh_uv)

    def save(step, arrays):
        state = arrays_to_numpy(rk3.unprepare(
            arrays, [n for n in _EVOLVED if n in arrays]))
        d = checkpoint.save_checkpoint(
            f"{args.checkpoint_dir}/step_{step:06d}", state, step=step)
        print(f"  checkpoint -> {d}", flush=True)

    def tripwire(where: str):
        return SystemExit(
            f"non-finite state {where} (NaN tripwire). The degenerate RK3 "
            "shell (--closure none) is unstable over many large steps — "
            "the golden path diverges at the same step (see "
            "wrf_tpu_torch/models/rk3.py). Re-run with --closure nudge "
            "(base-state snapshot + nudging tendencies, "
            "models/tendencies.py) for long horizons, or integrate within "
            "a bounded large-step horizon.")

    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    end = start_step + args.steps
    mass0 = None
    with prof:
        if args.steps_per_sync > 1:
            # K large steps per host synchronisation; total dry mass =
            # the constant sum(mut) + the per-step mass-perturbation sum
            ny, nx = b.jde, b.ide
            mut = rk3.unprepare(arrays, ["mut"])["mut"]
            mut_sum = mut[1:1 + ny, 1:1 + nx].sum(dtype=torch.float64).item()
            step = start_step
            while step < end:
                n = min(args.steps_per_sync, end - step)
                t0 = time.perf_counter()
                with span(f"run_sim steps {step + 1}-{step + n}"):
                    arrays, diags = rk3.multi_step(
                        arrays, n, dyn["rdx"], dyn["rdy"], dt, dyn["epssm"],
                        tendency_fn=tendency_fn)
                dt_s = time.perf_counter() - t0
                if not np.isfinite(diags).all():
                    raise tripwire(f"within steps {step + 1}-{step + n}")
                note = " (incl. compile)" if step == start_step else ""
                print(f"steps {step + 1}-{step + n}: {dt_s * 1e3:.1f} ms "
                      f"({dt_s / n * 1e3:.2f} ms/large-step, "
                      f"device-resident){note}", flush=True)
                if args.diagnostics:
                    for i in range(n):
                        pert = float(diags[i, 0])
                        mass = mut_sum + pert
                        if mass0 is None:
                            mass0 = mass if mass else 1.0
                        print(f"  step {step + i + 1}: total dry mass "
                              f"{mass:.10e} "
                              f"(drift {(mass - mass0) / abs(mass0):+.3e}),"
                              f" mass perturbation sum {pert:+.6e}",
                              flush=True)
                step += n
                # --checkpoint-every at chunk granularity: when the chunk
                # crossed a multiple of the interval, and at the end
                every = args.checkpoint_every
                crossed = step // every > (step - n) // every
                if args.checkpoint_dir and (crossed or step >= end):
                    save(step, arrays)
            return 0

        for step in range(start_step, end):
            t0 = time.perf_counter()
            with span(f"run_sim step {step + 1}"):
                out = rk3.step(arrays, dyn["rdx"], dyn["rdy"], dt,
                               dyn["epssm"], tendency_fn=tendency_fn)
                arrays = rk3.merge_evolved(arrays, out)
                if tendency_fn is not None:
                    tendency_fn.damp_winds(arrays)
                checksum = out["t"].sum().item()   # scalar readback = sync
            dt_s = time.perf_counter() - t0
            if not np.isfinite(checksum):
                raise tripwire(f"at step {step + 1}")
            per_sub = dt_s / n_sub
            note = " (incl. compile)" if step == start_step else ""
            print(f"step {step + 1}: {dt_s * 1e3:.1f} ms "
                  f"({per_sub * 1e3:.2f} ms/substep, "
                  f"{n_pts / per_sub:.3e} grid-points/s){note}", flush=True)
            if args.diagnostics:
                # total dry mass (mut + mu = muts summed over the domain):
                # advance_mu_t IS the mass-conservation update, so relative
                # drift beyond boundary fluxes indicates trouble
                mass = out["muts"].sum(dtype=torch.float64).item()
                pert = out["mu"].sum(dtype=torch.float64).item()
                if mass0 is None:
                    mass0 = mass if mass else 1.0
                print(f"  total dry mass {mass:.10e} "
                      f"(drift {(mass - mass0) / abs(mass0):+.3e}), "
                      f"mass perturbation sum {pert:+.6e}", flush=True)
            if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
                save(step + 1, arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
