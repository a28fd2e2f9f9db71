"""CLI verification driver: load a golden fixture, run a tier, diff, time.

The port of ``wrf_tpu.driver``: read every input field from the fixture
directory, run ``advance_mu_t`` for N small steps on the selected tier,
print the timing line, then the per-field comparison report
(``wrf_tpu_torch.compare``), gated on the same element-wise tolerance.

Usage:
    python -m wrf_tpu_torch.driver FIXTURE_DIR [--steps N] [--tier T]
        [--inner-steps S] [--fast] [--with-w] [--device cuda|cpu]
        [--mesh JxI] [--halo-backend ppermute|rdma|rdma_overlap]
        [--precision f32|bf16-const] [--dump-intermediates DIR]

Tiers (the JAX tier each replaces in brackets): numpy (golden path) and
native (C++ oracle), both without torch; eager [xla] (whole-array PyTorch,
``ops/advance_mu_t_eager.py``); cuda [pallas] (one K1 call per step on the
memory-window arrays); sharded-eager / sharded-cuda [sharded-xla /
sharded-pallas] (``ShardedAdvanceMuT``; sharded-cuda
honours --inner-steps and --fast, running K2); coupled (the acoustic
small-step loop, ``SmallStepLoop``; honours --inner-steps and --fast,
running K3), coupled-eager [coupled-xla] (the same loop as three
whole-array calls per substep) and coupled-native, all verified against
the numpy golden loop and all honouring --with-w (the vertically-implicit
w/pp substep every substep); all (every tier side by side, plus the
blocked rows sharded-cuda~blk and sharded-cuda~blkfast at S=4, coupled~blk
and coupled~blkfast at S=2, the +w rows coupled+w, coupled-eager+w and
coupled-native+w, and the bf16 rows sharded-cuda~bf16 and coupled~bf16:
the 18 rows of ``wrf_tpu.driver``'s matrix).

``--precision bf16-const`` (tiers sharded-cuda and coupled) narrows the
read-only 3-D bases to bf16 in device memory; acceptance relaxes to that
mode's contract, 2e-2 of field scale (:data:`BF16_RTOL`).

``--mesh JxI`` runs the sharded and coupled loop tiers on a mesh of
``J*I`` shards (the visible CUDA devices in order, wrapping round when
there are fewer: several shards may share one card), and
``--halo-backend rdma`` gives the coupled tiers' per-substep j exchange to
the hand-written kernel (K5), ``rdma_overlap`` to the substep kernels
themselves (K1 and K3 read the neighbours' edge rows).  With ``--tier all``
the backend also reaches the coupled rows of the matrix, which
``wrf_tpu.driver`` runs on ``ppermute`` whatever the flag says: the port's
matrix checks more (a blocked row under plain ``rdma``, which has no
width-S exchange, and the eager rows under ``rdma_overlap``, which have no
kernel to hold the exchange, run on ``ppermute``).

``--dump-intermediates DIR`` (tiers numpy, native, eager and cuda) writes
the last step's five phase-A snapshots, ``muave_``, ``mu_``, ``mudf_``,
``muts_`` and ``ww_before_theta.bin``, in the fixture binary format: what
advance_mu_t holds between its mu/ww pass and its theta pass, for
phase-by-phase bisection of a numerical divergence.  The cuda tier's come
from the kernel itself (K1's ``capture``) and are zero on the memory
window's first and last rows, which that kernel never computes.

The native tier's own CLI is the C++ executable
``wrf_tpu_torch.native.build_driver()`` builds (``driver.cc``).

``--device`` is explicit: ``cuda`` (the default) fails when there is no
GPU, and ``cpu`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import torch

from . import native
from .compare import compare
from .convert import arrays_from_numpy, arrays_to_numpy
from .io import codec, fixtures
from .models.small_step import SmallStepLoop, small_step_golden
from .ops.advance_mu_t_cuda import CAPTURE_NAMES, advance_mu_t_fused
from .ops.advance_mu_t_eager import advance_mu_t_core, window_masks
from .ops.advance_uv import DEFAULT_CS2
from .ops.advance_w import DEFAULT_CW, DEFAULT_GW
from .ops.reference_numpy import advance_mu_t_numpy
from .parallel.mesh import describe, mesh_from_spec
from .parallel.sharded import ShardedAdvanceMuT, case_to_domain, embed_outputs

#: output-field -> golden file name (reference driver naming)
GOLDEN_FILES = {
    "ww": "grid_ww_output.bin",
    "t": "grid_t_2_output.bin",
    "t_ave": "t_2save_output.bin",
    "mu": "grid_mu_2_output.bin",
    "muave": "muave_output.bin",
    "muts": "grid_muts_output.bin",
    "mudf": "grid_mudf_output.bin",
}

#: the acceptance gate: element-wise |a-g| <= atol + rtol*|g| with the
#: absolute floor scaled per field (atol_scale * max|golden|), as
#: ``wrf_tpu.driver``
RTOL = 1e-4
ATOL_SCALE = 1e-5

#: acceptance for --precision bf16-const: the documented contract of the
#: reduced-precision constant-stream mode — outputs within 2e-2 of field
#: scale of the float32 loop over O(10) substeps
BF16_RTOL = 2e-2
BF16_ATOL_SCALE = 2e-2

#: the tiers --precision bf16-const applies to (the fused-kernel loops)
BF16_TIERS = ("sharded-cuda", "coupled")

TIERS = ("numpy", "native", "eager", "cuda", "sharded-eager",
         "sharded-cuda", "coupled", "coupled-eager", "coupled-native")

#: the tiers that can write the phase-A snapshots (--dump-intermediates)
CAPTURE_TIERS = ("numpy", "native", "eager", "cuda")

#: the tiers that run the coupled loop (and so honour --with-w)
COUPLED_TIERS = ("coupled", "coupled-eager", "coupled-native")

#: rows of --tier all: every tier, then the coupled tiers with the w/pp
#: substep, the two loops with bf16 constant streams, then the blocked
#: loops, exact and fast (the mu/t loop at S=4, the coupled loop at S=2):
#: the matrix of ``wrf_tpu.driver``
ALL_ROWS = TIERS + ("coupled+w", "coupled-eager+w", "coupled-native+w",
                    "sharded-cuda~bf16", "coupled~bf16",
                    "sharded-cuda~blk", "coupled~blk",
                    "sharded-cuda~blkfast", "coupled~blkfast")

_STATE = ("ww", "mu", "t", "t_ave")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_tier(case, steps: int, tier: str, device, inner_steps: int = 1,
             fast: bool = False, with_w: bool = False, mesh=None,
             halo_backend: str = "ppermute", capture: bool = False,
             const_dtype=None):
    """Run ``steps`` small steps on the chosen tier; returns
    ``(outputs, seconds, golden_override)`` — ``golden_override`` is None
    for tiers verified against the fixture goldens, or the numpy golden
    loop's outputs for the coupled tiers.  Outputs are numpy arrays.
    ``with_w`` (coupled tiers only) adds the w/pp substep and its fields;
    ``mesh`` (a :class:`~wrf_tpu_torch.parallel.mesh.Mesh`) decomposes the
    loop tiers, and ``halo_backend`` picks the coupled loop's exchange.
    ``capture`` (the :data:`CAPTURE_TIERS`) adds the last step's five
    ``*_before_theta`` snapshots to the outputs.  ``const_dtype``
    (``torch.bfloat16``; the :data:`BF16_TIERS`) narrows the loops'
    constant streams.

    The timed window covers the step calls and the readback of the
    outputs, after one untimed warm-up run (the first launch builds the
    kernels and allocates), as ``wrf_tpu.driver`` times its tiers."""
    device = torch.device(device)
    kw = case.kernel_kwargs()
    if with_w and tier not in COUPLED_TIERS:
        raise SystemExit(f"--with-w applies to the coupled tiers "
                         f"{COUPLED_TIERS}, not {tier!r}")

    if tier == "coupled-native":
        # the coupled loop on the C++ oracle: advance_uv + advance_mu_t (+
        # advance_w) per substep; bit-identical to the numpy golden loop
        # by construction
        state = {k: kw[k] for k in _STATE + ("u", "v")}
        out = dict(state)
        if with_w:
            f = case.fields
            wst = {"w": f["grid_w"], "pp": f["grid_pp"]}
        t0 = time.perf_counter()
        for _ in range(steps):
            u, v = native.advance_uv_native(
                u=state["u"], v=state["v"], mu=state["mu"], muu=kw["muu"],
                muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
                rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"], cs2=DEFAULT_CS2,
                flags=case.flags, bounds=case.bounds)
            out = native.advance_mu_t_native(
                **{**kw, **state, "u": u, "v": v})
            if with_w:
                wst["w"], wst["pp"] = native.advance_w_native(
                    w=wst["w"], pp=wst["pp"], t=out["t"],
                    rdn=case.fields["grid_rdn"], rdnw=kw["rdnw"],
                    dts=kw["dts"], epssm=kw["epssm"], cw=DEFAULT_CW,
                    gw=DEFAULT_GW, flags=case.flags, bounds=case.bounds)
            state = {**{k: out[k] for k in _STATE}, "u": u, "v": v}
        dt = time.perf_counter() - t0
        out = {**out, "u": state["u"], "v": state["v"]}
        if with_w:
            out.update(wst)
        return out, dt, small_step_golden(case, steps, with_w=with_w)

    if tier in ("numpy", "native"):
        fn = (advance_mu_t_numpy if tier == "numpy"
              else native.advance_mu_t_native)
        state = {k: kw[k] for k in _STATE}
        out = dict(state)
        t0 = time.perf_counter()
        for s in range(steps):
            cap = capture and s == steps - 1   # the last step's phase A
            out = fn(**{**kw, **state}, capture_intermediates=cap)
            state = {k: out[k] for k in _STATE}
        return out, time.perf_counter() - t0, None

    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    if tier in ("coupled", "coupled-eager"):
        loop = SmallStepLoop(nx, ny, nz, case.flags, n_steps=steps,
                             kernel="eager" if tier == "coupled-eager"
                             else "cuda",
                             inner_steps=inner_steps, fast=fast,
                             with_w=with_w, device=device, mesh=mesh,
                             halo_backend=halo_backend,
                             const_dtype=const_dtype)
        gold = small_step_golden(case, steps, with_w=with_w)
    elif tier.startswith("sharded"):
        loop = ShardedAdvanceMuT(nx, ny, nz, case.flags, n_steps=steps,
                                 kernel=tier.split("-", 1)[1],
                                 inner_steps=inner_steps, fast=fast,
                                 device=device, mesh=mesh,
                                 const_dtype=const_dtype)
        gold = None
    elif tier in ("eager", "cuda"):
        return _run_single_tile(case, steps, tier, device, capture)
    else:
        raise SystemExit(f"unknown tier {tier!r}")
    run = functools.partial(
        loop, loop.prepare(case_to_domain(case, with_w=with_w)),
        case.rdx, case.rdy, case.dts, case.epssm)

    # both loops leave the prepared arrays alone, so the warm-up run and
    # the timed run start from the same state
    run()
    _sync(device)
    t0 = time.perf_counter()
    out = arrays_to_numpy(run())
    dt = time.perf_counter() - t0
    return embed_outputs(case, out), dt, gold


def _run_single_tile(case, steps, tier, device, capture=False):
    """eager / cuda: one advance_mu_t call per step on the memory-window
    arrays (the reference's own call), state carried on the device;
    ``capture``: the last step also returns its phase-A snapshots."""
    b, flags = case.bounds, case.flags
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = b.loop_bounds(flags)
    sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
    arr = arrays_from_numpy({k: v for k, v in kw.items()
                             if hasattr(v, "ndim")}, device)
    if tier == "cuda":
        def step(ins, cap=False):
            return advance_mu_t_fused(**ins, **sc, window=(i0, i1, j0, j1),
                                      k0=k0, k1=k1, kde=b.mem(b.kde, "k"),
                                      capture=cap)
    else:
        i_mask, j_mask = (torch.as_tensor(m, device=device)
                          for m in window_masks(b, flags))

        def step(ins, cap=False):
            return advance_mu_t_core(**ins, **sc, i_mask=i_mask,
                                     j_mask=j_mask, k0=k0, k1=k1,
                                     kde=b.mem(b.kde, "k"),
                                     capture_intermediates=cap)

    # warm-up (K1 writes no operand; the eager core's results are new too)
    step(arr, capture)
    _sync(device)
    state = {k: arr[k] for k in _STATE}
    t0 = time.perf_counter()
    for s in range(steps):
        out = step({**arr, **state}, capture and s == steps - 1)
        state = {k: out[k] for k in _STATE}
    out = arrays_to_numpy(out)
    return out, time.perf_counter() - t0, None


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("fixture_dir")
    p.add_argument("--steps", type=int, default=None,
                   help="small steps (default: the fixture's steps.bin)")
    p.add_argument("--tier", default="cuda", choices=TIERS + ("all",))
    p.add_argument("--inner-steps", type=int, default=1,
                   help="temporal blocking: substeps per K2 pass "
                        "(sharded-cuda) or K3 pass (coupled)")
    p.add_argument("--fast", action="store_true",
                   help="blocked tiers: K2's closed form or K3's fast scan "
                        "(re-associated float32, the eager tier's "
                        "tolerance class)")
    p.add_argument("--with-w", action="store_true",
                   help="coupled tiers: also run the vertically-implicit "
                        "w/pp substep (advance_w) every substep")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' requires a GPU (no fallback)")
    p.add_argument("--mesh", default=None,
                   help="JxI mesh of shards for the sharded and coupled "
                        "loop tiers (default: one shard on --device)")
    p.add_argument("--halo-backend", default="ppermute",
                   choices=["ppermute", "rdma", "rdma_overlap"],
                   help="coupled-tier per-substep halo exchange backend "
                        "(SmallStepLoop docstring); rdma_overlap fuses "
                        "the j exchange into the substep kernels")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16-const"],
                   help="bf16-const (sharded-cuda / coupled tiers): narrow "
                        "the read-only 3-D bases to bf16 in device memory; "
                        "acceptance relaxes to the mode's documented "
                        "2e-2-of-scale contract")
    p.add_argument("--dump-intermediates", default=None, metavar="DIR",
                   help="write *_before_theta.bin phase-A captures of the "
                        "final substep (numpy, native, eager and cuda tiers)")
    return p


def _row(case, steps, tier, golden, device, mesh=None,
         halo_backend="ppermute") -> bool:
    """One row of --tier all: the worst field against the goldens."""
    fast = tier.endswith("~blkfast")
    with_w = tier.endswith("+w")
    bf16 = tier.endswith("~bf16")
    name = tier.split("~", 1)[0].removesuffix("+w")
    inner = (2 if name == "coupled" else 4) if "~blk" in tier else 1
    try:
        # ppermute where the backend has nothing to run in: a blocked
        # coupled row under plain rdma (no width-S exchange kernel), the
        # eager rows under rdma_overlap (no kernel to hold the exchange)
        backend = ("ppermute" if name not in COUPLED_TIERS
                   or (inner > 1 and halo_backend == "rdma")
                   or (name == "coupled-eager"
                       and halo_backend == "rdma_overlap")
                   else halo_backend)
        out, dt, gold_ov = run_tier(case, steps, name, device,
                                    inner_steps=inner, fast=fast,
                                    with_w=with_w, mesh=mesh,
                                    halo_backend=backend,
                                    const_dtype=(torch.bfloat16 if bf16
                                                 else None))
    except Exception as e:  # report, keep the matrix going
        print(f"{tier:>20}: ERROR {type(e).__name__}: {e}")
        return False
    gold = gold_ov if gold_ov is not None else golden
    names = (sorted(gold.keys() & out.keys()) if gold_ov is not None
             else list(GOLDEN_FILES))
    rtol, atol_scale = ((BF16_RTOL, BF16_ATOL_SCALE) if bf16
                        else (RTOL, ATOL_SCALE))
    results = [compare(out[n], gold[n], n, rtol=rtol, atol_scale=atol_scale)
               for n in names]
    worst = max(results, key=lambda r: r.max_scaled_err)
    ok = all(r.passed for r in results)
    print(f"{tier:>20}: {dt / steps * 1e3:9.3f} ms/step   "
          f"worst field {worst.name}: max_abs={worst.max_abs_err:.3e}"
          f" scaled_err={worst.max_scaled_err:.3f}   "
          f"{'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if args.halo_backend != "ppermute" and not (
            args.tier.startswith("coupled") or args.tier == "all"):
        p.error("--halo-backend applies to the coupled tiers")
    if args.dump_intermediates and args.tier not in CAPTURE_TIERS:
        p.error("--dump-intermediates requires a capture-capable tier "
                "(numpy, native, eager, cuda)")
    rtol, atol_scale = RTOL, ATOL_SCALE
    if args.precision == "bf16-const":
        if args.tier not in BF16_TIERS:
            p.error("--precision bf16-const applies to the fused-kernel "
                    "loop tiers (sharded-cuda, coupled)")
        rtol, atol_scale = BF16_RTOL, BF16_ATOL_SCALE
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("driver: --device cuda, but torch.cuda.is_available() "
                         "is False (no GPU). Pass --device cpu to run the "
                         "kernels' plain PyTorch versions (ROADMAP.md: every "
                         "kernel has a plain twin for the CPU)")

    case, fx_steps = fixtures.read_case(args.fixture_dir)
    steps = args.steps if args.steps is not None else fx_steps
    mesh = mesh_from_spec(args.mesh, device) if args.mesh else None
    if mesh is not None:
        print(f"{describe(mesh)}, halo backend {args.halo_backend}")

    if args.tier == "all":
        golden = fixtures.read_golden(args.fixture_dir, case.bounds)
        print(f"device: {_device_name(device)}")
        failures = sum(not _row(case, steps, tier, golden, device, mesh,
                                args.halo_backend)
                       for tier in ALL_ROWS)
        if failures:
            print(f"FAILED: {failures} tier(s)")
        return 1 if failures else 0

    out, dt, gold_override = run_tier(case, steps, args.tier, device,
                                      inner_steps=args.inner_steps,
                                      fast=args.fast, with_w=args.with_w,
                                      mesh=mesh,
                                      halo_backend=args.halo_backend,
                                      capture=bool(args.dump_intermediates),
                                      const_dtype=(
                                          torch.bfloat16
                                          if args.precision == "bf16-const"
                                          else None))
    if args.dump_intermediates:
        d = Path(args.dump_intermediates)
        d.mkdir(parents=True, exist_ok=True)
        for name in CAPTURE_NAMES:
            codec.write_field(d / f"{name}.bin", out[name])
    b = case.bounds
    n_pts = (b.ide - b.ids) * (b.jde - b.jds) * b.kdim * steps
    print(f"advance_mu_t [{args.tier}]: {steps} step(s) in {dt * 1e3:.3f} ms "
          f"({dt / steps * 1e3:.4f} ms/step, {n_pts / dt:.3e} grid-points/s) "
          f"on {_device_name(device)}")

    failures = 0
    if gold_override is not None:
        checks = [(n, gold_override[n], f"{n} (golden loop)")
                  for n in sorted(gold_override.keys() & out.keys())]
    else:
        golden = fixtures.read_golden(args.fixture_dir, case.bounds)
        checks = [(n, golden[n], f) for n, f in GOLDEN_FILES.items()]
    for name, gold, label in checks:
        r = compare(out[name], gold, label, rtol=rtol, atol_scale=atol_scale)
        print(r)
        if not r.passed:
            failures += 1
    if failures:
        print(f"FAILED: {failures} field(s) outside tolerance")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
