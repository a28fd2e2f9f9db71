"""Measure the per-substep halo-exchange overhead on one card.

Port of ``tools/bench_halo.py``.  One card cannot measure a transfer
between cards, but it can measure what an exchange costs the loop to
launch: a (1,1) mesh with ``force_exchange=True`` runs the exact in-loop
exchange code of a multi-shard run on a ring of one (every refresh sends
the shard's edge rows to itself: ``Tensor.copy_`` under ``ppermute``, one
K5 launch under ``rdma``, the neighbour-row pointers of K1 and K3 under
``rdma_overlap``).

Per configuration, the marginal-step method (the difference between two
substep counts, pass-aligned for the blocked loops by
``utils/timing.py::blocked_counts``, best of ``repeats``, each call ended
by a scalar read back from the device) cancels the per-call set-up:

    python -m wrf_tpu_torch.tools.bench_halo [nx ny nz]      # 128 128 50
    python -m wrf_tpu_torch.tools.bench_halo 512 512 50
    python -m wrf_tpu_torch.tools.bench_halo --device cpu 16 16 8

Prints ms per substep for the JAX tool's seven rows: no exchange, the
``ppermute``, ``rdma`` and ``rdma_overlap`` backends, and the depth-4
trapezoid without an exchange, with the width-4 ``ppermute`` block refresh
and with its j leg inside K3; each row's overhead is its difference from
its own baseline (the first row, or "S=4 no exchange").  The times are the
host clock around calls that end in a synchronise; on ``--device cpu``
they are the plain PyTorch versions' on the host, not the card's.
"""

from __future__ import annotations

import argparse
import math
import time

#: the JAX tool's rows: (name, SmallStepLoop keywords)
CONFIGS = (
    ("no exchange", dict(force_exchange=False)),
    ("ppermute exchange", dict(force_exchange=True, halo_backend="ppermute")),
    ("rdma exchange", dict(force_exchange=True, halo_backend="rdma")),
    # the j exchange inside K1: one launch per substep, no K5 launch
    ("rdma_overlap", dict(force_exchange=True, halo_backend="rdma_overlap")),
    # blocked (depth-4 trapezoid): a width-4 exchange once per block, by
    # copies or inside K3; overheads against the blocked baseline
    ("S=4 no exchange", dict(force_exchange=False, inner_steps=4)),
    ("S=4 ppermute blocks", dict(force_exchange=True, inner_steps=4,
                                 halo_backend="ppermute")),
    ("S=4 rdma_overlap", dict(force_exchange=True, inner_steps=4,
                              halo_backend="rdma_overlap")),
)

#: the JAX tool's step counts
COUNTS = (100, 400)


def checksum(out) -> float:
    """The scalar each timed call reads back (and so waits for)."""
    return float(out["t"][:, 0, :].sum() + out["mu"].sum())


def marginal(case, nx, ny, nz, n1, n2, repeats=4, device="cuda",
             prepared=None, mesh=None, min_passes=8, **kw) -> float:
    """Seconds per substep of ``SmallStepLoop`` with ``kw`` on ``mesh`` (a
    (1,1) mesh on ``device`` by default): ``(T(n2) - T(n1)) / (n2 - n1)``,
    the counts pass-aligned (``blocked_counts`` with ``min_passes``), each
    T the best of ``repeats`` after a warm-up call whose state must be
    finite.  ``prepared`` (a dict) keeps the prepared arrays between
    calls: every row of the tool reads the same layout, and a copy of a
    512x512x50 case to the card costs more than the timed substeps."""
    from ..models.small_step import SmallStepLoop
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import case_to_domain
    from ..utils.timing import blocked_counts

    # pass-align the two counts for blocked configs so that the
    # single-step tails cancel in the difference
    n1, n2 = blocked_counts(kw.get("inner_steps", 1), n1, n2, min_passes)
    mesh = make_mesh([device], (1, 1)) if mesh is None else mesh
    prepared = {} if prepared is None else prepared
    times = {}
    for steps in (n1, n2):
        loop = SmallStepLoop(nx, ny, nz, case.flags, n_steps=steps,
                             device=mesh.device((0, 0)), mesh=mesh, **kw)
        if "arrays" not in prepared:
            prepared["arrays"] = loop.prepare(
                case_to_domain(case, with_w=kw.get("with_w", False)))
        arrays = prepared["arrays"]
        scalars = (case.rdx, case.rdy, case.dts, case.epssm)
        if not math.isfinite(checksum(loop(arrays, *scalars))):
            raise AssertionError(f"non-finite state on {mesh} at "
                                 f"n={steps} {kw}")
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            checksum(loop(arrays, *scalars))
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    return (times[n2] - times[n1]) / (n2 - n1)


def run(nx=128, ny=128, nz=50, device="cuda", counts=COUNTS, repeats=4,
        echo=print) -> dict:
    """Every row of :data:`CONFIGS` at nx x ny x nz: ``{name: (ms per
    substep, overhead us)}``, each row printed (through ``echo``) as the
    JAX tool prints it."""
    from ..io import fixtures

    case = fixtures.make_case(nx, ny, nz, halo=3, seed=42)
    prepared: dict = {}
    rows = {}
    base = blk_base = None
    for name, kw in CONFIGS:
        per = marginal(case, nx, ny, nz, *counts, repeats=repeats,
                       device=device, prepared=prepared, **kw)
        if base is None:
            base = per
        if name == "S=4 no exchange":
            blk_base = per
        b = blk_base if (name.startswith("S=4") and blk_base) else base
        rows[name] = (per * 1e3, max(per - b, 0) * 1e6)
        echo(f"{name:>20} ({nx}x{ny}x{nz}): {per * 1e3:8.4f} ms/substep"
             f"   overhead {max(per - b, 0) * 1e6:7.1f} us", flush=True)
    return rows


def main(argv=None) -> int:
    from .probe_2d import device_name, device_or_exit

    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.bench_halo",
        description="ms per substep of the coupled loop on a (1,1) mesh "
                    "with and without the in-loop exchange, per backend.")
    ap.add_argument("grid", type=int, nargs="*", default=[],
                    help="nx ny nz (default 128 128 50)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    nx, ny, nz = args.grid + [128, 128, 50][len(args.grid):]
    device = device_or_exit("bench_halo", args.device)
    note = ("host clock around synchronised calls" if device.type == "cuda"
            else "the plain versions on the host: not a card's time")
    print(f"device={device} ({device_name(device)}); {note}", flush=True)
    run(nx, ny, nz, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
