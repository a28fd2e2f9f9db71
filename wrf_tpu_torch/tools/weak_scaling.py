"""Weak-scaling measurement over the visible cards: the one command between
a multi-card machine and BASELINE.md's >= 80 % efficiency verdict.

Port of ``tools/weak_scaling.py``.  Weak scaling holds the LOCAL tile fixed
while the mesh (and the global domain) grows; ideal scaling keeps the ms
per substep flat, and the efficiency of a rung is t(1 card) / t(N cards).
One process drives every card (``parallel/mesh.py``): the shards of a rung
take ``cuda:0`` .. ``cuda:N-1``, one each, and exchange through
``Tensor.copy_`` between cards (``ppermute``), K5 writing into the peers'
blocks (``rdma``) or K1 reading the neighbours' rows through peer pointers
(``rdma_overlap``).

    python -m wrf_tpu_torch.tools.weak_scaling                 # every card
    python -m wrf_tpu_torch.tools.weak_scaling --halo-backend rdma
    python -m wrf_tpu_torch.tools.weak_scaling --dryrun        # on the CPU

It prints ONE JSON line:

  {"metric": "weak_scaling_efficiency", "tile": [ny, nx, nz],
   "ladder": [{"n_devices": 1, "mesh": [1, 1], "global": [...],
               "ms_per_substep": ..., "efficiency": 1.0}, ...],
   "min_efficiency": ..., "pass_80pct": true/false,
   "model": {...}}          # the prediction from one card's measurements

``--dryrun`` runs the same ladder on the CPU with the CPU device repeated
once per shard (eight, as the JAX tool's virtual devices), at a 12x12 tile
and nz 8, through the plain versions: it checks the harness end to end; its
times are the host's, not a card's, and the line carries ``"dryrun":
true``.  Without ``--dryrun`` the ladder needs a card and never falls back
to the CPU.

The loop of a rung is ``SmallStepLoop`` on the tool's own case
(``make_case(nx, ny, nz, halo=3, seed=42)``), timed as ``bench_halo``
times it (two substep counts, best of ``repeats``, scalar readback).
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch


def mesh_shape_for(n: int) -> tuple[int, int]:
    """Near-square (j, i) factorization, j >= i (j is the cheaper axis to
    grow: row exchanges stay contiguous)."""
    i = int(np.sqrt(n))
    while n % i:
        i -= 1
    return (n // i, i)


def ladder_sizes(n_devices: int) -> list[int]:
    """1, 2, 4, ... up to ``n_devices``, and ``n_devices`` itself."""
    sizes = [1]
    while sizes[-1] * 2 <= n_devices:
        sizes.append(sizes[-1] * 2)
    if sizes[-1] != n_devices:
        sizes.append(n_devices)
    return sizes


@functools.lru_cache(maxsize=3)
def rung_case(nx: int, ny: int, nz: int):
    """The case every loop of a rung runs (cached: a 1024x1024x50 case
    takes the host half a minute to make, and the backends and the other
    rungs of a ladder share the last three)."""
    from ..io import fixtures

    return fixtures.make_case(nx, ny, nz, halo=3, seed=42)


def rung_backend(shape, inner_steps: int, halo_backend: str) -> str:
    """The backend a rung runs: ``halo_backend`` only for a single-step
    loop with more than one j shard (as in the JAX tool), else
    ``ppermute``."""
    return (halo_backend if inner_steps == 1 and shape[0] > 1
            else "ppermute")


def rung_args(mesh, tile, nz, *, with_w=False, inner_steps=1,
              halo_backend="ppermute"):
    """What a rung's ``SmallStepLoop`` is made of: the global grid
    ``(nx, ny, nz)`` (``tile`` times the mesh shape), the case and the
    loop's keywords."""
    nj, ni = mesh.shape
    grid = (tile[1] * ni, tile[0] * nj, nz)
    return grid, rung_case(*grid), dict(
        with_w=with_w, inner_steps=inner_steps,
        halo_backend=rung_backend(mesh.shape, inner_steps, halo_backend))


def time_substep(mesh, tile, nz, *, steps_pair=(20, 80), repeats=8,
                 with_w=False, inner_steps=1,
                 halo_backend="ppermute") -> float:
    """ms per coupled substep at a FIXED local tile on ``mesh``:
    ``bench_halo.marginal`` on the rung's loop, at least two blocked
    passes between the counts."""
    from .bench_halo import marginal

    grid, case, kw = rung_args(mesh, tile, nz, with_w=with_w,
                               inner_steps=inner_steps,
                               halo_backend=halo_backend)
    return 1e3 * marginal(case, *grid, *steps_pair, repeats=repeats,
                          mesh=mesh, min_passes=2, **kw)


#: one H100's measurements the model is built from: the median of three
#: ``chip_smoke.py`` runs' ``[halo overhead]`` rows (``bench_halo``), the
#: per-substep exchange overhead of each backend at 128x128x50 on a (1,1)
#: mesh with ``force_exchange`` (a ring of one: what the loop spends
#: launching the exchange; no transfer between cards), and the coupled
#: substep at 512x512x50 without an exchange (S=1, and the blocked S=4
#: that exchanges once per 4 substeps).  Host-clock numbers: the three
#: runs' overheads spread over up to 14x, and the prediction with them.
MEASURED = {
    "exchange_us": {"ppermute": 91.2, "rdma": 79.0, "rdma_overlap": 13.7},
    "coupled_ms_512": {"S1": 0.3101, "S4_blocked": 0.3858},
    "provenance": "NVIDIA H100 80GB HBM3, 700.00 W; median of three "
                  "chip_smoke.py [halo overhead] (bench_halo) runs on the "
                  "tree that follows commit dbbdbca; overheads at "
                  "128x128x50 spread ppermute 56.9-136.1, rdma 38.8-244.5, "
                  "rdma_overlap 11.2-152.2 us (host noise); no-exchange "
                  "rows at 512x512x50 S1 0.3098-0.3127, S4 0.3849-0.3870 "
                  "ms",
}


def model_prediction(tile, nz, halo_backend="ppermute",
                     inner_steps=1) -> dict:
    """Weak-scaling efficiency at this tile predicted from one card's
    :data:`MEASURED` inputs: the selected backend's per-substep exchange
    overhead against the 512x512x50 coupled substep scaled to the tile
    (the JAX tool's formula).  Cites its provenance."""
    ex = MEASURED["exchange_us"].get(halo_backend,
                                     MEASURED["exchange_us"]["ppermute"])
    if inner_steps > 1:
        # blocked loops run ONE width-S exchange per S substeps
        ex = ex / inner_steps
        compute_ms = MEASURED["coupled_ms_512"]["S4_blocked"]
    else:
        compute_ms = MEASURED["coupled_ms_512"]["S1"]
    compute_us = compute_ms * 1e3 * (tile[0] * tile[1] * nz) / (512 * 512 * 50)
    eff = compute_us / (compute_us + ex)
    return {"halo_backend": halo_backend,
            "exchange_us": round(ex, 1),
            "compute_us": round(compute_us, 1),
            "predicted_efficiency": round(eff, 3),
            "provenance": MEASURED["provenance"]}


def ladder(devices, tile, nz, *, pair=(20, 80), repeats=8, with_w=False,
           inner_steps=1, halo_backend="ppermute", dryrun=False,
           timings=None) -> dict:
    """The measured ladder over ``devices`` (rung n: the first n of them on
    ``mesh_shape_for(n)``) as the JSON record the tool prints.
    ``timings`` (a dict) keeps each rung's ms by the configuration it
    timed, so that ladders which share a rung (another backend, where the
    rung runs ``ppermute`` all the same) time it once."""
    from ..parallel.mesh import make_mesh

    rungs = []
    base_ms = None
    timings = {} if timings is None else timings
    for n in ladder_sizes(len(devices)):
        shape = mesh_shape_for(n)
        hb = rung_backend(shape, inner_steps, halo_backend)
        key = (tuple(map(str, devices[:n])), tuple(tile), nz, pair, repeats,
               with_w, inner_steps, hb)
        if key not in timings:
            timings[key] = time_substep(
                make_mesh(devices[:n], shape), tile, nz, steps_pair=pair,
                repeats=repeats, with_w=with_w, inner_steps=inner_steps,
                halo_backend=hb)
        ms = timings[key]
        if base_ms is None:
            base_ms = ms
        rungs.append({
            "n_devices": n, "mesh": list(shape),
            "global": [tile[0] * shape[0], tile[1] * shape[1], nz],
            "ms_per_substep": round(ms, 4),
            # host-clock marginals of tiny dryrun loops can be sub-noise
            # (<= 0): an efficiency needs both ends positive
            "efficiency": (round(base_ms / ms, 3)
                           if ms > 0 and base_ms > 0 else None),
        })
    effs = [r["efficiency"] for r in rungs if r["efficiency"]]
    return {
        "metric": "weak_scaling_efficiency",
        "tile": [tile[0], tile[1], nz],
        "ladder": rungs,
        "min_efficiency": min(effs) if effs else None,
        "pass_80pct": bool(effs and min(effs) >= 0.8),
        "model": model_prediction(tile, nz, halo_backend, inner_steps),
        **({"dryrun": True} if dryrun else {}),
    }


#: the CPU "devices" of a dryrun: as many as the JAX tool's virtual ones
DRYRUN_DEVICES = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.weak_scaling",
        description="The weak-scaling ladder over the visible cards, one "
                    "JSON line.")
    ap.add_argument("--tile", type=int, default=256,
                    help="local tile edge (ny_loc = nx_loc)")
    ap.add_argument("--nz", type=int, default=50)
    ap.add_argument("--with-w", action="store_true")
    ap.add_argument("--inner-steps", type=int, default=1)
    ap.add_argument("--halo-backend", default="ppermute",
                    choices=["ppermute", "rdma", "rdma_overlap"],
                    help="per-substep exchange backend for the measured "
                         "ladder (SmallStepLoop); the model block predicts "
                         "from the same backend's measured exchange cost")
    ap.add_argument("--max-devices", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true",
                    help="tiny tiles on the CPU device repeated per shard "
                         "(checks the harness; times are not a card's)")
    args = ap.parse_args(argv)

    if args.dryrun:
        devices = [torch.device("cpu")] * DRYRUN_DEVICES
    else:
        from ..parallel.mesh import default_devices

        devices = default_devices()   # raises when no card is visible
    if args.max_devices:
        devices = devices[:args.max_devices]
    tile = (12, 12) if args.dryrun else (args.tile, args.tile)
    nz = 8 if args.dryrun else args.nz
    rec = ladder(devices, tile, nz,
                 pair=(3, 7) if args.dryrun else (20, 80),
                 repeats=1 if args.dryrun else 8, with_w=args.with_w,
                 inner_steps=args.inner_steps,
                 halo_backend=args.halo_backend, dryrun=args.dryrun)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
