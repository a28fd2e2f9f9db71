"""CPU stability check of a configuration's dynamics at a small slice.

    python -m wrfbench.stability --config conus12km [--steps N] [--grid 40x32]

Runs the plain reference (:mod:`wrfbench.reference`) from the seeded inputs
for ``N`` closed large steps at a ``JxI`` slice of the configuration, with
its dx, dt, acoustic substeps, divergence damping and closure unchanged
(and ``--time-step`` to try another dt), and prints the largest value of
each evolved field every ``--every`` steps.  Exits 1 at the first step
whose state is not finite.  A cell's window must hold: the run length to
check is the warm-up plus the calls of the longest window.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import inputs
from .reference import EVOLVED, Reference

ROOT = Path(__file__).resolve().parent


def run(cfg: dict, steps: int, every: int, seed: int, log=sys.stdout) -> int:
    """Steps held before the state went non-finite (``steps`` if it held)."""
    host = inputs.make_domain(cfg, seed, "cpu")
    ref = Reference(cfg, host, "cpu")
    state = ref.initial(host)
    mu0 = float(state["mu"].double().sum() + host["mut"].double().sum())
    for n in range(1, steps + 1):
        state = ref.step(state)
        if not all(torch.isfinite(state[f]).all() for f in EVOLVED):
            print(f"step {n}: not finite", file=log, flush=True)
            return n - 1
        if n % every == 0 or n == steps:
            mass = float(state["mu"].double().sum() + host["mut"].double().sum())
            top = ", ".join(f"{f} {state[f].abs().max().item():.3e}"
                            for f in EVOLVED)
            print(f"step {n}: mass drift {(mass - mu0) / mu0:+.2e}; "
                  f"largest {top}", file=log, flush=True)
    return steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--every", type=int, default=100)
    p.add_argument("--grid", default="40x32", help="e_we x e_sn of the slice")
    p.add_argument("--time-step", type=float, default=None)
    p.add_argument("--seed", type=int, default=2026)
    args = p.parse_args(argv)
    cfg = json.loads((ROOT / "configs" / f"{args.config}.json").read_text())
    nx, ny = (int(x) for x in args.grid.split("x"))
    cfg.update(e_we=nx, e_sn=ny)
    if args.time_step is not None:
        cfg["time_step"] = args.time_step
    torch.set_num_threads(2)
    held = run(cfg, args.steps, args.every, args.seed)
    print(f"{args.config} at {nx}x{ny}x{cfg['e_vert']}, dt "
          f"{cfg['time_step']:g} s: held {held} of {args.steps} large steps")
    return 0 if held == args.steps else 1


if __name__ == "__main__":
    sys.exit(main())
