"""Readings that set a cell's limits: the program over many seeds, the
bfloat16 control and the faults, at the cell's own size, in one process.

    python -m wrfbench.control --workload <cell> [--seeds 12] [--control 3]
        [--faults 3] [--seconds 2] [--base-seed N]

Each run is a whole run of the cell (:func:`wrfbench.run.run_cell`) with a
short window at the cell's load, the program replaced by the control
(:class:`wrfbench.check.Control`) or broken underneath
(:class:`wrfbench.check.Fault`: every fault a closed step can have, and
on a cell whose traffic names a mesh, those of a mesh too).  It runs on
the cell's ``chips`` cards, or with ``--device`` on that one device alone
(which then holds every shard of a mesh).  One JSON line per run on
standard output:
what ran, the seed, the two compared numbers and ``correct``.  A run that
raises is reported with its error and no numbers.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

from .check import FAULTS, MESH_FAULTS, Control, Fault
from .run import ROOT, _START, Spec, cache_dirs, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--base-seed", type=int, default=2**31 + 1000)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    devices = ([args.device] if args.device else
               [f"cuda:{i}" for i in range(cell["chips"])])
    if torch.device(devices[0]).type == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < len(devices)):
        print(f"wrfbench.control: needs {len(devices)} CUDA device(s)",
              file=sys.stderr)
        return 2
    from .program import ClosedStep

    faults = FAULTS + (MESH_FAULTS if "mesh" in spec.traffic(cell) else ())

    def fault(kind):
        return lambda *a: Fault(ClosedStep(*a), kind)

    plan = [("program", None, i) for i in range(args.seeds)]
    plan += [("control bf16", Control, 100 + i) for i in range(args.control)]
    plan += [(f"fault {k}", fault(k), 200 + 10 * j + i)
             for j, k in enumerate(faults) for i in range(args.faults)]
    for what, make, offset in plan:
        seed = args.base_seed + offset
        t0 = time.perf_counter()
        row = {"run": what, "workload": args.workload, "seed": seed}
        try:
            res = run_cell(ROOT, args.workload, seed, args.seconds, False,
                           devices, _START, make_program=make,
                           log=io.StringIO())
            row.update({k: c["value"] for k, c in res["compared"].items()},
                       correct=res["correct"], calls=res["attempted"])
        except Exception as exc:  # a control that crashes has failed
            row.update(error=f"{type(exc).__name__}: {exc}"[:300])
        row["seconds"] = round(time.perf_counter() - t0, 3)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
