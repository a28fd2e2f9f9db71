"""The loops across real OS processes, bit for bit against one process.

Port of ``tools/multihost_check.py``.  The parent runs each program once in
this process on a one-process mesh, then starts ``--nproc`` worker
processes that join one ``torch.distributed`` group (a ``file://`` init in
a temporary directory, so concurrent runs never meet), build the same mesh
over all of them with ``parallel.distributed.global_mesh`` (rank r holds a
consecutive j-major run of shards), take their blocks of every field with
``process_local_block`` and ``host_local_arrays``, and run the same
program.  Every rank ends with the domain-shaped result (the loops
all-gather it); rank 0's is held against the one-process result bit for
bit, field by field.  Only process placement differs, so any difference is
a fault of the exchange or of the gather, not rounding.

Suites:

* ``jax`` (default): the JAX tool's three programs on the (2, 4) mesh: the
  mu/t loop (``ShardedAdvanceMuT``, 4 substeps, ``vary_winds``, 40x36x12),
  the coupled loop (``SmallStepLoop``, 3 substeps, 24x20x8) and one closed
  RK3 large step (``snapshot="base"``, ``NudgingTendencies(tau_steps=5)``,
  2 acoustic substeps, 24x20x8, the balanced fixture).  With 2 processes
  each rank holds one j row of the mesh; with 4, half a row, so the i
  exchange crosses processes too (a 2-D process grid);
* ``chip``: the main path's loops at ``--grid`` (the balanced fixture): the
  coupled loop at S=1 (9 substeps) and at ``inner_steps=2`` (9),
  ``ShardedAdvanceMuT(inner_steps=8)`` for 17 steps, 3 closed RK3 large
  steps (4 acoustic substeps) and the transport alone, all under
  ``ppermute``; then the same loops under the rdma backends, whose j
  exchange crosses processes through the mailboxes
  (``ops/halo_rdma_cuda.py::Mailbox``): S=1 under ``rdma`` and
  ``rdma_overlap``, S=2 and the RK3 steps under ``rdma_overlap``, and
  ``rdma_rows`` and ``remote_refresh_multi`` alone.  Every rank reports
  its K1, K2, K3 and K5 launches, its launches of the signalled put and
  the wait, and the ms of each program (host clock, the device
  synchronised around it) and of each large step.

The transport is gloo unless ``--backend nccl`` asks for NCCL, which needs
one card per rank (rank r takes ``cuda:r``); on a one-card machine NCCL
with more than one rank raises before any exchange.  Under gloo every rank
of a ``--device cuda`` run sits on ``cuda:0`` and the rows and blocks it
sends are staged through pinned host memory.  Every worker has a time
limit: a hang or a failed worker kills the rest and fails the run.  Each
worker checks before it exits that neither jax nor the JAX package was
imported.

Usage::

    python -m wrf_tpu_torch.tools.multihost_check --device cpu            # 2 processes
    python -m wrf_tpu_torch.tools.multihost_check --device cpu --nproc 4
    python -m wrf_tpu_torch.tools.multihost_check --device cpu --save-reference ref.npz
    python -m wrf_tpu_torch.tools.multihost_check --device cuda --backend nccl --nproc 4
    python -m wrf_tpu_torch.tools.multihost_check                         # on cuda:0, gloo
    python -m wrf_tpu_torch.tools.multihost_check --suite chip --mesh 2x2 --grid 512x512x50

It prints ``MULTIHOST OK (N processes)`` and exits 0 when every field is
bit-equal.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]

#: the JAX tool's programs: (tag, kind, grid, substeps, case)
JAX_SUITE = (("mu_t", "mu_t", (40, 36, 12), dict(n_steps=4), "noise"),
             ("coupled", "coupled", (24, 20, 8), dict(n_steps=3), "noise"),
             ("rk3", "rk3", (24, 20, 8), dict(acoustic_steps=2, steps=1),
              "balanced"))
#: the main path's loops, at the grid the caller names
CHIP_SUITE = (("coupled S=1", "coupled", None, dict(n_steps=9), "balanced"),
              ("coupled S=2", "coupled", None,
               dict(n_steps=9, inner_steps=2), "balanced"),
              ("mu_t S=8", "mu_t", None, dict(n_steps=17, inner_steps=8),
               "balanced"),
              ("rk3", "rk3", None, dict(acoustic_steps=4, steps=3),
               "balanced"),
              ("exchange", "exchange", None, dict(repeats=20), "balanced"),
              ("coupled S=1 rdma", "coupled", None,
               dict(n_steps=9, halo_backend="rdma"), "balanced"),
              ("coupled S=1 rdma_overlap", "coupled", None,
               dict(n_steps=9, halo_backend="rdma_overlap"), "balanced"),
              ("coupled S=2 rdma_overlap", "coupled", None,
               dict(n_steps=9, inner_steps=2, halo_backend="rdma_overlap"),
               "balanced"),
              ("rk3 rdma_overlap", "rk3", None,
               dict(acoustic_steps=4, steps=3, halo_backend="rdma_overlap"),
               "balanced"),
              ("rdma exchange", "rdma exchange", None, dict(repeats=20),
               "balanced"))


def suite(name: str, grid=None) -> list:
    """The programs of ``name``, each at ``grid`` when it is given."""
    progs = {"jax": JAX_SUITE, "chip": CHIP_SUITE}[name]
    out = [(tag, kind, tuple(grid) if grid else g, dict(kw), case)
           for tag, kind, g, kw, case in progs]
    if any(g is None for _, _, g, _, _ in out):
        raise ValueError(f"suite {name!r} needs --grid")
    return out


def _case(grid, which):
    from wrf_tpu_torch.io.fixtures import make_case

    if which == "balanced":
        return make_case(*grid, halo=3, seed=9, amplitude=1e-2, balanced=True)
    return make_case(*grid, halo=3, seed=7)


def _counters() -> dict:
    """``{name: (module, its launch counter)}`` of every kernel a program
    may launch: K1, K2, K3, K5 and the signalled put and the wait of the
    exchange across processes."""
    from wrf_tpu_torch.ops import (
        advance_mu_t_coupled_cuda as k3, advance_mu_t_cuda as k1,
        advance_mu_t_msteps_cuda as k2, halo_rdma_cuda as k5,
    )
    return {"k1": (k1, "LAUNCHES"), "k2": (k2, "LAUNCHES"),
            "k3": (k3, "LAUNCHES"), "k5": (k5, "LAUNCHES"),
            "put": (k5, "PUT_LAUNCHES"), "wait": (k5, "WAIT_LAUNCHES")}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _assemble(loop, dom, mesh, multihost: bool) -> dict:
    """The loop's input: ``prepare`` of the whole domain in one process;
    across processes, this rank's block of every padded field
    (``process_local_block``) through ``host_local_arrays``, as a process
    that holds only its block would."""
    from wrf_tpu_torch.parallel import distributed
    from wrf_tpu_torch.parallel.sharded import pad_to_mesh

    if not multihost:
        return loop.prepare(dom)
    blocks, gshapes = {}, {}
    for name, arr in dom.items():
        padded = pad_to_mesh(np.asarray(arr), mesh)
        if padded.ndim in (2, 3):
            blocks[name] = padded[distributed.process_local_block(
                mesh, padded.shape)]
            gshapes[name] = padded.shape
        else:
            blocks[name] = padded
    return distributed.host_local_arrays(mesh, blocks, global_shapes=gshapes)


def compute(mesh, device, progs, doms, multihost: bool):
    """Every program of ``progs`` on ``mesh``: ``({"tag/field": array},
    {tag: report})``; a report holds the launches of every kernel of
    :func:`_counters` and the ms of the program (and of each large step of
    the RK3 program)."""
    from wrf_tpu_torch.models.rk3 import RK3Integrator
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.models.tendencies import NudgingTendencies
    from wrf_tpu_torch.parallel.sharded import ShardedAdvanceMuT

    counters = _counters()
    results, reports = {}, {}
    for tag, kind, grid, kw, which in progs:
        case, dom = doms[grid, which]
        nx, ny, nz = grid
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        _sync(device)
        t0 = time.perf_counter()
        report = {}
        if kind == "rk3":
            A, steps = kw["acoustic_steps"], kw["steps"]
            rk3 = RK3Integrator(nx, ny, nz, case.flags, acoustic_steps=A,
                                snapshot="base", device=device, mesh=mesh,
                                halo_backend=kw.get("halo_backend",
                                                    "ppermute"))
            arrays = _assemble(rk3.loops[0], dom, mesh, multihost)
            dt = case.dts * A
            fn = NudgingTendencies(arrays, dt, tau_steps=5.0)
            diags, step_ms = [], []
            for _ in range(steps):
                _sync(device)
                ts = time.perf_counter()
                arrays, d = rk3.multi_step(arrays, 1, case.rdx, case.rdy, dt,
                                           case.epssm, tendency_fn=fn)
                _sync(device)
                step_ms.append(1e3 * (time.perf_counter() - ts))
                diags.append(d)
            out = rk3.unprepare(arrays, ("t", "mu", "u"))
            out["diags"] = torch.from_numpy(np.concatenate(diags))
            report["step_ms"] = step_ms
            names = ("t", "mu", "u", "diags")
        elif kind == "exchange":
            loop = ShardedAdvanceMuT(nx, ny, nz, case.flags, device=device,
                                     mesh=mesh)
            out = _exchanges(mesh, device,
                             _assemble(loop, dom, mesh, multihost), report,
                             kw["repeats"])
            names = tuple(out)
        elif kind == "rdma exchange":
            loop = ShardedAdvanceMuT(nx, ny, nz, case.flags, device=device,
                                     mesh=mesh)
            out = _rdma_exchanges(mesh, device,
                                  _assemble(loop, dom, mesh, multihost),
                                  report, kw["repeats"])
            names = tuple(out)
        else:
            if kind == "coupled":
                loop = SmallStepLoop(nx, ny, nz, case.flags, device=device,
                                     mesh=mesh, **kw)
            else:
                loop = ShardedAdvanceMuT(nx, ny, nz, case.flags,
                                         vary_winds=True, device=device,
                                         mesh=mesh, **kw)
            out = loop(_assemble(loop, dom, mesh, multihost), case.rdx,
                       case.rdy, case.dts, case.epssm)
            names = ("t", "mu", "ww")
        _sync(device)
        report["ms"] = 1e3 * (time.perf_counter() - t0)
        report["launches"] = {k: getattr(mod, attr)
                              for k, (mod, attr) in counters.items()}
        for name in names:
            results[f"{tag}/{name}"] = out[name].cpu().numpy()
        reports[tag] = report
    return results, reports


def _exchanges(mesh, device, arrays, report, repeats: int) -> dict:
    """The transport alone: ``repeats`` 1-cell j refreshes of v's padded
    blocks (a row of nz x the block's width per message) and of mu's (one
    row), an i refresh of mu, and ``repeats // 4`` gathers of t; ``report``
    gets the ms of one of each and the bytes this rank sends for it to
    other ranks (for a gather, its blocks to each other rank)."""
    from wrf_tpu_torch.parallel import halo
    from wrf_tpu_torch.parallel.sharded import gather, pad_local

    j_sh, i_sh = mesh.shape[0] > 1, mesh.shape[1] > 1
    local = pad_local({k: arrays[k] for k in ("v", "mu")}, mesh, j_sh, i_sh)
    v = {c: p["v"] for c, p in local.items()}
    mu = {c: p["mu"] for c, p in local.items()}
    nj_loc = next(iter(v.values())).shape[0] - 2
    ni_loc = next(iter(mu.values())).shape[1] - 2
    t = arrays["t"]
    nranks = len({mesh.owner(c) for c in mesh.coords()})

    def sent(blocks, axis, axis_name):
        """Bytes this rank sends to other ranks in one exchange of one cell
        of ``blocks`` along ``axis``."""
        x = next(iter(blocks.values()))
        return x.narrow(axis, 0, 1).numel() * 4 * sum(
            mesh.owner(mesh.neighbour(c, axis_name, d)) != mesh.rank
            for c in blocks for d in (-1, 1))

    first = next(iter(v))
    for name, fn, n, nbytes in (
            ("v j", lambda: halo.refresh_axis(v, 0, "j", mesh, nj_loc),
             repeats, sent(v, 0, "j") if j_sh else 0),
            ("mu j", lambda: halo.refresh_axis(mu, 0, "j", mesh, nj_loc),
             repeats, sent(mu, 0, "j") if j_sh else 0),
            ("mu i", lambda: halo.refresh_axis(mu, 1, "i", mesh, ni_loc),
             repeats, sent(mu, 1, "i") if i_sh else 0),
            ("t gather", lambda: gather(t, mesh), max(1, repeats // 4),
             t[first].numel() * 4 * len(t) * (nranks - 1))):
        fn()    # the first call pays for the buffers
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(device)
        report[f"{name} ms"] = 1e3 * (time.perf_counter() - t0) / n
        report[f"{name} bytes sent"] = nbytes
    return {"v": gather(v, mesh), "mu": gather(mu, mesh),
            "t": gather(t, mesh)}


def rdma_rows_input(v: dict, nj_loc: int) -> dict:
    """Every shard's 2-slot staging buffer of ``rdma_rows`` from its padded
    ``v`` block: its last interior row (slot 0, for the next shard) and its
    first (slot 1, for the previous one), as the TPU wrapper stages them."""
    return {c: torch.stack([b[nj_loc], b[1]]) for c, b in v.items()}


def _rdma_exchanges(mesh, device, arrays, report, repeats: int) -> dict:
    """The rdma transport alone, across processes through the mailboxes:
    ``rdma_rows`` of v's staged edge rows, and ``remote_refresh_multi`` of
    the j halos of mu and v (v's high halo only, as the coupled loop
    refreshes it), once each and then ``repeats`` times timed; ``report``
    gets the ms of one of each.  Returns the received rows and the
    refreshed blocks, gathered."""
    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel.sharded import gather, pad_local

    local = pad_local({k: arrays[k] for k in ("v", "mu")}, mesh,
                      mesh.shape[0] > 1, mesh.shape[1] > 1)
    v = {c: p["v"] for c, p in local.items()}
    mu = {c: p["mu"] for c, p in local.items()}
    nj_loc = next(iter(v.values())).shape[0] - 2
    rows = rdma_rows_input(v, nj_loc)
    got = {}
    for name, fn in (
            ("rdma_rows", lambda: got.__setitem__(
                "rows", k5.rdma_rows(rows, "j", mesh))),
            ("remote_refresh_multi", lambda: k5.remote_refresh_multi(
                [mu, v], "j", mesh, nj_loc, recv_only=("", "hi")))):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        _sync(device)
        report[f"{name} ms"] = 1e3 * (time.perf_counter() - t0) / repeats
    return {"rows": gather(got["rows"], mesh), "mu": gather(mu, mesh),
            "v": gather(v, mesh)}


def domains(progs) -> dict:
    """``{(grid, case): (what the programs read of the fixture case beside
    its arrays, its ring-shaped arrays)}`` for ``progs``."""
    from wrf_tpu_torch.parallel.sharded import case_to_domain

    out = {}
    for _, _, grid, _, which in progs:
        if (grid, which) not in out:
            case = _case(grid, which)
            info = SimpleNamespace(flags=case.flags, rdx=case.rdx,
                                   rdy=case.rdy, dts=case.dts,
                                   epssm=case.epssm)
            out[grid, which] = (info, case_to_domain(case))
    return out


def _mesh_shape(spec: str) -> tuple[int, int]:
    nj, ni = (int(x) for x in spec.lower().split("x"))
    return nj, ni


def _rank_device(device: str, backend: str, rank: int) -> str:
    if device == "cpu":
        return "cpu"
    if backend == "nccl":   # one card per rank
        return f"cuda:{rank % torch.cuda.device_count()}"
    return "cuda:0"


def worker(rank: int, nproc: int, workdir: str) -> int:
    """One rank: join the group, run the programs across the processes,
    write rank 0's results and every rank's report into ``workdir``."""
    from wrf_tpu_torch.parallel import distributed

    cfg = json.loads((Path(workdir) / "config.json").read_text())
    if cfg["device"] == "cpu":
        torch.set_num_threads(1)
    progs = suite(cfg["suite"], cfg["grid"])
    distributed.initialize(
        backend=cfg["backend"], init_method=f"file://{workdir}/pg",
        world_size=nproc, rank=rank,
        timeout=timedelta(seconds=cfg["timeout"]))
    nj, ni = cfg["mesh"]
    if (nj * ni) % nproc:
        raise ValueError(f"{nj}x{ni} shards do not divide over {nproc} ranks")
    device = _rank_device(cfg["device"], cfg["backend"], rank)
    mesh = distributed.global_mesh((nj, ni),
                                   devices=[device] * (nj * ni // nproc))
    with open(Path(workdir) / "domains.pkl", "rb") as f:
        doms = pickle.load(f)
    results, reports = compute(mesh, device, progs, doms, multihost=True)
    if rank == 0:
        np.savez(Path(workdir) / "mh.npz", **results)
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(
        {"rank": rank, "device": device, "shards": mesh.local_coords(),
         "programs": reports}))
    distributed.close_mailboxes(mesh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    borrowed = [m for m in sys.modules
                if m == "jax" or m == "wrf_tpu" or m.startswith("wrf_tpu.")]
    if borrowed:
        raise AssertionError(f"worker {rank}: jax or the JAX package was "
                             f"imported: {borrowed}")
    print(f"worker {rank} done", flush=True)
    return 0


def _worker_env() -> dict:
    """This environment, with the repository on the module path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _wait_all(procs, timeout: float) -> None:
    """Wait for every worker; the first failure or the time limit kills
    the rest and raises."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if bad:
                raise RuntimeError(f"a worker failed (exit codes "
                                   f"{[p.poll() for p in procs]})")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the workers did not finish within "
                                   f"{timeout:.0f} s")
            time.sleep(0.05)
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"a worker failed (exit codes {codes})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def bit_differences(a: np.ndarray, b: np.ndarray) -> int:
    """Elements whose bits differ (NaN equals a NaN of the same bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.size, b.size)
    width = {4: np.uint32, 8: np.uint64}[a.dtype.itemsize]
    return int(np.count_nonzero(a.view(width) != b.view(width)))


def _require_device(device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (use --device cpu)")


def reference(progs, doms, device: str, mesh_shape, nproc: int,
              backend: str = "gloo"):
    """The one-process run of ``progs`` on a ``mesh_shape`` mesh whose
    shards sit on the devices the ranks would use: ``(results, reports)``."""
    from wrf_tpu_torch.parallel.mesh import make_mesh

    _require_device(device)

    nj, ni = mesh_shape
    devices = [_rank_device(device, backend, r)
               for r in range(nproc) for _ in range(nj * ni // nproc)]
    return compute(make_mesh(devices, (nj, ni)), devices[0], progs, doms,
                   multihost=False)


def run(nproc: int = 2, device: str = "cuda", *, suite_name: str = "jax",
        grid=None, mesh_shape=(2, 4), backend: str = "gloo",
        timeout: float = 600.0, doms=None, ref=None) -> dict:
    """The one-process run here (or ``ref``, :func:`reference`'s, on the
    fixture arrays ``doms``), then ``nproc`` workers; returns
    ``{"different": {field: count}, "shapes": ..., "reference": {tag:
    report}, "ranks": [rank report]}``.  Raises when a worker fails or
    exceeds ``timeout`` seconds."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"bad backend {backend!r}: gloo or nccl")
    _require_device(device)
    progs = suite(suite_name, grid)
    nj, ni = mesh_shape
    if (nj * ni) % nproc:
        raise ValueError(f"{nj}x{ni} shards do not divide over {nproc} ranks")
    doms = domains(progs) if doms is None else doms
    ref, ref_reports = (reference(progs, doms, device, mesh_shape, nproc,
                                  backend) if ref is None else ref)
    with tempfile.TemporaryDirectory(prefix="multihost_") as tmp:
        with open(Path(tmp) / "domains.pkl", "wb") as f:
            pickle.dump(doms, f, protocol=pickle.HIGHEST_PROTOCOL)
        (Path(tmp) / "config.json").write_text(json.dumps(
            {"suite": suite_name, "grid": list(grid) if grid else None,
             "mesh": [nj, ni], "device": device, "backend": backend,
             "timeout": timeout}))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "wrf_tpu_torch.tools.multihost_check",
             "worker", str(r), str(nproc), tmp], env=_worker_env())
            for r in range(nproc)]
        _wait_all(procs, timeout)
        with np.load(Path(tmp) / "mh.npz") as mh:
            got = {k: mh[k] for k in mh.files}
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(nproc)]
    if got.keys() != ref.keys():
        raise AssertionError(f"fields {sorted(got)} != {sorted(ref)}")
    return {"different": {k: bit_differences(got[k], ref[k]) for k in ref},
            "shapes": {k: ref[k].shape for k in ref},
            "reference": ref_reports, "ranks": ranks}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["worker"]:
        return worker(int(argv[1]), int(argv[2]), argv[3])
    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.multihost_check",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2, choices=(1, 2, 4, 8))
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--grid", type=lambda s: tuple(int(x) for x in
                                                   s.lower().split("x")),
                    default=None, help="NXxNYxNZ for every program")
    ap.add_argument("--mesh", type=_mesh_shape, default=(2, 4))
    ap.add_argument("--suite", choices=("jax", "chip"), default="jax")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the workers may take together")
    ap.add_argument("--save-reference", metavar="PATH", default=None,
                    help="write the one-process results (one array per "
                         "program and field) to this .npz")
    a = ap.parse_args(argv)
    doms = domains(suite(a.suite, a.grid))
    ref = None
    if a.save_reference:
        ref = reference(suite(a.suite, a.grid), doms, a.device, a.mesh,
                        a.nproc, a.backend)
        np.savez(a.save_reference, **ref[0])
    res = run(a.nproc, a.device, suite_name=a.suite, grid=a.grid,
              mesh_shape=a.mesh, backend=a.backend, timeout=a.timeout,
              doms=doms, ref=ref)
    for rep in res["ranks"]:
        for tag, r in rep["programs"].items():
            extra = {k: v for k, v in r.items()
                     if k not in ("ms", "launches")}
            print(f"rank {rep['rank']} ({rep['device']}, shards "
                  f"{rep['shards']}) {tag}: launches {r['launches']}, "
                  f"{r['ms']:.1f} ms" + (f", {extra}" if extra else ""))
    bad = 0
    for name, d in res["different"].items():
        if d:
            bad += 1
            print(f"DIFF {name}: different={d} of {res['shapes'][name]}")
        else:
            print(f"OK   {name}: {a.nproc}-process == one-process "
                  f"(bit-equal, {res['shapes'][name]})")
    if bad:
        print(f"MULTIHOST FAILED ({bad} fields differ)")
        return 1
    print(f"MULTIHOST OK ({a.nproc} processes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
