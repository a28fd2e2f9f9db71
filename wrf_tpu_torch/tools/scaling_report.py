"""Scaling report: what the mesh loop's exchanges send, per substep and per
shard, across mesh shapes.

Port of ``tools/scaling_report.py``.  The JAX tool reads the compiled SPMD
program's collective-permutes; the port has no compiled program, so it
counts what its own exchanges move (``parallel/halo.py::SENT``): the
messages (one slab that one shard receives from one neighbour) and bytes of
every ``exchange_axis``, ``refresh_axis``/``refresh_axis_w`` and
``widen_ring_to`` call, and K5's segments and bytes.  A loop is run at two
step counts (two block counts for the trapezoid) and the difference is
what one substep (one block) sends; what is left of the shorter run is
the one-time set-up (the halo construction and the final substep, as the
JAX tool counts the permutes outside its scan).

    python -m wrf_tpu_torch.tools.scaling_report [nx ny nz steps]  # 64 64 16 4
    python -m wrf_tpu_torch.tools.scaling_report --device cuda

By default every shard sits on the CPU (the CPU device repeated, as the
JAX tool's virtual devices) and the kernels' plain versions run; the
counts do not depend on the device.  ``--device cuda`` builds each mesh on
the visible cards (wrapping round, as ``run_sim --mesh``) and also counts
K5's launches.
"""

from __future__ import annotations

import argparse

#: the JAX tool's meshes
MESHES = ((1, 1), (2, 2), (4, 2), (8, 1))
#: the depth of the trapezoid it reports, and on which meshes
TRAPEZOID_S = 4
TRAPEZOID_MESHES = ((2, 2), (4, 2))


def _sent(loop, arrays, case) -> tuple[dict, int]:
    """What one call of ``loop`` sends: ``SENT``'s difference around it,
    and K5's launches."""
    from ..ops import halo_rdma_cuda as k5
    from ..parallel import halo

    before, launches = dict(halo.SENT), k5.LAUNCHES
    loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    after = dict(halo.SENT)
    return ({k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}, k5.LAUNCHES - launches)


def analyze(case, mesh_shape, steps, with_w=False, inner_steps=1,
            device="cpu", halo_backend="ppermute") -> dict:
    """The exchanges of ``SmallStepLoop`` on ``mesh_shape`` per shard:
    ``collectives_per_substep`` messages (per block of ``inner_steps``
    substeps when blocked) moving ``halo_bytes_per_substep`` bytes, and
    ``setup_collectives``: the JAX tool's keys, each message counted
    where the JAX tool counts a collective-permute.  ``by_kind`` splits
    the per-substep (per-block) messages and bytes by the exchange and
    the mesh axis that sent them (``"refresh_axis_w j"``, ``"rdma j"``),
    and ``k5_launches_per_substep`` counts K5's launches (on
    the card; 0 on the CPU, where the plain version runs)."""
    from ..models.small_step import SmallStepLoop
    from ..parallel.mesh import mesh_from_spec
    from ..parallel.sharded import case_to_domain

    mesh = mesh_from_spec(f"{mesh_shape[0]}x{mesh_shape[1]}", device)
    n_shards = mesh_shape[0] * mesh_shape[1]
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    S = inner_steps
    counts = (steps, steps + S)   # one more substep, or one more block
    sent, launches = {}, {}
    arrays = None
    for n in counts:
        loop = SmallStepLoop(nx, ny, nz, case.flags, n_steps=n,
                             with_w=with_w, inner_steps=S, mesh=mesh,
                             device=mesh.device((0, 0)),
                             halo_backend=halo_backend)
        if arrays is None:
            arrays = loop.prepare(case_to_domain(case, with_w=with_w))
        sent[n], launches[n] = _sent(loop, arrays, case)

    def total(n, what):
        return sum(v for (_, w), v in sent[n].items() if w == what)

    per = {w: total(counts[1], w) - total(counts[0], w)
           for w in ("messages", "bytes")}
    n_periodic = (steps - 1) // S   # substeps (blocks) before the final one
    kinds = {k for k, _ in sent[counts[1]]}
    by_kind = {k: {w: (sent[counts[1]].get((k, w), 0)
                       - sent[counts[0]].get((k, w), 0)) // n_shards
                   for w in ("messages", "bytes")} for k in sorted(kinds)}
    return dict(
        mesh=mesh_shape,
        collectives_per_substep=per["messages"] // n_shards,
        halo_bytes_per_substep=per["bytes"] // n_shards,
        setup_collectives=(total(counts[0], "messages")
                           - n_periodic * per["messages"]) // n_shards,
        by_kind={k: v for k, v in by_kind.items() if v["messages"]},
        k5_launches_per_substep=launches[counts[1]] - launches[counts[0]],
    )


def _kib(nbytes) -> str:
    return f"{nbytes / 1024:.1f} KiB" if nbytes else "0"


def main(argv=None) -> int:
    from ..io import fixtures
    from .probe_2d import device_or_exit

    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.scaling_report",
        description="Messages and bytes per substep and per shard of the "
                    "mesh loop's exchanges, per mesh shape.")
    ap.add_argument("grid", type=int, nargs="*", default=[],
                    help="nx ny nz steps (default 64 64 16 4)")
    ap.add_argument("--device", default="cpu",
                    help="cpu (default: every shard on the CPU) or cuda")
    args = ap.parse_args(argv)
    nx, ny, nz, steps = args.grid + [64, 64, 16, 4][len(args.grid):]
    device = device_or_exit("scaling_report", args.device)
    case = fixtures.make_case(nx, ny, nz, halo=2, seed=5)
    print(f"domain {nx}x{ny}x{nz}, {steps} substeps per call, shards on "
          f"{device}")
    for shape in MESHES:
        r = analyze(case, shape, steps, device=device)
        print(f"  mesh {shape}: {r['collectives_per_substep']} in-loop "
              f"messages/substep moving {_kib(r['halo_bytes_per_substep'])}"
              f"/shard, {r['setup_collectives']} one-time setup messages")
        if r["by_kind"]:
            print("    " + ", ".join(
                f"{k} {v['messages']} ({_kib(v['bytes'])})"
                for k, v in r["by_kind"].items()))
        if shape != (1, 1):
            k = analyze(case, shape, steps, device=device,
                        halo_backend="rdma")
            k5 = k["by_kind"].get("rdma j", {"messages": 0, "bytes": 0})
            where = ("on the card(s)" if device.type == "cuda"
                     else "the plain version on the CPU: no launch")
            print(f"    --halo-backend rdma: K5 moves the j rows, "
                  f"{k5['messages']} segments/substep, {_kib(k5['bytes'])}"
                  f"/shard, in {k['k5_launches_per_substep']} launches/"
                  f"substep ({where})")
    print("(volumes are per shard per substep and independent of mesh size —"
          " the flat-extrapolation premise of SCALING.md)")

    # the depth-S trapezoid: one width-S exchange of mu, u and v per axis
    # per BLOCK of S substeps, at S times the width
    S = TRAPEZOID_S
    print(f"depth-{S} trapezoid (inner_steps={S}):")
    for shape in TRAPEZOID_MESHES:
        r = analyze(case, shape, steps=4 * S + 1, inner_steps=S,
                    device=device)
        per_sub = r["collectives_per_substep"] / S
        print(f"  mesh {shape}: {r['collectives_per_substep']} "
              f"messages/block = {per_sub:.1f}/substep moving "
              f"{_kib(r['halo_bytes_per_substep'] / S)}/shard/substep")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
