"""RK3 large-step shell around the acoustic small-step loop.

Port of ``wrf_tpu/models/rk3.py`` (``rk3_stages``, ``RK3Integrator``).  WRF
integrates the large step with the Wicker–Skamarock three-stage
Runge–Kutta scheme; each stage restarts from the large-step-start state and
sub-cycles the acoustic loop over the stage interval:

    stage 1: dt/3, 1 acoustic substep
    stage 2: dt/2, ns/2 substeps
    stage 3: dt,   ns substeps

``snapshot="base"`` (the default) keeps the ``*_1`` advecting fields at
the prepared base state; ``snapshot="stage"`` re-snapshots them from the
stage-start state (``u_1 := u`` etc.), the degenerate shell ``run_sim``
runs without a closure.  ``inner_steps`` and ``fast`` pass to every
stage's loop (a stage too short to block runs K1 only); ``with_w`` adds
the vertically-implicit w/pp substep to every substep, and w and pp join
the evolved state; ``smdiv`` turns on divergence damping in every stage's
loop (each stage starts from a zero ``mudf``).  ``mesh`` and
``halo_backend`` pass to every stage's loop too (``rdma_overlap`` to every
stage, blocked or not: K3 carries its own width-S exchange), except that a
stage whose blocked path engages under plain ``rdma`` downgrades to the
width-S ppermute refresh, loudly (there is no width-S exchange kernel).
``const_dtype`` (bf16 constant streams) passes to every stage's loop.  The
slow-tendency hook (``tendency_fn``), the closures
that use it and the device-resident ``multi_step`` are not ported yet.
"""

from __future__ import annotations

import warnings

from ..grid import ConfigFlags
from ..parallel.sharded import as_blocks, merge_interior
from .small_step import SmallStepLoop

#: large-step fields re-snapshotted at every stage start in "stage" mode
_STAGE_SNAPSHOT = {"u_1": "u", "v_1": "v", "t_1": "t", "ww_1": "ww"}


def rk3_stages(acoustic_steps: int) -> tuple[tuple[float, int], ...]:
    """(stage_dt_fraction, substeps) per stage, WRF convention."""
    ns = max(2, acoustic_steps)
    return ((1.0 / 3.0, 1), (0.5, max(1, ns // 2)), (1.0, ns))


class RK3Integrator:
    """One RK3 large step over the (mesh-decomposed) acoustic loop; the
    slow tendencies (``ft``, ``mu_tend``) keep their prepared values."""

    #: large-step evolved state, written back into the ring interior
    #: between steps (run_sim shares this list)
    _EVOLVED = ("ww", "mu", "t", "t_ave", "u", "v", "w", "pp")

    def __init__(self, nx, ny, nz, flags: ConfigFlags,
                 acoustic_steps: int = 6, kernel: str = "cuda",
                 snapshot: str = "base", device="cuda",
                 inner_steps: int = 1, fast: bool = False,
                 with_w: bool = False, smdiv: float = 0.0, *, mesh=None,
                 halo_backend: str = "ppermute", const_dtype=None):
        if snapshot not in ("stage", "base"):
            raise ValueError(f"bad snapshot mode {snapshot!r}")
        self.snapshot = snapshot
        self.stages = rk3_stages(acoustic_steps)

        def stage_backend(n_sub: int) -> str:
            # downgrade only the stages whose blocked path actually
            # engages (rem = n_sub-1 >= S); shorter stages run the
            # supported per-substep rdma exchange untouched
            if (halo_backend == "rdma" and inner_steps > 1
                    and n_sub - 1 >= inner_steps):
                warnings.warn(
                    "RK3 blocked stage (inner_steps="
                    f"{inner_steps}, n_sub={n_sub}): halo_backend "
                    "'rdma' has no width-S block exchange — this "
                    "stage uses the width-S ppermute refresh instead "
                    "(use 'rdma_overlap' for an in-kernel blocked "
                    "exchange)", stacklevel=3)
                return "ppermute"
            return halo_backend

        self.loops = [
            SmallStepLoop(nx, ny, nz, flags, n_steps=n_sub, kernel=kernel,
                          device=device, inner_steps=inner_steps, fast=fast,
                          with_w=with_w, smdiv=smdiv, mesh=mesh,
                          halo_backend=stage_backend(n_sub),
                          const_dtype=const_dtype)
            for (_, n_sub) in self.stages
        ]
        self.prepare = self.loops[0].prepare
        self.unprepare = self.loops[0].unprepare

    def step(self, arrays, rdx, rdy, dt, epssm):
        """Advance one large step dt; returns the stage-3 outputs
        (domain-shaped).  ``arrays`` are prepared ring-shaped tensors; every
        stage restarts from them and none is modified."""
        out = None
        for (frac, n_sub), loop in zip(self.stages, self.loops):
            stage_arrays = dict(arrays)  # restart from step-start state
            if self.snapshot == "stage":
                for snap, src in _STAGE_SNAPSHOT.items():
                    stage_arrays[snap] = arrays[src]
            dts = (frac * dt) / n_sub
            out = loop(stage_arrays, rdx, rdy, dts, epssm)
        return out

    def merge_evolved(self, arrays, out):
        """Fold ``out``'s domain-shaped evolved fields back into the ring
        interiors of ``arrays`` (returns a new dict of new tensors; works on
        full prepared dicts and on evolved-only state dicts alike, and on a
        mesh shard by shard)."""
        loop = self.loops[0]
        new = dict(arrays)
        for name in self._EVOLVED:
            if name not in out or name not in arrays:
                continue
            blocks = as_blocks({name: arrays[name]}, loop.mesh,
                               loop._blocks)[name]
            merged = merge_interior(blocks, out[name])
            new[name] = merged if loop._blocks else merged[0, 0]
        return new
