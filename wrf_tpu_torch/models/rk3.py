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
stage, blocked or not: K3 carries its own width-S exchange; on a mesh over
processes on one host the rdma backends reach a j neighbour in another
process through its mailbox, and across hosts each stage's loop refuses
them), except that a
stage whose blocked path engages under plain ``rdma`` downgrades to the
width-S ppermute refresh, loudly (there is no width-S exchange kernel).
``const_dtype`` (bf16 constant streams) passes to every stage's loop.
The three loops share loop 0's memo (``models/stage_memo.py``): a stage
pads, and builds lean constants and Thomas K-vectors, only for inputs no
stage has met since they last changed.

``step(..., tendency_fn)`` takes the slow-tendency hook: before each stage
``tendency_fn(stage, prev_stage_out, stage_arrays)`` returns replacement
``ft``/``mu_tend`` fields (the nudging closure of models/tendencies.py).
``multi_step`` runs several large steps (step, merge, wind damping) with
no host synchronisation between them and reads the per-step diagnostics
back once at the end; the JAX package scans them in one compiled program,
here the same launches run eagerly, so the result equals host stepping
bit for bit.

While a ``torch.profiler`` records, ``step`` is a ``wrf.rk3.step`` span
with a ``wrf.closure.tendency`` span around each ``tendency_fn`` call and
each stage's loop spans inside, and ``merge_evolved`` a ``wrf.rk3.merge``
span (``utils/timing.py::span``; device time on the first local shard's
card).

``snapshot="base"`` with the nudging closure and a balanced fixture
integrates indefinitely (100/100 steps in ``tests/test_torch_closure.py``);
``snapshot="stage"`` amplifies the state ~5e4x per large step and is for
bounded-horizon structure tests only (``wrf_tpu/models/rk3.py``).

:func:`rk3_golden` and :func:`rk3_golden_run` are the numpy golden
integrations on memory-window arrays, over
``models/small_step.py::small_step_golden``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..grid import ConfigFlags
from ..ops.advance_uv import DEFAULT_CS2
from ..parallel.sharded import as_blocks, merge_interior
from ..utils.timing import span
from .small_step import SmallStepLoop, small_step_golden

#: large-step fields re-snapshotted at every stage start in "stage" mode
_STAGE_SNAPSHOT = {"u_1": "u", "v_1": "v", "t_1": "t", "ww_1": "ww"}


def rk3_stages(acoustic_steps: int) -> tuple[tuple[float, int], ...]:
    """(stage_dt_fraction, substeps) per stage, WRF convention."""
    ns = max(2, acoustic_steps)
    return ((1.0 / 3.0, 1), (0.5, max(1, ns // 2)), (1.0, ns))


class RK3Integrator:
    """One RK3 large step over the (mesh-decomposed) acoustic loop.

    The slow tendencies (``ft``, ``mu_tend``) keep their prepared values
    unless a ``tendency_fn`` replaces them before each stage."""

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

        def stage_loop(n_sub: int, memo=None) -> SmallStepLoop:
            return SmallStepLoop(
                nx, ny, nz, flags, n_steps=n_sub, kernel=kernel,
                device=device, inner_steps=inner_steps, fast=fast,
                with_w=with_w, smdiv=smdiv, mesh=mesh,
                halo_backend=stage_backend(n_sub), const_dtype=const_dtype,
                memo=memo)

        first = stage_loop(self.stages[0][1])
        self.loops = [first] + [stage_loop(n_sub, first.memo)
                                for _, n_sub in self.stages[1:]]
        self.prepare = self.loops[0].prepare
        self.unprepare = self.loops[0].unprepare

    def step(self, arrays, rdx, rdy, dt, epssm,
             tendency_fn: Callable | None = None):
        """Advance one large step dt; returns the stage-3 outputs
        (domain-shaped).  ``arrays`` are prepared ring-shaped tensors; every
        stage restarts from them and none is modified.
        ``tendency_fn(stage, prev_stage_out, stage_arrays)`` receives the
        previous stage's provisional (domain-shaped) outputs, None at stage
        0, and returns replacement prepared slow-tendency fields
        (``ft``/``mu_tend``)."""
        dev = self.loops[0].span_device
        with span("wrf.rk3.step", device=dev):
            out = None
            for stage, ((frac, n_sub), loop) in enumerate(
                    zip(self.stages, self.loops)):
                stage_arrays = dict(arrays)  # restart from step-start state
                if self.snapshot == "stage":
                    for snap, src in _STAGE_SNAPSHOT.items():
                        stage_arrays[snap] = arrays[src]
                # "base": the *_1 advecting fields keep their prepared values
                if tendency_fn is not None:
                    with span("wrf.closure.tendency", device=dev):
                        stage_arrays.update(
                            tendency_fn(stage, out, stage_arrays))
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
        with span("wrf.rk3.merge", device=loop.span_device):
            for name in self._EVOLVED:
                if name not in out or name not in arrays:
                    continue
                blocks = as_blocks({name: arrays[name]}, loop.mesh,
                                   loop._blocks)[name]
                merged = merge_interior(blocks, out[name])
                new[name] = merged if loop._blocks else merged[0, 0]
        return new

    def multi_step(self, arrays, n_steps: int, rdx, rdy, dt, epssm,
                   tendency_fn: Callable | None = None,
                   readback: bool = True):
        """Run ``n_steps`` large steps with no host synchronisation between
        them: each is :meth:`step`, :meth:`merge_evolved` and the closure's
        wind damping, and its diagnostics are reduced on the device.

        Returns ``(arrays, diags)``: the input dict with the evolved fields
        advanced ``n_steps``, and a float32 ``(n_steps, 2)`` array of
        per-step ``[sum(mu), sum(t[:, 0, :])]`` over the domain — the
        mass-perturbation series and a NaN-tripwire checksum — stacked on
        the device and read back once, at the end (``readback=False``
        leaves it there as a tensor).  The caller adds the constant
        ``sum(mut)`` in float64; the float32 sums may differ from a host
        path's float64 ones in their last places.

        The JAX package traces the chunk into one cached program and
        rebinds the closure's references for the trace; here the same
        launches run eagerly, with nothing cached and nothing rebound, so
        the state equals host stepping bit for bit."""
        diags = []
        for _ in range(n_steps):
            out = self.step(arrays, rdx, rdy, dt, epssm,
                            tendency_fn=tendency_fn)
            arrays = self.merge_evolved(arrays, out)
            if tendency_fn is not None:
                tendency_fn.damp_winds(arrays)
            diags.append(torch.stack([
                out["mu"].sum(dtype=torch.float32),
                out["t"][:, 0, :].sum(dtype=torch.float32)]))
        diags = torch.stack(diags)
        return arrays, (diags.cpu().numpy() if readback else diags)


def rk3_golden(case, acoustic_steps: int = 6, dt: float | None = None,
               cs2: float = DEFAULT_CS2, with_w: bool = False,
               smdiv: float = 0.0, snapshot: str = "base"):
    """Golden-path RK3 step on memory-window arrays (single tile): the
    port of ``wrf_tpu.models.rk3.rk3_golden``."""
    dt = dt if dt is not None else case.dts * acoustic_steps
    snap = (("u", "grid_u_2"), ("v", "grid_v_2"), ("t", "grid_t_2"),
            ("ww", "grid_ww"), ("mu", "grid_mu_2"), ("t_ave", "t_2save"))
    if with_w:
        snap += (("w", "grid_w"), ("pp", "grid_pp"))
    start = {k: np.asarray(case.fields[n]) for k, n in snap}
    out = None
    for (frac, n_sub) in rk3_stages(acoustic_steps):
        # every stage restarts from the step-start state
        stage_fields = dict(case.fields)
        for k, n in snap:
            stage_fields[n] = start[k]
        if snapshot == "stage":  # degenerate: *_1 := coupled state
            stage_fields["grid_u_save"] = start["u"]
            stage_fields["grid_v_save"] = start["v"]
            stage_fields["grid_t_save"] = start["t"]
            stage_fields["ww1"] = start["ww"]
        # "base": the *_1 advecting fields keep the fixture base state
        stage_case = dataclasses.replace(case, fields=stage_fields,
                                         dts=(frac * dt) / n_sub)
        out = small_step_golden(stage_case, n_sub, cs2=cs2, with_w=with_w,
                                smdiv=smdiv)
    return out


def rk3_golden_run(case, n_large_steps: int, acoustic_steps: int = 6,
                   dt: float | None = None, cs2: float = DEFAULT_CS2,
                   with_w: bool = False, smdiv: float = 0.0,
                   snapshot: str = "base", tendency_fn=None,
                   rayleigh_uv: float = 0.0, diag_cb=None):
    """Multi-large-step golden integration with the closed-loop slow
    forcing — the anchor of ``run_sim``'s long-horizon mode; the port of
    ``wrf_tpu.models.rk3.rk3_golden_run``.  ``tendency_fn(fields) ->
    {"t_tend": ..., "mu_tend": ...}`` is recomputed once per large step
    (:func:`wrf_tpu_torch.models.tendencies.golden_nudging_fn`);
    ``rayleigh_uv`` damps the perturbation winds by ``1-r`` per step.
    ``diag_cb(step, out)``, if given, observes every step's outputs.
    Returns the final step's output dict."""
    dt = dt if dt is not None else case.dts * acoustic_steps
    fields = dict(case.fields)
    fold = (("u", "grid_u_2"), ("v", "grid_v_2"), ("t", "grid_t_2"),
            ("ww", "grid_ww"), ("mu", "grid_mu_2"), ("t_ave", "t_2save"))
    if with_w:
        fold += (("w", "grid_w"), ("pp", "grid_pp"))
    out = None
    for step in range(n_large_steps):
        if tendency_fn is not None:
            fields.update(tendency_fn(fields))
        out = rk3_golden(
            dataclasses.replace(case, fields=fields),
            acoustic_steps=acoustic_steps, dt=dt, cs2=cs2, with_w=with_w,
            smdiv=smdiv, snapshot=snapshot)
        for key, name in fold:
            fields[name] = out[key]
        if rayleigh_uv:
            d = np.float32(1.0 - rayleigh_uv)
            fields["grid_u_2"] = fields["grid_u_2"] * d
            fields["grid_v_2"] = fields["grid_v_2"] * d
        if diag_cb is not None:
            diag_cb(step, out)
    return out
