"""Slow-tendency closures for long-horizon RK3 integration.

Port of ``wrf_tpu/models/tendencies.py``.  The reference sample runs ONE
acoustic substep and stops; its capability set contains no
advection/physics packages, so nothing recomputes the slow tendencies
(``ft``, ``mu_tend``) or the advecting base state (the ``*_1`` fields)
between large steps.  Naively re-snapshotting ``u_1 := u`` per stage (the
degenerate shell, see models/rk3.py) is violently unstable: the ``*_1``
slots expect UNCOUPLED winds (m/s scale) while the evolved ``u`` is
mass-coupled (``~mut*u``, 5e4x larger), so the mass flux
``u + muu*u_1/msfuy`` amplifies by ~5e4 every large step.

This module ships the minimal CONSISTENT closure that makes ``run_sim``
integrate indefinitely:

* **base-state freeze** (``RK3Integrator(snapshot="base")``): the ``*_1``
  advecting fields stay at the prepared base state.  The acoustic system
  then has constant coefficients — the (u, v, mu) pressure/divergence loop
  has per-substep gain ``(dts*rdx)^2 * cs2 * mut ~ 0.035`` (stable), theta
  is passively advected, and the only secular terms are boundary fluxes;
* **nudging tendencies** (:class:`NudgingTendencies`): ``ft`` and
  ``mu_tend`` recomputed every large step as Rayleigh relaxation toward
  the reference state, ``(x_ref - x)/tau`` — the standard analysis-nudging
  closure (WRF's own grid/spectral nudging has this exact form), which
  bounds the secular boundary-flux drift at ``~flux_rate*tau``;
* **Rayleigh wind damping** (:meth:`NudgingTendencies.damp_winds`):
  optional per-large-step ``u,v *= 1-r`` on the perturbation winds, the
  acoustic-energy sink WRF delegates to its damping layers;
* **balanced base winds** (:func:`wrf_tpu_torch.io.fixtures.make_case`
  ``balanced=True``): ``u_1``/``v_1`` minted from a streamfunction so the
  coupled base mass flux is DISCRETELY non-divergent — the constant part
  of ``dmdt`` vanishes cell-by-cell and the base state forces no mass
  drift at all.

At 20x18x8 (amplitude 1e-2, tau=5 large steps, r=0.1, smdiv=0.1) this
holds 100/100 large steps with |total-dry-mass drift| 1.01e-6 at its peak
and 1.8e-7 at step 100, on the numpy golden path and on the loop's plain
versions alike (a CPU run; ``tests/test_torch_closure.py`` bounds it at
2e-6).  ``tau`` below ~3 large steps destabilizes (the nudging term
itself goes stiff at the RK3 stage length); 5-10 is the working range.

The arithmetic is plain PyTorch on the fields' device, as it is plain
``jnp`` in the JAX package: one subtraction and one product per cell and
large step, with the rate and the damping factor rounded to float32 first
(the JAX class multiplies by ``jnp.float32(...)``), so an evaluation is
bit-equal to the JAX one.  On a mesh every field is a dict of blocks
(``SmallStepLoop.prepare``) and the arithmetic runs block by block; the
mesh padding holds zeros in the state and the reference alike, so it stays
zero.
"""

from __future__ import annotations

import numpy as np

from ..utils.timing import span


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a float32 tensor times
    it is the float32 product by that float32 scalar."""
    return float(np.float32(x))


def _blockwise(fn, *fields):
    """``fn`` over plain tensors, or block by block over dicts of blocks
    keyed alike (a mesh loop's prepared fields)."""
    if isinstance(fields[0], dict):
        return {c: fn(*(f[c] for f in fields)) for c in fields[0]}
    return fn(*fields)


class NudgingTendencies:
    """Nudging (Rayleigh-relaxation) slow-tendency closure.

    Built from the PREPARED state dict (the arrays fed to
    ``RK3Integrator.step``); snapshots the reference ``t``/``mu`` at
    construction.  Instances are the ``tendency_fn`` hook:
    ``fn(stage, prev_out, stage_arrays) -> {"ft": ..., "mu_tend": ...}``.

    The tendencies are recomputed once per large step from the step-start
    state (stage 0) and reused by stages 1-2 — WRF evaluates most slow
    physics once per large step too; per-stage re-evaluation from the
    provisional state is available with ``per_stage=True``.
    """

    def __init__(self, arrays, dt: float, tau_steps: float = 5.0,
                 rayleigh_uv: float = 0.1, per_stage: bool = False):
        if tau_steps < 3.0:
            raise ValueError(
                f"tau_steps={tau_steps}: nudging stiffer than ~3 large "
                "steps destabilizes the RK3 stages (see module docstring)")
        self.ref_t = arrays["t"]
        self.ref_mu = arrays["mu"]
        #: the device the ``wrf.closure.damp`` span times (the first block's)
        t = self.ref_t
        self.span_device = (next(iter(t.values())) if isinstance(t, dict)
                            else t).device
        self.rate = 1.0 / (tau_steps * dt)
        self.rayleigh_uv = rayleigh_uv
        self.per_stage = per_stage
        self._step_tend = None

    def __call__(self, stage: int, prev_out, stage_arrays) -> dict:
        rate = _f32(self.rate)
        if stage == 0 or self.per_stage:
            def nudge(ref, x):
                return (ref - x) * rate

            self._step_tend = {
                "ft": _blockwise(nudge, self.ref_t, stage_arrays["t"]),
                "mu_tend": _blockwise(nudge, self.ref_mu, stage_arrays["mu"]),
            }
        return self._step_tend

    def damp_winds(self, arrays) -> None:
        """Apply the per-large-step Rayleigh damping ``u,v *= 1-r`` to the
        prepared state dict in place (new tensors; no-op when r == 0).
        While a ``torch.profiler`` records it is a ``wrf.closure.damp``
        span (``utils/timing.py::span``)."""
        with span("wrf.closure.damp", device=self.span_device):
            if not self.rayleigh_uv:
                return
            d = _f32(1.0 - self.rayleigh_uv)
            for name in ("u", "v"):
                arrays[name] = _blockwise(lambda x: x * d, arrays[name])


def golden_nudging_fn(case, dt: float, tau_steps: float = 5.0):
    """The same closure for the numpy golden path (``rk3_golden_run``):
    returns ``fn(fields) -> field updates`` operating on memory-window
    fixture field names."""
    ref_t = np.asarray(case.fields["grid_t_2"]).copy()
    ref_mu = np.asarray(case.fields["grid_mu_2"]).copy()
    rate = np.float32(1.0 / (tau_steps * dt))

    def fn(fields: dict) -> dict:
        return {
            "t_tend": ((ref_t - fields["grid_t_2"]) * rate).astype(np.float32),
            "mu_tend": ((ref_mu - fields["grid_mu_2"]) * rate).astype(
                np.float32),
        }

    return fn
