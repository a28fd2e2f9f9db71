"""The system under test: the port's closed RK3 large step, as ``run_sim`` runs it.

The only file of the benchmark that imports the program (``wrf_tpu_torch``),
and only these names, its contract with the benchmark:

* ``grid.ConfigFlags``;
* ``parallel.mesh.Mesh``, built from a list of devices (one a shard,
  j-major; a device may repeat) and the mesh's ``(nj, ni)``;
* ``models.rk3.RK3Integrator`` with ``prepare``, ``step``,
  ``merge_evolved``, ``multi_step`` and ``unprepare``;
* ``models.tendencies.NudgingTendencies`` with ``damp_winds``;
* the layout of a prepared field on a mesh (``prepare``'s, that is
  ``parallel/sharded.py::scatter``'s): a dict of equal blocks keyed by the
  shard's ``(jj, ii)``, block ``(jj, ii)`` holding the rows from
  ``jj*nj_loc`` and the columns from ``ii*ni_loc`` of the field
  zero-padded at its end to a multiple of the mesh, on its shard's
  device.

:class:`ClosedStep` builds the integrator for a configuration
(``snapshot="base"``, the fused kernels, its divergence damping) and a
traffic mix (``with_w``, ``inner_steps``, ``const_dtype``, and ``mesh``
``[nj, ni]`` with its ``halo_backend``: no ``mesh`` is one shard on the
first device), prepares the seeded inputs and runs ``run_sim``'s
host-stepped loop body per call: ``step`` with the nudging closure as its
tendency hook, ``merge_evolved``, ``damp_winds`` and one scalar readback.
With ``steps_per_sync`` K > 1 a call is ``multi_step`` over K large steps
and its one readback.  ``spans=True`` wraps each call into the program in
a ``torch.profiler`` span named ``wrfbench.<call>``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from .inputs import grid, scalars
from .reference import EVOLVED


class ClosedStep:
    """The program's closed large step on the run's devices: shard ``s`` of
    the traffic's mesh on ``devices[s % len(devices)]``.  ``state`` is the
    prepared input; ``step(state)`` returns the next state and the call's
    checksum (a float read back from the device)."""

    def __init__(self, cfg: dict, traffic: dict, host_inputs: dict, devices):
        from wrf_tpu_torch.grid import ConfigFlags
        from wrf_tpu_torch.models.rk3 import RK3Integrator
        from wrf_tpu_torch.models.tendencies import NudgingTendencies
        from wrf_tpu_torch.parallel.mesh import Mesh

        nx, ny, nz = grid(cfg)
        nj, ni = traffic.get("mesh", (1, 1))
        mesh = (None if nj * ni == 1 else
                Mesh([devices[s % len(devices)] for s in range(nj * ni)],
                     (nj, ni)))
        self.on_mesh = mesh is not None
        self.sc = scalars(cfg)
        self.steps_per_call = traffic.get("steps_per_sync", 1)
        const = traffic.get("const_dtype", "f32")
        self.rk3 = RK3Integrator(
            nx, ny, nz, ConfigFlags(specified=cfg["specified"]),
            acoustic_steps=cfg["time_step_sound"], kernel="cuda",
            snapshot="base", device=devices[0], mesh=mesh,
            halo_backend=traffic.get("halo_backend", "ppermute"),
            inner_steps=traffic.get("inner_steps", 1),
            with_w=traffic["with_w"],
            smdiv=self.sc["smdiv"],
            const_dtype=torch.bfloat16 if const == "bf16" else None)
        self.state = self.rk3.prepare(host_inputs)
        clo = cfg["closure"]
        self.closure = NudgingTendencies(
            self.state, self.sc["dt"], tau_steps=clo["tau_steps"],
            rayleigh_uv=clo["rayleigh_uv"])

    def step(self, arrays, spans: bool = False):
        span = record_function if spans else _no_span
        sc = self.sc
        if self.steps_per_call > 1:
            with span("wrfbench.multi_step"):
                arrays, diags = self.rk3.multi_step(
                    arrays, self.steps_per_call, sc["rdx"], sc["rdy"],
                    sc["dt"], sc["epssm"], tendency_fn=self.closure)
            return arrays, float(diags[:, 1].sum())
        with span("wrfbench.step"):
            out = self.rk3.step(arrays, sc["rdx"], sc["rdy"], sc["dt"],
                                sc["epssm"], tendency_fn=self.closure)
        with span("wrfbench.merge_evolved"):
            arrays = self.rk3.merge_evolved(arrays, out)
        with span("wrfbench.damp_winds"):
            self.closure.damp_winds(arrays)
        with span("wrfbench.readback"):
            checksum = (self.checksum(arrays) if self.on_mesh
                        else out["t"].sum().item())
        return arrays, checksum

    def checksum(self, arrays) -> float:
        """The sum of a state's ``t``, shard by shard on each shard's
        device, read back once (on one shard: its ring-shaped ``t``)."""
        t = arrays["t"]
        if not self.on_mesh:
            return t.sum().item()
        sums = [b.sum() for b in t.values()]
        return sum(x.to(sums[0].device) for x in sums).item()

    def evolved(self, arrays) -> dict:
        """The evolved fields of a state where they lie, no copy: on one
        shard ring-shaped views, on a mesh each field's dict of blocks
        (read with ``check.region``)."""
        names = [n for n in EVOLVED if n in arrays]
        if self.on_mesh:
            return {n: arrays[n] for n in names}
        return self.rk3.unprepare(arrays, names)

    def close(self):
        """Drop the program's references to its state."""
        self.state = self.closure = self.rk3 = None


@contextlib.contextmanager
def _no_span(_name):
    yield
