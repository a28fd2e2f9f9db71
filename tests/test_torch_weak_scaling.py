"""The port's weak-scaling tool (``wrf_tpu_torch/tools/weak_scaling.py``)
against the JAX package's ``tools/weak_scaling.py``: the ladder's meshes
and sizes, the model block, the ``--dryrun`` JSON line's keys and rungs,
and on every dryrun rung the port's ``SmallStepLoop`` on the tool's own
case against the JAX loop on the same mesh over the virtual CPU devices.

The JAX tool is loaded from its file (it is a script, not a package
module).  Tolerance rtol 5e-5, atol_scale 2e-6 (the mesh tier's,
tests/test_torch_mesh.py) where the two loops meet; the port's backends
agree with each other bit for bit.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.parallel import mesh as jax_mesh
from wrf_tpu.parallel import sharded as jax_sharded
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain
from wrf_tpu_torch.tools import weak_scaling

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
REPO = Path(__file__).resolve().parent.parent
#: the JAX dryrun's tile and depth
TILE, NZ = (12, 12), 8
#: the meshes of the dryrun ladder over eight devices
RUNGS = [(1, 1), (2, 1), (2, 2), (4, 2)]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_weak_scaling_tool", REPO / "tools" / "weak_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


def test_mesh_shape_and_ladder_sizes_match_jax():
    for n in range(1, 17):
        assert weak_scaling.mesh_shape_for(n) == JAX_TOOL.mesh_shape_for(n)
        assert weak_scaling.ladder_sizes(n) == JAX_TOOL.ladder_sizes(n)


@pytest.mark.parametrize("backend", ["ppermute", "rdma", "rdma_overlap",
                                     "unknown"])
@pytest.mark.parametrize("inner_steps", [1, 4])
def test_model_prediction_matches_jax(monkeypatch, backend, inner_steps):
    """Given the same measured inputs, the port's model is the JAX tool's
    formula (the unknown backend falls back to ppermute's cost on both)."""
    measured = {"exchange_us": {"ppermute": 21.5, "rdma": 40.25,
                                "rdma_overlap": 17.0},
                "coupled_ms_512": {"S1": 0.3321, "S4_blocked": 0.3958},
                "provenance": "the same inputs on both sides"}
    monkeypatch.setattr(JAX_TOOL, "MEASURED", measured)
    monkeypatch.setattr(weak_scaling, "MEASURED", measured)
    for tile in ((12, 12), (256, 256), (512, 512)):
        for nz in (8, 50):
            assert (weak_scaling.model_prediction(tile, nz, backend,
                                                  inner_steps)
                    == JAX_TOOL.model_prediction(tile, nz, backend,
                                                 inner_steps))


def test_measured_holds_the_cards_own_figures():
    """MEASURED names the card and its power limit and holds numbers, one
    per backend and per loop."""
    m = weak_scaling.MEASURED
    assert "H100" in m["provenance"] and " W" in m["provenance"]
    assert sorted(m["exchange_us"]) == ["ppermute", "rdma", "rdma_overlap"]
    assert sorted(m["coupled_ms_512"]) == ["S1", "S4_blocked"]
    for v in list(m["exchange_us"].values()) + list(
            m["coupled_ms_512"].values()):
        assert np.isfinite(v) and v > 0


def _port_dryrun(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert weak_scaling.main(["--dryrun", *argv]) == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def _jax_dryrun(monkeypatch, *argv):
    """The JAX tool's line with its timing replaced by a constant (its
    ladder, meshes and record are its own; its loops are not run)."""
    monkeypatch.setattr(JAX_TOOL, "time_substep", lambda *a, **k: 1.0)
    monkeypatch.setattr("sys.argv", ["weak_scaling.py", "--dryrun", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JAX_TOOL.main()
    return json.loads(buf.getvalue().splitlines()[-1])


@pytest.mark.parametrize("argv", [(), ("--inner-steps", "4"),
                                  ("--halo-backend", "rdma_overlap",
                                   "--max-devices", "4")])
def test_dryrun_line_has_the_jax_keys_and_rungs(monkeypatch, argv):
    got = _port_dryrun(*argv)
    want = _jax_dryrun(monkeypatch, *argv)
    assert sorted(got) == sorted(want)
    assert got["dryrun"] is True and got["metric"] == want["metric"]
    assert got["tile"] == want["tile"] == [12, 12, 8]
    assert ([(r["n_devices"], r["mesh"], r["global"]) for r in got["ladder"]]
            == [(r["n_devices"], r["mesh"], r["global"])
                for r in want["ladder"]])
    assert sorted(got["ladder"][0]) == sorted(want["ladder"][0])
    assert sorted(got["model"]) == sorted(want["model"])
    assert got["ladder"][0]["efficiency"] == 1.0
    assert isinstance(got["pass_80pct"], bool)


def test_dryrun_rungs_are_the_ladder_over_eight_devices():
    rec = _port_dryrun()
    assert [tuple(r["mesh"]) for r in rec["ladder"]] == RUNGS
    assert all(np.isfinite(r["ms_per_substep"]) for r in rec["ladder"])


def test_without_dryrun_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weak_scaling.main([])


def test_a_rung_times_once_for_every_backend_that_runs_ppermute():
    """The S=4 ladder runs ppermute under every backend: with a shared
    ``timings`` dict the second backend's rungs are not timed again."""
    devices = [torch.device("cpu")] * 2
    timings = {}
    a = weak_scaling.ladder(devices, TILE, NZ, pair=(3, 7), repeats=1,
                            inner_steps=4, timings=timings)
    n = len(timings)
    b = weak_scaling.ladder(devices, TILE, NZ, pair=(3, 7), repeats=1,
                            inner_steps=4, halo_backend="rdma_overlap",
                            timings=timings)
    assert len(timings) == n == 2
    assert a["ladder"] == b["ladder"]
    assert a["model"]["halo_backend"] == "ppermute"
    assert b["model"]["halo_backend"] == "rdma_overlap"


def _loop(mesh, grid, case, n_steps, kw):
    """The ``SmallStepLoop`` that ``time_substep`` times on a rung."""
    return SmallStepLoop(*grid, case.flags, n_steps=n_steps, mesh=mesh,
                         device=mesh.device((0, 0)), **kw)


def _rung_case(shape):
    return (TILE[1] * shape[1], TILE[0] * shape[0], NZ)


@pytest.mark.parametrize("shape", RUNGS)
def test_rung_loop_matches_jax_on_the_same_mesh(shape):
    """The loop a dryrun rung times, on the tool's own case, against the
    JAX loop on the same mesh over the virtual CPU devices (the JAX tool's
    own case from its seed: the two inputs are equal first)."""
    nx, ny, nz = _rung_case(shape)
    n = shape[0] * shape[1]
    mesh = make_mesh(["cpu"] * n, shape)
    grid, case, kw = weak_scaling.rung_args(mesh, TILE, nz)
    assert grid == (nx, ny, nz)
    loop = _loop(mesh, grid, case, 3, kw)
    dom = case_to_domain(case)
    jcase = jax_fixtures.make_case(nx, ny, nz, halo=3, seed=42)
    jdom = jax_sharded.case_to_domain(jcase)
    assert sorted(dom) == sorted(jdom)
    for k in dom:
        np.testing.assert_array_equal(np.asarray(dom[k]),
                                      np.asarray(jdom[k]), err_msg=k)
    got = arrays_to_numpy(loop(loop.prepare(dom), case.rdx, case.rdy,
                               case.dts, case.epssm))
    jmesh = jax_mesh.make_mesh(jax.devices()[:n], shape)
    jloop = JaxSmallStepLoop(jmesh, nx, ny, nz, jcase.flags, n_steps=3)
    want = jloop(jloop.prepare(jdom), jcase.rdx, jcase.rdy, jcase.dts,
                 jcase.epssm)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_rung_loop_backends_agree_bit_for_bit(shape):
    """A rung's loop under the three backends (their plain versions here),
    and blocked S=4, on the tool's own case."""
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    outs = {}
    for backend in ("ppermute", "rdma", "rdma_overlap"):
        grid, case, kw = weak_scaling.rung_args(mesh, TILE, NZ,
                                                halo_backend=backend)
        loop = _loop(mesh, grid, case, 5, kw)
        assert loop.halo_backend == backend
        outs[backend] = arrays_to_numpy(loop(
            loop.prepare(case_to_domain(case)), case.rdx, case.rdy,
            case.dts, case.epssm))
    for backend in ("rdma", "rdma_overlap"):
        for k in outs["ppermute"]:
            np.testing.assert_array_equal(outs[backend][k],
                                          outs["ppermute"][k], err_msg=k)
    grid, case, kw = weak_scaling.rung_args(mesh, TILE, NZ, inner_steps=4,
                                            halo_backend="rdma")
    loop = _loop(mesh, grid, case, 9, kw)
    assert loop.halo_backend == "ppermute"   # the JAX tool's rule


def test_time_substep_times_the_rung_loop_as_bench_halo(monkeypatch):
    """A rung is timed by ``bench_halo.marginal`` on its own mesh: the
    rung's loops at the two pass-aligned counts (two passes apart at
    S=4), every shard on the mesh's devices."""
    seen = []
    real = SmallStepLoop.__init__

    def spy(self, *a, **kw):
        seen.append((a[:3], kw["n_steps"], kw["mesh"].shape,
                     kw["halo_backend"]))
        real(self, *a, **kw)

    monkeypatch.setattr(SmallStepLoop, "__init__", spy)
    mesh = make_mesh(["cpu"] * 2, (2, 1))
    ms = weak_scaling.time_substep(mesh, TILE, NZ, steps_pair=(3, 7),
                                   repeats=1, inner_steps=4,
                                   halo_backend="rdma")
    assert np.isfinite(ms)
    from wrf_tpu.utils.timing import blocked_counts
    n1, n2 = blocked_counts(4, 3, 7, min_passes=2)
    assert seen == [((TILE[1], 2 * TILE[0], NZ), n, (2, 1), "ppermute")
                    for n in (n1, n2)]
