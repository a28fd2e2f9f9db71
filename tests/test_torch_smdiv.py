"""Divergence damping (smdiv) through the port, against the JAX package on
the CPU: the golden loop (bit for bit, both numpy), the loops on one shard
and on a mesh under both halo backends, RK3, and ``run_sim --namelist`` in
both forms.  The same ``case_to_domain`` arrays go to both packages; the
JAX loops run their Pallas kernel in interpret mode or their xla substep.
Tolerance rtol 5e-5, atol_scale 2e-6 (tests/test_small_step.py's); the
50-substep ``with_w`` runs rtol 1e-4, atol_scale 1e-5 (its capstone's)."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu import run_sim as jax_run_sim
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.rk3 import rk3_golden
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.small_step import small_step_golden as jax_golden_loop
from wrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_tpu_torch import run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop, small_step_golden
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain, embed_outputs

torch.set_num_threads(1)

SMDIV = 0.1
STEPS = 6
TOL = dict(rtol=5e-5, atol_scale=2e-6)
LONG_TOL = dict(rtol=1e-4, atol_scale=1e-5)
STATE = ("ww", "mu", "t", "t_ave", "u", "v")


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def _mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape) if shape else None


def _port_loop(case, kernel, shape=None, backend="ppermute", steps=STEPS,
               with_w=False, smdiv=SMDIV):
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=steps,
                         kernel=kernel, device="cpu", smdiv=smdiv,
                         with_w=with_w, mesh=_mesh(shape),
                         halo_backend=backend)
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


def _jax_loop(case, kernel, shape=(1, 1), steps=STEPS, with_w=False):
    mesh = jax_make_mesh(jax.devices()[:shape[0] * shape[1]], shape)
    loop = JaxSmallStepLoop(mesh, *_dims(case), case.flags, n_steps=steps,
                            kernel=kernel, smdiv=SMDIV, with_w=with_w)
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


# ------------------------------------------------------ the golden loop ----
@pytest.mark.parametrize("with_w", [False, True])
def test_golden_loop_with_smdiv_is_the_jax_modules(small_case, with_w):
    got = small_step_golden(small_case, STEPS, with_w=with_w, smdiv=SMDIV)
    want = jax_golden_loop(small_case, STEPS, with_w=with_w, smdiv=SMDIV)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    undamped = small_step_golden(small_case, STEPS, with_w=with_w)
    assert np.abs(got["u"] - undamped["u"]).max() > 1e-2


# ------------------------------------------------------------- one shard ----
@pytest.mark.parametrize("kernel", ["plain", "cuda", "eager"])
@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_damped_loop_matches_golden(case_name, kernel, request):
    case = request.getfixturevalue(case_name)
    got = embed_outputs(case, _port_loop(case, kernel))
    gold = small_step_golden(case, STEPS, smdiv=SMDIV)
    outputs_allclose(got, {k: gold[k] for k in got}, **TOL)
    undamped = _port_loop(case, kernel, smdiv=0.0)
    assert np.abs(got["u"] - embed_outputs(case, undamped)["u"]).max() > 1e-2


@pytest.mark.parametrize("kernel,jax_kernel", [("plain", "pallas"),
                                               ("eager", "xla")])
def test_damped_loop_matches_jax_loop(small_case, kernel, jax_kernel):
    got = _port_loop(small_case, kernel)
    want = _jax_loop(small_case, jax_kernel)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel", ["plain", "eager"])
def test_damped_loop_with_w_50_substeps(small_case, kernel):
    """Damping, the implicit w substep and 50 substeps at once (the JAX
    package's capstone, tests/test_small_step.py)."""
    case = small_case
    got = _port_loop(case, kernel, steps=50, with_w=True)
    gold = small_step_golden(case, 50, with_w=True, smdiv=SMDIV)
    outputs_allclose(embed_outputs(case, got), gold, **LONG_TOL)
    if kernel == "plain":
        want = _jax_loop(case, "pallas", steps=50, with_w=True)
        assert sorted(got) == sorted(want)
        outputs_allclose(got, want, **LONG_TOL)


# ---------------------------------------------------------------- a mesh ----
@functools.lru_cache(maxsize=None)
def _unsharded(kernel):
    return _port_loop(fixtures.make_case(20, 18, 8, halo=2, seed=7), kernel)


@pytest.mark.parametrize("kernel", ["plain", "eager"])
@pytest.mark.parametrize("backend", ["ppermute", "rdma"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_damped_mesh_loop_equals_unsharded(small_case, shape, backend,
                                           kernel):
    """mudf rides every exchange mu rides (a third field of the one rdma
    launch): a column's arithmetic does not depend on its block."""
    got = _port_loop(small_case, kernel, shape, backend)
    ref = _unsharded(kernel)
    assert sorted(got) == sorted(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("kernel,jax_kernel", [("plain", "pallas"),
                                               ("eager", "xla")])
def test_damped_mesh_loop_matches_jax_mesh_loop(small_case, kernel,
                                                jax_kernel):
    got = _port_loop(small_case, kernel, (2, 2), "rdma")
    want = _jax_loop(small_case, jax_kernel, (2, 2))
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)


def test_damped_mesh_loop_with_w(small_case):
    got = _port_loop(small_case, "plain", (2, 2), "rdma", with_w=True)
    ref = _port_loop(small_case, "plain", with_w=True)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_damping_refused_with_blocking(small_case):
    """As in JAX: the blocked path does not carry mudf."""
    case = small_case
    with pytest.raises(ValueError, match="does not support smdiv"):
        RK3Integrator(*_dims(case), case.flags, acoustic_steps=8,
                      inner_steps=2, smdiv=SMDIV, device="cpu")
    with pytest.raises(ValueError, match="does not support smdiv"):
        JaxRK3Integrator(jax_make_mesh(jax.devices()[:1], (1, 1)),
                         *_dims(case), case.flags, acoustic_steps=8,
                         inner_steps=2, smdiv=SMDIV)


# ------------------------------------------------------------------- RK3 ----
@pytest.mark.parametrize("shape", [None, (2, 2)])
def test_rk3_with_smdiv_matches_golden_and_jax(small_case, shape):
    case = small_case
    dt = case.dts * 4
    dom = case_to_domain(case)
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        kernel="plain", snapshot="base", device="cpu",
                        smdiv=SMDIV, mesh=_mesh(shape), halo_backend="rdma")
    got = arrays_to_numpy(rk3.step(rk3.prepare(dom), case.rdx, case.rdy, dt,
                                   case.epssm))
    gold = rk3_golden(case, acoustic_steps=4, dt=dt, smdiv=SMDIV)
    outputs_allclose(embed_outputs(case, {k: got[k] for k in STATE}),
                     {k: gold[k] for k in STATE}, **TOL)
    jshape = shape or (1, 1)
    jrk3 = JaxRK3Integrator(
        jax_make_mesh(jax.devices()[:jshape[0] * jshape[1]], jshape),
        *_dims(case), case.flags, acoustic_steps=4, kernel="pallas",
        smdiv=SMDIV, snapshot="base")
    want = jrk3.step(jrk3.prepare(dom), case.rdx, case.rdy, dt, case.epssm)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()}, **TOL)


@pytest.mark.parametrize("with_w", [False, True])
def test_smoke_oracle_rk3_with_smdiv_matches_golden(small_case, with_w):
    """chip_smoke.py's RK3 reference (C++ oracle substeps) takes smdiv and
    is the numpy rk3_golden, bit for bit."""
    import chip_smoke

    dt = small_case.dts * 4
    got = chip_smoke.rk3_golden_native(small_case, 4, dt, "stage",
                                       with_w=with_w, smdiv=SMDIV)
    want = rk3_golden(small_case, acoustic_steps=4, dt=dt, with_w=with_w,
                      smdiv=SMDIV, snapshot="stage")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ------------------------------------------------- run_sim --namelist ----
NML_JSON = json.dumps({
    "dx": 12000.0, "dy": 12000.0, "time_step": 12, "time_step_sound": 6,
    "epssm": 0.1, "smdiv": SMDIV, "specified": True,
})
NML_TEXT = """
&domains
 time_step       = 12,
 dx              = 12000.0, 4000.0,
 dy              = 12000.0, 4000.0,
/
&dynamics
 epssm           = 1.d-1,
 smdiv           = 0.1,
 time_step_sound = 6,
/
&bdy_control
 specified = .true.
/
"""


@pytest.fixture(scope="module")
def nml_run(tmp_path_factory, request):
    """One fixture directory and the JAX CLI's one-step checkpoint for the
    JSON namelist (``--kernel xla``, as tests/test_run_sim.py runs it)."""
    tmp = tmp_path_factory.mktemp("nml")
    case = request.getfixturevalue("small_case")
    fx = str(fixtures.write_case(case, tmp / "fx", steps=1))
    (tmp / "nml.json").write_text(NML_JSON)
    (tmp / "namelist.input").write_text(NML_TEXT)
    assert jax_run_sim.main([fx, "--namelist", str(tmp / "nml.json"),
                             "--steps", "1", "--kernel", "xla",
                             "--checkpoint-dir", str(tmp / "jax")]) == 0
    want, step, _ = checkpoint.load_checkpoint(tmp / "jax" / "step_000001")
    assert step == 1
    return tmp, fx, want


def _port_checkpoint(tmp, fx, name, *flags):
    assert run_sim.main([fx, "--device", "cpu", "--steps", "1",
                         "--checkpoint-dir", str(tmp / name), *flags]) == 0
    got, step, _ = checkpoint.load_checkpoint(tmp / name / "step_000001")
    assert step == 1
    return got


@pytest.mark.parametrize("nml", ["nml.json", "namelist.input"])
@pytest.mark.parametrize("kernel", ["cuda", "xla"])
def test_run_sim_namelist_matches_jax_cli(nml_run, nml, kernel):
    """Both namelist forms, each with smdiv = 0.1, on the fused path and on
    the eager one, against the JAX CLI's checkpoint."""
    tmp, fx, want = nml_run
    got = _port_checkpoint(tmp, fx, f"port_{nml}_{kernel}", "--namelist",
                           str(tmp / nml), "--kernel", kernel)
    assert sorted(got) == sorted(want) == sorted(STATE)
    outputs_allclose(got, want, **TOL)


def test_run_sim_namelist_damping_reaches_the_loop(nml_run):
    """The same record without smdiv gives another state: the flag is not
    dropped on the way."""
    tmp, fx, _ = nml_run
    (tmp / "nodamp.json").write_text(
        json.dumps({**json.loads(NML_JSON), "smdiv": 0.0}))
    damped = _port_checkpoint(tmp, fx, "d1", "--namelist",
                              str(tmp / "nml.json"))
    plain = _port_checkpoint(tmp, fx, "d0", "--namelist",
                             str(tmp / "nodamp.json"))
    assert np.abs(damped["u"] - plain["u"]).max() > 1e-2


def test_run_sim_namelist_on_a_mesh(nml_run):
    tmp, fx, _ = nml_run
    ref = _port_checkpoint(tmp, fx, "m0", "--namelist", str(tmp / "nml.json"))
    got = _port_checkpoint(tmp, fx, "m1", "--namelist", str(tmp / "nml.json"),
                           "--mesh", "2x2", "--halo-backend", "rdma")
    for name in STATE:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_run_sim_namelist_smdiv_with_inner_steps_raises(nml_run):
    tmp, fx, _ = nml_run
    with pytest.raises(ValueError, match="does not support smdiv"):
        run_sim.main([fx, "--device", "cpu", "--namelist",
                      str(tmp / "nml.json"), "--inner-steps", "2"])


# ------------------------------------------------------ run_sim --kernel ----
def test_run_sim_kernel_names(tmp_path, small_case):
    """--kernel xla is --kernel eager and --kernel pallas is the default,
    bit for bit; the eager run equals the JAX CLI's --kernel xla run."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    runs = {k: _port_checkpoint(tmp_path, fx, f"k_{k}", *flags)
            for k, flags in (("default", ()),
                             ("pallas", ("--kernel", "pallas")),
                             ("eager", ("--kernel", "eager")),
                             ("xla", ("--kernel", "xla")))}
    for a, b in (("pallas", "default"), ("xla", "eager")):
        for name in STATE:
            np.testing.assert_array_equal(runs[a][name], runs[b][name],
                                          err_msg=f"{a} {name}")
    assert not np.array_equal(runs["eager"]["t"], runs["default"]["t"])
    assert jax_run_sim.main([fx, "--steps", "1", "--kernel", "xla",
                             "--checkpoint-dir", str(tmp_path / "jax")]) == 0
    want, _, _ = checkpoint.load_checkpoint(tmp_path / "jax" / "step_000001")
    outputs_allclose(runs["xla"], want, **TOL)


def test_run_sim_kernel_eager_refuses_blocking(tmp_path, small_case):
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    with pytest.raises(ValueError, match="inner_steps requires the fused"):
        run_sim.main([fx, "--device", "cpu", "--kernel", "eager",
                      "--inner-steps", "2"])
