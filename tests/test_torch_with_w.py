"""The ``with_w`` path of the port on the CPU: the coupled loop, the RK3
step and ``run_sim --with-w``, against the JAX package and the numpy
golden loop.

* ``SmallStepLoop(with_w=True)`` with ``kernel="plain"`` (the kernels'
  plain versions, ``fuse_w``) and ``kernel="eager"`` (three whole-array
  ops per substep) against the JAX loop on a 1x1 mesh (Pallas in
  interpret mode; its ``kernel="xla"`` for the eager tier) and against
  ``small_step_golden(with_w=True)``, at 5 substeps (rtol 5e-5,
  atol_scale 2e-6) and 50 (rtol 1e-4, atol_scale 1e-5:
  tests/test_small_step.py's long-loop tolerance).
* The blocked loop S=2, 4 and 4 fast with ``with_w`` against the JAX
  blocked loop and the S=1 loop.
* ``RK3Integrator(with_w=True)`` against the JAX integrator.
* ``run_sim --with-w``: runs, checkpoints w and pp, resumes, and refuses a
  resume whose ``--with-w`` differs from the checkpoint's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.small_step import small_step_golden as jax_golden_loop
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu_torch import run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.io import checkpoint
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop, small_step_golden
from wrf_tpu_torch.parallel.sharded import case_to_domain, embed_outputs

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
LONG_TOL = dict(rtol=1e-4, atol_scale=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol_scale=1e-6)
NAMES = ["mu", "muave", "mudf", "muts", "pp", "t", "t_ave", "u", "v", "w",
         "ww"]


@functools.lru_cache(maxsize=None)
def _case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7)


def _dims():
    b = _case().bounds
    return b.ide, b.jde, b.kdim


@functools.lru_cache(maxsize=None)
def _port_loop(steps=5, kernel="plain", inner_steps=1, fast=False):
    case = _case()
    loop = SmallStepLoop(*_dims(), case.flags, n_steps=steps, kernel=kernel,
                         inner_steps=inner_steps, fast=fast, with_w=True,
                         device="cpu")
    out = loop(loop.prepare(case_to_domain(case, with_w=True)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


@functools.lru_cache(maxsize=None)
def _jax_loop(steps=5, kernel="pallas", inner_steps=1, fast=False):
    case = _case()
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    loop = JaxSmallStepLoop(mesh, *_dims(), case.flags, n_steps=steps,
                            kernel=kernel, with_w=True,
                            inner_steps=inner_steps, fast=fast)
    out = loop(loop.prepare(case_to_domain(case, with_w=True)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _golden(steps):
    return small_step_golden(_case(), steps, with_w=True)


@pytest.mark.parametrize("steps", [1, 4])
def test_golden_loop_with_w_is_the_jax_modules(steps):
    want = jax_golden_loop(_case(), steps, with_w=True)
    got = _golden(steps)
    assert sorted(got) == sorted(want) and {"w", "pp"} <= set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kernel,jax_kernel", [("plain", "pallas"),
                                               ("eager", "xla")])
def test_loop_with_w_matches_jax_loop(kernel, jax_kernel):
    got = _port_loop(5, kernel)
    want = _jax_loop(5, jax_kernel)
    assert sorted(got) == sorted(want) == NAMES
    outputs_allclose(got, want, **TOL)


@pytest.mark.parametrize("steps,tol", [(5, TOL), (50, LONG_TOL)])
@pytest.mark.parametrize("kernel", ["plain", "eager"])
def test_loop_with_w_matches_golden(kernel, steps, tol):
    got = embed_outputs(_case(), _port_loop(steps, kernel))
    gold = _golden(steps)
    assert (gold["w"] != _case().fields["grid_w"]).any()
    outputs_allclose(got, {k: gold[k] for k in got}, **tol)


@pytest.mark.parametrize("case_name", ["periodic_case", "open_bc_case"])
def test_loop_with_w_other_bcs_match_golden(case_name, request):
    case = request.getfixturevalue(case_name)
    b = case.bounds
    for kernel in ("plain", "eager"):
        loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=5,
                             kernel=kernel, with_w=True, device="cpu")
        out = loop(loop.prepare(case_to_domain(case, with_w=True)), case.rdx,
                   case.rdy, case.dts, case.epssm)
        gold = small_step_golden(case, 5, with_w=True)
        got = embed_outputs(case, arrays_to_numpy(out))
        outputs_allclose(got, {k: gold[k] for k in got}, **TOL)


def test_cuda_kernel_on_cpu_tensors_is_the_plain_loop():
    plain = _port_loop(5, "plain")
    for name, val in _port_loop(5, "cuda").items():
        np.testing.assert_array_equal(val, plain[name], err_msg=name)


@pytest.mark.parametrize("S,fast", [(2, False), (4, False), (4, True)])
def test_blocked_loop_with_w(S, fast):
    """9 substeps: S=2 runs 4 K3 passes, S=4 two, then the final K1 one."""
    got = _port_loop(9, "plain", S, fast)
    want = _jax_loop(9, "pallas", S, fast)
    assert sorted(got) == sorted(want) == NAMES
    outputs_allclose(got, want, **TOL)
    outputs_allclose(got, _port_loop(9, "plain"), **KERNEL_TOL)
    gold = _golden(9)
    emb = embed_outputs(_case(), got)
    outputs_allclose(emb, {k: gold[k] for k in emb}, **TOL)
    if not fast:   # exact blocking is bit-compatible with the S=1 loop
        for name, val in _port_loop(9, "plain").items():
            np.testing.assert_array_equal(got[name][1:-1], val[1:-1],
                                          err_msg=name)


def test_loop_with_w_leaves_prepared_arrays_alone():
    case = _case()
    loop = SmallStepLoop(*_dims(), case.flags, n_steps=5, inner_steps=2,
                         with_w=True, device="cpu")
    arrays = loop.prepare(case_to_domain(case, with_w=True))
    assert {"w", "pp", "rdn"} <= set(arrays)
    before = {k: v.clone() for k, v in arrays.items()}
    loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert all(torch.equal(arrays[k], before[k]) for k in arrays)


def test_eager_kernel_cannot_block():
    with pytest.raises(ValueError, match="inner_steps requires the fused"):
        SmallStepLoop(*_dims(), _case().flags, n_steps=5, kernel="eager",
                      inner_steps=2, device="cpu")


@pytest.mark.parametrize("inner_steps,acoustic_steps", [(1, 4), (2, 8)])
def test_rk3_with_w_matches_jax(inner_steps, acoustic_steps):
    case = _case()
    dt = case.dts * acoustic_steps
    dom = case_to_domain(case, with_w=True)
    rk3 = RK3Integrator(*_dims(), case.flags, acoustic_steps=acoustic_steps,
                        kernel="plain", snapshot="stage", device="cpu",
                        inner_steps=inner_steps, with_w=True)
    arrays = rk3.prepare(dom)
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)
    got = arrays_to_numpy(out)
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jrk3 = JaxRK3Integrator(mesh, *_dims(), case.flags,
                            acoustic_steps=acoustic_steps, kernel="pallas",
                            snapshot="stage", with_w=True,
                            inner_steps=inner_steps)
    want = jrk3.step(jrk3.prepare(dom), case.rdx, case.rdy, dt, case.epssm)
    assert sorted(got) == sorted(want) == NAMES
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()}, **TOL)
    merged = rk3.merge_evolved(arrays, out)
    nx, ny, _ = _dims()
    for name in ("w", "pp"):
        assert torch.equal(merged[name][1:1 + ny, :, 1:1 + nx], out[name])
        assert torch.equal(merged[name][0], arrays[name][0])


@pytest.mark.parametrize("snapshot", ["base", "stage"])
def test_smoke_oracle_rk3_with_w_matches_golden(snapshot):
    """chip_smoke.py's RK3 golden on the C++ oracle (advance_uv ->
    advance_mu_t -> advance_w per substep) is the JAX package's numpy
    rk3_golden with the w substep, bit for bit."""
    import chip_smoke
    from wrf_tpu.models.rk3 import rk3_golden

    case = _case()
    dt = case.dts * 4
    got = chip_smoke.rk3_golden_native(case, 4, dt, snapshot, with_w=True)
    want = rk3_golden(case, acoustic_steps=4, dt=dt, snapshot=snapshot,
                      with_w=True)
    assert sorted(got) == sorted(want) and {"w", "pp"} <= set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ------------------------------------------------------------ run_sim ----
STATE_W = ("mu", "pp", "t", "t_ave", "u", "v", "w", "ww")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return str(fixtures.write_case(_case(), tmp_path_factory.mktemp("fxw"),
                                   steps=1))


@pytest.mark.parametrize("extra", [[], ["--inner-steps", "2"],
                                   ["--inner-steps", "2", "--fast"]])
def test_run_sim_with_w_runs_and_checkpoints(tmp_path, fx, capsys, extra):
    assert run_sim.main([fx, "--device", "cpu", "--with-w", "--diagnostics",
                         "--checkpoint-dir", str(tmp_path / "ck"),
                         *extra]) == 0
    out = capsys.readouterr().out
    assert out.count("grid-points/s") == 1 and "total dry mass" in out
    state, step, _ = checkpoint.load_checkpoint(tmp_path / "ck" /
                                                "step_000001")
    assert step == 1 and tuple(sorted(state)) == STATE_W
    assert all(np.isfinite(v).all() for v in state.values())
    # one JAX RK3 step with the same options
    case = _case()
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jrk3 = JaxRK3Integrator(mesh, *_dims(), case.flags, acoustic_steps=4,
                            kernel="pallas", snapshot="stage", with_w=True,
                            inner_steps=2 if extra else 1,
                            fast="--fast" in extra)
    arrays = jrk3.prepare(case_to_domain(case, with_w=True))
    want = jrk3.merge_evolved(arrays, jrk3.step(
        arrays, case.rdx, case.rdy, case.dts * 4, case.epssm))
    outputs_allclose(state, {k: np.asarray(want[k]) for k in state}, **TOL)


def test_run_sim_with_w_resume_continues(tmp_path, fx, capsys):
    """1 step + resume 1 step == 2 straight steps, bit for bit."""
    common = [fx, "--device", "cpu", "--with-w"]
    assert run_sim.main(common + ["--steps", "2", "--checkpoint-dir",
                                  str(tmp_path / "ck2")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--checkpoint-dir",
                                  str(tmp_path / "ck")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--checkpoint-dir",
                                  str(tmp_path / "ck"), "--resume"]) == 0
    assert "resuming from" in capsys.readouterr().out
    straight, _, _ = checkpoint.load_checkpoint(tmp_path / "ck2" /
                                                "step_000002")
    resumed, step, _ = checkpoint.load_checkpoint(tmp_path / "ck" /
                                                  "step_000002")
    assert step == 2 and tuple(sorted(resumed)) == STATE_W
    for name in STATE_W:
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)


@pytest.mark.parametrize("first,second", [(["--with-w"], []),
                                          ([], ["--with-w"])])
def test_run_sim_refuses_mismatched_resume(tmp_path, fx, first, second):
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    assert run_sim.main([fx, "--device", "cpu", *first, *ck]) == 0
    with pytest.raises(SystemExit, match="matching --with-w setting"):
        run_sim.main([fx, "--device", "cpu", *second, *ck, "--resume"])
