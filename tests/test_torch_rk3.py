"""The port's RK3 large step (1x1) against rk3_golden and the JAX
RK3Integrator on a 1x1 mesh, and the port's run_sim against two JAX RK3
steps.  Tolerance rtol 5e-5, atol_scale 2e-6 (tests/test_rk3.py's)."""

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.rk3 import rk3_golden, rk3_stages as jax_rk3_stages
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu_torch import run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator, rk3_stages
from wrf_tpu_torch.parallel.sharded import case_to_domain, embed_outputs

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
STATE = ("ww", "mu", "t", "t_ave", "u", "v")


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def test_stage_schedule_matches_jax():
    for ns in (1, 2, 4, 6, 7):
        assert rk3_stages(ns) == jax_rk3_stages(ns)
    assert RK3Integrator._EVOLVED == JaxRK3Integrator._EVOLVED


@pytest.mark.parametrize("snapshot", ["base", "stage"])
def test_rk3_step_matches_golden_and_jax(small_case, snapshot):
    case = small_case
    dt = case.dts * 4
    dom = case_to_domain(case)
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        kernel="plain", snapshot=snapshot, device="cpu")
    arrays = rk3.prepare(dom)
    got = arrays_to_numpy(rk3.step(arrays, case.rdx, case.rdy, dt,
                                   case.epssm))

    gold = rk3_golden(case, acoustic_steps=4, dt=dt, snapshot=snapshot)
    outputs_allclose(embed_outputs(case, {k: got[k] for k in STATE}),
                     {k: gold[k] for k in STATE}, **TOL)

    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jrk3 = JaxRK3Integrator(mesh, *_dims(case), case.flags,
                            acoustic_steps=4, kernel="pallas",
                            snapshot=snapshot)
    want = jrk3.step(jrk3.prepare(dom), case.rdx, case.rdy, dt, case.epssm)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()},
                     **TOL)


@pytest.mark.parametrize("snapshot", ["base", "stage"])
def test_smoke_oracle_rk3_matches_golden(small_case, snapshot):
    """chip_smoke.py's jax-free RK3 golden (C++ oracle substeps) is the
    numpy rk3_golden, bit for bit."""
    import chip_smoke

    dt = small_case.dts * 4
    got = chip_smoke.rk3_golden_native(small_case, 4, dt, snapshot)
    want = rk3_golden(small_case, acoustic_steps=4, dt=dt, snapshot=snapshot)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_merge_evolved_is_functional(small_case):
    case = small_case
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=2,
                        device="cpu")
    arrays = rk3.prepare(case_to_domain(case))
    out = rk3.step(arrays, case.rdx, case.rdy, case.dts * 2, case.epssm)
    merged = rk3.merge_evolved(arrays, out)
    nx, ny, _ = _dims(case)
    assert torch.equal(merged["t"][1:1 + ny, :, 1:1 + nx], out["t"])
    assert torch.equal(merged["t"][0], arrays["t"][0])
    assert merged["t_1"] is arrays["t_1"]
    assert not torch.equal(merged["t"], arrays["t"])


def test_run_sim_checkpoint_matches_jax(tmp_path, small_case, capsys):
    """Two host-stepped large steps through the CLI on CPU; the checkpoints
    equal two JAX RK3Integrator steps (stage snapshots, as run_sim).

    The degenerate stage-snapshot shell amplifies the state ~5e4x per large
    step (wrf_tpu/models/rk3.py), so by step 2 ww is the f32 cancellation
    residue of ~1e10-scale fluxes on BOTH paths; it is compared at step 1,
    every other field at both steps."""
    case = small_case
    fx = fixtures.write_case(case, tmp_path / "fx", steps=1)
    rc = run_sim.main([str(fx), "--device", "cpu", "--steps", "2",
                       "--diagnostics", "--checkpoint-dir",
                       str(tmp_path / "ck")])
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count("grid-points/s") == 2
    assert printed.count("total dry mass") == 2

    case2, _ = fixtures.read_case(fx)
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jrk3 = JaxRK3Integrator(mesh, *_dims(case2), case2.flags,
                            acoustic_steps=4, kernel="pallas",
                            snapshot="stage")
    arrays = jrk3.prepare(case_to_domain(case2))
    for n in (1, 2):
        out = jrk3.step(arrays, case2.rdx, case2.rdy, case2.dts * 4,
                        case2.epssm)
        arrays = jrk3.merge_evolved(arrays, out)
        got, step, _ = checkpoint.load_checkpoint(
            tmp_path / "ck" / f"step_{n:06d}")
        assert step == n and sorted(got) == sorted(STATE)
        names = STATE if n == 1 else tuple(k for k in STATE if k != "ww")
        outputs_allclose({k: got[k] for k in names},
                         {k: np.asarray(arrays[k]) for k in names}, **TOL)


def test_run_sim_resume_continues(tmp_path, small_case, capsys):
    """1 step + resume 1 step == 2 straight steps, bit for bit."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    common = [fx, "--device", "cpu"]
    assert run_sim.main(common + ["--steps", "2", "--checkpoint-dir",
                                  str(tmp_path / "ck2")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--checkpoint-dir",
                                  str(tmp_path / "ck")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--checkpoint-dir",
                                  str(tmp_path / "ck"), "--resume"]) == 0
    assert "resuming from" in capsys.readouterr().out
    straight, _, _ = checkpoint.load_checkpoint(tmp_path / "ck2" / "step_000002")
    resumed, step, _ = checkpoint.load_checkpoint(tmp_path / "ck" / "step_000002")
    assert step == 2
    for name in STATE:
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)


@pytest.mark.parametrize("flags", [
    ["--closure", "nudge"], ["--steps-per-sync", "2"],
    ["--profile", "trace"],
    ["--closure", "nudge", "--tau-steps", "5.0", "--rayleigh-uv", "0.1"],
])
def test_run_sim_rejects_unported_flags(tmp_path, flags):
    """Checked before the fixture is read."""
    with pytest.raises(SystemExit, match="not yet ported"):
        run_sim.main([str(tmp_path / "fx"), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [
    ["--halo-backend", "rdma_overlap"],
    ["--mesh", "2x2", "--halo-backend", "rdma_overlap"],
    ["--precision", "bf16-const"],
    ["--precision", "f32", "--tau-steps", "5.0", "--rayleigh-uv", "0.1"],
    ["--tau-steps", "7", "--rayleigh-uv", "0.3"],
])
def test_run_sim_once_unported_flags_run(tmp_path, small_case, capsys, flags):
    """The options that stopped with "not yet ported" until their kernels
    were ported, and the JAX CLI's spelled-out closure defaults
    (``--tau-steps 5.0 --rayleigh-uv 0.1``, ignored without ``--closure
    nudge`` as there): each runs a large step.  The exchange backends move
    the same rows, so they reproduce the default run bit for bit; bf16
    constants do not."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))

    def state(extra, ck):
        assert run_sim.main([fx, "--device", "cpu", "--checkpoint-dir",
                             str(tmp_path / ck), *extra]) == 0
        return checkpoint.load_checkpoint(tmp_path / ck / "step_000001")[0]

    got, want = state(flags, "ck"), state([], "ck0")
    assert "step 1:" in capsys.readouterr().out
    same = all(np.array_equal(got[n], want[n]) for n in STATE)
    assert same == ("bf16-const" not in flags)
    assert all(np.isfinite(got[n]).all() for n in STATE)


def test_run_sim_closure_defaults_match_jax():
    """--tau-steps and --rayleigh-uv have the JAX CLI's types and
    defaults (5.0 and 0.1)."""
    args = run_sim._parser().parse_args(["fx"])
    assert (args.tau_steps, args.rayleigh_uv) == (5.0, 0.1)
    assert isinstance(args.tau_steps, float)
    args = run_sim._parser().parse_args(["fx", "--tau-steps", "4"])
    assert args.tau_steps == 4.0 and isinstance(args.tau_steps, float)


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x2"], ["--halo-backend", "rdma"],
    ["--mesh", "2x2", "--halo-backend", "rdma"],
])
def test_run_sim_mesh_flags_run(tmp_path, small_case, capsys, flags):
    """--mesh and --halo-backend rdma run on the CPU (every shard there,
    the exchange through its plain version); the checkpoint holds global
    arrays and equals the 1x1 run's bit for bit."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    for name, extra in (("mesh", flags), ("ref", [])):
        assert run_sim.main([fx, "--device", "cpu", "--checkpoint-dir",
                             str(tmp_path / name), *extra]) == 0
    printed = capsys.readouterr().out
    if "--mesh" in flags:
        assert "mesh 2x2: 4 shard(s) on 1 device(s) (cpu)" in printed
    got, step, _ = checkpoint.load_checkpoint(
        tmp_path / "mesh" / "step_000001")
    ref, _, _ = checkpoint.load_checkpoint(tmp_path / "ref" / "step_000001")
    assert step == 1 and sorted(got) == sorted(STATE)
    for name in STATE:
        assert got[name].shape == ref[name].shape
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("extra", [[], ["--fast"]])
def test_run_sim_blocked_runs(tmp_path, small_case, capsys, extra):
    """--inner-steps 2 on the CPU: one large step at acoustic_steps=4 runs
    one K3 block in its last stage; the checkpoint is finite and agrees
    with the unblocked run at the loop tolerance."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    for name, flags in (("blk", ["--inner-steps", "2", *extra]), ("ref", [])):
        assert run_sim.main([fx, "--device", "cpu", "--checkpoint-dir",
                             str(tmp_path / name), *flags]) == 0
    assert capsys.readouterr().out.count("grid-points/s") == 2
    blk, step, _ = checkpoint.load_checkpoint(tmp_path / "blk" / "step_000001")
    ref, _, _ = checkpoint.load_checkpoint(tmp_path / "ref" / "step_000001")
    assert step == 1 and sorted(blk) == sorted(STATE)
    assert all(np.isfinite(v).all() for v in blk.values())
    outputs_allclose(blk, ref, **TOL)


def test_run_sim_fast_requires_inner_steps(tmp_path, small_case):
    """--fast alone fails as the loop's validation does."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    with pytest.raises(ValueError, match="inner_steps > 1"):
        run_sim.main([fx, "--device", "cpu", "--fast"])
