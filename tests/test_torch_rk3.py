"""The port's RK3 large step (1x1) against rk3_golden and the JAX
RK3Integrator on a 1x1 mesh, and the port's run_sim against two JAX RK3
steps and against JAX's run_sim with the nudging closure.  Tolerance rtol
5e-5, atol_scale 2e-6 (tests/test_rk3.py's)."""

import re

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
def test_run_sim_closure_flags_run(tmp_path, small_case, capsys, flags):
    """The flag sets that stopped with "not yet ported" before the
    long-horizon path was ported: each runs two large steps to a finite
    checkpoint.  The closure changes the state; chunked stepping and the
    profiler leave the closure-less run's bits as they were."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    flags = [str(tmp_path / f) if f == "trace" else f for f in flags]

    def state(extra, ck):
        assert run_sim.main([fx, "--device", "cpu", "--steps", "2",
                             "--checkpoint-dir", str(tmp_path / ck),
                             *extra]) == 0
        return checkpoint.load_checkpoint(tmp_path / ck / "step_000002")[0]

    got, want = state(flags, "ck"), state([], "ck0")
    assert "not yet ported" not in capsys.readouterr().out
    assert all(np.isfinite(got[n]).all() for n in STATE)
    same = all(np.array_equal(got[n], want[n]) for n in STATE)
    assert same == ("--closure" not in flags)
    if "--profile" in flags:
        assert list((tmp_path / "trace").glob("trace_*.json"))


def _jax_run_sim(argv):
    from wrf_tpu import run_sim as jax_run_sim

    assert jax_run_sim.main([str(a) for a in argv]) == 0


@pytest.fixture(scope="module")
def balanced_fx(tmp_path_factory):
    """The long-horizon fixture (balanced base winds, amplitude 1e-2)."""
    case = fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)
    return fixtures.write_case(case, tmp_path_factory.mktemp("bal") / "fx",
                               steps=1)


def test_run_sim_nudge_matches_jax(tmp_path, balanced_fx, capsys):
    """4 closed large steps through the CLI on the CPU against JAX's
    ``run_sim --closure nudge``: every checkpoint within the RK3 tolerance.
    """
    common = [balanced_fx, "--closure", "nudge", "--steps", "4"]
    assert run_sim.main([*map(str, common), "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path / "port")]) == 0
    _jax_run_sim([*common, "--checkpoint-dir", tmp_path / "jax"])
    assert capsys.readouterr().out.count("grid-points/s") == 8
    for n in range(1, 5):
        got, step, _ = checkpoint.load_checkpoint(
            tmp_path / "port" / f"step_{n:06d}")
        want, _, _ = checkpoint.load_checkpoint(
            tmp_path / "jax" / f"step_{n:06d}")
        assert step == n and sorted(got) == sorted(want) == sorted(STATE)
        outputs_allclose(got, want, **TOL)


def test_run_sim_steps_per_sync_matches_host(tmp_path, balanced_fx, capsys):
    """--steps-per-sync 2: the final checkpoint equals host stepping's bit
    for bit, the chunks say they are device-resident, and the per-step
    diagnostics series is printed on both paths (tests/test_run_sim.py)."""
    common = [str(balanced_fx), "--device", "cpu", "--steps", "4",
              "--closure", "nudge", "--diagnostics"]
    assert run_sim.main(common + ["--checkpoint-dir",
                                  str(tmp_path / "host")]) == 0
    assert run_sim.main(common + ["--steps-per-sync", "2", "--checkpoint-dir",
                                  str(tmp_path / "chunk")]) == 0
    out = capsys.readouterr().out
    assert out.count("device-resident") == 2
    assert out.count("total dry mass") >= 8
    host, _, _ = checkpoint.load_checkpoint(tmp_path / "host" / "step_000004")
    chunk, step, _ = checkpoint.load_checkpoint(
        tmp_path / "chunk" / "step_000004")
    assert step == 4 and sorted(chunk) == sorted(host)
    for name in host:
        np.testing.assert_array_equal(chunk[name], host[name], err_msg=name)
    # the chunk's float32 perturbation sums are the host's float64 ones to
    # rtol 1e-5 (the total adds sum(mut) on one path, sums muts on the
    # other, as in JAX's run_sim, so the drift columns differ)
    pert = [float(x) for x in re.findall(r"perturbation sum ([-+0-9.e]+)",
                                         out)]
    assert len(pert) == 8
    np.testing.assert_allclose(pert[4:], pert[:4], rtol=1e-5)


def test_run_sim_nudge_resume_continuity(tmp_path, balanced_fx, capsys):
    """A resumed --closure nudge run relaxes toward the run's ORIGINAL
    state, not the checkpointed one: 2 steps + resume 2 equals 4 straight
    steps bit for bit (tests/test_run_sim.py)."""
    common = [str(balanced_fx), "--device", "cpu", "--closure", "nudge"]
    assert run_sim.main(common + ["--steps", "4", "--checkpoint-dir",
                                  str(tmp_path / "ck4")]) == 0
    ck = tmp_path / "ck_res"
    assert run_sim.main(common + ["--steps", "2", "--checkpoint-dir",
                                  str(ck)]) == 0
    assert run_sim.main(common + ["--steps", "2", "--checkpoint-dir",
                                  str(ck), "--resume"]) == 0
    assert "resuming from" in capsys.readouterr().out
    straight, _, _ = checkpoint.load_checkpoint(tmp_path / "ck4" /
                                                "step_000004")
    resumed, step, _ = checkpoint.load_checkpoint(ck / "step_000004")
    assert step == 4
    for name in STATE:
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)


def test_run_sim_chunk_checkpoints_where_jax_puts_them(tmp_path, balanced_fx,
                                                       capsys):
    """--steps-per-sync 3 --checkpoint-every 2 over 5 steps: a checkpoint
    when a chunk crosses a multiple of 2 and at the end, the same
    directories JAX's run_sim writes (steps 3 and 5)."""
    flags = [balanced_fx, "--closure", "nudge", "--steps", "5",
             "--steps-per-sync", "3", "--checkpoint-every", "2"]
    assert run_sim.main([*map(str, flags), "--device", "cpu",
                         "--checkpoint-dir", str(tmp_path / "port")]) == 0
    _jax_run_sim([*flags, "--kernel", "xla", "--checkpoint-dir",
                  tmp_path / "jax"])
    names = {d: sorted(p.name for p in (tmp_path / d).iterdir())
             for d in ("port", "jax")}
    assert names["port"] == names["jax"] == ["step_000003", "step_000005"]
    assert capsys.readouterr().out.count("device-resident") == 4


def test_run_sim_profile_writes_trace(tmp_path, balanced_fx, capsys):
    """--profile DIR writes a torch.profiler Chrome trace there."""
    assert run_sim.main([str(balanced_fx), "--device", "cpu", "--closure",
                         "nudge", "--steps", "2", "--steps-per-sync", "2",
                         "--profile", str(tmp_path / "tr")]) == 0
    traces = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(traces) == 1
    assert '"traceEvents"' in traces[0].read_text()


def test_run_sim_nudge_mesh_equals_1x1(tmp_path, balanced_fx, capsys):
    """--closure nudge on a 2x2 mesh under the rdma backend (K5's plain
    version on the CPU) equals the 1x1 run bit for bit over 3 steps."""
    common = [str(balanced_fx), "--device", "cpu", "--closure", "nudge",
              "--steps", "3"]
    for name, extra in (("mesh", ["--mesh", "2x2", "--halo-backend",
                                  "rdma"]), ("ref", [])):
        assert run_sim.main(common + ["--checkpoint-dir",
                                      str(tmp_path / name), *extra]) == 0
    got, _, _ = checkpoint.load_checkpoint(tmp_path / "mesh" / "step_000003")
    ref, _, _ = checkpoint.load_checkpoint(tmp_path / "ref" / "step_000003")
    for name in STATE:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


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
