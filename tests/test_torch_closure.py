"""The port's long-horizon path against the JAX package's: the nudging
closure (models/tendencies.py), the tendency hook, the numpy golden RK3
integrations and the chunked ``multi_step``.

Bit-equal where both sides run the same float32 operations in the same
order (the closure's arithmetic, the numpy goldens); 10 closed large steps
of the port's loop against JAX's golden run at rtol 2e-4, atol_scale 2e-5
(tests/test_closure.py's tolerance); ``multi_step`` bit-equal to host
stepping (the same launches, eagerly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu.models import rk3 as jax_rk3
from wrf_tpu.models import tendencies as jax_tend
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.rk3 import RK3Integrator, rk3_golden, rk3_golden_run
from wrf_tpu_torch.models.tendencies import (
    NudgingTendencies, golden_nudging_fn,
)
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain

torch.set_num_threads(1)

CLOSED_TOL = dict(rtol=2e-4, atol_scale=2e-5)
STATE = ("ww", "mu", "t", "t_ave", "u", "v")


@pytest.fixture(scope="module")
def balanced_case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)


@pytest.fixture(scope="module")
def jax_balanced_case():
    return jax_fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                                  balanced=True)


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def _mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _nudge_inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = {n: rng.standard_normal(shape).astype(np.float32) * scale
         for n, shape, scale in (("t", (20, 8, 22), 3.0),
                                 ("mu", (20, 22), 50.0),
                                 ("u", (20, 8, 22), 1e4),
                                 ("v", (20, 8, 22), 1e4))}
    g = {n: x + rng.standard_normal(x.shape).astype(np.float32) * 1e-2 * (
        np.abs(x).max()) for n, x in f.items()}
    return f, g


def _bits(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


@pytest.mark.parametrize("per_stage", [False, True])
def test_nudging_tendencies_bit_equal_to_jax(per_stage):
    """Stage 0, then stage 1 from another state (reused, or recomputed with
    ``per_stage``), then damp_winds: every field bit-equal to the JAX
    class's on the same numpy inputs."""
    ref, later = _nudge_inputs()
    dt = 13.7
    port = NudgingTendencies({k: torch.from_numpy(v) for k, v in ref.items()},
                             dt, tau_steps=6.0, rayleigh_uv=0.13,
                             per_stage=per_stage)
    jx = jax_tend.NudgingTendencies({k: jnp.asarray(v)
                                     for k, v in ref.items()},
                                    dt, tau_steps=6.0, rayleigh_uv=0.13,
                                    per_stage=per_stage)
    for stage, src in ((0, later), (1, ref)):
        got = port(stage, None, {k: torch.from_numpy(v)
                                 for k, v in src.items()})
        want = jx(stage, None, {k: jnp.asarray(v) for k, v in src.items()})
        assert sorted(got) == sorted(want) == ["ft", "mu_tend"]
        for n in got:
            _bits(got[n], want[n], f"stage {stage} {n}")
    # the reused stage-1 tendencies are the stage-0 ones (the state at
    # stage 1 equals the reference, so recomputed they would be zero)
    assert (float(got["ft"].abs().max()) == 0.0) == per_stage

    arrays = {k: torch.from_numpy(v) for k, v in later.items()}
    jarrays = {k: jnp.asarray(v) for k, v in later.items()}
    port.damp_winds(arrays)
    jx.damp_winds(jarrays)
    for n in ("u", "v", "t", "mu"):
        _bits(arrays[n], jarrays[n], f"damp_winds {n}")
    assert not torch.equal(arrays["u"], torch.from_numpy(later["u"]))


def test_nudging_tendencies_on_blocks(balanced_case):
    """On a mesh (every field a dict of blocks) the closure works block by
    block: its tendencies and damped winds are the 1x1 ones, scattered, and
    the mesh padding stays zero."""
    case = balanced_case
    dom = case_to_domain(case)
    dt = case.dts * 6
    one = RK3Integrator(*_dims(case), case.flags, device="cpu")
    # (3, 4) pads the 20x22 ring-shaped fields to 21x24
    mesh = RK3Integrator(*_dims(case), case.flags, device="cpu",
                         mesh=_mesh((3, 4)))
    a1, am = one.prepare(dom), mesh.prepare(dom)
    f1, fm = NudgingTendencies(a1, dt), NudgingTendencies(am, dt)
    later = {k: dict(v) for k, v in am.items()}
    later["t"] = {c: b * 1.01 for c, b in am["t"].items()}
    t1 = f1(0, None, {**a1, "t": a1["t"] * 1.01})
    tm = fm(0, None, later)
    glob = mesh.unprepare(tm, ["ft", "mu_tend"])
    for n in ("ft", "mu_tend"):
        assert torch.equal(glob[n], t1[n]), n
    padded = torch.cat([torch.cat([tm["ft"][jj, ii] for ii in range(4)], -1)
                        for jj in range(3)], 0)
    J, _, I = t1["ft"].shape
    assert padded.shape[0] > J and padded.shape[-1] > I
    assert float(padded[J:].abs().max()) == 0.0
    assert float(padded[..., I:].abs().max()) == 0.0
    fm.damp_winds(am)
    f1.damp_winds(a1)
    assert torch.equal(mesh.unprepare(am, ["u"])["u"], a1["u"])


def test_tau_floor_enforced():
    with pytest.raises(ValueError, match="tau_steps"):
        NudgingTendencies({"t": None, "mu": None}, 12.0, tau_steps=1.0)


def test_golden_nudging_fn_bit_equal_to_jax(balanced_case, jax_balanced_case):
    dt = balanced_case.dts * 6
    got = golden_nudging_fn(balanced_case, dt, tau_steps=5.0)
    want = jax_tend.golden_nudging_fn(jax_balanced_case, dt, tau_steps=5.0)
    fields = dict(balanced_case.fields)
    fields["grid_t_2"] = fields["grid_t_2"] * np.float32(1.01)
    fields["grid_mu_2"] = fields["grid_mu_2"] + np.float32(0.5)
    g, w = got(fields), want(fields)
    assert sorted(g) == sorted(w) == ["mu_tend", "t_tend"]
    for n in g:
        assert g[n].dtype == np.float32
        _bits(g[n], w[n], n)


@pytest.mark.parametrize("snapshot,with_w,smdiv", [
    ("base", False, 0.0), ("stage", False, 0.0), ("base", True, 0.0),
    ("base", False, 0.1), ("stage", True, 0.1),
])
def test_rk3_golden_bit_equal_to_jax(balanced_case, jax_balanced_case,
                                     snapshot, with_w, smdiv):
    got = rk3_golden(balanced_case, acoustic_steps=4, snapshot=snapshot,
                     with_w=with_w, smdiv=smdiv)
    want = jax_rk3.rk3_golden(jax_balanced_case, acoustic_steps=4,
                              snapshot=snapshot, with_w=with_w, smdiv=smdiv)
    assert sorted(got) == sorted(want)
    for n in want:
        _bits(got[n], want[n], n)


def test_rk3_golden_run_bit_equal_to_jax(balanced_case, jax_balanced_case):
    """5 closed golden steps (nudging + Rayleigh damping, smdiv), and the
    diagnostics callback sees every step."""
    dt = balanced_case.dts * 6
    seen = []
    got = rk3_golden_run(
        balanced_case, 5, acoustic_steps=6, smdiv=0.1,
        tendency_fn=golden_nudging_fn(balanced_case, dt), rayleigh_uv=0.1,
        diag_cb=lambda step, out: seen.append(step))
    want = jax_rk3.rk3_golden_run(
        jax_balanced_case, 5, acoustic_steps=6, smdiv=0.1,
        tendency_fn=jax_tend.golden_nudging_fn(jax_balanced_case, dt),
        rayleigh_uv=0.1)
    assert seen == list(range(5))
    for n in want:
        _bits(got[n], want[n], n)


def test_balanced_base_flux_nondivergent(balanced_case):
    """The port's minted base winds recouple to a discretely non-divergent
    mass flux: rdx*d_i(U) + rdy*d_j(V) ~ 0 at every interior cell (the
    bound of tests/test_closure.py)."""
    f = balanced_case.fields
    U = (f["grid_muu"][:, None, :] * f["grid_u_save"]
         / f["grid_msfuy"][:, None, :])
    V = (f["grid_muv"][:, None, :] * f["grid_v_save"]
         * f["grid_msfvx_inv"][:, None, :])
    rdx = np.float32(balanced_case.rdx)
    rdy = np.float32(balanced_case.rdy)
    div = (rdx * (U[:-1, :, 1:] - U[:-1, :, :-1])
           + rdy * (V[1:, :, :-1] - V[:-1, :, :-1]))
    flux_scale = float(np.abs(U).max())
    assert float(np.abs(div).max()) < 20 * flux_scale * 1.2e-7 * float(rdx)


def _closed_run(rk3, case, n_steps, dt, diag=None):
    arrays = rk3.prepare(case_to_domain(case))
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    out = None
    for step in range(n_steps):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        if diag is not None:
            diag(step, out)
    return out


def test_closure_100_large_steps(balanced_case):
    """100 closed large steps of the port's RK3Integrator (plain kernels on
    the CPU): the state stays bounded and the total dry mass drifts by
    less than 2e-6 (tests/test_closure.py's bounds)."""
    case = balanced_case
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=6,
                        kernel="plain", smdiv=0.1, snapshot="base",
                        device="cpu")
    masses, maxts = [], []

    def diag(step, out):
        masses.append(out["muts"].sum(dtype=torch.float64).item())
        maxts.append(float(out["t"].abs().max()))

    out = _closed_run(rk3, case, 100, case.dts * 6, diag)
    assert torch.isfinite(out["t"]).all()
    t0 = float(np.abs(case.fields["grid_t_2"]).max())
    assert max(maxts) < 3.0 * t0, f"state grew: {max(maxts):.3e} vs {t0:.3e}"
    drift = max(abs(m - masses[0]) / abs(masses[0]) for m in masses)
    assert drift < 2e-6, f"total-mass drift {drift:.2e}"


def test_degenerate_shell_still_diverges(balanced_case):
    """Control: the stage-snapshot shell blows up within a few steps on
    the same fixture and loop (why the closure exists)."""
    case = balanced_case
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=6,
                        kernel="plain", snapshot="stage", device="cpu")
    arrays = rk3.prepare(case_to_domain(case))
    for _ in range(4):
        out = rk3.step(arrays, case.rdx, case.rdy, case.dts * 6, case.epssm)
        arrays = rk3.merge_evolved(arrays, out)
    t0 = float(np.abs(case.fields["grid_t_2"]).max())
    assert (not torch.isfinite(out["t"]).all()
            or float(out["t"].abs().max()) > 1e3 * t0)


@pytest.mark.parametrize("shape", [None, (4, 2)])
def test_closed_loop_matches_jax_golden(balanced_case, jax_balanced_case,
                                        shape):
    """10 closed large steps of the port's loop, on one shard and on a
    (4,2) mesh of CPU shards, against JAX's rk3_golden_run over the domain
    region (the run_sim long-horizon configuration)."""
    case = balanced_case
    dt = case.dts * 6
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=6,
                        kernel="plain", smdiv=0.1, snapshot="base",
                        device="cpu", mesh=_mesh(shape) if shape else None)
    out = arrays_to_numpy(_closed_run(rk3, case, 10, dt))
    gold = jax_rk3.rk3_golden_run(
        jax_balanced_case, 10, acoustic_steps=6, smdiv=0.1, snapshot="base",
        tendency_fn=jax_tend.golden_nudging_fn(jax_balanced_case, dt),
        rayleigh_uv=0.1)
    b = case.bounds
    j0, j1 = b.mem(b.jds, "j"), b.mem(b.jde, "j")
    i0, i1 = b.mem(b.ids, "i"), b.mem(b.ide, "i")
    got, want = {}, {}
    for n in STATE:
        g = np.asarray(gold[n])
        want[n] = (g[j0:j1 + 1, :, i0:i1 + 1] if g.ndim == 3
                   else g[j0:j1 + 1, i0:i1 + 1])
        got[n] = out[n]
        assert got[n].shape == want[n].shape
    outputs_allclose(got, want, **CLOSED_TOL)


def test_tendency_hook_call_order(balanced_case):
    """The hook sees (stage, previous stage's outputs or None) in order,
    and what it returns replaces the stage's tendencies."""
    case = balanced_case
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=2,
                        kernel="plain", device="cpu")
    arrays = rk3.prepare(case_to_domain(case))
    seen = []

    def hook(stage, prev_out, stage_arrays):
        seen.append((stage, prev_out is not None))
        return {"ft": stage_arrays["ft"] * 0.0}

    dt = case.dts * 2
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                   tendency_fn=hook)
    assert seen == [(0, False), (1, True), (2, True)]
    assert torch.isfinite(out["t"]).all()
    plain = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)
    assert not torch.equal(out["t"], plain["t"])


@pytest.mark.parametrize("shape,with_w", [(None, False), ((2, 2), False),
                                          (None, True)])
def test_multi_step_equals_host_stepping(balanced_case, shape, with_w):
    """3 chunked large steps equal 3 host-stepped ones (step, merge,
    damping) bit for bit; the diagnostics are (3, 2), finite, and within
    rtol 1e-5 of the host's float64 sums."""
    case = balanced_case
    dt = case.dts * 4
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        kernel="plain", smdiv=0.1, snapshot="base",
                        device="cpu", with_w=with_w,
                        mesh=_mesh(shape) if shape else None)
    arrays = rk3.prepare(case_to_domain(case, with_w=with_w))
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0)

    host, host_diag = dict(arrays), []
    for _ in range(3):
        out = rk3.step(host, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        host = rk3.merge_evolved(host, out)
        fn.damp_winds(host)
        host_diag.append(out["mu"].sum(dtype=torch.float64).item())

    chunk, diags = rk3.multi_step(arrays, 3, case.rdx, case.rdy, dt,
                                  case.epssm, tendency_fn=fn)
    assert isinstance(diags, np.ndarray) and diags.dtype == np.float32
    assert diags.shape == (3, 2) and np.isfinite(diags).all()
    names = [n for n in RK3Integrator._EVOLVED if n in arrays]
    assert ("w" in names) == with_w
    got = rk3.unprepare(chunk, names)
    want = rk3.unprepare(host, names)
    for n in names:
        assert torch.equal(got[n], want[n]), n
    np.testing.assert_allclose(diags[:, 0], host_diag, rtol=1e-5)
    # the input dict is left as it was, and the device-side form agrees
    assert arrays["t"] is not chunk["t"]
    _, dev = rk3.multi_step(arrays, 3, case.rdx, case.rdy, dt, case.epssm,
                            tendency_fn=fn, readback=False)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), diags)


def test_rk3_golden_run_defaults_match_open_loop(balanced_case):
    """Without a closure rk3_golden_run is rk3_golden folded step by step:
    one step of it is one rk3_golden step."""
    got = rk3_golden_run(balanced_case, 1, acoustic_steps=4)
    want = rk3_golden(balanced_case, acoustic_steps=4)
    for n in want:
        _bits(got[n], want[n], n)


def test_smoke_oracle_closed_run_matches_golden(balanced_case):
    """chip_smoke.py's closed run with the C++ oracle's substeps is the
    numpy rk3_golden_run, bit for bit (3 closed steps, smdiv)."""
    import chip_smoke

    case = balanced_case
    dt = case.dts * 6
    got = chip_smoke.rk3_golden_native_run(
        case, 3, 6, dt, 0.1, golden_nudging_fn(case, dt), 0.1)
    want = rk3_golden_run(case, 3, acoustic_steps=6, dt=dt, smdiv=0.1,
                          tendency_fn=golden_nudging_fn(case, dt),
                          rayleigh_uv=0.1)
    for n in STATE:
        _bits(got[n], want[n], n)


def test_thomas_bundles_built_once_from_host_copies(balanced_case,
                                                    monkeypatch):
    """With ``with_w`` the loops build each stage's Thomas K-vectors once,
    from the host copies prepare kept: two closed large steps read no
    vertical vector back from the device, the three stages share one
    memo and so one cache, and the bundles equal those built from the
    tensors."""
    from wrf_tpu_torch.ops import thomas

    case = balanced_case
    dt = case.dts * 4
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        kernel="plain", snapshot="base", device="cpu",
                        with_w=True)
    assert all(loop.memo is rk3.loops[0].memo for loop in rk3.loops)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    readbacks = []
    host = thomas._host
    monkeypatch.setattr(thomas, "_host", lambda x: (
        readbacks.append(x) if isinstance(x, torch.Tensor) else None,
        host(x))[1])
    fn = NudgingTendencies(arrays, dt)
    arrays, _ = rk3.multi_step(arrays, 2, case.rdx, case.rdy, dt, case.epssm,
                               tendency_fn=fn)
    assert readbacks == []
    bundles = rk3.loops[0].memo.thomas._bundles
    # stage 1 takes dt/3 a substep, stages 2 and 3 both dt/4
    assert len(bundles) == 2
    for rdn, rdnw, got in bundles.values():
        dts = next(k[2] for k, v in bundles.items() if v[2] is got)
        want = thomas.thomas_vectors(rdn=rdn, rdnw=rdnw, dts=dts,
                                     epssm=case.epssm, cw=rk3.loops[0].cw,
                                     gw=rk3.loops[0].gw,
                                     k0=rk3.loops[0].window[4],
                                     k1=rk3.loops[0].window[5])
        for name in ("a", "cp", "den", "crdn", "erdn"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert (got.c_w, got.g_t, got.beta) == (want.c_w, want.g_t,
                                                want.beta)
