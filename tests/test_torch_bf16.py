"""Reduced-precision (bf16) constant streams through the port, on the CPU,
against the JAX package: ``tests/test_bf16.py``'s tests mirrored for both
loops and RK3, the wrappers' eligible sets, and the two CLIs.

The port's wrappers run their plain versions here, which widen a bf16
operand with ``.float()`` where the CUDA kernels widen it on load; the JAX
kernels run in Pallas interpret mode.  Both sides get one
``case_to_domain`` dict.  Tolerances: bf16 against float32 inputs 2e-2 of
field scale (the mode's contract, ``tests/test_bf16.py``); the port
against JAX with bf16 on BOTH sides rtol 5e-5, atol_scale 2e-6 (the loops'
float32 tolerance: both round the same float32 constants to nearest even,
so the narrow streams hold the same bits); a bf16 operand against the
float32 call on the rounded values: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.ops.advance_mu_t_pallas import advance_mu_t_pallas
from wrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_tpu.parallel.sharded import ShardedAdvanceMuT as JaxShardedAdvanceMuT
from wrf_tpu_torch import driver, run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import ShardedAdvanceMuT, case_to_domain

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
NX, NY, NZ = 40, 36, 12
BF = torch.bfloat16


@pytest.fixture(scope="module")
def case():
    return fixtures.make_case(NX, NY, NZ, halo=2, seed=11)


def _cpu_mesh(shape=(2, 2)):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _jax_mesh(shape=(2, 2)):
    return jax_make_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _run(loop, case, with_w=False):
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)), case.rdx,
               case.rdy, case.dts, case.epssm)
    if isinstance(next(iter(out.values())), torch.Tensor):
        return arrays_to_numpy(out)
    return {k: np.asarray(v) for k, v in out.items()}


LOOPS = {
    "coupled": (SmallStepLoop, JaxSmallStepLoop, {}),
    "coupled+w": (SmallStepLoop, JaxSmallStepLoop, {"with_w": True}),
    "coupled~blk": (SmallStepLoop, JaxSmallStepLoop, {"inner_steps": 2}),
    "mu_t": (ShardedAdvanceMuT, JaxShardedAdvanceMuT, {"vary_winds": True}),
    "mu_t~blk": (ShardedAdvanceMuT, JaxShardedAdvanceMuT,
                 {"vary_winds": True, "inner_steps": 4}),
}


@pytest.mark.parametrize("name", list(LOOPS))
def test_bf16_const_streams_track_f32_and_jax(case, name):
    """tests/test_bf16.py::test_bf16_const_streams_track_f32 for the port's
    loops (plus the blocked ones, which narrow K2's and K3's streams), and
    the port's bf16 loop against the JAX bf16 loop."""
    cls, jcls, kw = LOOPS[name]
    with_w = kw.get("with_w", False)
    f32 = _run(cls(NX, NY, NZ, case.flags, n_steps=6, device="cpu",
                   mesh=_cpu_mesh(), **kw), case, with_w)
    bf = _run(cls(NX, NY, NZ, case.flags, n_steps=6, device="cpu",
                  mesh=_cpu_mesh(), const_dtype=BF, **kw), case, with_w)
    drifted = False
    fields = ("t", "mu", "ww", "muts") + (("w", "pp") if with_w else ())
    for n in fields:
        a, b = f32[n], bf[n]
        assert b.dtype == np.float32          # outputs stay f32
        assert np.isfinite(b).all()
        scale, err = np.max(np.abs(a)), np.max(np.abs(a - b))
        assert err <= 2e-2 * scale, (n, err, scale)
        drifted |= err > 0
    assert drifted  # the mode is actually active (not silently ignored)
    want = _run(jcls(_jax_mesh(), NX, NY, NZ, case.flags, n_steps=6,
                     const_dtype=jnp.bfloat16, **kw), case, with_w)
    assert sorted(bf) == sorted(want)
    outputs_allclose(bf, want, **TOL)
    # one shard gives what the mesh gives: the cast is per element
    one = _run(cls(NX, NY, NZ, case.flags, n_steps=6, device="cpu",
                   const_dtype=BF, **kw), case, with_w)
    for n in one:
        np.testing.assert_array_equal(one[n], bf[n], err_msg=n)


@pytest.mark.parametrize("kw", [{}, {"inner_steps": 2}],
                         ids=["S1", "S2"])
def test_rk3_bf16_tracks_f32_and_jax(case, kw):
    def port(const_dtype):
        rk3 = RK3Integrator(NX, NY, NZ, case.flags, acoustic_steps=4,
                            device="cpu", mesh=_cpu_mesh(),
                            const_dtype=const_dtype, **kw)
        out = rk3.step(rk3.prepare(case_to_domain(case)), case.rdx, case.rdy,
                       case.dts * 4, case.epssm)
        return arrays_to_numpy(out)

    f32, bf = port(None), port(BF)
    for n in ("t", "mu", "ww", "muts"):
        scale, err = np.max(np.abs(f32[n])), np.max(np.abs(f32[n] - bf[n]))
        assert 0 < err <= 2e-2 * scale, (n, err, scale)
    jrk3 = JaxRK3Integrator(_jax_mesh(), NX, NY, NZ, case.flags,
                            acoustic_steps=4, const_dtype=jnp.bfloat16, **kw)
    want = jrk3.step(jrk3.prepare(case_to_domain(case)), case.rdx, case.rdy,
                     case.dts * 4, case.epssm)
    outputs_allclose(bf, {k: np.asarray(v) for k, v in want.items()}, **TOL)


def test_bf16_composes_with_overlap_smdiv_and_w(case):
    """The loops' arguments are independent: none is refused, and the
    exchange backend changes no bit of a bf16 run."""
    def run(backend):
        return _run(SmallStepLoop(NX, NY, NZ, case.flags, n_steps=6,
                                  device="cpu", mesh=_cpu_mesh(),
                                  const_dtype=BF, smdiv=0.1, with_w=True,
                                  halo_backend=backend), case, True)

    a, b = run("rdma_overlap"), run("ppermute")
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
        assert np.isfinite(a[n]).all()


def test_cast_bit_patterns_match_jax(case):
    """``jnp.astype(bfloat16)`` and ``Tensor.to(torch.bfloat16)`` both round
    to nearest even: the 16-bit patterns are the same, also for values that
    lie exactly between two bf16 numbers, and widening back is exact."""
    dom = case_to_domain(case)
    ties = np.array([1.00390625, 1.01171875, -3.0078125, 65280.0 * 1.001,
                     1e-40, 3.3895314e38, 0.0, -0.0], np.float32)
    for x in (dom["t_1"], dom["ww_1"], dom["ft"], ties):
        x = np.ascontiguousarray(x, np.float32)
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
        got = torch.tensor(x).to(BF).view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want)
        wide = torch.tensor(x).to(BF).float().numpy()
        np.testing.assert_array_equal(
            wide.view(np.uint32), got.astype(np.uint32) << 16)


# ---------------------------------------------------------------------
# the wrappers: eligible sets, state operands, mixed sets
# ---------------------------------------------------------------------
def _k1_inputs(case):
    kw = case.kernel_kwargs()
    arr = {k: torch.tensor(np.asarray(v, np.float32))
           for k, v in kw.items() if hasattr(v, "ndim")}
    b = case.bounds
    i0, i1, j0, j1, k0, k1_ = b.loop_bounds(case.flags)
    static = dict(window=(i0, i1, j0, j1), k0=k0, k1=k1_,
                  kde=b.mem(b.kde, "k"),
                  **{k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")})
    return arr, static


def _narrowed(arr, names):
    return {k: (v.to(BF) if k in names else v.clone())
            for k, v in arr.items()}


def _rounded(arr, names):
    return {k: (v.to(BF).float() if k in names else v.clone())
            for k, v in arr.items()}


K1_MODES = {
    "full": (dict(), ("t_1", "ww_1", "u_1", "v_1", "ft", "u", "v")),
    "full+uv": (dict(fuse_uv=True, cs2=0.3),
                ("t_1", "ww_1", "u_1", "v_1", "ft")),
}


@pytest.mark.parametrize("mode", list(K1_MODES))
def test_k1_eligible_set_and_state_operands(case, mode):
    """Every eligible operand alone, all together and a mixed set equal the
    float32 call on the rounded values bit for bit; every other 3-D operand
    raises the JAX wrapper's ValueError, here and there."""
    arr, static = _k1_inputs(case)
    mkw, eligible = K1_MODES[mode]
    for names in ([n] for n in eligible):
        got = k1.advance_mu_t_fused(**_narrowed(arr, names), **static, **mkw)
        want = k1.advance_mu_t_fused(**_rounded(arr, names), **static, **mkw)
        assert all(torch.equal(got[n], want[n]) for n in want), names
    for names in (eligible, eligible[::2]):     # the whole set, a mixed one
        got = k1.advance_mu_t_fused(**_narrowed(arr, names), **static, **mkw)
        want = k1.advance_mu_t_fused(**_rounded(arr, names), **static, **mkw)
        for n in want:
            assert got[n].dtype == torch.float32
            assert torch.equal(got[n], want[n]), (names, n)
    state = [n for n in ("ww", "t", "t_ave", "u", "v") if n not in eligible]
    for n in state:
        msg = (f"bf16 '{n}' is not a constant stream here "
               r"\(state/aliased operands must be f32\)")
        with pytest.raises(ValueError, match=msg):
            k1.advance_mu_t_fused(**_narrowed(arr, [n]), **static, **mkw)
        jarr = {k: jnp.asarray(v.numpy(), jnp.bfloat16 if k == n else None)
                for k, v in arr.items()}
        with pytest.raises(ValueError, match=msg):
            advance_mu_t_pallas(**jarr, **static, **mkw, interpret=True)


def test_k1_lean_constants_may_be_narrow(case):
    """The scan substep's streams: tconst and dvdxi_const narrow, ww1_k0
    (2-D) stays float32."""
    arr, static = _k1_inputs(case)
    sc = {k: static[k] for k in ("rdx", "rdy", "dts")}
    lean = k1.lean_kwargs(arr, **sc, k0=static["k0"], k1=static["k1"])
    mkw = dict(fuse_uv=True, cs2=0.3, lean=True, ww_mode="lite",
               with_tave=False)
    names = ("t_1", "tconst", "dvdxi_const")

    def call(cast):
        a = {k: v.clone() for k, v in arr.items()}
        lk = dict(lean)
        for n in names:
            tgt = a if n in a else lk
            tgt[n] = cast(tgt[n])
        return k1.advance_mu_t_fused(
            **a, **lk, **static, **mkw,
            ww_row=arr["ww"][:, static["k0"], :].clone())

    got, want = call(lambda x: x.to(BF)), call(lambda x: x.to(BF).float())
    ref = call(lambda x: x)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert not torch.equal(got["t"], ref["t"])


def _k2_inputs(case):
    arr, static = _k1_inputs(case)
    sc = {k: static[k] for k in ("rdx", "rdy", "dts")}
    lean = k1.lean_kwargs(arr, **sc, k0=static["k0"], k1=static["k1"])
    names = ("u", "v", "t", "t_1", "mu", "mu_tend", "msftx", "msfty", "dnw",
             "fnm", "fnp", "rdnw")
    ins = {**{k: arr[k] for k in names}, **lean,
           "ww_row": arr["ww"][:, static["k0"], :].clone()}
    return ins, static


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_k2_eligible_set_and_state_operands(case, fast):
    ins, static = _k2_inputs(case)
    eligible = k2.CONST_STREAMS
    assert eligible == ("u", "v", "t_1", "tconst", "dvdxi_const")
    kw = dict(n_inner=4, wind_scale_step=1e-7, fast=fast)
    for names in (eligible, ("u", "tconst"), ("t_1",)):
        got = k2.advance_mu_t_multistep(**_narrowed(ins, names), **static,
                                        **kw)
        want = k2.advance_mu_t_multistep(**_rounded(ins, names), **static,
                                         **kw)
        assert all(torch.equal(got[n], want[n]) for n in want), names
    with pytest.raises(ValueError,
                       match="bf16 't' is not a constant stream$"):
        k2.advance_mu_t_multistep(**_narrowed(ins, ["t"]), **static, **kw)


def _k3_inputs(case, S):
    """Ring-S inputs of K3 from a fixture's memory-window arrays (zero ring
    rows around them: the window masks keep them out)."""
    arr, static = _k1_inputs(case)
    from wrf_tpu_torch.parallel import halo
    wide = {k: (halo.widen_ring_to(v, 0, S) if v.ndim > 1 else v)
            for k, v in arr.items()}
    sc = {k: static[k] for k in ("rdx", "rdy", "dts")}
    ins = {"u": wide["u"], "v": wide["v"], "t": wide["t"], "mu": wide["mu"],
           "t_1": wide["t_1"], "mu_tend": wide["mu_tend"],
           "msftx": wide["msftx"], "msfty": wide["msfty"],
           **{k: wide[k] for k in ("dnw", "fnm", "fnp", "rdnw")},
           **k1.lean_kwargs(wide, **sc, k0=static["k0"], k1=static["k1"]),
           **k3.coupled_lean_kwargs(wide, **sc),
           "ww_row": wide["ww"][:, static["k0"], :].clone()}
    st = {k: v for k, v in static.items() if k != "epssm"}
    return ins, dict(st, cs2=0.3)


@pytest.mark.parametrize("fn,S", [("coupled_multistep", 2),
                                  ("coupled_multistep", 3),
                                  ("coupled_two_step", 2)])
def test_k3_k4_eligible_set_and_state_operands(case, fn, S):
    ins, static = _k3_inputs(case, S)
    call = getattr(k3, fn)
    kw = {} if fn == "coupled_two_step" else {"n_inner": S}
    assert k3.CONST_STREAMS == ("t_1", "tconst", "dvdxi_const")
    for names in (k3.CONST_STREAMS, ("tconst",)):
        got = call(**_narrowed(ins, names), **static, **kw)
        want = call(**_rounded(ins, names), **static, **kw)
        for n in want:
            assert torch.equal(got[n], want[n]), (names, n)
    for n in ("u", "v", "t"):
        with pytest.raises(ValueError,
                           match=f"bf16 '{n}' is not a constant stream$"):
            call(**_narrowed(ins, [n]), **static, **kw)


def test_const_dtype_requires_the_fused_kernel(case):
    """tests/test_bf16.py::test_const_dtype_requires_pallas, with the
    port's kernel names."""
    with pytest.raises(ValueError, match="const_dtype requires the fused "
                                         "kernel"):
        SmallStepLoop(NX, NY, NZ, case.flags, kernel="eager", device="cpu",
                      const_dtype=BF)
    with pytest.raises(ValueError, match="const_dtype requires the cuda "
                                         "kernel"):
        ShardedAdvanceMuT(NX, NY, NZ, case.flags, kernel="eager",
                          device="cpu", const_dtype=BF)
    with pytest.raises(ValueError, match="const_dtype requires the fused"):
        RK3Integrator(NX, NY, NZ, case.flags, kernel="eager", device="cpu",
                      const_dtype=BF)
    mesh = _jax_mesh((1, 1))
    for jcls in (JaxSmallStepLoop, JaxShardedAdvanceMuT):
        with pytest.raises(ValueError, match="const_dtype requires the "
                                             "pallas kernel"):
            jcls(mesh, NX, NY, NZ, case.flags, kernel="xla",
                 const_dtype=jnp.bfloat16)
    for cls in (SmallStepLoop, ShardedAdvanceMuT):
        with pytest.raises(ValueError, match="const_dtype must be "
                                             "torch.bfloat16 or None"):
            cls(NX, NY, NZ, case.flags, device="cpu",
                const_dtype=torch.float16)


# ---------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    [], ["--mesh", "2x2", "--halo-backend", "rdma_overlap"],
    ["--inner-steps", "2", "--with-w"],
], ids=["1x1", "2x2-overlap", "S2+w"])
def test_run_sim_precision_bf16_const(tmp_path, small_case, capsys, flags):
    """One large step with --precision bf16-const is within 2e-2 of field
    scale of the float32 run and differs from it."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))

    def state(extra, ck):
        assert run_sim.main([fx, "--device", "cpu", *flags, *extra,
                             "--checkpoint-dir", str(tmp_path / ck)]) == 0
        return checkpoint.load_checkpoint(tmp_path / ck / "step_000001")[0]

    bf = state(["--precision", "bf16-const"], "bf")
    f32 = state(["--precision", "f32"], "f32")
    assert "step 1:" in capsys.readouterr().out
    drifted = False
    for n in f32:
        scale, err = np.abs(f32[n]).max(), np.abs(f32[n] - bf[n]).max()
        assert err <= 2e-2 * max(scale, 1e-30), (n, err, scale)
        drifted |= err > 0
    assert drifted


def test_run_sim_bf16_with_the_eager_kernel_raises(tmp_path, small_case):
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    with pytest.raises(ValueError, match="const_dtype requires the fused"):
        run_sim.main([fx, "--device", "cpu", "--kernel", "eager",
                      "--precision", "bf16-const"])


@pytest.fixture(scope="module")
def fx9(tmp_path_factory):
    case = fixtures.make_case(20, 18, 8, halo=2, seed=7)
    return fixtures.write_case(case, tmp_path_factory.mktemp("bf16") / "fx",
                               steps=9)


@pytest.mark.parametrize("tier", ["sharded-cuda", "coupled"])
def test_driver_bf16_gate(fx9, capsys, tier):
    """--precision bf16-const passes at 2e-2 / 2e-2 and would fail the
    float32 gate (1e-4 / 1e-5): the relaxed gate is what lets it pass."""
    assert (driver.BF16_RTOL, driver.BF16_ATOL_SCALE) == (2e-2, 2e-2)
    rc = driver.main([str(fx9), "--tier", tier, "--precision", "bf16-const",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    case, steps = fixtures.read_case(fx9)
    res, _, gold = driver.run_tier(case, steps, tier, "cpu",
                                   const_dtype=torch.bfloat16)
    if gold is None:
        gold = fixtures.read_golden(fx9, case.bounds)
    strict = [driver.compare(res[n], gold[n], n, rtol=driver.RTOL,
                             atol_scale=driver.ATOL_SCALE)
              for n in ("t", "mu", "ww")]
    assert not all(r.passed for r in strict)


def test_driver_all_has_the_jax_matrix_rows(fx9, capsys):
    """--tier all: the 18 rows of wrf_tpu.driver's matrix, the two bf16
    rows among them, all PASS."""
    assert len(driver.ALL_ROWS) == 18
    assert {"sharded-cuda~bf16", "coupled~bf16"} <= set(driver.ALL_ROWS)
    rc = driver.main([str(fx9), "--tier", "all", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("PASS") == 18
    for row in driver.ALL_ROWS:
        assert f"{row}:" in out
