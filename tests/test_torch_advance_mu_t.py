"""K1 in the port: the plain PyTorch substep (what advance_mu_t_fused runs
on CPU tensors) against the JAX package's Pallas kernel, run in interpret
mode on the CPU as tests/test_pallas.py runs it.  Same numpy inputs to
both; tolerance rtol 2e-5, atol_scale 1e-6 (assert_outputs_allclose's
defaults: the two differ only in the order of the dmdt column sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.ops import advance_mu_t_pallas as pallas_mod
from wrf_tpu.ops.advance_uv import DEFAULT_CS2
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.models.small_step import DEFAULT_CS2 as PORT_CS2

torch.set_num_threads(1)

MODES = {
    # the reference's single call
    "full": dict(),
    # SmallStepLoop scan substep
    "scan": dict(fuse_uv=True, lean=True, ww_mode="lite", with_tave=False),
    # SmallStepLoop final substep
    "final": dict(fuse_uv=True, ww_mode="final", with_tave=True),
}


def _inputs(case):
    """Memory-window numpy arrays, scalars and static kwargs of one call."""
    kw = case.kernel_kwargs()
    arr = {k: np.asarray(v, np.float32) for k, v in kw.items()
           if hasattr(v, "ndim")}
    b = case.bounds
    i0, i1, j0, j1, k0, k1_ = b.loop_bounds(case.flags)
    static = dict(window=(i0, i1, j0, j1), k0=k0, k1=k1_,
                  kde=b.mem(b.kde, "k"))
    sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
    return arr, sc, static


def _mode_kwargs(mode, arr, sc, static):
    """Mode flags plus the scan-seed row (a perturbed ww(k0), so that the
    seed and ww really differ) for lite/final."""
    kw = dict(MODES[mode])
    if kw.get("fuse_uv"):
        kw["cs2"] = DEFAULT_CS2
    if kw.get("ww_mode") in ("lite", "final"):
        k0 = static["k0"]
        kw["ww_row"] = (arr["ww"][:, k0, :]
                        + np.float32(0.01) * arr["ww_1"][:, k0 + 1, :])
    return kw


def _run_jax(arr, sc, static, mkw):
    mkw = dict(mkw)
    if mkw.get("lean"):
        mkw.update(pallas_mod.lean_kwargs(
            {k: jnp.asarray(v) for k, v in arr.items()},
            sc["rdx"], sc["rdy"], sc["dts"], static["k0"], static["k1"]))
    out = pallas_mod.advance_mu_t_pallas(**arr, **sc, **static, **mkw,
                                         interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


def _run_torch(arr, sc, static, mkw):
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    mkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in mkw.items()}
    if mkw.get("lean"):
        mkw.update(k1.lean_kwargs(tarr, sc["rdx"], sc["rdy"], sc["dts"],
                                  static["k0"], static["k1"]))
    out = k1.advance_mu_t_fused(**tarr, **sc, **static, **mkw)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_plain_matches_pallas(case_name, mode, request):
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    mkw = _mode_kwargs(mode, arr, sc, static)
    want = _run_jax(arr, sc, static, mkw)
    got = _run_torch(arr, sc, static, mkw)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want)


@pytest.mark.parametrize("case_name", ["small_case", "open_bc_case"])
def test_lean_constants_match_jax(case_name, request):
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    want = pallas_mod.lean_kwargs(
        {k: jnp.asarray(v) for k, v in arr.items()},
        sc["rdx"], sc["rdy"], sc["dts"], static["k0"], static["k1"])
    got = k1.lean_kwargs({k: torch.tensor(v) for k, v in arr.items()},
                         sc["rdx"], sc["rdy"], sc["dts"], static["k0"],
                         static["k1"])
    outputs_allclose({k: v.numpy() for k, v in got.items()},
                     {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("mode", ["full", "final"])
def test_edge_rows_never_computed(small_case, mode):
    """Rows 0 and J-1 pass the state through and zero the diagnostics even
    when the window covers them (tj divides J-2, so the TPU kernel's
    tiles leave exactly those rows alone)."""
    arr, sc, static = _inputs(small_case)
    J, _, I = arr["t"].shape
    assert (J - 2) % 4 == 0
    static = {**static, "window": (0, I - 1, 0, J - 1)}
    mkw = _mode_kwargs(mode, arr, sc, static)
    want = pallas_mod.advance_mu_t_pallas(**arr, **sc, **static, **mkw,
                                          tj=4, interpret=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = _run_torch(arr, sc, static, mkw)
    outputs_allclose(got, want)
    for edge in (0, J - 1):
        assert (got["t"][edge] == arr["t"][edge]).all()
        assert (got["mu"][edge] == arr["mu"][edge]).all()
        assert (got["muave"][edge] == 0).all()


#: the buffer contract's cases: (mode of MODES, fuse_w, extra keywords),
#: MODES' three (full, the lite scan, final) with and without fuse_w, then
#: the capture and divergence damping
CONTRACT = {f"{m}-{w}": (m, w, {}) for m in MODES for w in (False, True)}
CONTRACT.update(capture=("full", False, dict(capture=True)),
                damping=("final", True, dict(smdiv=0.1)))


@pytest.mark.parametrize("case", list(CONTRACT))
def test_in_place_contract(small_case, case):
    """K1 writes no operand: every input keeps its contents and its
    ``_version``, and every output is a tensor of its own, sharing no
    storage with any input, whatever the mode."""
    arr, sc, static = _inputs(small_case)
    mode, fuse_w, extra = CONTRACT[case]
    mkw = {**_mode_kwargs(mode, arr, sc, static), **extra}
    if fuse_w:
        f = small_case.fields
        mkw.update(fuse_w=True, **{n: np.asarray(f["grid_" + n], np.float32)
                                   for n in ("w", "pp", "rdn")})
    if mkw.get("smdiv"):
        mkw["mudf_in"] = _mudf_in(arr, sc, static)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    tarr.update({k: torch.tensor(v) for k, v in mkw.items()
                 if isinstance(v, np.ndarray)})
    flags = {k: v for k, v in mkw.items() if not isinstance(v, np.ndarray)}
    if flags.get("lean"):
        tarr.update(k1.lean_kwargs(tarr, sc["rdx"], sc["rdy"], sc["dts"],
                                   static["k0"], static["k1"]))
    before = {k: (x.clone(), x._version) for k, x in tarr.items()}
    out = k1.advance_mu_t_fused(**tarr, **sc, **static, **flags)
    for k, (x, version) in before.items():
        assert torch.equal(tarr[k].nan_to_num(), x.nan_to_num()), k
        assert tarr[k]._version == version, k
    inputs = {x.untyped_storage().data_ptr() for x in tarr.values()}
    for k, x in out.items():
        assert x.untyped_storage().data_ptr() not in inputs, k
    carried = {"t"} | ({"ww_row"} if flags.get("ww_mode") == "lite"
                       else {"ww"}) | ({"w", "pp"} if fuse_w else set())
    assert carried <= set(out)
    assert not torch.equal(out["t"], tarr["t"])


@pytest.mark.parametrize("mode", ["overlap"])
def test_unported_modes_raise(small_case, mode):
    """``overlap`` was refused until it was ported; now it runs: on a ring
    of one the neighbour rows are the block's own first and last interior
    rows, and the call equals, bit for bit, the call on halo rows that
    were refreshed with them (the memory halo rows poisoned)."""
    assert mode == "overlap"
    arr, sc, static = _inputs(small_case)
    kw = dict(fuse_uv=True, cs2=DEFAULT_CS2)
    ref = {k: torch.tensor(v) for k, v in arr.items()}
    for n in ("mu", "v"):
        ref[n][0], ref[n][-1] = ref[n][-2].clone(), ref[n][1].clone()
    want = k1.advance_mu_t_fused(**ref, **sc, **static, **kw)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    rows = dict(mu_lo=tarr["mu"][-2].clone(), mu_hi=tarr["mu"][1].clone(),
                v_hi=tarr["v"][1].clone())
    for n in ("mu", "v"):
        tarr[n][0] = tarr[n][-1] = 1e30
    got = k1.advance_mu_t_fused(**tarr, **sc, **static, **kw, overlap=rows)
    assert sorted(got) == sorted(want)
    for n in want:
        assert torch.equal(got[n][1:-1], want[n][1:-1]), n
        assert got[n][1:-1].abs().max() < 1e20, f"poison leaked into {n}"
    with pytest.raises(ValueError, match="overlap requires fuse_uv"):
        k1.advance_mu_t_fused(**tarr, **sc, **static, overlap=rows)


WIND_SCALE_MODES = {
    # ShardedAdvanceMuT's scan substep and its final substep
    "lite": dict(lean=True, ww_mode="lite", with_tave=False),
    "final": dict(ww_mode="final", with_tave=True),
}


@pytest.mark.parametrize("mode", list(WIND_SCALE_MODES))
@pytest.mark.parametrize("case_name", ["small_case", "open_bc_case"])
def test_wind_scale_matches_pallas(case_name, mode, request):
    """The read-only winds scaled on load (the mu/t loop's ramp)."""
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    k0 = static["k0"]
    mkw = dict(WIND_SCALE_MODES[mode], wind_scale=1.5,
               ww_row=arr["ww"][:, k0, :]
               + np.float32(0.01) * arr["ww_1"][:, k0 + 1, :])
    want = _run_jax(arr, sc, static, mkw)
    got = _run_torch(arr, sc, static, mkw)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want)
    unscaled = _run_torch(arr, sc, static, {**mkw, "wind_scale": 1.0})
    assert not np.array_equal(got["t"], unscaled["t"])


def test_fuse_uv_with_wind_scale_raises(small_case):
    arr, sc, static = _inputs(small_case)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    with pytest.raises(ValueError, match="mutually exclusive"):
        k1.advance_mu_t_fused(**tarr, **sc, **static, fuse_uv=True,
                              wind_scale=1.5)


def test_bf16_inputs_raise(small_case):
    """A bf16 constant stream was refused until it was ported; now it is
    widened on load: the call equals, bit for bit, the float32 call on the
    rounded values.  A bf16 STATE operand raises, with the JAX message."""
    arr, sc, static = _inputs(small_case)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    ref = {k: v.clone() for k, v in tarr.items()}
    ref["t_1"] = ref["t_1"].to(torch.bfloat16).float()
    want = k1.advance_mu_t_fused(**ref, **sc, **static)
    tarr["t_1"] = tarr["t_1"].to(torch.bfloat16)
    got = k1.advance_mu_t_fused(**tarr, **sc, **static)
    for n in want:
        assert got[n].dtype == torch.float32
        assert torch.equal(got[n], want[n]), n
    tarr["t"] = tarr["t"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 't' is not a constant stream"):
        k1.advance_mu_t_fused(**tarr, **sc, **static)


def test_block_width_and_cs2():
    """K1's block: 32 lanes along i by BLOCK_ROWS rows along j.  Only
    fuse_w keeps a K-long shared-memory slice per thread (the w/pp sweep
    state), and it takes fewer rows as K grows, up to the 48 KB a block
    gets without opting in; without fuse_w no K is too deep."""
    assert (k1.LANES, k1.BLOCK_ROWS) == (32, 4)
    assert k1.launch_shape(50, fuse_w=True) == (32, 4, 50 * 32 * 4 * 4)
    assert k1.launch_shape(200, fuse_w=True) == (32, 1, 200 * 32 * 4)
    assert k1.launch_shape(120, fuse_w=True) == (32, 3, 120 * 32 * 3 * 4)
    assert k1.launch_shape(384, fuse_w=True)[1:] == (1, 48 * 1024)
    with pytest.raises(ValueError, match="385|levels"):
        k1.launch_shape(385, fuse_w=True)
    for K in (1, 50, 385, 1000):
        assert k1.launch_shape(K, fuse_w=False) == (32, 4, 0)
    assert PORT_CS2 == DEFAULT_CS2


@pytest.mark.parametrize("K,fuse_w", [(50, False), (50, True), (8, True),
                                      (96, True), (97, True), (128, True),
                                      (129, True), (192, True), (193, True)])
def test_launch_shape_follows_block_rows(K, fuse_w):
    """The rows per block are one constant of the module (measured on the
    card, PERF.md); under fuse_w a block takes the most rows up to it whose
    K-long slices fit 48 KB, and its shared memory follows the rows."""
    lanes, rows, smem = k1.launch_shape(K, fuse_w)
    assert lanes == 32 and 1 <= rows <= k1.BLOCK_ROWS
    if not fuse_w:
        assert (rows, smem) == (k1.BLOCK_ROWS, 0)
        return
    assert smem == K * 32 * rows * 4 <= 48 * 1024
    assert rows == k1.BLOCK_ROWS or K * 32 * (rows + 1) * 4 > 48 * 1024


# ------------------------------------------ divergence damping (smdiv) ----
def _mudf_in(arr, sc, static):
    """A mass-divergence tendency of a realistic size: the mudf of an
    undamped reference call on the same inputs."""
    return _run_torch(arr, sc, static, {})["mudf"].copy()


@pytest.mark.parametrize("mode", ["scan", "final"])
@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_damped_plain_matches_pallas(case_name, mode, request):
    """p = cs2*mu + (cs2*smdiv)*mudf_in in the fused wind update."""
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    mkw = dict(_mode_kwargs(mode, arr, sc, static),
               mudf_in=_mudf_in(arr, sc, static), smdiv=0.1)
    want = _run_jax(arr, sc, static, mkw)
    got = _run_torch(arr, sc, static, mkw)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want)
    undamped = _run_torch(arr, sc, static, {**mkw, "smdiv": 0.0})
    assert not np.array_equal(got["u"], undamped["u"])
    assert not np.array_equal(got["v"], undamped["v"])


def test_damping_is_off_without_fuse_uv(small_case):
    """As in the TPU wrapper: smdiv and mudf_in change nothing when the
    wind update does not run in the kernel, and nothing raises."""
    arr, sc, static = _inputs(small_case)
    damp = dict(mudf_in=_mudf_in(arr, sc, static), smdiv=0.1)
    got = _run_torch(arr, sc, static, damp)
    want = _run_torch(arr, sc, static, {})
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ref = _run_jax(arr, sc, static, damp)
    outputs_allclose(got, ref)


# --------------------------------------------- the phase-A capture --------
@pytest.mark.parametrize("fuse_uv", [False, True])
@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_capture_matches_pallas(case_name, fuse_uv, request):
    """The five *_before_theta outputs, and the ordinary ones beside them."""
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    mkw = dict(capture=True)
    if fuse_uv:
        mkw.update(fuse_uv=True, cs2=DEFAULT_CS2)
    want = _run_jax(arr, sc, static, mkw)
    got = _run_torch(arr, sc, static, mkw)
    assert set(k1.CAPTURE_NAMES) <= set(got)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want)


def test_capture_equals_the_outputs(small_case):
    """What the capture exists to show: phase B leaves the phase-A outputs
    alone.  Rows 0 and J-1, never computed, are zero in the captures;
    elsewhere ww and mu pass through outside the window."""
    arr, sc, static = _inputs(small_case)
    got = _run_torch(arr, sc, static, dict(capture=True))
    for cap in k1.CAPTURE_NAMES:
        out = cap.removesuffix("_before_theta")
        np.testing.assert_array_equal(got[cap][1:-1], got[out][1:-1],
                                      err_msg=cap)
        assert (got[cap][0] == 0).all() and (got[cap][-1] == 0).all()
        assert got[cap].dtype == np.float32
    i0, _, j0, _ = static["window"]
    assert j0 >= 2 and i0 >= 1
    np.testing.assert_array_equal(got["ww_before_theta"][1], arr["ww"][1])
    np.testing.assert_array_equal(got["mu_before_theta"][1], arr["mu"][1])
    plain = _run_torch(arr, sc, static, {})
    for name in plain:   # capture changes no ordinary output
        np.testing.assert_array_equal(got[name], plain[name], err_msg=name)


@pytest.mark.parametrize("mode", ["scan", "final"])
def test_capture_requires_the_full_ww_path(small_case, mode):
    arr, sc, static = _inputs(small_case)
    mkw = _mode_kwargs(mode, arr, sc, static)
    with pytest.raises(ValueError, match="capture requires"):
        _run_torch(arr, sc, static, dict(mkw, capture=True))
    with pytest.raises(ValueError, match="capture requires"):
        _run_jax(arr, sc, static, dict(mkw, capture=True))
