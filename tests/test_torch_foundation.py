"""The port's own copies of the jax-free foundation modules, each held
against the module of the JAX package it was copied from: grid bounds,
comparators, the namelist config record, the binary codec, checkpoints,
fixture minting, the numpy golden path and the C++ scalar oracle.

Everything here is exact: the same inputs give the same values, the same
bytes on disk and the same report fields, and a file written by one package
reads in the other.  The oracle is built with g++ at first use into the
port's own build directory.
"""

import dataclasses
import filecmp
import importlib

import numpy as np
import pytest

from wrf_tpu import config as jax_config
from wrf_tpu import grid as jax_grid
from wrf_tpu import native as jax_native
from wrf_tpu.io import checkpoint as jax_checkpoint
from wrf_tpu.io import codec as jax_codec
from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu.ops.advance_uv import DEFAULT_CS2
from wrf_tpu.ops.advance_w import DEFAULT_CW, DEFAULT_GW
from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy as jax_numpy_ref
from wrf_tpu_torch import _build, compare, config, grid, native
from wrf_tpu_torch.io import checkpoint, codec, fixtures
from wrf_tpu_torch.ops.reference_numpy import advance_mu_t_numpy

# wrf_tpu re-exports the function ``compare`` over the module's name
jax_compare = importlib.import_module("wrf_tpu.compare")

FLAG_SETS = [dict(specified=True), dict(nested=True),
             dict(periodic_x=True, specified=True),
             dict(periodic_x=True), dict()]

NAMELIST = """
&time_control
 run_hours = 12,
/
&domains
 time_step = 72, 24,
 max_dom = 2,
 e_we = 74, 112,
 e_sn = 61, 97,
 e_vert = 32, 32,
 dx = 12000, 4000,
 dy = 12000, 4000,
/
&dynamics
 time_step_sound = 6, 4,
 epssm = 0.2, 0.3,
 smdiv = 0.0, 0.1,
 non_hydrostatic = .true., .false.,
/
&bdy_control
 specified = .true., .false.,
 nested = .false., .true.,
 periodic_x = .false., .false.,
/
"""


# ---------------------------------------------------------------- grid ----
@pytest.mark.parametrize("flag_kw", FLAG_SETS)
@pytest.mark.parametrize("dims", [(74, 61, 32, 3), (20, 18, 8, 2),
                                  (5, 7, 4, 0)])
def test_grid_bounds_match(dims, flag_kw):
    nx, ny, nz, halo = dims
    a = grid.GridBounds.for_domain(nx, ny, nz, halo=halo)
    b = jax_grid.GridBounds.for_domain(nx, ny, nz, halo=halo)
    fa, fb = grid.ConfigFlags(**flag_kw), jax_grid.ConfigFlags(**flag_kw)
    assert dataclasses.astuple(fa) == dataclasses.astuple(fb)
    assert a.as_tuple() == b.as_tuple()
    assert grid.GridBounds.FIELD_ORDER == jax_grid.GridBounds.FIELD_ORDER
    assert a.loop_bounds(fa) == b.loop_bounds(fb)
    assert (a.shape3, a.shape2, a.idim, a.jdim, a.kdim) == \
        (b.shape3, b.shape2, b.idim, b.jdim, b.kdim)
    assert [a.mem(getattr(a, n), ax) for n, ax in
            (("ids", "i"), ("jde", "j"), ("kde", "k"))] == \
        [b.mem(getattr(b, n), ax) for n, ax in
         (("ids", "i"), ("jde", "j"), ("kde", "k"))]


# ------------------------------------------------------------- compare ----
def _compare_inputs(seed=5, n=4000):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    a = g.copy()
    a[::7] = np.nextafter(a[::7], np.float32(np.inf))      # one ulp apart
    a[5::11] = a[5::11] * np.float32(1.0 + 3e-5)
    g[3::13] = 0.0                                         # zero goldens
    a[3::26] = 0.0
    return a, g


@pytest.mark.parametrize("tol", [dict(), dict(rtol=2e-5, atol_scale=1e-6),
                                 dict(rtol=1e-4, atol=1e-3)])
def test_compare_every_field_equal(tol):
    a, g = _compare_inputs()
    got = compare.compare(a, g, "x", **tol)
    want = jax_compare.compare(a, g, "x", **tol)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    assert got.all_equal == want.all_equal
    if tol:
        assert got.passed == want.passed
    else:   # no tolerances given: both refuse to judge
        for r in (got, want):
            with pytest.raises(ValueError, match="without tolerances"):
                r.passed


def test_compare_nan_handling_matches():
    a, g = _compare_inputs()
    a[17] = np.nan
    with pytest.raises(jax_compare.NaNError) as want:
        jax_compare.compare(a, g, "x")
    with pytest.raises(compare.NaNError) as got:
        compare.compare(a, g, "x")
    assert str(got.value) == str(want.value)
    r_got = compare.compare(a, g, "x", nan_check=False)
    r_want = jax_compare.compare(a, g, "x", nan_check=False)
    assert repr(dataclasses.asdict(r_got)) == repr(dataclasses.asdict(r_want))


def test_float_ulps_and_window_match():
    a, g = _compare_inputs(seed=9, n=6 * 5 * 4)
    np.testing.assert_array_equal(compare.float_ulps(a, g),
                                  jax_compare.float_ulps(a, g))
    a3, g3 = a.reshape(6, 5, 4), g.reshape(6, 5, 4)
    kw = dict(i_slice=slice(1, 3), j_slice=slice(2, 5), k_slice=slice(0, 4))
    assert dataclasses.asdict(compare.compare_window(a3, g3, "w", **kw)) == \
        dataclasses.asdict(jax_compare.compare_window(a3, g3, "w", **kw))


def test_assert_outputs_allclose_matches():
    a, g = _compare_inputs()
    compare.assert_outputs_allclose({"x": g}, {"x": g})
    with pytest.raises(AssertionError) as got:
        compare.assert_outputs_allclose({"x": a}, {"x": g})
    with pytest.raises(AssertionError) as want:
        jax_compare.assert_outputs_allclose({"x": a}, {"x": g})
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- config ----
@pytest.mark.parametrize("domain", [0, 1])
def test_read_namelist_and_dynamics_params_match(domain):
    got = config.read_namelist(NAMELIST, domain=domain)
    want = jax_config.read_namelist(NAMELIST, domain=domain)
    assert got.to_overrides() == want.to_overrides()
    assert len(got) == len(want)
    assert got.to_blob() == want.to_blob()
    dg, dw = config.dynamics_params(got), jax_config.dynamics_params(want)
    assert dataclasses.astuple(dg.pop("flags")) == \
        dataclasses.astuple(dw.pop("flags"))
    assert dg == dw
    assert config.parse_namelist_text(NAMELIST) == \
        jax_config.parse_namelist_text(NAMELIST)


def test_config_record_roundtrips_across_packages(tmp_path):
    rec = config.GridConfigRecord(epssm=0.25, time_step_sound=8,
                                  specified=True)
    rec.save(tmp_path / "rec.json")
    back = jax_config.GridConfigRecord.load(tmp_path / "rec.json")
    assert back.to_overrides() == rec.to_overrides()
    assert config.GridConfigRecord.from_blob(back.to_blob()).to_blob() == \
        rec.to_blob()
    assert (config._SCHEMA_PATH.read_bytes()
            == jax_config._SCHEMA_PATH.read_bytes())


# --------------------------------------------------------------- codec ----
@pytest.mark.parametrize("writer,reader", [(codec, jax_codec),
                                           (jax_codec, codec)])
def test_codec_round_trips_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((5, 4, 3)).astype(np.float32)
    writer.write_field(tmp_path / "f.bin", arr)
    writer.write_int(tmp_path / "i.bin", -12345)
    writer.write_real(tmp_path / "r.bin", 1.0 / 12000.0)
    writer.write_flag(tmp_path / "b.bin", True)
    np.testing.assert_array_equal(
        reader.read_field(tmp_path / "f.bin", arr.shape), arr)
    assert reader.read_int(tmp_path / "i.bin") == -12345
    assert reader.read_real(tmp_path / "r.bin") == \
        writer.read_real(tmp_path / "r.bin") == float(np.float32(1 / 12000.0))
    assert reader.read_flag(tmp_path / "b.bin") is True
    a4 = rng.standard_normal((3, 2, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(codec.swap_field_4d(a4),
                                  jax_codec.swap_field_4d(a4))


def test_codec_bytes_equal(tmp_path):
    arr = np.random.default_rng(4).standard_normal((6, 7)).astype(np.float32)
    for name, mod in (("port", codec), ("jax", jax_codec)):
        d = tmp_path / name
        d.mkdir()
        mod.write_field(d / "f.bin", arr)
        mod.write_int(d / "i.bin", 77)
        mod.write_real(d / "r.bin", 0.1)
        mod.write_flag(d / "b.bin", False)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax",
        ["f.bin", "i.bin", "r.bin", "b.bin"], shallow=False)
    assert (len(match), mismatch, errors) == (4, [], [])


# ------------------------------------------------------------ fixtures ----
CASE_KW = {
    "plain": dict(),
    "periodic": dict(flags=dict(periodic_x=True, specified=True), seed=11),
    "open": dict(flags=dict(specified=False, nested=False), seed=13),
    "balanced": dict(balanced=True, amplitude=1e-2),
}


def _both_cases(kind):
    kw = dict(CASE_KW[kind])
    fl = kw.pop("flags", None)
    kw.setdefault("seed", 7)
    a = fixtures.make_case(20, 18, 8, halo=2, **kw,
                           flags=grid.ConfigFlags(**fl) if fl else None)
    b = jax_fixtures.make_case(20, 18, 8, halo=2, **kw,
                               flags=jax_grid.ConfigFlags(**fl) if fl else None)
    return a, b


@pytest.mark.parametrize("kind", list(CASE_KW))
def test_make_case_bit_equal(kind):
    a, b = _both_cases(kind)
    assert a.fields.keys() == b.fields.keys()
    for name in a.fields:
        assert a.fields[name].dtype == b.fields[name].dtype
        np.testing.assert_array_equal(a.fields[name], b.fields[name],
                                      err_msg=name)
    assert (a.rdx, a.rdy, a.dts, a.epssm) == (b.rdx, b.rdy, b.dts, b.epssm)
    assert a.bounds.as_tuple() == b.bounds.as_tuple()
    assert dataclasses.astuple(a.flags) == dataclasses.astuple(b.flags)
    ka, kb = a.kernel_kwargs(), b.kernel_kwargs()
    assert ka.keys() == kb.keys()
    assert (fixtures.INPUT_FIELDS_3D, fixtures.INPUT_FIELDS_2D,
            fixtures.INPUT_FIELDS_1D, fixtures.OUTPUT_FIELDS) == \
        (jax_fixtures.INPUT_FIELDS_3D, jax_fixtures.INPUT_FIELDS_2D,
         jax_fixtures.INPUT_FIELDS_1D, jax_fixtures.OUTPUT_FIELDS)


def test_fixture_directories_byte_equal_and_cross_read(tmp_path):
    a, b = _both_cases("plain")
    da = fixtures.write_case(a, tmp_path / "port", steps=3)
    db = jax_fixtures.write_case(b, tmp_path / "jax", steps=3)
    names = sorted(p.name for p in da.iterdir())
    assert names == sorted(p.name for p in db.iterdir())
    match, mismatch, errors = filecmp.cmpfiles(da, db, names, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == len(names)
    # a case written by one package reads in the other
    got, steps = fixtures.read_case(db)
    want, steps_j = jax_fixtures.read_case(da)
    assert steps == steps_j == 3
    for name in want.fields:
        np.testing.assert_array_equal(got.fields[name], want.fields[name],
                                      err_msg=name)
    gold = fixtures.read_golden(db, got.bounds)
    gold_j = jax_fixtures.read_golden(da, want.bounds)
    for name in gold_j:
        np.testing.assert_array_equal(gold[name], gold_j[name], err_msg=name)
    # a fixture directory without the w fields (older layout) derives them
    for extra in ("grid_w.bin", "grid_pp.bin", "grid_rdn.bin"):
        (da / extra).unlink()
    old, _ = fixtures.read_case(da)
    old_j, _ = jax_fixtures.read_case(da)
    for name in ("grid_w", "grid_pp", "grid_rdn"):
        np.testing.assert_array_equal(old.fields[name], old_j.fields[name])


# ------------------------------------------------ numpy golden, oracle ----
@pytest.mark.parametrize("case_name", ["small_case", "periodic_case",
                                       "open_bc_case"])
def test_numpy_golden_matches(case_name, request):
    case = request.getfixturevalue(case_name)
    got = advance_mu_t_numpy(**case.kernel_kwargs())
    want = jax_numpy_ref(**case.kernel_kwargs())
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_native_oracle_builds_into_the_ports_build_dir():
    lib = native.build()
    assert lib == native.library_path() and lib.is_file()
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libwrf_tpu_torch_native_")
    for src in native.LIB_SRCS:
        assert (native._DIR / src).read_bytes() == \
            (jax_native._DIR / src).read_bytes().replace(
                b"wrf_tpu/ops/", b"wrf_tpu_torch/ops/").replace(
                b"wrf_tpu/io/", b"wrf_tpu_torch/io/")


def test_native_build_without_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("case_name", ["small_case", "open_bc_case"])
def test_native_oracle_matches_bit_for_bit(case_name, request):
    case = request.getfixturevalue(case_name)
    kw = case.kernel_kwargs()
    f = case.fields
    got = native.advance_mu_t_native(**kw, capture_intermediates=True)
    want = jax_native.advance_mu_t_native(**kw, capture_intermediates=True)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    uv_kw = dict(u=kw["u"], v=kw["v"], mu=kw["mu"], muu=kw["muu"],
                 muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
                 rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"], cs2=DEFAULT_CS2,
                 flags=case.flags, bounds=case.bounds)
    for extra in (dict(), dict(mudf=want["mudf"], smdiv=0.1)):
        for g, w in zip(native.advance_uv_native(**uv_kw, **extra),
                        jax_native.advance_uv_native(**uv_kw, **extra)):
            np.testing.assert_array_equal(g, w)
    w_kw = dict(w=f["grid_w"], pp=f["grid_pp"], t=want["t"],
                rdn=f["grid_rdn"], rdnw=kw["rdnw"], dts=case.dts,
                epssm=case.epssm, cw=DEFAULT_CW, gw=DEFAULT_GW,
                flags=case.flags, bounds=case.bounds)
    for g, w in zip(native.advance_w_native(**w_kw),
                    jax_native.advance_w_native(**w_kw)):
        np.testing.assert_array_equal(g, w)
    a, g = _compare_inputs()
    assert dataclasses.astuple(native.compare_native(a, g)) == \
        dataclasses.astuple(jax_native.compare_native(a, g))
    a4 = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    np.testing.assert_array_equal(native.swap_4d_native(a4),
                                  jax_native.swap_4d_native(a4))


# ---------------------------------------------------------- checkpoint ----
@pytest.mark.parametrize("writer,reader", [(checkpoint, jax_checkpoint),
                                           (jax_checkpoint, checkpoint)])
def test_checkpoint_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(8)
    state = {"t": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "mu": rng.standard_normal((4, 5)).astype(np.float32),
             "w": rng.standard_normal((4, 3, 5)).astype(np.float32),
             "pp": rng.standard_normal((4, 3, 5)).astype(np.float32)}
    d = writer.save_checkpoint(tmp_path / "ck", state, step=7,
                               extra={"note": "x"})
    back, step, extra = reader.load_checkpoint(d)
    assert step == 7 and extra == {"note": "x"}
    assert sorted(back) == sorted(state)
    for name in state:
        np.testing.assert_array_equal(back[name], state[name], err_msg=name)
    assert checkpoint.STATE_FIELDS == jax_checkpoint.STATE_FIELDS
