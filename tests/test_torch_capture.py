"""The phase-A capture through the port, against the JAX package on the
CPU: the eager core's ``capture_intermediates`` against
``advance_mu_t_jnp``'s, ``python -m wrf_tpu_torch.driver --device cpu
--dump-intermediates`` against ``wrf_tpu.driver``'s files on the same
fixture (numpy and native bit for bit; eager and the cuda tier's plain
version within the driver's gate, rtol 1e-4, atol_scale 1e-5), and the
native CLI executable against the JAX package's."""

import re
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu import driver as jax_driver
from wrf_tpu.io import codec, fixtures
from wrf_tpu.ops import advance_mu_t_jnp as jnp_mod
from wrf_tpu_torch import driver, native
from wrf_tpu_torch.ops import advance_mu_t_eager as eager
from wrf_tpu_torch.ops.advance_mu_t_cuda import CAPTURE_NAMES

torch.set_num_threads(1)

GATE = dict(rtol=driver.RTOL, atol_scale=driver.ATOL_SCALE)
#: the JAX tier each of the port's capture tiers is held against
JAX_TIER = {"numpy": "numpy", "native": "native", "eager": "xla",
            "cuda": "pallas"}


@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_eager_capture_matches_jnp(case_name, request):
    case = request.getfixturevalue(case_name)
    kw = case.kernel_kwargs()
    b = case.bounds
    _, _, _, _, k0, k1 = b.loop_bounds(case.flags)
    arr = {k: np.asarray(v, np.float32) for k, v in kw.items()
           if hasattr(v, "ndim")}
    sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
    i_mask, j_mask = jnp_mod.window_masks(b, case.flags)
    static = dict(k0=k0, k1=k1, kde=b.mem(b.kde, "k"))
    want = jnp_mod.advance_mu_t_core(
        **arr, **sc, **static, i_mask=jnp.asarray(i_mask),
        j_mask=jnp.asarray(j_mask), capture_intermediates=True)
    got = eager.advance_mu_t_core(
        **{k: torch.tensor(v) for k, v in arr.items()}, **sc, **static,
        i_mask=torch.tensor(i_mask), j_mask=torch.tensor(j_mask),
        capture_intermediates=True)
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want) and set(CAPTURE_NAMES) <= set(got)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()})
    for cap in CAPTURE_NAMES:   # nothing zeroed: the outputs themselves
        np.testing.assert_array_equal(
            got[cap], got[cap.removesuffix("_before_theta")], err_msg=cap)
    plain = eager.advance_mu_t_core(
        **{k: torch.tensor(v) for k, v in arr.items()}, **sc, **static,
        i_mask=torch.tensor(i_mask), j_mask=torch.tensor(j_mask))
    assert not set(CAPTURE_NAMES) & set(plain)


@pytest.fixture(scope="module")
def fx2(tmp_path_factory, request):
    case = request.getfixturevalue("small_case")
    return fixtures.write_case(case, tmp_path_factory.mktemp("cap") / "fx",
                               steps=2)


def _read_dump(d, bounds):
    return {n: codec.read_field(
        Path(d) / f"{n}.bin",
        bounds.shape3 if n.startswith("ww") else bounds.shape2,
        nan_check=False) for n in CAPTURE_NAMES}


@pytest.mark.parametrize("tier", list(JAX_TIER))
def test_driver_dump_intermediates_matches_jax_driver(fx2, tmp_path, tier,
                                                      small_case):
    b = small_case.bounds
    assert driver.main([str(fx2), "--tier", tier, "--device", "cpu",
                        "--dump-intermediates", str(tmp_path / "port")]) == 0
    assert jax_driver.main([str(fx2), "--tier", JAX_TIER[tier],
                            "--dump-intermediates",
                            str(tmp_path / "jax")]) == 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir()) == \
        sorted(f"{n}.bin" for n in CAPTURE_NAMES)
    got, want = _read_dump(tmp_path / "port", b), _read_dump(tmp_path / "jax",
                                                             b)
    if tier in ("numpy", "native"):
        for n in CAPTURE_NAMES:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    else:
        outputs_allclose(got, want, **GATE)
    # the last step's phase-A state is the step's mu-phase output
    golden = fixtures.read_golden(fx2, b)
    inner = slice(1, -1)
    outputs_allclose({n: got[f"{n}_before_theta"][inner]
                      for n in ("mu", "ww", "muave", "muts", "mudf")},
                     {n: golden[n][inner]
                      for n in ("mu", "ww", "muave", "muts", "mudf")}, **GATE)


def test_dump_intermediates_tiers_agree(fx2, tmp_path, small_case):
    """The port's four capture tiers side by side: the scalar tiers bit for
    bit, the device tiers within the gate away from the cuda tier's zeroed
    first and last rows."""
    b = small_case.bounds
    caps = {}
    for tier in JAX_TIER:
        assert driver.main([str(fx2), "--tier", tier, "--device", "cpu",
                            "--dump-intermediates",
                            str(tmp_path / tier)]) == 0
        caps[tier] = _read_dump(tmp_path / tier, b)
    inner = slice(1, -1)
    for n in CAPTURE_NAMES:
        np.testing.assert_array_equal(caps["native"][n], caps["numpy"][n])
        assert (caps["cuda"][n][0] == 0).all()
        assert (caps["cuda"][n][-1] == 0).all()
    for tier in ("eager", "cuda"):
        outputs_allclose({n: caps[tier][n][inner] for n in CAPTURE_NAMES},
                         {n: caps["numpy"][n][inner] for n in CAPTURE_NAMES},
                         **GATE)


@pytest.mark.parametrize("tier", ["coupled", "sharded-cuda", "coupled-native",
                                  "all"])
def test_dump_intermediates_on_a_loop_tier_exits(fx2, tmp_path, tier, capsys):
    """The JAX driver's p.error for a tier that cannot capture."""
    with pytest.raises(SystemExit):
        driver.main([str(fx2), "--tier", tier, "--device", "cpu",
                     "--dump-intermediates", str(tmp_path / "dump")])
    assert "--dump-intermediates requires a capture-capable tier" in \
        capsys.readouterr().err
    assert not (tmp_path / "dump").exists()
    jax_tier = tier.replace("cuda", "pallas")
    with pytest.raises(SystemExit):
        jax_driver.main([str(fx2), "--tier", jax_tier,
                         "--dump-intermediates", str(tmp_path / "dump")])


# ------------------------------------------- the native CLI executable ----
def _report(text):
    """The executable's per-field report without its timing line."""
    lines = text.splitlines()
    assert lines[0].startswith("advance_mu_t native:")
    assert re.search(r"\d+ step\(s\) in", lines[0])
    return lines[1:]


def test_native_driver_executable(fx2, tmp_path, small_case):
    """Built with g++ at first use into the package's build directory; its
    report equals the JAX package's executable's on the same fixture, with
    diff=0 on every field, and the step override is honoured."""
    exe = native.build_driver()
    assert exe == native.driver_path() and exe.exists()
    assert exe.parent.name == "_build" and exe.parent.parent.name == \
        "wrf_tpu_torch"
    proc = subprocess.run([str(exe), str(fx2)], capture_output=True,
                          text=True, check=True)
    assert proc.stdout.count("diff=0 ") == 8, proc.stdout
    assert "2 step(s)" in proc.stdout
    ref = Path(__file__).resolve().parents[1] / "wrf_tpu/native/wrf_tpu_driver"
    if not ref.exists():
        subprocess.run(["make", "-s"], cwd=ref.parent, check=True)
    want = subprocess.run([str(ref), str(fx2)], capture_output=True,
                          text=True, check=True)
    assert _report(proc.stdout) == _report(want.stdout)
    one = subprocess.run([str(exe), str(fx2), "1"], capture_output=True,
                         text=True, check=True)
    assert "1 step(s)" in one.stdout and "diff=0 " in one.stdout
    assert one.stdout.count("diff=0 ") < 8   # a wrong step count shows
    usage = subprocess.run([str(exe)], capture_output=True, text=True)
    assert usage.returncode == 2 and "usage:" in usage.stderr


def test_native_driver_matches_the_library_tier(fx2, capsys):
    """The executable and ``--tier native`` run the same oracle: both
    reproduce the goldens exactly."""
    exe = native.build_driver()
    proc = subprocess.run([str(exe), str(fx2)], capture_output=True,
                          text=True, check=True)
    assert driver.main([str(fx2), "--tier", "native", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("max_ulp=0") == 7
    assert proc.stdout.count("max_ulp=0") == 8


def test_native_driver_needs_a_compiler(monkeypatch, tmp_path):
    """A missing compiler raises; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build_driver()
