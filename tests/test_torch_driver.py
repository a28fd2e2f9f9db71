"""The port's verification driver, ``python -m wrf_tpu_torch.driver``, with
``--device cpu`` (the kernels' plain PyTorch versions), against the
goldens the C++ oracle writes into the fixture, at the driver's own gate
(rtol 1e-4, atol_scale 1e-5)."""

import numpy as np
import pytest
import torch

from wrf_tpu.io import fixtures
from wrf_tpu.models.small_step import small_step_golden as jax_golden_loop
from wrf_tpu_torch import driver
from wrf_tpu_torch.models.small_step import small_step_golden

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx9(tmp_path_factory, request):
    """A 9-step small_case fixture: the blocked rows run whole K2 or K3
    passes (S=2: 4 passes; S=4: 2) before the single-step tail."""
    case = request.getfixturevalue("small_case")
    return fixtures.write_case(case, tmp_path_factory.mktemp("fx9"), steps=9)


def _main(capsys, *argv):
    rc = driver.main([*map(str, argv), "--device", "cpu"])
    return rc, capsys.readouterr().out


def test_numpy_tier_bit_exact(fx9, capsys):
    rc, out = _main(capsys, fx9, "--tier", "numpy")
    assert rc == 0
    assert out.count("max_ulp=0") == 7
    assert "grid-points/s" in out and "on cpu" in out


@pytest.mark.parametrize("args", [
    ("--tier", "eager"),
    ("--tier", "cuda"),
    ("--tier", "sharded-eager"),
    ("--tier", "sharded-cuda", "--inner-steps", "2"),
    ("--tier", "sharded-cuda", "--inner-steps", "2", "--fast"),
    ("--tier", "coupled"),
    ("--tier", "coupled", "--inner-steps", "2"),
    ("--tier", "coupled", "--inner-steps", "2", "--fast"),
    ("--tier", "coupled", "--inner-steps", "3"),
    ("--tier", "coupled", "--with-w"),
    ("--tier", "coupled", "--with-w", "--inner-steps", "2"),
    ("--tier", "coupled", "--with-w", "--inner-steps", "4", "--fast"),
    ("--tier", "coupled-eager"),
    ("--tier", "coupled-eager", "--with-w"),
    ("--tier", "coupled-native", "--with-w"),
])
def test_tier_passes(fx9, capsys, args):
    rc, out = _main(capsys, fx9, *args)
    assert rc == 0, out
    assert "FAILED" not in out


def test_coupled_native_bit_exact(fx9, capsys):
    rc, out = _main(capsys, fx9, "--tier", "coupled-native")
    lines = [ln for ln in out.splitlines() if "golden loop" in ln]
    assert rc == 0
    assert len(lines) == 9 and all("max_ulp=0" in ln for ln in lines), out


def test_all_tiers(fx9, capsys):
    rc, out = _main(capsys, fx9, "--tier", "all")
    assert rc == 0, out
    assert out.count("PASS") == len(driver.ALL_ROWS) == 18
    # the JAX driver's matrix, row for row and in its order
    assert [r.replace("eager", "xla").replace("cuda", "pallas")
            for r in driver.ALL_ROWS] == [
        "numpy", "native", "xla", "pallas", "sharded-xla", "sharded-pallas",
        "coupled", "coupled-xla", "coupled-native", "coupled+w",
        "coupled-xla+w", "coupled-native+w", "sharded-pallas~bf16",
        "coupled~bf16", "sharded-pallas~blk", "coupled~blk",
        "sharded-pallas~blkfast", "coupled~blkfast"]
    assert "FAIL" not in out and "ERROR" not in out
    for tier in ("numpy", "native"):
        line = next(ln for ln in out.splitlines()
                    if ln.strip().startswith(tier + ":"))
        assert "max_abs=0.000e+00" in line


def test_steps_override_fails(tmp_path, small_case, capsys):
    """A wrong step count is caught by the comparators."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=3)
    rc, out = _main(capsys, d, "--tier", "cuda", "--steps", "1")
    assert rc == 1
    assert "FAILED" in out


def test_device_cuda_without_gpu_exits(fx9):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path cannot be shown")
    with pytest.raises(SystemExit, match="ROADMAP"):
        driver.main([str(fx9), "--tier", "cuda"])


@pytest.mark.parametrize("args", [
    ("--tier", "coupled", "--halo-backend", "rdma_overlap"),
    ("--tier", "coupled", "--precision", "bf16-const"),
    ("--tier", "coupled", "--mesh", "2x2", "--halo-backend", "rdma_overlap"),
    ("--tier", "sharded-cuda", "--precision", "bf16-const"),
    ("--tier", "sharded-cuda", "--precision", "bf16-const", "--inner-steps",
     "4", "--mesh", "2x2"),
    ("--tier", "coupled", "--mesh", "4x1", "--halo-backend", "rdma_overlap",
     "--inner-steps", "2", "--with-w", "--precision", "bf16-const"),
])
def test_unported_options_exit(fx9, capsys, args):
    """The options that exited "not yet ported" until their kernels were
    ported: each now runs its tier and passes its gate (bf16-const at
    2e-2 of field scale)."""
    rc, out = _main(capsys, fx9, *args)
    assert rc == 0, out
    assert "FAILED" not in out


def test_precision_applies_to_the_fused_loop_tiers(fx9, capsys):
    """The JAX driver's p.error, with the port's tier names."""
    for tier in ("cuda", "eager", "coupled-eager", "all"):
        with pytest.raises(SystemExit):
            driver.main([str(fx9), "--tier", tier, "--precision",
                         "bf16-const", "--device", "cpu"])
        assert ("--precision bf16-const applies to the fused-kernel loop "
                "tiers (sharded-cuda, coupled)") in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    ("--tier", "sharded-cuda", "--mesh", "2x2"),
    ("--tier", "sharded-eager", "--mesh", "4x2"),
    ("--tier", "sharded-cuda", "--mesh", "2x2", "--inner-steps", "4"),
    ("--tier", "coupled", "--mesh", "2x2"),
    ("--tier", "coupled", "--halo-backend", "rdma"),
    ("--tier", "coupled", "--mesh", "2x2", "--halo-backend", "rdma"),
    ("--tier", "coupled", "--mesh", "4x1", "--halo-backend", "rdma",
     "--with-w"),
    ("--tier", "coupled", "--mesh", "2x2", "--inner-steps", "2"),
    ("--tier", "coupled-eager", "--mesh", "2x2", "--halo-backend", "rdma"),
])
def test_mesh_tier_passes(fx9, capsys, args):
    rc, out = _main(capsys, fx9, *args)
    assert rc == 0, out
    assert "FAILED" not in out
    if "--mesh" in args:
        shape = args[args.index("--mesh") + 1]
        n = int(shape[0]) * int(shape[2])
        assert f"mesh {shape}: {n} shard(s) on 1 device(s) (cpu)" in out


def test_all_tiers_on_a_mesh(fx9, capsys):
    rc, out = _main(capsys, fx9, "--tier", "all", "--mesh", "2x2",
                    "--halo-backend", "rdma")
    assert rc == 0, out
    assert out.count("PASS") == len(driver.ALL_ROWS)
    assert "FAIL" not in out and "ERROR" not in out


def test_halo_backend_on_a_mu_t_tier_exits(fx9, capsys):
    """The JAX driver's p.error for a misplaced flag."""
    with pytest.raises(SystemExit):
        driver.main([str(fx9), "--tier", "sharded-cuda", "--halo-backend",
                     "rdma", "--device", "cpu"])
    assert "--halo-backend applies to the coupled tiers" in \
        capsys.readouterr().err


def test_coupled_native_with_w_bit_exact(fx9, capsys):
    rc, out = _main(capsys, fx9, "--tier", "coupled-native", "--with-w")
    lines = [ln for ln in out.splitlines() if "golden loop" in ln]
    assert rc == 0
    assert len(lines) == 11 and all("max_ulp=0" in ln for ln in lines), out
    assert any(ln.startswith("pp (golden loop)") for ln in lines)


def test_with_w_on_a_mu_t_tier_exits(fx9):
    with pytest.raises(SystemExit, match="coupled tiers"):
        driver.main([str(fx9), "--tier", "sharded-cuda", "--with-w",
                     "--device", "cpu"])


def test_golden_loop_matches_jax_module(small_case, with_w=False):
    """The port's jax-free golden loop is the JAX module's, bit for bit."""
    got = small_step_golden(small_case, 3, with_w=with_w)
    want = jax_golden_loop(small_case, 3, with_w=with_w)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_golden_loop_with_w_matches_jax_module(small_case):
    test_golden_loop_matches_jax_module(small_case, with_w=True)
