"""K7 in the port on the CPU: ``run_1d`` and ``run_2d`` (their plain
versions, what the wrappers run on CPU tensors) against the JAX probe's
``run_1d`` / ``run_2d`` in interpret mode, bit for bit over the whole array
(NaN outside the written region included), the forms against each other,
the written region, the CLI, and the refusal to run on a missing GPU."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_tpu_torch.tools import probe_2d as k7

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_probe_2d", REPO / "tools" / "probe_2d.py")
jax_k7 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_k7)

#: (shape, tj, ti): the last does not divide its 384-lane interior, and
#: 11x7x640 has K not a power of two and J-2 not a multiple of tj
CASES = [((10, 8, 512), 4, 128), ((14, 50, 768), 4, 256),
         ((11, 7, 640), 3, 128), ((10, 8, 640), 4, 256)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_run_1d_matches_jax_bit_for_bit(shape, tj, ti):
    x = _x(shape)
    want = np.asarray(jax_k7.run_1d(jnp.asarray(x), tj, True))
    before = dict(k7.LAUNCHES)
    got = k7.run_1d(torch.from_numpy(x), tj)
    assert k7.LAUNCHES == before   # no launch on the CPU
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isnan(want).any() or (shape[0] - 2) % tj == 0


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_run_2d_matches_jax_bit_for_bit(shape, tj, ti):
    x = _x(shape, seed=1)
    want = np.asarray(jax_k7.run_2d(jnp.asarray(x), tj, ti, True))
    got = k7.run_2d(torch.from_numpy(x), tj, ti)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # NaN exactly outside the region the 2-D form writes
    mask = np.ones(shape, bool)
    mask[k7.written(shape, tj, ti)] = False
    np.testing.assert_array_equal(np.isnan(want), mask)


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_forms_agree_on_the_lanes_both_write(shape, tj, ti):
    x = torch.from_numpy(_x(shape, seed=2))
    a, b = k7.run_1d(x, tj), k7.run_2d(x, tj, ti)
    region = k7.written(shape, tj, ti)
    assert torch.equal(a[region], b[region])
    assert torch.isfinite(a[k7.written(shape, tj)]).all()


@pytest.mark.parametrize("halo,ti", [(1, 64), (2, 128), (3, 5)])
def test_narrow_halo_gives_the_same_interior(halo, ti):
    """The port's layout parameter: one lane of halo is all the stencil
    reads, so a narrow halo gives the 1-D form's values on its lanes."""
    shape = (6, 9, 2 * halo + 4 * ti)
    x = torch.from_numpy(_x(shape, seed=3))
    b = k7.run_2d(x, 2, ti, halo=halo)
    region = k7.written(shape, 2, ti, halo)
    assert region[2] == slice(halo, halo + 4 * ti)
    assert torch.equal(b[region], k7.run_1d(x, 2)[region])
    assert torch.isnan(b[:, :, :halo]).all()


def test_written_regions():
    assert k7.written((130, 50, 1664), 4) == (
        slice(1, 129), slice(0, 50), slice(0, 1664))
    assert k7.written((130, 50, 1664), 4, 512) == (
        slice(1, 129), slice(0, 50), slice(128, 1152))
    assert k7.written((516, 50, 516), 2, 128, halo=2) == (
        slice(1, 515), slice(0, 50), slice(2, 514))
    assert k7.written((11, 7, 640), 3, 128)[0] == slice(1, 10)


def test_compulsory_bytes():
    assert k7.compulsory_bytes((130, 50, 1664), 4) == 2 * 4 * 128 * 50 * 1664
    assert k7.compulsory_bytes((130, 50, 1664), 4, 128) == \
        4 * 128 * 50 * (1410 + 1408)
    assert k7.compulsory_bytes((516, 50, 516), 2, 128, halo=2) == \
        4 * 514 * 50 * (514 + 512)
    assert k7.compulsory_bytes((10, 8, 300), 4, 128) == 0   # no whole tile


def test_out_is_written_on_its_region_only():
    x = torch.from_numpy(_x((10, 8, 512)))
    out = torch.full_like(x, 7.0)
    got = k7.run_2d(x, 4, 128, out=out)
    assert got is out
    mask = torch.ones(x.shape, dtype=torch.bool)
    mask[k7.written(x.shape, 4, 128)] = False
    assert (out[mask] == 7.0).all()
    assert torch.equal(out[~mask], k7.run_2d(x, 4, 128)[~mask])


@pytest.mark.parametrize("call,err,match", [
    (lambda x: k7.run_1d(x.double(), 4), TypeError, "float32"),
    (lambda x: k7.run_1d(x.transpose(0, 2), 4), ValueError, "contiguous"),
    (lambda x: k7.run_1d(x, 0), ValueError, "tj"),
    (lambda x: k7.run_2d(x, 4, 128, halo=0), ValueError, "halo"),
    (lambda x: k7.run_2d(x, 4, 128, halo=300), ValueError, "2\\*halo"),
    (lambda x: k7.run_1d(x, 4, out=x), ValueError, "must not be x"),
    (lambda x: k7.run_2d(x, 4, 128, out=torch.zeros(3)), ValueError,
     "shape"),
])
def test_argument_checks(call, err, match):
    with pytest.raises(err, match=match):
        call(torch.zeros(10, 8, 512))


@pytest.mark.parametrize("argv,covered", [
    (["--shape", "10", "8", "512", "--ti", "128"], None),
    (["--shape", "10", "8", "640", "--ti", "256"], "256 of 384"),
    (["--shape", "11", "7", "640", "--tj", "3", "--halo", "2", "--ti", "212",
      "--time"], None),
])
def test_cli_on_the_cpu(argv, covered, capsys):
    assert k7.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "device=cpu (cpu)"
    assert "2-D vs 1-D bit-equal (interior lanes): True" in out
    assert (f"2-D form covers {covered} interior lanes" in out) == \
        (covered is not None)
    assert ("not timed on the CPU" in out) == ("--time" in argv)


def test_cli_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path cannot be shown")
    with pytest.raises(SystemExit, match="is_available"):
        k7.main(["--shape", "10", "8", "512", "--ti", "128"])


def test_run_on_an_unsupported_device_raises():
    x = torch.zeros(10, 8, 512, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k7.run_1d(x, 4)


def test_cli_at_the_jax_defaults_covers_what_it_wrote(capsys):
    """At the JAX probe's own defaults (130x50x1664, ti 512) the 2-D form
    writes 1024 of the 1408 interior lanes; the JAX probe compares all 1408
    and fails on the NaN lanes, the port compares the lanes both wrote."""
    assert k7.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2-D form covers 1024 of 1408 interior lanes" in out
    assert "2-D vs 1-D bit-equal (interior lanes): True" in out
