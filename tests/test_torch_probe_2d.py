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
#: 11x7x640 has K not a power of two and J-2 not a multiple of tj; K 8,
#: 16, 50 are the register instances' depths, 7 and 33 run-time ones
CASES = [((10, 8, 512), 4, 128), ((14, 50, 768), 4, 256),
         ((11, 7, 640), 3, 128), ((10, 8, 640), 4, 256),
         ((9, 33, 320), 2, 64), ((8, 16, 515), 3, 100)]


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


@pytest.mark.parametrize("K,kt", [(50, 50), (16, 16), (8, 8), (7, 0),
                                  (33, 0), (1, 0), (64, 0)])
def test_instance_by_depth(K, kt):
    assert k7.instance(K) == kt


@pytest.mark.parametrize("shape,tj,aligned,want", [
    # the register instances take LANES_1D lanes a thread where I allows
    ((130, 50, 1664), 4, True, dict(kt=50, vec=1, grid=(13, 128), smem=0)),
    ((516, 50, 516), 2, True, dict(kt=50, vec=1, grid=(5, 514), smem=0)),
    ((10, 16, 516), 4, True, dict(kt=16, vec=1, grid=(5, 8), smem=0)),
    ((10, 8, 520), 4, True, dict(kt=8, vec=4, grid=(2, 8), smem=0)),
    # a pitch (or pointers) not aligned for them: one lane a thread
    ((10, 16, 515), 3, True, dict(kt=16, vec=1, grid=(5, 6), smem=0)),
    ((10, 8, 514), 4, True, dict(kt=8, vec=1, grid=(5, 8), smem=0)),
    ((10, 8, 520), 4, False, dict(kt=8, vec=1, grid=(5, 8), smem=0)),
    # a run-time depth: the column in shared memory, K x 128 floats
    ((12, 33, 515), 3, True, dict(kt=0, vec=1, grid=(5, 9),
                                  smem=4 * 33 * 128)),
    ((9, 7, 264), 2, True, dict(kt=0, vec=1, grid=(3, 6), smem=4 * 7 * 128)),
])
def test_plan_1d(shape, tj, aligned, want):
    assert k7.plan_1d(shape, tj, aligned) == dict(want, threads=128)


@pytest.mark.parametrize("shape,tj,ti,halo,aligned,want", [
    # 16-byte pitch: bulk copies; two slabs of (ti + 8) & ~3 floats a line
    ((130, 50, 1664), 4, 128, 128, True, dict(
        kt=50, path="bulk", threads=128, stages=2, width=136,
        grid=(11, 32), smem=16 + 4 * 2 * 50 * 136)),
    ((516, 50, 516), 2, 128, 2, True, dict(
        kt=50, path="bulk", threads=128, stages=2, width=136,
        grid=(4, 257), smem=16 + 4 * 2 * 50 * 136)),
    ((130, 50, 1664), 4, 512, 128, True, dict(
        kt=50, path="bulk", threads=256, stages=2, width=520,
        grid=(2, 32), smem=16 + 4 * 2 * 50 * 520)),
    # x not 16-byte aligned, or a pitch that is not: 4-byte cp.async
    ((516, 50, 516), 2, 128, 2, False, dict(
        kt=50, path="cp.async", threads=128, stages=2, width=136,
        grid=(4, 257), smem=16 + 4 * 2 * 50 * 136)),
    ((10, 16, 515), 3, 100, 2, True, dict(
        kt=16, path="cp.async", threads=128, stages=2, width=108,
        grid=(5, 2), smem=16 + 4 * 2 * 16 * 108)),
    # two slabs do not fit: one in flight
    ((6, 50, 1280), 2, 1024, 128, True, dict(
        kt=50, path="bulk", threads=256, stages=1, width=1032,
        grid=(1, 2), smem=16 + 4 * 50 * 1032)),
    # a run-time depth adds a K x threads scratch column per thread
    ((12, 33, 515), 3, 100, 2, True, dict(
        kt=0, path="cp.async", threads=128, stages=2, width=108,
        grid=(5, 3), smem=16 + 4 * (2 * 33 * 108 + 33 * 128))),
    ((9, 7, 264), 2, 64, 4, True, dict(
        kt=0, path="bulk", threads=64, stages=2, width=72, grid=(4, 3),
        smem=16 + 4 * (2 * 7 * 72 + 7 * 64))),
])
def test_plan_2d(shape, tj, ti, halo, aligned, want):
    got = k7.plan_2d(shape, tj, ti, halo, aligned)
    assert got == want
    assert got["smem"] <= k7.MAX_SMEM
    # a line holds the tile, a lane each side and up to 3 lanes of
    # alignment, on 16-byte boundaries
    assert got["width"] % 4 == 0 and got["width"] >= ti + 5


def test_plan_2d_refuses_a_slab_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        k7.plan_2d((6, 50, 2560), 2, 2048, 128)


def test_chip_smoke_counts_the_loads_before_the_first_add():
    """``chip_smoke.loads_ahead`` reads ``cuobjdump -sass`` output: the
    LDGs (not LDGSTS) before each function's first FADD, and in all."""
    import chip_smoke

    sass = """
        Function : _Z7kernel1PKfPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/               @P0 LDG.E R5, desc[UR4][R2.64+0x4] ;
        /*0030*/                   LDGSTS [R7], [R2.64] ;
        /*0040*/                   FADD R6, R4, R5 ;
        /*0050*/                   LDG.E R8, desc[UR4][R2.64+0x8] ;
        /*0060*/                   FADD.FTZ R6, R6, R8 ;
        Function : _Z7kernel2PKfPf
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   STG.E desc[UR4][R2.64], R4 ;
    """
    assert chip_smoke.loads_ahead(sass) == {"_Z7kernel1PKfPf": (2, 3),
                                            "_Z7kernel2PKfPf": (1, 1)}
