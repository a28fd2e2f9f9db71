"""K8 in the port on the CPU: each of the nine rungs (its plain version,
what the wrapper runs on CPU tensors) against the JAX probe's rung in
interpret mode, bit for bit over the whole array (NaN outside the written
region included); rung e's second output, rung i's aliased operand, h == j,
d == a on d's region, the written regions, and the CLI.

The JAX rungs take no ``interpret`` argument, so each test hands the JAX
module a copy of ``pl`` whose ``pallas_call`` runs in interpret mode."""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from wrf_tpu_torch.tools import probe_2d_bisect as k8

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "jax_probe_2d_bisect", REPO / "tools" / "probe_2d_bisect.py")
jax_k8 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_k8)

#: (shape, tj, ti); K = 7 is a depth only the run-time k loops take on
#: the card (rung j's plain version runs at any K)
CASES = [((10, 8, 512), 4, 128), ((14, 16, 768), 4, 256),
         ((9, 7, 556), 3, 100)]


@pytest.fixture
def interpret(monkeypatch):
    shim = types.SimpleNamespace(**vars(pl))
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jax_k8, "pl", shim)
    return jax_k8


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _same(a, b):
    """Bit for bit, NaN included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _outside(shape, region):
    mask = np.ones(shape, bool)
    mask[region] = False
    return mask


@pytest.mark.parametrize("rung", list(k8.RUNGS))
@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_rung_matches_jax_bit_for_bit(interpret, rung, shape, tj, ti):
    x = _x(shape, seed=ord(rung))
    want = np.asarray(getattr(interpret, f"rung_{rung}")(jnp.asarray(x), tj,
                                                         ti))
    before = dict(k8.LAUNCHES)
    got = k8.FUNCS[rung](torch.from_numpy(x), tj, ti)
    assert k8.LAUNCHES == before   # no launch on the CPU
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    region = k8.written_region(rung, shape, tj, ti)
    np.testing.assert_array_equal(np.isnan(want), _outside(shape, region))


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_rung_e_second_output(shape, tj, ti):
    x = torch.from_numpy(_x(shape, seed=5))
    out1 = torch.full_like(x, float("nan"))
    out0 = k8.rung_e(x, tj, ti, out1=out1)
    region = k8.written_region("e", shape, tj, ti)
    assert torch.equal(out1[region], 2 * x[region])
    assert torch.isnan(out1[torch.from_numpy(_outside(shape, region))]).all()
    # s = 1: the first output is d's values plus x
    assert torch.equal(out0[region],
                       k8.rung_d(x, tj, ti)[region] + x[region])


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_rung_i_updates_its_aliased_operand_only(shape, tj, ti):
    x = torch.from_numpy(_x(shape, seed=6))
    x0 = x.clone()
    t = x.clone()
    out0 = k8.rung_i(x, tj, ti, t=t)
    region = k8.written_region("i", shape, tj, ti)
    outside = torch.from_numpy(_outside(shape, region))
    assert torch.equal(x, x0)                    # the caller's x unchanged
    assert torch.equal(t[region], x[region] + 1.0)
    assert torch.equal(t[outside], x[outside])
    assert _same(out0, k8.rung_d(x, tj, ti))
    k8.rung_i(x, tj, ti)                         # a clone of x, dropped
    assert torch.equal(x, x0)
    with pytest.raises(ValueError, match="must not be x"):
        k8.rung_i(x, tj, ti, t=x)


@pytest.mark.parametrize("shape,tj,ti", CASES)
def test_ladder_identities(shape, tj, ti):
    """h == j (the same op sequence), d == a on d's region (no wrap reaches
    the centre), c != d exactly at each window's first lane (c's roll wraps
    inside the window), b == a, f == d + 1 (ones operands)."""
    x = torch.from_numpy(_x(shape, seed=7))
    a, d = k8.rung_a(x, tj, ti), k8.rung_d(x, tj, ti)
    region = k8.written_region("d", shape, tj, ti)
    assert _same(k8.rung_h(x, tj, ti), k8.rung_j(x, tj, ti))
    assert torch.equal(d[region], a[region])
    assert _same(k8.rung_b(x, tj, ti), a)
    c = k8.rung_c(x, tj, ti)
    differs = (c[region] != d[region]).any(dim=(0, 1))
    first = torch.zeros_like(differs)
    first[::ti] = True
    assert torch.equal(differs, first)
    f = k8.rung_f(x, tj, ti)
    assert torch.equal(f[region], d[region] * 1.0 + 1.0)


def test_written_regions_and_bytes():
    assert k8.written_region("a", (26, 16, 512), 4, 128) == (
        slice(1, 25), slice(0, 16), slice(0, 512))
    assert k8.written_region("d", (26, 16, 512), 4, 128) == (
        slice(1, 25), slice(0, 16), slice(128, 384))
    assert k8.written_region("j", (258, 50, 1280), 4, 128)[2] == \
        slice(128, 1152)
    with pytest.raises(ValueError, match="bad rung"):
        k8.written_region("g", (26, 16, 512), 4, 128)
    n = 256 * 50
    assert k8.compulsory_bytes("a", (258, 50, 1280), 4, 128) == \
        4 * n * 2 * 1280
    assert k8.compulsory_bytes("c", (258, 50, 1280), 4, 128) == \
        4 * n * 2 * 1024
    assert k8.compulsory_bytes("d", (258, 50, 1280), 4, 128) == \
        4 * n * (1025 + 1024)
    assert k8.compulsory_bytes("e", (258, 50, 1280), 4, 128) == \
        4 * (n * (1025 + 2 * 1024) + 1)
    assert k8.compulsory_bytes("f", (258, 50, 1280), 4, 128) == \
        4 * (n * (1025 + 1024) + 256 * 1024 + 50)
    assert k8.compulsory_bytes("i", (258, 50, 1280), 4, 128) == \
        4 * n * (1025 + 3 * 1024)


@pytest.mark.parametrize("call,err,match", [
    (lambda x: k8.rung_a(x.double(), 4, 128), TypeError, "float32"),
    (lambda x: k8.rung_d(x, 0, 128), ValueError, "tj"),
    (lambda x: k8.rung_d(x, 4, 128, out=x), ValueError, "must not be x"),
    (lambda x: k8.rung_e(x, 4, 128, out1=torch.zeros(3)), ValueError,
     "out1"),
    (lambda x: k8.rung_f(x, 4, 128, thin=torch.ones(10, 8, 512)), ValueError,
     "thin"),
    (lambda x: k8.operands("a", x, t=x.clone()), TypeError, "unexpected"),
    (lambda x: k8.rung_c(x[:, :, :255].contiguous(), 4, 64), ValueError,
     "rings"),
])
def test_argument_checks(call, err, match):
    with pytest.raises(err, match=match):
        call(torch.zeros(10, 8, 512))


@pytest.mark.parametrize("rung", list(k8.RUNGS))
def test_cli_on_the_cpu(rung, capsys):
    assert k8.main([rung, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"rung {rung}: compiled+ran, finite=True"]


def test_cli_time_and_missing_gpu(capsys):
    assert k8.main(["h", "--shape", "10", "8", "512", "--time", "--device",
                    "cpu"]) == 0
    assert "not timed on the CPU" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path cannot be shown")
    with pytest.raises(SystemExit, match="is_available"):
        k8.main(["d"])


@pytest.mark.parametrize("rung,K,kt", [
    ("j", 16, 16), ("j", 50, 50), ("h", 50, 0), ("a", 16, 0), ("d", 7, 0)])
def test_instance_by_depth(rung, K, kt):
    assert k8.instance(rung, K) == kt


@pytest.mark.parametrize("K", [7, 33, 8])
def test_rung_j_has_no_instance_at_other_depths(K):
    with pytest.raises(ValueError, match="K in"):
        k8.instance("j", K)


@pytest.mark.parametrize("rung,shape,tj,ti,want", [
    ("a", (258, 50, 1280), 4, 128, dict(threads=(256, 1), grid=(1280,),
                                        smem=0)),
    ("b", (258, 50, 1280), 4, 128, dict(threads=(1024, 1), grid=(64,),
                                        smem=0)),
    # a tile's tj rows side by side: (ti, tj) threads
    ("d", (258, 50, 1280), 4, 128, dict(threads=(128, 4), grid=(64, 8),
                                        smem=0)),
    ("h", (258, 50, 1280), 4, 128, dict(threads=(128, 4), grid=(64, 8),
                                        smem=4 * 50 * 4 * 128)),
    ("j", (26, 16, 512), 4, 128, dict(threads=(128, 4), grid=(6, 2),
                                      smem=4 * 16 * 4 * 128)),
    # 512 threads at most: two row slots, a thread takes two rows
    ("e", (14, 16, 768), 4, 256, dict(threads=(256, 2), grid=(3, 2),
                                      smem=0)),
    ("j", (14, 16, 768), 4, 256, dict(threads=(256, 2), grid=(3, 2),
                                      smem=4 * 16 * 2 * 256)),
    # ti rounded up to a warp
    ("i", (9, 7, 556), 3, 100, dict(threads=(128, 3), grid=(2, 3), smem=0)),
    ("c", (6, 8, 1280), 2, 1024, dict(threads=(512, 1), grid=(2, 1),
                                      smem=0)),
])
def test_plan(rung, shape, tj, ti, want):
    got = k8.plan(rung, shape, tj, ti)
    assert got == dict(want, kt=k8.instance(rung, shape[1]))
    tx, ty = got["threads"]
    assert tx * ty <= 1024 and ty <= tj
