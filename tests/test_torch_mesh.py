"""The port's mesh-decomposed path on the CPU against the JAX package on the
virtual CPU devices: the mesh helpers, the array glue
(``pad_to_mesh``/``scatter``/``gather``), ``ShardedAdvanceMuT`` and
``SmallStepLoop`` on (1,1), (2,2), (4,2) and (8,1) meshes, ``RK3Integrator``
on (2,2) and ``run_sim --mesh``.

Every shard of the port's mesh lies on the CPU (a device may appear more
than once in a mesh), so the wrappers run their plain versions; the JAX
loops run on the same mesh shape with the Pallas kernels in interpret
mode.  Both sides get one ``case_to_domain`` dict.  Tolerance rtol 5e-5,
atol_scale 2e-6 (tests/test_small_step.py's) against the JAX loops and the
golden loops; the port's own meshes, backends and kernels agree with each
other bit for bit where the arithmetic per column is the same.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.small_step import small_step_golden
from wrf_tpu.native import advance_mu_t_native
from wrf_tpu.parallel import mesh as jax_mesh
from wrf_tpu.parallel import sharded as jax_sharded
from wrf_tpu_torch import run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.parallel import mesh as port_mesh
from wrf_tpu_torch.parallel import sharded as port_sharded
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_1d

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
MESHES = [(1, 1), (2, 2), (4, 2), (8, 1)]
CASES = ["small_case", "periodic_case", "open_bc_case"]
STEPS = 5


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def _cpu_mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _jax_mesh(shape):
    return jax_mesh.make_mesh(jax.devices()[:shape[0] * shape[1]], shape)


# ---------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------
def test_factor_near_square_matches_jax():
    assert port_mesh.AXES == jax_mesh.AXES
    for n in range(1, 65):
        assert (port_mesh.factor_near_square(n)
                == jax_mesh.factor_near_square(n))


def test_mesh_layout_and_rings():
    mesh = _cpu_mesh((4, 2))
    assert mesh.shape == (4, 2)
    assert mesh.coords()[:3] == [(0, 0), (0, 1), (1, 0)]
    assert mesh.neighbour((3, 1), "j", +1) == (0, 1)
    assert mesh.neighbour((0, 0), "j", -1) == (3, 0)
    assert mesh.neighbour((2, 1), "i", +1) == (2, 0)
    assert mesh.rings("j") == [[(0, 0), (1, 0), (2, 0), (3, 0)],
                               [(0, 1), (1, 1), (2, 1), (3, 1)]]
    assert mesh.rings("i")[3] == [(3, 0), (3, 1)]
    assert mesh.unique_devices() == [torch.device("cpu")]
    assert port_mesh.describe(mesh) == \
        "mesh 4x2: 8 shard(s) on 1 device(s) (cpu)"
    # the default shape is the near-square factorization, larger factor on j
    assert make_mesh(["cpu"] * 8).shape == (4, 2) == \
        tuple(jax_mesh.make_mesh(jax.devices()[:8]).devices.shape)
    assert make_mesh_1d(["cpu"] * 3).shape == (3, 1)
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) != device "
                                         "count 3"):
        make_mesh(["cpu"] * 3, (2, 2))
    with pytest.raises(ValueError, match="mesh shape"):
        jax_mesh.make_mesh(jax.devices()[:3], (2, 2))


def test_mesh_from_spec():
    mesh = port_mesh.mesh_from_spec("2x4", "cpu")
    assert isinstance(mesh, Mesh) and mesh.shape == (2, 4)
    assert port_mesh.mesh_from_spec("1X1", torch.device("cpu")).shape == (1, 1)
    assert [str(mesh.device(c)) for c in mesh.coords()] == ["cpu"] * 8
    for bad in ("2", "2x", "axb", "2x2x2"):
        with pytest.raises(ValueError, match="expected JxI"):
            port_mesh.mesh_from_spec(bad, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_mesh.mesh_from_spec("2x2", "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


# ---------------------------------------------------------------------
# the array glue
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES + [(2, 4), (3, 2)])
def test_pad_scatter_gather_round_trip(shape):
    """A 19x13x6 domain divides over none of these meshes but 1x1: the
    zero padding follows the domain, and gather(scatter(x)) is x."""
    case = fixtures.make_case(19, 13, 6, halo=2, seed=21)
    dom = port_sharded.case_to_domain(case)
    mesh, jmesh = _cpu_mesh(shape), _jax_mesh(shape)
    for name in ("t", "mu", "dnw"):
        x = dom[name]
        padded = port_sharded.pad_to_mesh(x, mesh)
        want = np.asarray(jax_sharded.pad_to_mesh(x, jmesh))
        assert padded.shape == want.shape and (padded == want).all()
        t = port_sharded.pad_to_mesh(torch.tensor(x), shape)
        assert isinstance(t, torch.Tensor) and (t.numpy() == want).all()
        blocks = port_sharded.scatter(padded, mesh)
        assert sorted(blocks) == mesh.coords()
        if x.ndim > 1:
            njl = padded.shape[0] // shape[0]
            nil = padded.shape[-1] // shape[1]
            for (jj, ii), b in blocks.items():
                assert b.shape[0] == njl and b.shape[-1] == nil
                assert (b.numpy() == padded[jj * njl:(jj + 1) * njl, ...,
                                            ii * nil:(ii + 1) * nil]).all()
        else:
            assert all((b.numpy() == x).all() for b in blocks.values())
        back = port_sharded.gather(blocks, mesh).numpy()
        assert back.shape == padded.shape and (back == padded).all()
        if x.ndim > 1:
            assert (back[:x.shape[0], ..., :x.shape[-1]] == x).all()
    if shape != (1, 1):
        with pytest.raises(ValueError, match="does not divide"):
            port_sharded.scatter(dom["t"], mesh)


def test_scatter_copies_and_offsets():
    mesh = _cpu_mesh((2, 2))
    x = np.arange(4 * 3 * 6, dtype=np.float32).reshape(4, 3, 6)
    blocks = port_sharded.scatter(x, mesh)
    blocks[0, 0].zero_()
    assert x[0, 0, 0] == 0 and x[0, 0, 1] == 1     # numpy is never written
    assert port_sharded.shard_offsets((0, 0), 2, 3) == (-1, -1)
    assert port_sharded.shard_offsets((1, 1), 2, 3) == (1, 2)
    # the JAX loop's offsets: axis_index * n_loc - 1 (sharded.py)
    assert port_sharded.shard_offsets((3, 1), 5, 11) == (3 * 5 - 1, 11 - 1)


def test_prepare_returns_blocks_on_a_mesh(small_case):
    case = small_case
    dom = port_sharded.case_to_domain(case)
    loop = SmallStepLoop(*_dims(case), case.flags, device="cpu",
                         mesh=_cpu_mesh((4, 2)))
    arrays = loop.prepare(dom)
    jloop = JaxSmallStepLoop(_jax_mesh((4, 2)), *_dims(case), case.flags,
                             kernel="xla")
    jarrays = jloop.prepare(dom)
    assert sorted(arrays) == sorted(jarrays)
    for name, blocks in arrays.items():
        assert sorted(blocks) == loop.mesh.coords()
        got = port_sharded.gather(blocks, loop.mesh).numpy()
        np.testing.assert_array_equal(got, np.asarray(jarrays[name]))
    back = loop.unprepare(arrays, ["t", "mu"])
    assert all((back[n].numpy() == dom[n]).all() for n in back)
    # no mesh: plain tensors, as before
    plain = SmallStepLoop(*_dims(case), case.flags, device="cpu").prepare(dom)
    assert all(isinstance(v, torch.Tensor) for v in plain.values())


# ---------------------------------------------------------------------
# ShardedAdvanceMuT on a mesh
# ---------------------------------------------------------------------
def _native_steps(case, steps):
    kw = case.kernel_kwargs()
    state = {k: kw[k] for k in ("ww", "mu", "t", "t_ave")}
    for _ in range(steps):
        out = advance_mu_t_native(**{**kw, **state})
        state = {k: out[k] for k in ("ww", "mu", "t", "t_ave")}
    return out


def _port_mut(case, shape, steps=3, **kw):
    loop = port_sharded.ShardedAdvanceMuT(
        *_dims(case), case.flags, n_steps=steps, device="cpu",
        mesh=_cpu_mesh(shape) if shape else None, **kw)
    out = loop(loop.prepare(port_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


@pytest.mark.parametrize("case_name", CASES)
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_mu_t_matches_oracle(shape, case_name, request):
    case = request.getfixturevalue(case_name)
    got = _port_mut(case, shape)
    gold = _native_steps(case, 3)
    outputs_allclose(port_sharded.embed_outputs(case, got),
                     {k: gold[k] for k in got}, **TOL)
    # per-column arithmetic does not depend on the block: every mesh gives
    # the unsharded loop's bits
    ref = _port_mut(case, None)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("kernel,jkernel", [("cuda", "pallas"),
                                            ("eager", "xla")])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_mu_t_matches_jax_on_the_same_mesh(small_case, shape, kernel,
                                                   jkernel):
    case = small_case
    jloop = jax_sharded.ShardedAdvanceMuT(_jax_mesh(shape), *_dims(case),
                                          case.flags, n_steps=1,
                                          kernel=jkernel)
    want = jloop(jloop.prepare(port_sharded.case_to_domain(case)), case.rdx,
                 case.rdy, case.dts, case.epssm)
    got = _port_mut(case, shape, steps=1, kernel=kernel)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()}, **TOL)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (8, 1)])
def test_sharded_mu_t_blocked_and_indivisible(shape):
    """19x13x6 divides over no mesh here (zero padding after the domain,
    excluded by the masks); blocked S=4 equals S=1 bit for bit and the
    oracle within tolerance."""
    case = fixtures.make_case(19, 13, 6, halo=2, seed=21)
    one = _port_mut(case, shape, steps=10)
    blk = _port_mut(case, shape, steps=10, inner_steps=4)
    for name in one:
        np.testing.assert_array_equal(blk[name], one[name], err_msg=name)
    gold = _native_steps(case, 10)
    outputs_allclose(port_sharded.embed_outputs(case, one),
                     {k: gold[k] for k in one}, **TOL)
    fast = _port_mut(case, shape, steps=10, inner_steps=4, fast=True,
                     vary_winds=True)
    outputs_allclose(fast, _port_mut(case, None, steps=10, inner_steps=4,
                                     fast=True, vary_winds=True), **TOL)


# ---------------------------------------------------------------------
# SmallStepLoop on a mesh
# ---------------------------------------------------------------------
def _port_loop(case, shape, steps=STEPS, with_w=False, **kw):
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=steps,
                         device="cpu", with_w=with_w,
                         mesh=_cpu_mesh(shape) if shape else None, **kw)
    dom = port_sharded.case_to_domain(case, with_w=with_w)
    out = loop(loop.prepare(dom), case.rdx, case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


@functools.lru_cache(maxsize=None)
def _jax_loop(shape, kernel="pallas", with_w=False, inner_steps=1,
              force_exchange=False, steps=STEPS):
    case = fixtures.make_case(20, 18, 8, halo=2, seed=7)     # small_case
    loop = JaxSmallStepLoop(_jax_mesh(shape), *_dims(case), case.flags,
                            n_steps=steps, kernel=kernel, with_w=with_w,
                            inner_steps=inner_steps,
                            force_exchange=force_exchange)
    dom = port_sharded.case_to_domain(case, with_w=with_w)
    out = loop(loop.prepare(dom), case.rdx, case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case_name", CASES)
@pytest.mark.parametrize("shape", MESHES)
def test_loop_matches_golden_on_a_mesh(shape, case_name, request):
    """The per-substep exchange of mu and v is what this validates: the
    winds change every substep and cross the shard edges."""
    case = request.getfixturevalue(case_name)
    got = _port_loop(case, shape)
    gold = small_step_golden(case, STEPS)
    outputs_allclose(port_sharded.embed_outputs(case, got),
                     {k: gold[k] for k in got}, **TOL)
    ref = _port_loop(case, None)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("kernel", ["cuda", "eager"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (8, 1)])
def test_rdma_equals_ppermute(small_case, shape, kernel):
    """The hand-written exchange (its plain version here) moves the rows
    the ppermute refresh moves: bit for bit, with and without w."""
    for with_w in (False, True):
        perm = _port_loop(small_case, shape, kernel=kernel, with_w=with_w)
        rdma = _port_loop(small_case, shape, kernel=kernel, with_w=with_w,
                          halo_backend="rdma")
        assert sorted(perm) == sorted(rdma)
        for name in perm:
            np.testing.assert_array_equal(rdma[name], perm[name],
                                          err_msg=name)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_loop_matches_jax_loop_on_the_same_mesh(small_case, shape):
    got = _port_loop(small_case, shape)
    want = _jax_loop(shape)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)


def test_loop_8x1_matches_jax_xla_loop(small_case):
    got = _port_loop(small_case, (8, 1), kernel="eager")
    outputs_allclose(got, _jax_loop((8, 1), kernel="xla"), **TOL)
    fused = _port_loop(small_case, (8, 1))
    outputs_allclose(fused, got, **TOL)


@pytest.mark.parametrize("kernel,jkernel", [("cuda", "pallas"),
                                            ("eager", "xla")])
def test_loop_with_w_matches_jax_and_golden(small_case, kernel, jkernel):
    case = small_case
    got = _port_loop(case, (2, 2), with_w=True, kernel=kernel)
    want = _jax_loop((2, 2), kernel=jkernel, with_w=True)
    assert sorted(got) == sorted(want) and "pp" in got
    outputs_allclose(got, want, **TOL)
    gold = small_step_golden(case, STEPS, with_w=True)
    outputs_allclose(port_sharded.embed_outputs(case, got),
                     {k: gold[k] for k in got}, **TOL)
    ref = _port_loop(case, None, with_w=True, kernel=kernel)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_blocked_loop_on_a_mesh(small_case, shape, S):
    """K3 on ring-S blocks whose outer cells hold the neighbours' data (in
    i too when i is sharded, with the column offset shifted by S-1): equal
    to the unsharded blocked loop bit for bit, and to the golden loop."""
    case = small_case
    got = _port_loop(case, shape, steps=2 * S + 2, inner_steps=S)
    ref = _port_loop(case, None, steps=2 * S + 2, inner_steps=S)
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    gold = small_step_golden(case, 2 * S + 2)
    outputs_allclose(port_sharded.embed_outputs(case, got),
                     {k: gold[k] for k in got}, **TOL)


@pytest.mark.parametrize("S", [2, 4])
def test_blocked_loop_matches_jax_on_2x2(small_case, S):
    got = _port_loop(small_case, (2, 2), inner_steps=S)
    outputs_allclose(got, _jax_loop((2, 2), inner_steps=S), **TOL)
    fast = _port_loop(small_case, (2, 2), inner_steps=S, fast=True,
                      with_w=True)
    outputs_allclose(fast, _port_loop(small_case, None, inner_steps=S,
                                      fast=True, with_w=True), **TOL)


def test_indivisible_domain_on_a_mesh():
    case = fixtures.make_case(19, 13, 6, halo=2, seed=21)
    gold = small_step_golden(case, STEPS)
    for shape, kw in (((4, 2), {}), ((2, 2), dict(inner_steps=2)),
                      ((4, 2), dict(kernel="eager", halo_backend="rdma"))):
        got = _port_loop(case, shape, **kw)
        outputs_allclose(port_sharded.embed_outputs(case, got),
                         {k: gold[k] for k in got}, **TOL)


@pytest.mark.parametrize("backend", ["ppermute", "rdma"])
def test_force_exchange_matches_jax(small_case, backend):
    """A ring of one: the refreshes run on the single shard (and overwrite
    its boundary-ring rows with its own edge rows, identically on both
    sides), so the JAX loop to compare with is the one WITH
    force_exchange."""
    got = _port_loop(small_case, None, force_exchange=True,
                     halo_backend=backend)
    want = _jax_loop((1, 1), force_exchange=True)
    outputs_allclose(got, want, **TOL)
    on_mesh = _port_loop(small_case, (1, 1), force_exchange=True,
                         halo_backend=backend)
    for name in got:
        np.testing.assert_array_equal(on_mesh[name], got[name], err_msg=name)


def test_force_exchange_blocked_matches_jax(small_case):
    got = _port_loop(small_case, None, force_exchange=True, inner_steps=2)
    want = _jax_loop((1, 1), force_exchange=True, inner_steps=2)
    outputs_allclose(got, want, **TOL)


def test_loop_leaves_prepared_blocks_alone(small_case):
    case = small_case
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=4, device="cpu",
                         mesh=_cpu_mesh((2, 2)), halo_backend="rdma")
    arrays = loop.prepare(port_sharded.case_to_domain(case))
    before = {n: {c: b.clone() for c, b in blocks.items()}
              for n, blocks in arrays.items()}
    loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert all(torch.equal(arrays[n][c], before[n][c])
               for n in arrays for c in arrays[n])


@pytest.mark.parametrize("kw,err,match", [
    (dict(halo_backend="nccl"), ValueError, "bad halo_backend 'nccl'"),
    (dict(halo_backend="rdma_overlap", const_dtype=torch.bfloat16), None,
     "runs: ported"),
    (dict(const_dtype=torch.bfloat16, kernel="eager"), ValueError,
     "const_dtype requires the fused kernel"),
    (dict(const_dtype=torch.float16), ValueError,
     "const_dtype must be torch.bfloat16 or None"),
    (dict(halo_backend="rdma_overlap", kernel="eager"), ValueError,
     "rdma_overlap requires the fused"),
    (dict(inner_steps=2.0), ValueError,
     "inner_steps must be a positive integer"),
    (dict(fast=True), ValueError, "requires inner_steps > 1"),
    (dict(inner_steps=2, kernel="eager"), ValueError,
     "inner_steps requires the fused kernel"),
    (dict(inner_steps=2, smdiv=0.1), ValueError, "does not support smdiv"),
    (dict(inner_steps=2, halo_backend="rdma", mesh=(2, 1)), ValueError,
     "blocked substeps .n_steps-1 >= inner_steps. use the width-S ppermute"),
    (dict(inner_steps=2, halo_backend="rdma", force_exchange=True),
     ValueError, "the plain rdma backend covers the single-step loop"),
])
def test_loop_validation_messages(small_case, kw, err, match):
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh"] = _cpu_mesh(kw["mesh"])
    if err is None:   # an option that was refused until it was ported
        loop = SmallStepLoop(*_dims(small_case), small_case.flags, n_steps=5,
                             device="cpu", **kw)
        out = loop(loop.prepare(port_sharded.case_to_domain(small_case)),
                   small_case.rdx, small_case.rdy, small_case.dts,
                   small_case.epssm)
        assert all(torch.isfinite(x).all() for x in out.values())
        return
    with pytest.raises(err, match=match):
        SmallStepLoop(*_dims(small_case), small_case.flags, n_steps=5,
                      device="cpu", **kw)


def test_rdma_with_a_short_blocked_loop_is_accepted(small_case):
    """Rejected only when the blocked path engages (n_steps-1 >= S), and
    only where j exchanges: as the JAX loop."""
    dims, flags = _dims(small_case), small_case.flags
    SmallStepLoop(*dims, flags, n_steps=2, inner_steps=2, device="cpu",
                  halo_backend="rdma", mesh=_cpu_mesh((2, 1)))
    SmallStepLoop(*dims, flags, n_steps=5, inner_steps=2, device="cpu",
                  halo_backend="rdma", mesh=_cpu_mesh((1, 2)))
    JaxSmallStepLoop(_jax_mesh((1, 2)), *dims, flags, n_steps=5,
                     inner_steps=2, halo_backend="rdma")
    with pytest.raises(ValueError, match="blocked substeps"):
        JaxSmallStepLoop(_jax_mesh((2, 1)), *dims, flags, n_steps=5,
                         inner_steps=2, halo_backend="rdma")


# ---------------------------------------------------------------------
# RK3 and run_sim on a mesh
# ---------------------------------------------------------------------
def test_rk3_on_2x2_matches_jax(small_case):
    case = small_case
    dt = case.dts * 4
    dom = port_sharded.case_to_domain(case)
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        snapshot="stage", device="cpu",
                        mesh=_cpu_mesh((2, 2)), halo_backend="rdma")
    arrays = rk3.prepare(dom)
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)
    jrk3 = JaxRK3Integrator(_jax_mesh((2, 2)), *_dims(case), case.flags,
                            acoustic_steps=4, kernel="pallas",
                            snapshot="stage")
    jarrays = jrk3.prepare(dom)
    want = jrk3.step(jarrays, case.rdx, case.rdy, dt, case.epssm)
    outputs_allclose(arrays_to_numpy(out),
                     {k: np.asarray(v) for k, v in want.items()}, **TOL)
    # merge_evolved works shard by shard and gives the JAX global arrays
    merged = rk3.merge_evolved(arrays, out)
    jmerged = jrk3.merge_evolved(jarrays, want)
    assert merged["t_1"] is arrays["t_1"]
    back = arrays_to_numpy(rk3.unprepare(merged, ["t", "mu", "u"]))
    nx, ny, _ = _dims(case)
    outputs_allclose(back, {k: np.asarray(jmerged[k])[:ny + 2, ..., :nx + 2]
                            for k in back}, **TOL)
    ref = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        snapshot="stage", device="cpu")
    ref_out = ref.step(ref.prepare(dom), case.rdx, case.rdy, dt, case.epssm)
    assert all(torch.equal(out[k], ref_out[k]) for k in ref_out)


def test_rk3_downgrades_blocked_stages_under_rdma(small_case):
    """acoustic_steps=8, S=2: the stages of 4 and 8 substeps engage the
    blocked path and fall back to the width-S ppermute refresh with the JAX
    integrator's warning; the 1-substep stage keeps rdma."""
    case = small_case
    kw = dict(acoustic_steps=8, inner_steps=2, halo_backend="rdma")
    with pytest.warns(UserWarning, match="has no width-S block exchange") \
            as caught:
        rk3 = RK3Integrator(*_dims(case), case.flags, device="cpu",
                            mesh=_cpu_mesh((2, 2)), **kw)
    with pytest.warns(UserWarning) as jcaught:
        JaxRK3Integrator(_jax_mesh((2, 2)), *_dims(case), case.flags, **kw)
    assert ([str(w.message) for w in caught]
            == [str(w.message) for w in jcaught])
    assert len(caught) == 2
    assert [lp.halo_backend for lp in rk3.loops] == ["rdma", "ppermute",
                                                     "ppermute"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # nothing to downgrade: silent
        RK3Integrator(*_dims(case), case.flags, device="cpu",
                      mesh=_cpu_mesh((2, 2)), acoustic_steps=2,
                      inner_steps=2, halo_backend="rdma")
    dom = port_sharded.case_to_domain(case)
    out = rk3.step(rk3.prepare(dom), case.rdx, case.rdy, case.dts * 8,
                   case.epssm)
    ref = RK3Integrator(*_dims(case), case.flags, device="cpu",
                        acoustic_steps=8, inner_steps=2)
    want = ref.step(ref.prepare(dom), case.rdx, case.rdy, case.dts * 8,
                    case.epssm)
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_run_sim_2x2_checkpoint_resumes_at_1x1(tmp_path, small_case, capsys):
    """Checkpoints hold global arrays: one step on 2x2 under rdma, resumed
    for one step on 1x1, equals two straight 1x1 steps bit for bit."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    common = [fx, "--device", "cpu"]
    assert run_sim.main(common + ["--steps", "2", "--checkpoint-dir",
                                  str(tmp_path / "ck2")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--mesh", "2x2",
                                  "--halo-backend", "rdma",
                                  "--checkpoint-dir",
                                  str(tmp_path / "ck")]) == 0
    assert run_sim.main(common + ["--steps", "1", "--checkpoint-dir",
                                  str(tmp_path / "ck"), "--resume"]) == 0
    printed = capsys.readouterr().out
    assert "mesh 2x2: 4 shard(s) on 1 device(s) (cpu), halo backend rdma" \
        in printed
    assert "resuming from" in printed
    straight, _, _ = checkpoint.load_checkpoint(
        tmp_path / "ck2" / "step_000002")
    resumed, step, _ = checkpoint.load_checkpoint(
        tmp_path / "ck" / "step_000002")
    assert step == 2
    for name in straight:
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)


def test_run_sim_mesh_with_w_blocked(tmp_path, small_case, capsys):
    """--mesh 8x1 --with-w --inner-steps 2 (20 ring rows over 8 shards:
    zero padding after the domain) equals the 1x1 run bit for bit, w and
    pp included."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    outs = {}
    for name, flags in (("m", ["--mesh", "8x1"]), ("r", [])):
        assert run_sim.main([fx, "--device", "cpu", "--with-w",
                             "--inner-steps", "2", "--checkpoint-dir",
                             str(tmp_path / name), *flags]) == 0
        outs[name], _, _ = checkpoint.load_checkpoint(
            tmp_path / name / "step_000001")
    assert "mesh 8x1: 8 shard(s)" in capsys.readouterr().out
    assert "pp" in outs["m"]
    for name in outs["r"]:
        np.testing.assert_array_equal(outs["m"][name], outs["r"][name],
                                      err_msg=name)
