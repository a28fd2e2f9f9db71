"""The port's meshes over several processes (``wrf_tpu_torch/parallel/
distributed.py``) against the JAX package's multi-host helpers
(``wrf_tpu/parallel/distributed.py``), on the CPU.

The one-process path is held against JAX bit for bit (the helpers move
data and compute nothing); the multi-process path runs
``python -m wrf_tpu_torch.tools.multihost_check --device cpu`` at 2 and 4
processes, which holds every field bit for bit against the one-process
run on the same (2, 4) mesh, and that run's results (the tool's
``--save-reference``) are held against the JAX tool's three programs run
in JAX on the same fixture arrays over the 8 CPU devices, at
``tests/test_torch_mesh.py``'s tolerance.  The checks that need no process
group (the owner table, the NCCL refusal) use a fake owner table.  The
rdma backends across processes are ``tests/test_torch_ipc_halo.py``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.tendencies import NudgingTendencies as JaxNudging
from wrf_tpu.parallel import distributed as jax_distributed
from wrf_tpu.parallel import mesh as jax_mesh
from wrf_tpu.parallel import sharded as jax_sharded
from wrf_tpu_torch.parallel import distributed
from wrf_tpu_torch.parallel.mesh import Mesh, describe
from wrf_tpu_torch.parallel.sharded import (
    ShardedAdvanceMuT, case_to_domain, gather, pad_to_mesh, scatter,
)
from wrf_tpu_torch.tools import multihost_check

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: tests/test_torch_mesh.py's tolerance of the port's loops against JAX's
TOL = dict(rtol=5e-5, atol_scale=2e-6)


def owners_for(nproc: int, n: int = 8) -> list[int]:
    """Rank of every shard when ``nproc`` ranks hold consecutive runs."""
    return [k // (n // nproc) for k in range(n)]


def fake_mesh(nproc: int, rank: int = 0, shape=(2, 4), device="cpu",
              backend="gloo") -> Mesh:
    n = shape[0] * shape[1]
    return Mesh([device] * n, shape, owners=owners_for(nproc, n), rank=rank,
                backend=backend if nproc > 1 else None)


@pytest.fixture
def no_cluster(monkeypatch):
    for k in distributed.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)


# --------------------------------------------------------------------------
# (a) the one-process path, as tests/test_sharded.py::test_distributed_helpers
# --------------------------------------------------------------------------
def test_one_process_path_matches_jax(small_case, no_cluster):
    distributed.initialize()
    distributed.initialize()          # a second call: nothing happens
    assert not dist.is_initialized()
    mesh = distributed.global_mesh(devices=["cpu"] * 8)
    jax_distributed.initialize()
    jmesh = jax_distributed.global_mesh()
    assert mesh.shape == tuple(jmesh.devices.shape) == (2, 4)
    assert mesh.local_coords() == mesh.coords()
    assert not mesh.spans_processes

    case = small_case
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    dom = case_to_domain(case)
    step = ShardedAdvanceMuT(nx, ny, nz, case.flags, n_steps=2,
                             device="cpu", mesh=mesh)
    ref = step.prepare(dom)
    slabs = {n: np.asarray(pad_to_mesh(a, mesh)) for n, a in dom.items()}
    built = distributed.host_local_arrays(mesh, slabs)
    assert built.keys() == ref.keys()
    for name in built:
        assert built[name].keys() == ref[name].keys()
        for c in built[name]:
            assert torch.equal(built[name][c], ref[name][c]), (name, c)
    # the values JAX's helper assembles, bit for bit
    jstep = jax_sharded.ShardedAdvanceMuT(jmesh, nx, ny, nz, case.flags,
                                          n_steps=2)
    jslabs = {n: np.asarray(jax_sharded.pad_to_mesh(a, jmesh))
              for n, a in dom.items()}
    jbuilt = jax_distributed.host_local_arrays(jmesh, jslabs, jstep.shardings)
    for name in built:
        got = gather(built[name], mesh).numpy()
        assert np.array_equal(got.view(np.uint32),
                              np.asarray(jbuilt[name]).view(np.uint32)), name
    # the loop takes them as it takes prepare's blocks
    out = step(built, case.rdx, case.rdy, case.dts, case.epssm)
    want = step(ref, case.rdx, case.rdy, case.dts, case.epssm)
    assert all(torch.equal(out[k], want[k]) for k in want)
    assert torch.isfinite(out["t"]).all()


def test_global_mesh_factorisation_is_jaxs():
    """nj the largest divisor of n at most isqrt(n): 8 -> (2, 4), where the
    port's factor_near_square gives (4, 2)."""
    for n, want in ((1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (6, (2, 3)),
                    (8, (2, 4)), (12, (3, 4))):
        assert distributed.global_mesh(devices=["cpu"] * n).shape == want
    assert distributed.global_mesh((4, 2), devices=["cpu"] * 8).shape == (4, 2)


# --------------------------------------------------------------------------
# (b) process_local_block against NamedSharding.devices_indices_map
# --------------------------------------------------------------------------
def jax_local_block(nproc: int, rank: int, spec, gshape):
    """The union of the slices JAX gives the devices of ``rank`` (devices
    grouped into ranks by consecutive id) on the (2, 4) mesh."""
    jmesh = jax_mesh.make_mesh(jax.devices()[:8], (2, 4))
    idx = NamedSharding(jmesh, spec).devices_indices_map(tuple(gshape))
    mine = [ix for d, ix in idx.items() if d.id // (8 // nproc) == rank]
    return tuple(slice(min(ix[a].start or 0 for ix in mine),
                       max(gshape[a] if ix[a].stop is None else ix[a].stop
                           for ix in mine))
                 for a in range(len(gshape)))


@pytest.mark.parametrize("nproc", [1, 2, 4])
@pytest.mark.parametrize("spec,gshape", [
    (P("j", None, "i"), (40, 12, 48)), (P("j", "i"), (40, 48)),
    (P(), (12,))])
def test_process_local_block_matches_jax(nproc, spec, gshape):
    for rank in range(nproc):
        mesh = fake_mesh(nproc, rank)
        got = distributed.process_local_block(mesh, gshape)
        assert got == jax_local_block(nproc, rank, spec, gshape), rank
        assert got == distributed.process_local_block(fake_mesh(nproc),
                                                      gshape, rank=rank)


def test_process_local_block_raises_for_a_rank_without_shards():
    with pytest.raises(ValueError, match="holds no shard"):
        distributed.process_local_block(fake_mesh(2), (40, 48), rank=2)
    ragged = Mesh(["cpu"] * 8, (2, 4), owners=[0, 1, 0, 1, 0, 1, 0, 1],
                  backend="gloo")
    with pytest.raises(ValueError, match="do not tile one block"):
        distributed.process_local_block(ragged, (40, 48))


def test_host_local_arrays_j_slabs_and_2d_grids(small_case):
    """A rank's blocks are the same tensors prepare makes for its shards,
    with j-slabs inferred (2 ranks) or global shapes given (4 ranks, a 2-D
    process grid); a 2-D grid without global shapes raises."""
    case = small_case
    dom = case_to_domain(case)
    one = fake_mesh(1)
    padded = {n: np.asarray(pad_to_mesh(a, one)) for n, a in dom.items()}
    every = {n: scatter(a, one) for n, a in padded.items()}
    for nproc in (2, 4):
        for rank in range(nproc):
            mesh = fake_mesh(nproc, rank)
            blocks = {n: (a[distributed.process_local_block(mesh, a.shape)]
                          if a.ndim in (2, 3) else a)
                      for n, a in padded.items()}
            shapes = {n: a.shape for n, a in padded.items()}
            got = distributed.host_local_arrays(
                mesh, blocks, None if nproc == 2 else shapes)
            for n, b in got.items():
                assert list(b) == mesh.local_coords()
                for c, x in b.items():
                    assert torch.equal(x, every[n][c]), (nproc, rank, n, c)
            if nproc == 4:
                with pytest.raises(ValueError, match="global_shapes"):
                    distributed.host_local_arrays(mesh, blocks)
    # a copy: the port never writes through to numpy
    mesh = fake_mesh(2)
    src = np.zeros((8, 4), np.float32)
    got = distributed.host_local_arrays(mesh, {"mu": src})
    got["mu"][0, 0] += 1
    assert not src.any()


# --------------------------------------------------------------------------
# (c) initialize: explicit arguments surface every error
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(backend="no-such-backend", world_size=1, rank=0),
    dict(backend="gloo", world_size=1, rank=3)])
def test_initialize_bad_explicit_arguments_raise(kwargs, tmp_path,
                                                 no_cluster):
    try:
        with pytest.raises((ValueError, RuntimeError)):
            distributed.initialize(init_method=f"file://{tmp_path}/pg",
                                   **kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# (d) NCCL with two ranks on one device raises before any exchange
# --------------------------------------------------------------------------
def test_nccl_two_ranks_on_one_device_raises():
    with pytest.raises(ValueError, match="one card per rank"):
        fake_mesh(2, shape=(2, 2), device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="moves CUDA tensors"):
        fake_mesh(2, shape=(2, 2), device="cpu", backend="nccl")
    # one card per rank is what NCCL takes (no card is touched here)
    mesh = Mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:1"], (2, 2),
                owners=[0, 0, 1, 1], rank=0, backend="nccl")
    assert mesh.local_coords() == [(0, 0), (0, 1)]
    # the same device name on two hosts is two cards
    Mesh(["cuda:0"] * 4, (2, 2), owners=[0, 0, 1, 1], backend="nccl",
         hosts=["a", "b"])
    with pytest.raises(ValueError, match="needs its backend"):
        Mesh(["cpu"] * 4, (2, 2), owners=[0, 0, 1, 1])
    with pytest.raises(ValueError, match="bad backend"):
        Mesh(["cpu"] * 4, (2, 2), backend="mpi")


# --------------------------------------------------------------------------
# (e) a one-process mesh, and a rank's view of a mesh over processes
# --------------------------------------------------------------------------
def test_one_process_mesh_is_unchanged():
    mesh = Mesh(["cpu"] * 4, (2, 2))
    assert mesh.local_coords() == mesh.coords()
    assert mesh.owners == [[0, 0], [0, 0]] and mesh.rank == 0
    assert describe(mesh) == "mesh 2x2: 4 shard(s) on 1 device(s) (cpu)"
    two = fake_mesh(2, rank=1, shape=(2, 2))
    assert two.local_coords() == [(1, 0), (1, 1)]
    assert describe(two).endswith("(rank 1), of 2 processes over gloo")


# --------------------------------------------------------------------------
# (f) the loops across 2 and 4 processes, bit for bit against one
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_programs():
    """The JAX tool's three programs in JAX on the (2, 4) mesh of the 8 CPU
    devices, on the fixture arrays the port's tool runs (its
    ``domains``), as ``{"tag/field": array}`` in the port tool's layout:
    the loops' domain-shaped outputs; the closed RK3 step's merged t, mu
    and u (ring-shaped, the mesh padding dropped) and its diagnostics."""
    jmesh = jax_mesh.make_mesh(jax.devices()[:8], (2, 4))
    progs = multihost_check.suite("jax")
    doms = multihost_check.domains(progs)
    out = {}
    for tag, kind, (nx, ny, nz), kw, which in progs:
        _, dom = doms[(nx, ny, nz), which]
        case = (jax_fixtures.make_case(nx, ny, nz, halo=3, seed=9,
                                       amplitude=1e-2, balanced=True)
                if which == "balanced" else
                jax_fixtures.make_case(nx, ny, nz, halo=3, seed=7))
        # the same inputs on both sides
        jdom = jax_sharded.case_to_domain(case)
        assert jdom.keys() == dom.keys()
        for name in dom:
            assert np.array_equal(np.asarray(jdom[name]), dom[name]), name
        if kind == "rk3":
            A = kw["acoustic_steps"]
            rk3 = JaxRK3Integrator(jmesh, nx, ny, nz, case.flags,
                                   acoustic_steps=A, snapshot="base")
            arrays = rk3.prepare(dom)
            dt = case.dts * A
            fn = JaxNudging(arrays, dt, tau_steps=5.0)
            res = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                           tendency_fn=fn)
            merged = rk3.merge_evolved(arrays, res)
            fn.damp_winds(merged)
            for name in ("t", "mu", "u"):
                out[f"{tag}/{name}"] = np.asarray(
                    merged[name])[:ny + 2, ..., :nx + 2]
            out[f"{tag}/diags"] = np.array(
                [[np.asarray(res["mu"]).sum(dtype=np.float32),
                  np.asarray(res["t"])[:, 0, :].sum(dtype=np.float32)]],
                np.float32)
            continue
        if kind == "coupled":
            loop = JaxSmallStepLoop(jmesh, nx, ny, nz, case.flags, **kw)
        else:
            loop = jax_sharded.ShardedAdvanceMuT(
                jmesh, nx, ny, nz, case.flags, kernel="xla",
                vary_winds=True, **kw)
        res = loop(loop.prepare(dom), case.rdx, case.rdy, case.dts,
                   case.epssm)
        for name in ("t", "mu", "ww"):
            out[f"{tag}/{name}"] = np.asarray(res[name])
    return out


@pytest.mark.parametrize("nproc", [2, 4])
def test_multihost_check_cpu(nproc, tmp_path, jax_programs):
    """The tool across ``nproc`` processes, bit-equal to its one-process
    run, and that run within tolerance of the same programs in JAX."""
    env = {k: v for k, v in os.environ.items()
           if k not in distributed.CLUSTER_ENV}
    ref_path = tmp_path / "reference.npz"
    r = subprocess.run(
        [sys.executable, "-m", "wrf_tpu_torch.tools.multihost_check",
         "--device", "cpu", "--nproc", str(nproc), "--timeout", "240",
         "--save-reference", str(ref_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and f"MULTIHOST OK ({nproc} processes)" in \
        r.stdout, r.stdout[-3000:] + r.stderr[-3000:]
    # every field of the three programs, each rank's three reports
    assert r.stdout.count("bit-equal") == 10
    assert r.stdout.count("launches") == 3 * nproc
    with np.load(ref_path) as ref:
        got = {k: ref[k] for k in ref.files}
    assert got.keys() == jax_programs.keys()
    for key, want in jax_programs.items():
        assert got[key].shape == want.shape, key
        outputs_allclose({key: got[key]}, {key: want}, **TOL)


def test_a_failed_or_hung_worker_fails_the_run():
    """The first failure, or the time limit, kills the other workers."""
    def start(code):
        return subprocess.Popen([sys.executable, "-c", code])

    procs = [start("import sys; sys.exit(3)"),
             start("import time; time.sleep(60)")]
    with pytest.raises(RuntimeError, match="a worker failed"):
        multihost_check._wait_all(procs, timeout=60)
    assert procs[1].poll() is not None
    procs = [start("import time; time.sleep(60)")]
    with pytest.raises(RuntimeError, match="did not finish"):
        multihost_check._wait_all(procs, timeout=0.5)
    assert procs[0].poll() is not None


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path cannot be shown")
    with pytest.raises(RuntimeError, match="is_available"):
        multihost_check.run(2, "cuda")


def test_bit_differences_counts_bits():
    a = np.array([1.0, np.nan, 0.0], np.float32)
    assert multihost_check.bit_differences(a, a.copy()) == 0
    assert multihost_check.bit_differences(a, np.array([1.0, np.nan, -0.0],
                                                       np.float32)) == 1
