"""The port never imports jax nor anything of the JAX package (wrf_tpu),
and its CUDA-requesting paths fail loudly where there is no GPU or no nvcc.

tests/conftest.py imports jax into this process, so the import checks run
in a fresh interpreter."""

import re
import subprocess
import sys
import textwrap
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pytest
import torch

from wrf_tpu.io import fixtures
from wrf_tpu_torch import _build
from wrf_tpu_torch.io import fixtures as port_fixtures

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    torch.set_num_threads(1)
    import wrf_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(wrf_tpu_torch.__path__,
                                                   "wrf_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from wrf_tpu_torch.io.fixtures import make_case
    from wrf_tpu_torch.models.small_step import SmallStepLoop
    from wrf_tpu_torch.parallel.sharded import case_to_domain
    case = make_case(12, 10, 6, halo=2, seed=3)
    for inner, with_w in ((1, False), (2, False), (1, True), (2, True)):
        loop = SmallStepLoop(case.bounds.ide, case.bounds.jde,
                             case.bounds.kdim, case.flags, n_steps=3,
                             kernel="plain", inner_steps=inner, device="cpu",
                             with_w=with_w)
        out = loop(loop.prepare(case_to_domain(case, with_w=with_w)),
                   case.rdx, case.rdy, case.dts, case.epssm)
        assert torch.isfinite(out["t"]).all()
        assert ("w" in out) == with_w
    from wrf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    outs = []
    for backend in ("ppermute", "rdma"):
        loop = SmallStepLoop(case.bounds.ide, case.bounds.jde,
                             case.bounds.kdim, case.flags, n_steps=3,
                             device="cpu", mesh=mesh, halo_backend=backend)
        outs.append(loop(loop.prepare(case_to_domain(case)), case.rdx,
                         case.rdy, case.dts, case.epssm))
        assert torch.isfinite(outs[-1]["t"]).all()
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    # the exchange inside the kernels, with bf16 constant streams, blocked
    loop = SmallStepLoop(case.bounds.ide, case.bounds.jde, case.bounds.kdim,
                         case.flags, n_steps=6, inner_steps=2, device="cpu",
                         mesh=mesh, halo_backend="rdma_overlap",
                         const_dtype=torch.bfloat16)
    out = loop(loop.prepare(case_to_domain(case)), case.rdx, case.rdy,
               case.dts, case.epssm)
    assert torch.isfinite(out["t"]).all() and out["t"].dtype == torch.float32
    assert "jax" not in sys.modules, "jax was imported"
    borrowed = [m for m in sys.modules
                if m == "wrf_tpu" or m.startswith("wrf_tpu.")]
    assert not borrowed, f"the JAX package was imported: {borrowed}"
    print("MODULES", len(names))
""")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split("MODULES")[1])
    assert n >= 25


_IMPORT_BANNED = re.compile(
    r"^\s*(from|import)\s+(jax|wrf_tpu)(\.|\s|$)", re.MULTILINE)


def _port_sources():
    for src in (REPO / "wrf_tpu_torch").rglob("*.py"):
        if "_build" not in src.relative_to(REPO).parts:   # build outputs
            yield src
    yield REPO / "chip_smoke.py"


def test_port_sources_import_no_jax_modules():
    """No module of the port, nor chip_smoke.py, imports jax or any module
    of the JAX package (``wrf_tpu_torch`` itself is not ``wrf_tpu``)."""
    sources = list(_port_sources())
    assert len(sources) > 25
    for src in sources:
        hits = [m.group(0).strip()
                for m in _IMPORT_BANNED.finditer(src.read_text())]
        assert not hits, f"{src}: {hits}"


def test_import_ban_pattern_catches_what_it_should():
    bad = ("import wrf_tpu", "from wrf_tpu import native",
           "    from wrf_tpu.io import fixtures", "import wrf_tpu.grid as g",
           "import jax", "from jax import numpy")
    good = ("import wrf_tpu_torch", "from wrf_tpu_torch.io import fixtures",
            "# from wrf_tpu import x", "x = 'import wrf_tpu'",
            "from .grid import ConfigFlags", "import jaxtyping")
    assert all(_IMPORT_BANNED.search(ln) for ln in bad)
    assert not any(_IMPORT_BANNED.search(ln) for ln in good)


def test_make_case_matches_jax_package():
    a = port_fixtures.make_case(12, 10, 6, halo=2, seed=3, balanced=True)
    b = fixtures.make_case(12, 10, 6, halo=2, seed=3, balanced=True)
    assert a.fields.keys() == b.fields.keys()
    assert all(np.array_equal(a.fields[k], b.fields[k]) for k in a.fields)
    assert (a.rdx, a.rdy, a.dts, a.epssm, astuple(a.bounds),
            astuple(a.flags)) == \
        (b.rdx, b.rdy, b.dts, b.epssm, astuple(b.bounds), astuple(b.flags))


def test_run_sim_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU path cannot be shown")
    from wrf_tpu_torch import run_sim
    with pytest.raises(SystemExit, match="is_available"):
        run_sim.main([str(tmp_path / "fx"), "--device", "cuda"])


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed: nvcc cannot be hidden")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_tracks_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("libwrf_tpu_torch_") and p.suffix == ".so"
    assert p == _build.library_path()
    assert [s.name for s in _build.sources()] == [
        "advance_mu_t.cu", "advance_mu_t_bf16.cu",
        "advance_mu_t_bf16_overlap.cu", "advance_mu_t_coupled.cu",
        "advance_mu_t_coupled_bf16.cu", "advance_mu_t_coupled_bf16_overlap.cu",
        "advance_mu_t_coupled_overlap.cu", "advance_mu_t_msteps.cu",
        "advance_mu_t_overlap.cu", "copy.cu", "halo_ipc.cu", "halo_rdma.cu",
        "probe_2d.cu",
        "probe_2d_bisect.cu", "advance_mu_t_coupled_kernel.cuh", "advance_mu_t_kernel.cuh",
        "const_stream.cuh", "w_solve.cuh"]
