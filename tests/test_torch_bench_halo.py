"""The port's exchange-overhead tool (``wrf_tpu_torch/tools/bench_halo.py``)
against the JAX package's ``tools/bench_halo.py``: its seven rows, the
``force_exchange`` loops they time (the three backends bit-equal to each
other in the port, and within the mesh tier's tolerance, rtol 5e-5 and
atol_scale 2e-6, of the JAX loop with ``force_exchange`` on the same
(1,1) mesh and the tool's own case), and the CLI on the CPU.
"""

import contextlib
import io
import re

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.parallel import mesh as jax_mesh
from wrf_tpu.parallel import sharded as jax_sharded
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain
from wrf_tpu_torch.tools import bench_halo

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
GRID = (16, 14, 8)
#: the JAX tool's rows, in its order
JAX_ROWS = ["no exchange", "ppermute exchange", "rdma exchange",
            "rdma_overlap", "S=4 no exchange", "S=4 ppermute blocks",
            "S=4 rdma_overlap"]


def test_rows_are_the_jax_tools():
    assert [name for name, _ in bench_halo.CONFIGS] == JAX_ROWS
    assert bench_halo.COUNTS == (100, 400)
    for name, kw in bench_halo.CONFIGS:
        assert kw["force_exchange"] == ("no exchange" not in name)
        assert kw.get("inner_steps", 1) == (4 if name.startswith("S=4")
                                            else 1)


def _port(kw, steps):
    case = fixtures.make_case(*GRID, halo=3, seed=42)
    loop = SmallStepLoop(*GRID, case.flags, n_steps=steps, device="cpu",
                         mesh=make_mesh(["cpu"], (1, 1)), **kw)
    out = loop(loop.prepare(case_to_domain(case)), case.rdx, case.rdy,
               case.dts, case.epssm)
    return arrays_to_numpy(out)


def _jax(kw, steps):
    case = jax_fixtures.make_case(*GRID, halo=3, seed=42)
    kw = {k: v for k, v in kw.items() if k != "halo_backend"}
    loop = JaxSmallStepLoop(jax_mesh.make_mesh(jax.devices()[:1], (1, 1)),
                            *GRID, case.flags, n_steps=steps, **kw)
    out = loop(loop.prepare(jax_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("S", [1, 4])
def test_force_exchange_rows_agree(S):
    """The rows one baseline covers: every backend's ``force_exchange``
    loop equal to the others bit for bit (a ring of one moves the same
    rows whichever way), and within tolerance of the JAX loop with
    ``force_exchange`` (its ppermute form) on the same case."""
    steps = 9
    rows = [(name, kw) for name, kw in bench_halo.CONFIGS
            if kw["force_exchange"] and kw.get("inner_steps", 1) == S]
    assert len(rows) == (3 if S == 1 else 2)
    outs = {name: _port(kw, steps) for name, kw in rows}
    first = outs[rows[0][0]]
    for name, out in outs.items():
        assert sorted(out) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(out[k], first[k],
                                          err_msg=f"{name} {k}")
    outputs_allclose(first, _jax(rows[0][1], steps), **TOL)


def test_marginal_aligns_the_blocked_counts(monkeypatch):
    """A blocked row times pass-aligned counts (``blocked_counts``), as the
    JAX tool does."""
    seen = []
    real = SmallStepLoop.__init__

    def spy(self, *a, **kw):
        seen.append((kw["n_steps"], kw.get("inner_steps", 1)))
        real(self, *a, **kw)

    monkeypatch.setattr(SmallStepLoop, "__init__", spy)
    case = fixtures.make_case(*GRID, halo=3, seed=42)
    per = bench_halo.marginal(case, *GRID, 5, 13, repeats=1, device="cpu",
                              force_exchange=True, inner_steps=4)
    assert np.isfinite(per)
    from wrf_tpu.utils.timing import blocked_counts
    assert [n for n, _ in seen] == list(blocked_counts(4, 5, 13))


def test_cli_prints_the_seven_rows_on_the_cpu(monkeypatch):
    """The CLI's header and its seven rows, as ``run`` prints them (here at
    fewer substeps and one repeat, the host's time being no card's)."""
    real = bench_halo.run
    monkeypatch.setattr(bench_halo, "run", lambda *a: real(
        *a, counts=(3, 7), repeats=1))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_halo.main(["--device", "cpu", "12", "12", "8"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("device=cpu") and "not a card" in lines[0]
    pat = re.compile(r"^ *(.+) \(12x12x8\): +(-?[0-9.]+) ms/substep +"
                     r"overhead +([0-9.]+) us$")
    rows = [pat.match(line) for line in lines[1:]]
    assert all(rows), lines
    assert [m.group(1) for m in rows] == JAX_ROWS
    assert float(rows[0].group(3)) == 0.0   # the baseline's own overhead


def test_a_missing_card_stops_the_tool(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no GPU"):
        bench_halo.main([])
