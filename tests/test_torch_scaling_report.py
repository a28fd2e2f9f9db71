"""The port's scaling report (``wrf_tpu_torch/tools/scaling_report.py``,
which counts what ``parallel/halo.py``'s exchanges and K5 send) against the
JAX package's ``tools/scaling_report.py::analyze`` (the collective-permutes
of the compiled program) on the same case and meshes.

Every message count is equal: per substep mu's j and i halos and v's j
halo (2 each), per trapezoid block mu, u and v on both axes, and the
one-time set-up (the 19 fields' halo construction and the final substep).
Bytes differ by construction on the i axis alone: XLA lowers each of mu's
single-column i permutes to 2*J_loc rows (66 at (2,2), 34 at (4,2)) where
the port sends the padded column's J_loc+2 rows, and the trapezoid's
ring-4 i slabs to 72 and 40 rows where the port's ring-4 block has J_loc+8
(41 and 25); the j slabs are equal element for element.  Those tests pin
both numbers.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from wrf_tpu.io import fixtures as jax_fixtures
from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.ops import halo_rdma_cuda as k5
from wrf_tpu_torch.parallel import halo
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.tools import scaling_report

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GRID, STEPS = (64, 64, 16), 4   # the JAX tool's defaults


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_report_tool", REPO / "tools" / "scaling_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


@pytest.fixture(scope="module")
def cases():
    return (fixtures.make_case(*GRID, halo=2, seed=5),
            jax_fixtures.make_case(*GRID, halo=2, seed=5))


def _j_loc(shape, case):
    return -(-(case.bounds.jde + 2) // shape[0])


def _i_slab_bytes(rows):
    return 2 * rows * 4   # two single-column float32 slabs a substep


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2), (8, 1)])
def test_per_substep_counts_match_jax_analyze(cases, shape):
    port_case, jax_case = cases
    got = scaling_report.analyze(port_case, shape, STEPS)
    want = JAX_TOOL.analyze(jax_case, shape, STEPS)
    for key in ("collectives_per_substep", "setup_collectives"):
        assert got[key] == want[key], key
    assert got["k5_launches_per_substep"] == 0
    j_bytes = sum(v["bytes"] for k, v in got["by_kind"].items()
                  if k.endswith(" j"))
    if shape[1] == 1:   # no i exchange: every byte is a j row
        assert got["halo_bytes_per_substep"] == want["halo_bytes_per_substep"]
        assert j_bytes == got["halo_bytes_per_substep"]
        return
    # by construction: the i slabs (mu's column) differ in rows
    jl = _j_loc(shape, port_case)
    assert got["by_kind"]["refresh_axis_w i"] == {
        "messages": 2, "bytes": _i_slab_bytes(jl + 2)}
    assert want["halo_bytes_per_substep"] == j_bytes + _i_slab_bytes(2 * jl)
    pinned = {(2, 2): (5040, 5288), (4, 2): (4912, 5032)}[shape]
    assert (got["halo_bytes_per_substep"],
            want["halo_bytes_per_substep"]) == pinned


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_trapezoid_counts_match_jax_analyze(cases, shape):
    port_case, jax_case = cases
    S = 4
    got = scaling_report.analyze(port_case, shape, 4 * S + 1, inner_steps=S)
    want = JAX_TOOL.analyze(jax_case, shape, 4 * S + 1, inner_steps=S)
    assert got["collectives_per_substep"] == want[
        "collectives_per_substep"] == 12
    j = {k: v for k, v in got["by_kind"].items() if k.endswith(" j")}
    i = {k: v for k, v in got["by_kind"].items() if k.endswith(" i")}
    assert sum(v["messages"] for v in j.values()) == 6
    assert sum(v["messages"] for v in i.values()) == 6
    # mu's and u's/v's width-4 i slabs: J_loc+8 rows in the port, 72 (at
    # J_loc 33) and 40 (at 17) in the JAX program's
    jl = _j_loc(shape, port_case)
    i_elems = 2 * S * (1 + 2 * GRID[2])   # mu, u and v, both directions
    j_bytes = sum(v["bytes"] for v in j.values())
    assert sum(v["bytes"] for v in i.values()) == 4 * i_elems * (jl + 2 * S)
    jax_rows = {(2, 2): 72, (4, 2): 40}[shape]
    assert want["halo_bytes_per_substep"] == j_bytes + 4 * i_elems * jax_rows
    pinned = {(2, 2): (86592, 119328), (4, 2): (69696, 85536)}[shape]
    assert (got["halo_bytes_per_substep"],
            want["halo_bytes_per_substep"]) == pinned


def test_rdma_counts_k5_segments():
    """Under ``rdma`` the j rows go through K5 (its plain version on the
    CPU: counted, never launched): mu both ways and v's high row per shard
    per substep; the i halo stays on the copies."""
    case = fixtures.make_case(24, 20, 6, halo=2, seed=5)
    r = scaling_report.analyze(case, (2, 2), 3, halo_backend="rdma")
    I = -(-(case.bounds.ide + 2) // 2) + 2
    assert r["by_kind"]["rdma j"] == {"messages": 3,
                                      "bytes": 4 * I * (2 + case.bounds.kdim)}
    assert r["by_kind"]["refresh_axis_w i"]["messages"] == 2
    assert r["collectives_per_substep"] == 5
    assert r["k5_launches_per_substep"] == 0


def test_the_counter_counts_one_exchange():
    """``SENT`` adds two messages a shard per ppermute call and one segment
    a row per K5 exchange, with their bytes; nothing else."""
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    rng = np.random.default_rng(0)
    blocks = {c: torch.from_numpy(rng.standard_normal((6, 3, 7)).astype(
        np.float32)) for c in mesh.coords()}
    before = dict(halo.SENT)
    halo.refresh_axis(blocks, 0, "j", mesh, 4)
    halo.refresh_axis(blocks, 2, "i", mesh, 5)
    k5.remote_refresh_axis(blocks, "j", mesh, 4)
    delta = {k: v - before.get(k, 0) for k, v in halo.SENT.items()
             if v != before.get(k, 0)}
    assert delta == {
        ("refresh_axis_w j", "messages"): 8,
        ("refresh_axis_w j", "bytes"): 8 * 3 * 7 * 4,
        ("refresh_axis_w i", "messages"): 8,
        ("refresh_axis_w i", "bytes"): 8 * 6 * 3 * 4,
        ("rdma j", "messages"): 8,
        ("rdma j", "bytes"): 8 * 3 * 7 * 4,
    }


def test_cli_prints_the_mesh_lines():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert scaling_report.main(["24", "20", "6", "3"]) == 0
    text = buf.getvalue()
    for shape in ((1, 1), (2, 2), (4, 2), (8, 1)):
        assert f"mesh {shape}: " in text
    assert "depth-4 trapezoid (inner_steps=4):" in text
    assert "mesh (2, 2): 12 messages/block = 3.0/substep" in text
    assert "mesh (2, 2): 6 in-loop messages/substep" in text
    assert "82 one-time setup messages" in text
