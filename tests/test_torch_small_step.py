"""The port's acoustic small-step loop (1x1) against the JAX SmallStepLoop on
a 1x1 mesh with the Pallas kernel (interpret mode on CPU) and against the
numpy golden loop.  Both packages are fed from one case_to_domain dict;
tolerance rtol 5e-5, atol_scale 2e-6 (tests/test_small_step.py's)."""

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.small_step import small_step_golden
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.parallel import sharded as port_sharded
from wrf_tpu.parallel import sharded as jax_sharded

torch.set_num_threads(1)

STEPS = 5
TOL = dict(rtol=5e-5, atol_scale=2e-6)


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def _port_loop(case, dom, kernel):
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=STEPS,
                         kernel=kernel, device="cpu")
    out = loop(loop.prepare(dom), case.rdx, case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


@pytest.mark.parametrize("kernel", ["plain", "cuda"])
@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_loop_matches_golden(case_name, kernel, request):
    """kernel="cuda" on CPU tensors dispatches to the plain version."""
    case = request.getfixturevalue(case_name)
    got = _port_loop(case, port_sharded.case_to_domain(case), kernel)
    gold = small_step_golden(case, STEPS)
    outputs_allclose(port_sharded.embed_outputs(case, got),
                     {k: gold[k] for k in got}, **TOL)


def test_loop_matches_jax_pallas_loop(small_case):
    case = small_case
    dom = port_sharded.case_to_domain(case)
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jloop = JaxSmallStepLoop(mesh, *_dims(case), case.flags, n_steps=STEPS,
                             kernel="pallas")
    want = jloop(jloop.prepare(dom), case.rdx, case.rdy, case.dts,
                 case.epssm)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = _port_loop(case, dom, "plain")
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)


def test_numpy_glue_matches_jax_module(open_bc_case):
    """The port's copy of the jax module's numpy glue gives the same
    arrays and windows."""
    case = open_bc_case
    a = port_sharded.case_to_domain(case, with_w=True)
    b = jax_sharded.case_to_domain(case, with_w=True)
    assert a.keys() == b.keys()
    assert all((a[k] == b[k]).all() for k in a)
    assert (port_sharded.domain_window(*_dims(case), case.flags)
            == jax_sharded.domain_window(*_dims(case), case.flags))
    for name in ("FIELDS_3D", "FIELDS_2D", "FIELDS_1D", "SCALARS", "RING"):
        assert getattr(port_sharded, name) == getattr(jax_sharded, name)
    emb_a = port_sharded.embed_outputs(case, {"t": a["t"][1:-1, :, 1:-1]})
    emb_b = jax_sharded.embed_outputs(case, {"t": b["t"][1:-1, :, 1:-1]})
    assert (emb_a["t"] == emb_b["t"]).all()
    assert port_sharded.pad_to_mesh(a["t"]) is a["t"]
    for shape in ((2, 1), (4, 2), (8, 1), (2, 3)):
        mesh = make_mesh(jax.devices()[:shape[0] * shape[1]], shape)
        for name in ("t", "mu", "dnw"):
            got = port_sharded.pad_to_mesh(a[name], shape)
            want = np.asarray(jax_sharded.pad_to_mesh(b[name], mesh))
            assert got.shape == want.shape and (got == want).all()


def test_loop_leaves_prepared_arrays_alone(small_case):
    """The loop's in-place substep updates touch its own padded copies
    only: the prepared inputs are unchanged after a call."""
    case = small_case
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=3, device="cpu")
    arrays = loop.prepare(port_sharded.case_to_domain(case))
    before = {k: v.clone() for k, v in arrays.items()}
    loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert all(torch.equal(arrays[k], before[k]) for k in arrays)
