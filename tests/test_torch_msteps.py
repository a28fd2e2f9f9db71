"""K2 and the mu/t loop in the port, against the JAX package on the CPU.

* K2's plain PyTorch version (what ``advance_mu_t_multistep`` runs on CPU
  tensors) against ``advance_mu_t_multistep_pallas`` in interpret mode,
  on the same numpy inputs (the lean constants and the padded fields of
  one loop), at rtol 2e-5, atol_scale 1e-6; in exact mode also bit for bit
  against S sequential calls of the port's own K1 plain lean/lite substep.
* ``ShardedAdvanceMuT`` (1x1) against the JAX loop on a 1x1 mesh, at
  rtol 5e-5, atol_scale 2e-6 (tests/test_small_step.py's loop tolerance).
* The eager tier's ``advance_mu_t_impl`` against the JAX one at
  2e-5/1e-6 (both leave the order of the column sum and the scan to the
  library).

Grid 40x30x12 as in tests/test_msteps.py; the wind ramp is on
(``vary_winds``/``wind_scale_step=1e-7``) wherever the JAX side has it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.ops import advance_mu_t_jnp as jnp_mod
from wrf_tpu.ops.advance_mu_t_msteps import advance_mu_t_multistep_pallas
from wrf_tpu.parallel import sharded as jax_sharded
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.ops import advance_mu_t_eager as eager
from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2
from wrf_tpu_torch.parallel import sharded as port_sharded

torch.set_num_threads(1)

DW = 1e-7          # the loop's wind ramp per substep (vary_winds)
LOOP_TOL = dict(rtol=5e-5, atol_scale=2e-6)


@pytest.fixture(scope="module")
def blk_case():
    return fixtures.make_case(40, 30, 12, halo=3, seed=7)


@pytest.fixture(scope="module")
def k2_inputs(blk_case):
    """One blocked pass's numpy inputs, as the loop builds them: the
    padded ring arrays, the lean constants and a scan-seed row."""
    case = blk_case
    b = case.bounds
    dom = port_sharded.case_to_domain(case)
    padded = {n: port_sharded.pad_halo(torch.tensor(dom[n]))
              for n in port_sharded.FIELDS_3D + port_sharded.FIELDS_2D}
    padded.update({n: torch.tensor(dom[n]) for n in port_sharded.FIELDS_1D})
    i0, i1, j0, j1, k0, k1_ = port_sharded.domain_window(
        b.ide, b.jde, b.kdim, case.flags)
    lean = k1.lean_kwargs(padded, case.rdx, case.rdy, case.dts, k0, k1_)
    arr = {n: padded[n].numpy() for n in (
        "u", "v", "t", "t_1", "mu", "mu_tend", "msftx", "msfty", "dnw",
        "fnm", "fnp", "rdnw")}
    arr.update({k: v.numpy() for k, v in lean.items()})
    arr["ww_row"] = (padded["ww"][:, k0, :]
                     + 0.01 * padded["ww_1"][:, k0 + 1, :]).numpy()
    static = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0, k1=k1_,
                  kde=b.kdim - 1, rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                  epssm=case.epssm)
    # what K1 reads besides K2's inputs (the lean substep leaves them unused)
    k1_only = {n: padded[n] for n in ("ww", "ww_1", "u_1", "v_1", "ft", "mut",
                                      "muu", "muv", "msfuy", "msfvx_inv")}
    return arr, static, k1_only


def _port_k2(arr, static, **mode):
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    out = k2.advance_mu_t_multistep(**tarr, **static, **mode)
    return arrays_to_numpy(out)


def _jax_k2(arr, static, **mode):
    out = advance_mu_t_multistep_pallas(**arr, **static, **mode,
                                        interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("n_inner,step0", [(2, 0), (2, 2), (3, 0), (3, 3)])
def test_plain_exact_matches_pallas(k2_inputs, n_inner, step0):
    arr, static, _ = k2_inputs
    mode = dict(n_inner=n_inner, wind_step0=step0, wind_scale_step=DW)
    got = _port_k2(arr, static, **mode)
    want = _jax_k2(arr, static, **mode)
    assert sorted(got) == sorted(want) == ["mu", "t", "ww_row"]
    outputs_allclose(got, want)


@pytest.mark.parametrize("n_inner,step0", [(2, 0), (3, 3), (9, 18)])
def test_plain_exact_equals_sequential_k1(k2_inputs, n_inner, step0):
    """Exact mode is S of K1's lean/lite substeps with the ramp's wind
    scale, bit for bit (the kernel's own contract)."""
    arr, static, k1_only = k2_inputs
    got = _port_k2(arr, static, n_inner=n_inner, wind_step0=step0,
                   wind_scale_step=DW)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    state = {k: tarr.pop(k) for k in ("t", "mu", "ww_row")}
    for s in range(n_inner):
        out = k1.advance_mu_t_fused_plain(
            **tarr, **state, **static, **k1_only, with_tave=False,
            ww_mode="lite", lean=True,
            wind_scale=float(np.float32(1) + np.float32(step0 + s)
                             * np.float32(DW)))
        state = {k: out[k] for k in state}
    for name, val in arrays_to_numpy(state).items():
        np.testing.assert_array_equal(got[name], val, err_msg=name)


@pytest.mark.parametrize("step0", [0, 4])
def test_plain_fast_matches_pallas_and_exact(k2_inputs, step0):
    arr, static, _ = k2_inputs
    mode = dict(n_inner=4, wind_step0=step0, wind_scale_step=DW)
    fast = _port_k2(arr, static, **mode, fast=True)
    outputs_allclose(fast, _jax_k2(arr, static, **mode, fast=True))
    exact = _port_k2(arr, static, **mode)
    outputs_allclose(fast, exact)
    # the closed form re-associates: bit-identity on every field would
    # mean it never ran
    assert any(not np.array_equal(fast[k], exact[k]) for k in exact)


def test_wrapper_contract(k2_inputs):
    """t, mu and ww_row are updated in place and returned; the numpy
    inputs are never written through; bad arguments raise."""
    arr, static, _ = k2_inputs
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    out = k2.advance_mu_t_multistep(**tarr, **static, n_inner=2)
    for name in ("t", "mu", "ww_row"):
        assert out[name] is tarr[name]
        assert not np.array_equal(out[name].numpy(), arr[name])
    with pytest.raises(ValueError, match="n_inner"):
        k2.advance_mu_t_multistep(**tarr, **static, n_inner=0)
    # a bf16 constant stream is widened on load (it was refused until it
    # was ported): bit-equal to the float32 call on the rounded values; a
    # bf16 state operand raises, with the JAX message
    ref = {k: torch.tensor(v) for k, v in arr.items()}
    ref["t_1"] = ref["t_1"].to(torch.bfloat16).float()
    want = k2.advance_mu_t_multistep(**ref, **static, n_inner=2)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    tarr["t_1"] = tarr["t_1"].to(torch.bfloat16)
    got = k2.advance_mu_t_multistep(**tarr, **static, n_inner=2)
    assert all(torch.equal(got[n], want[n]) for n in want)
    tarr["t"] = tarr["t"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 't' is not a constant stream"):
        k2.advance_mu_t_multistep(**tarr, **static, n_inner=2)


K2_READ = ("u", "v", "t_1", "tconst", "dvdxi_const", "ww1_k0", "mu_tend",
           "msftx", "msfty", "dnw", "fnm", "fnp", "rdnw")


@pytest.mark.parametrize("read", K2_READ)
@pytest.mark.parametrize("written", ["t", "mu", "ww_row"])
def test_in_place_operand_must_not_alias_a_read_one(k2_inputs, written,
                                                    read):
    """K2 loads a level's operands before it stores t at the levels below
    (and other threads read the neighbour columns of the read-only
    fields), so t, mu and ww_row may not overlap any operand the launch
    only reads: the wrapper raises, on either device, before any launch."""
    arr, static, _ = k2_inputs
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    w, r = tarr[written], tarr[read]
    if r.numel() <= w.numel():   # the read operand inside the written one
        tarr[read] = w.view(-1)[:r.numel()].view(r.shape)
    else:                        # the written operand inside the read one
        tarr[written] = r.view(-1)[:w.numel()].view(w.shape)
    with pytest.raises(ValueError,
                       match=f"{read} must not alias {written}"):
        k2.advance_mu_t_multistep(**tarr, **static, n_inner=2)
    assert k2.LAUNCHES == 0


def test_views_of_one_storage_that_do_not_overlap_are_accepted(k2_inputs):
    arr, static, _ = k2_inputs
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    want = k2.advance_mu_t_multistep(
        **{k: v.clone() for k, v in tarr.items()}, **static, n_inner=2)
    big = torch.stack([tarr["t"], tarr["t_1"]])
    got = k2.advance_mu_t_multistep(**dict(tarr, t=big[0], t_1=big[1]),
                                    **static, n_inner=2)
    assert all(torch.equal(got[n], want[n]) for n in want)


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


def _port_loop(case, n_steps, **kw):
    loop = port_sharded.ShardedAdvanceMuT(*_dims(case), case.flags,
                                          n_steps=n_steps, device="cpu", **kw)
    out = loop(loop.prepare(port_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


def _jax_loop(case, n_steps, **kw):
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    loop = jax_sharded.ShardedAdvanceMuT(mesh, *_dims(case), case.flags,
                                         n_steps=n_steps, **kw)
    out = loop(loop.prepare(jax_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("inner_steps", [1, 2])
def test_loop_matches_jax_loop(blk_case, inner_steps):
    got = _port_loop(blk_case, 7, vary_winds=True, inner_steps=inner_steps)
    want = _jax_loop(blk_case, 7, vary_winds=True, inner_steps=inner_steps)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **LOOP_TOL)


def test_loop_blocked_equals_single_step(blk_case):
    ref = _port_loop(blk_case, 7, vary_winds=True)
    blk = _port_loop(blk_case, 7, vary_winds=True, inner_steps=2)
    assert sorted(ref) == sorted(blk)
    for name in ref:
        np.testing.assert_array_equal(blk[name], ref[name], err_msg=name)
    fast = _port_loop(blk_case, 7, vary_winds=True, inner_steps=3, fast=True)
    outputs_allclose(fast, ref)


@pytest.mark.parametrize("case_name", ["small_case", "open_bc_case"])
def test_eager_loop_matches_jax_xla_loop(case_name, request):
    case = request.getfixturevalue(case_name)
    got = _port_loop(case, 3, vary_winds=True, kernel="eager")
    want = _jax_loop(case, 3, vary_winds=True, kernel="xla")
    outputs_allclose(got, want, **LOOP_TOL)
    outputs_allclose(got, _port_loop(case, 3, vary_winds=True), **LOOP_TOL)


@pytest.mark.parametrize("bad", [
    dict(inner_steps=0), dict(fast=True), dict(kernel="eager", inner_steps=2),
    dict(kernel="pallas"), dict(n_steps=0),
])
def test_loop_argument_checks(small_case, bad):
    kw = {"n_steps": 3, **bad}
    with pytest.raises(ValueError):
        port_sharded.ShardedAdvanceMuT(*_dims(small_case), small_case.flags,
                                       device="cpu", **kw)


@pytest.mark.parametrize("case_name",
                         ["small_case", "periodic_case", "open_bc_case"])
def test_eager_impl_matches_jax(case_name, request):
    case = request.getfixturevalue(case_name)
    kw = case.kernel_kwargs()
    b = case.bounds
    _, _, _, _, k0, k1_ = b.loop_bounds(case.flags)
    arr = {k: np.asarray(v, np.float32) for k, v in kw.items()
           if hasattr(v, "ndim")}
    sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
    i_mask, j_mask = eager.window_masks(b, case.flags)
    assert all(np.array_equal(x, y) for x, y in
               zip((i_mask, j_mask), jnp_mod.window_masks(b, case.flags)))
    static = dict(k0=k0, k1=k1_, kde=b.mem(b.kde, "k"))
    want = jnp_mod.advance_mu_t_core(
        **{k: jnp.asarray(v) for k, v in arr.items()}, **sc,
        i_mask=jnp.asarray(i_mask), j_mask=jnp.asarray(j_mask), **static)
    got = eager.advance_mu_t_core(
        **{k: torch.tensor(v) for k, v in arr.items()}, **sc,
        i_mask=torch.tensor(i_mask), j_mask=torch.tensor(j_mask), **static)
    assert sorted(got) == sorted(want)
    outputs_allclose(arrays_to_numpy(got),
                     {k: np.asarray(v) for k, v in want.items()})
