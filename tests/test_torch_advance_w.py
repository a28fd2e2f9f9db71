"""The vertically-implicit w/pp substep in the port, against the JAX
package on the CPU: the eager ops, the Thomas precompute, and the fused
solve inside K1's and K3's plain PyTorch versions.

* ``rdn_from_dnw`` exact; eager ``advance_w`` against ``advance_w_jnp``
  at the JAX test's own tolerance (rtol 2e-6; atol 1e-5 on w, 1e-4 on pp:
  tests/test_advance_w.py) and against the numpy golden path; eager
  ``advance_uv`` against ``advance_uv_jnp`` at rtol 1e-6.
* The three Thomas helpers against the JAX ones: coefficients and the
  hoisted recurrence exact (the same float32 operations one at a time;
  XLA's CPU code may contract the recurrence's multiply-add, so that one
  is held to 1 ulp), the fast vectors at rtol 1e-6 (a cumulative product
  in another order).
* Plain K1 with ``fuse_w`` against ``advance_mu_t_pallas(fuse_w=True,
  interpret=True)`` in the scan, final and full modes under three lateral
  BCs, at rtol 2e-5, atol_scale 1e-6 (the kernels' tolerance: the TPU
  kernel sums dmdt in the compiler's order), and against the composition
  plain K1 -> eager ``advance_w`` (same tolerance: the eager op builds its
  rhs in another association).
* Plain K3 with ``fuse_w`` against ``coupled_multistep_pallas(fuse_w=True)``
  exact S=2/3/4 and fast S=4, K4 against the pair kernel, and plain K3
  bit for bit against S plain K1 ``fuse_w`` substeps.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from tests.test_torch_advance_mu_t import (
    _inputs, _mode_kwargs, _run_jax, _run_torch,
)
from tests.test_torch_coupled import _case, _k3_inputs
from wrf_tpu.ops import advance_mu_t_msteps as jax_msteps
from wrf_tpu.ops import advance_uv as jax_uv
from wrf_tpu.ops import advance_w as jax_w
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.ops import advance_uv as port_uv
from wrf_tpu_torch.ops import advance_w as port_w
from wrf_tpu_torch.ops import thomas
from wrf_tpu_torch.parallel import halo
from wrf_tpu_torch.parallel import sharded as port_sharded

torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-5, atol_scale=1e-6)
CASES = ["small_case", "periodic_case", "open_bc_case"]


def _w_args(case):
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1_ = case.bounds.loop_bounds(case.flags)
    f = case.fields
    return dict(w=f["grid_w"], pp=f["grid_pp"], t=kw["t_1"],
                rdn=f["grid_rdn"], rdnw=kw["rdnw"], dts=case.dts,
                epssm=case.epssm, window=(i0, i1, j0, j1), k0=k0, k1=k1_)


def _tensors(d):
    return {k: (torch.tensor(np.asarray(v, np.float32))
                if hasattr(v, "ndim") else v) for k, v in d.items()}


# ------------------------------------------------------- the eager ops ----
def test_constants_and_rdn_from_dnw(small_case):
    assert (port_w.DEFAULT_CW, port_w.DEFAULT_GW, port_uv.DEFAULT_CS2) == \
        (jax_w.DEFAULT_CW, jax_w.DEFAULT_GW, jax_uv.DEFAULT_CS2)
    dnw = np.asarray(small_case.kernel_kwargs()["dnw"])
    np.testing.assert_array_equal(port_w.rdn_from_dnw(dnw),
                                  jax_w.rdn_from_dnw(dnw))
    assert port_w.rdn_from_dnw(dnw)[0] == 0.0


@pytest.mark.parametrize("case_name", CASES)
def test_advance_w_numpy_is_the_jax_packages(case_name, request):
    args = _w_args(request.getfixturevalue(case_name))
    for got, want in zip(port_w.advance_w_numpy(**args),
                         jax_w.advance_w_numpy(**args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case_name", CASES)
def test_eager_advance_w_matches_jnp_and_numpy(case_name, request):
    args = _w_args(request.getfixturevalue(case_name))
    w_t, pp_t = port_w.advance_w(**_tensors(args))
    w_j, pp_j = jax_w.advance_w_jnp(**args)
    w_n, pp_n = port_w.advance_w_numpy(**args)
    assert (w_n != np.asarray(args["w"])).any(), "w never moved"
    for want_w, want_pp in ((np.asarray(w_j), np.asarray(pp_j)), (w_n, pp_n)):
        np.testing.assert_allclose(w_t.numpy(), want_w, rtol=2e-6, atol=1e-5)
        np.testing.assert_allclose(pp_t.numpy(), want_pp, rtol=2e-6,
                                   atol=1e-4)


def test_eager_advance_w_passes_through_outside_the_window(small_case):
    args = _w_args(small_case)
    i0, i1, j0, j1 = args["window"]
    k0 = args["k0"]
    targs = _tensors(args)
    w_t, pp_t = port_w.advance_w(**targs)
    w0, pp0 = np.asarray(args["w"]), np.asarray(args["pp"])
    assert w_t is not targs["w"] and (targs["w"].numpy() == w0).all()
    w_t, pp_t = w_t.numpy(), pp_t.numpy()
    assert (w_t[:j0] == w0[:j0]).all() and (w_t[j1 + 1:] == w0[j1 + 1:]).all()
    assert (w_t[:, :, :i0] == w0[:, :, :i0]).all()
    assert (pp_t[j1 + 1:] == pp0[j1 + 1:]).all()
    assert (pp_t[:, :, i1 + 1:] == pp0[:, :, i1 + 1:]).all()
    assert (w_t[:, k0, :] == w0[:, k0, :]).all()   # the surface is inert
    # offsets shift the window with the block's origin
    shifted = port_w.advance_w(**{**targs, "offsets": (3, 2),
                                  "window": (i0 + 2, i1 + 2, j0 + 3, j1 + 3)})
    assert torch.equal(shifted[0], torch.tensor(w_t))


@pytest.mark.parametrize("case_name", CASES)
def test_eager_advance_uv_matches_jnp_and_numpy(case_name, request):
    case = request.getfixturevalue(case_name)
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, _, _ = case.bounds.loop_bounds(case.flags)
    args = dict(u=kw["u"], v=kw["v"], mu=kw["mu"], muu=kw["muu"],
                muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
                rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
                window=(i0, i1, j0, j1))
    got = port_uv.advance_uv(**_tensors(args))
    for want in (jax_uv.advance_uv_jnp(**args),
                 port_uv.advance_uv_numpy(**args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for g, w in zip(port_uv.advance_uv_numpy(**args, mudf=kw["mu"],
                                             smdiv=0.1),
                    jax_uv.advance_uv_numpy(**args, mudf=kw["mu"],
                                            smdiv=0.1)):
        np.testing.assert_array_equal(g, w)
    assert port_uv.uv_windows((1, 5, 2, 7)) == jax_uv.uv_windows((1, 5, 2, 7))
    # divergence damping in the eager op: (cs2*smdiv)*mudf joins the pressure
    damp = dict(mudf=kw["mu_tend"], smdiv=0.1)
    got_d = port_uv.advance_uv(**_tensors({**args, **damp}))
    for want in (jax_uv.advance_uv_jnp(**args, **damp),
                 port_uv.advance_uv_numpy(**args, **damp)):
        for g, w in zip(got_d, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert not torch.equal(got_d[0], got[0])


# ------------------------------------------------ the Thomas precompute ----
@pytest.mark.parametrize("k0,k1_", [(0, 6), (1, 5)])
@pytest.mark.parametrize("dts", [2.0, 0.75])
def test_thomas_helpers_match_jax(small_case, dts, k0, k1_):
    f = small_case.fields
    rdn, rdnw = f["grid_rdn"], f["grid_rdnw"]
    K = len(rdnw)
    args = (rdn, rdnw, dts, 0.1, jax_w.DEFAULT_CW, jax_w.DEFAULT_GW, K, k0,
            k1_)
    got = thomas.thomas_coeffs(*args)
    want = jax_msteps._thomas_coeffs(*args)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    a, b, diag = got[2:5]
    cp, den = thomas.thomas_hoisted(a, b, diag)
    cp_j, den_j = jax_msteps._thomas_hoisted(*(jnp.asarray(x)
                                               for x in (a, b, diag)))
    np.testing.assert_array_max_ulp(cp, np.asarray(cp_j), maxulp=1)
    np.testing.assert_array_max_ulp(den, np.asarray(den_j), maxulp=1)
    # ... and it is the per-column sweep of the numpy golden path
    cp_seq = np.float32(0.0)
    for k in range(k0 + 1, k1_ + 1):
        d = np.float32(1.0) + a[k] + b[k]
        den_k = d if k == k0 + 1 else d + a[k] * cp_seq
        cp_seq = -b[k] / den_k
        assert (den[k], cp[k]) == (den_k, cp_seq)
    fast = thomas.thomas_fast_vectors(a, cp, den, K, k0, k1_)
    fast_j = jax_msteps._thomas_fast_vectors(
        jnp.asarray(a), jnp.asarray(cp), jnp.asarray(den), K, k0, k1_)
    for g, w in zip(fast, fast_j):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


def test_thomas_vectors_bundle(small_case):
    f = small_case.fields
    kw = dict(rdn=torch.tensor(f["grid_rdn"]),
              rdnw=torch.tensor(f["grid_rdnw"]), dts=2.0, epssm=0.1,
              cw=0.02, gw=1e-7, k0=0, k1=6)
    th = thomas.thomas_vectors(**kw)
    assert th.fast is None and th.a.dtype == torch.float32
    beta = np.float32(0.5) * (np.float32(1.0) + np.float32(0.1))
    assert (th.beta, th.alfa) == (float(beta), float(np.float32(1.0) - beta))
    assert th.c_w == float(np.float32(0.02) * np.float32(2.0))
    fast = thomas.thomas_vectors(**kw, fast=True)
    assert len(fast.fast) == 4 and torch.equal(fast.cp, th.cp)


# --------------------------------------------------------- K1 fuse_w ----
def _w_kwargs(case):
    f = case.fields
    return dict(fuse_w=True, w=np.asarray(f["grid_w"], np.float32),
                pp=np.asarray(f["grid_pp"], np.float32),
                rdn=np.asarray(f["grid_rdn"], np.float32),
                cw=jax_w.DEFAULT_CW, gw=jax_w.DEFAULT_GW)


@pytest.mark.parametrize("mode", ["scan", "final", "full"])
@pytest.mark.parametrize("case_name", CASES)
def test_plain_k1_fuse_w_matches_pallas(case_name, mode, request):
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    mkw = {**_mode_kwargs(mode, arr, sc, static), **_w_kwargs(case)}
    want = _run_jax(arr, sc, static, mkw)
    got = _run_torch(arr, sc, static, mkw)
    assert sorted(got) == sorted(want) and {"w", "pp"} <= set(got)
    assert (got["w"] != mkw["w"]).any(), "w never moved"
    outputs_allclose(got, want, **KERNEL_TOL)


@pytest.mark.parametrize("mode", ["scan", "final", "full"])
@pytest.mark.parametrize("case_name", ["small_case", "open_bc_case"])
def test_plain_k1_fuse_w_is_k1_then_advance_w(case_name, mode, request):
    """The fused call equals the substep without w followed by the eager
    ``advance_w`` on its new theta; everything but w and pp bit for bit."""
    case = request.getfixturevalue(case_name)
    arr, sc, static = _inputs(case)
    base = _mode_kwargs(mode, arr, sc, static)
    wkw = _w_kwargs(case)
    fused = _run_torch(arr, sc, static, {**base, **wkw})
    alone = _run_torch(arr, sc, static, base)
    for name, val in alone.items():
        np.testing.assert_array_equal(fused[name], val, err_msg=name)
    w_t, pp_t = port_w.advance_w(
        w=torch.tensor(wkw["w"]), pp=torch.tensor(wkw["pp"]),
        t=torch.tensor(alone["t"]), rdn=torch.tensor(wkw["rdn"]),
        rdnw=torch.tensor(arr["rdnw"]), dts=sc["dts"], epssm=sc["epssm"],
        window=static["window"], k0=static["k0"], k1=static["k1"],
        cw=wkw["cw"], gw=wkw["gw"])
    J = arr["t"].shape[0]
    rows = slice(1, J - 1)   # K1 never computes its first and last row
    outputs_allclose({"w": fused["w"][rows], "pp": fused["pp"][rows]},
                     {"w": w_t.numpy()[rows], "pp": pp_t.numpy()[rows]},
                     **KERNEL_TOL)
    for edge in (0, J - 1):
        assert (fused["w"][edge] == wkw["w"][edge]).all()
        assert (fused["pp"][edge] == wkw["pp"][edge]).all()


def test_k1_fuse_w_contract(small_case):
    """w and pp come back in fresh tensors and the inputs keep theirs; a
    passed ``thomas`` bundle gives the bits of the one the wrapper computes
    from rdn; the TPU wrapper's argument check."""
    arr, sc, static = _inputs(small_case)
    wkw = _w_kwargs(small_case)
    t1 = _tensors({**arr, **wkw})
    out = k1.advance_mu_t_fused(**t1, **sc, **static)
    assert out["w"] is not t1["w"] and out["pp"] is not t1["pp"]
    assert not np.array_equal(out["w"].numpy(), wkw["w"])
    assert np.array_equal(t1["w"].numpy(), wkw["w"])
    assert np.array_equal(t1["pp"].numpy(), wkw["pp"])
    th = thomas.thomas_vectors(
        rdn=torch.tensor(wkw["rdn"]), rdnw=torch.tensor(arr["rdnw"]),
        dts=sc["dts"], epssm=sc["epssm"], cw=wkw["cw"], gw=wkw["gw"],
        k0=static["k0"], k1=static["k1"])
    t2 = _tensors({**arr, **wkw})
    out2 = k1.advance_mu_t_fused(**t2, **sc, **static, thomas=th)
    for name in out:
        assert torch.equal(out[name], out2[name]), name
    for missing in ("w", "pp", "rdn"):
        bad = {**_tensors({**arr, **wkw}), missing: None}
        with pytest.raises(ValueError, match="fuse_w requires w, pp and rdn"):
            k1.advance_mu_t_fused(**bad, **sc, **static)
        with pytest.raises(ValueError, match="fuse_w requires w, pp and rdn"):
            k1.advance_mu_t_fused_plain(**bad, **sc, **static)


# --------------------------------------------------------- K3 fuse_w ----
@functools.lru_cache(maxsize=None)
def _k3w_inputs(S):
    """K3's inputs of tests/test_torch_coupled.py plus the w/pp state in
    the same ring-S layout, and the fuse_w arguments."""
    arr, static, padded, n = _k3_inputs(S)
    dom = port_sharded.case_to_domain(_case(), with_w=True)
    ring1 = {k: port_sharded.pad_halo(torch.tensor(dom[k])) for k in
             ("w", "pp")}
    arr = dict(arr, rdn=np.asarray(dom["rdn"], np.float32),
               **{k: halo.widen_ring_to(v, 0, S).numpy()
                  for k, v in ring1.items()})
    static = dict(static, fuse_w=True, cw=jax_w.DEFAULT_CW,
                  gw=jax_w.DEFAULT_GW, epssm=_case().epssm)
    padded = dict(padded, rdn=arr["rdn"],
                  **{k: v.numpy() for k, v in ring1.items()})
    return arr, static, padded, n


def _port_k3w(S, fn=k3.coupled_multistep, **mode):
    arr, static, _, _ = _k3w_inputs(S)
    return arrays_to_numpy(fn(**_tensors(arr), **static, **mode))


@functools.lru_cache(maxsize=None)
def _jax_k3w(S, fast=False, pair=False):
    arr, static, _, n = _k3w_inputs(S)
    if pair:
        out = jax_msteps.coupled_two_step_pallas(
            **arr, **static, fast=fast, tj=n, interpret=True)
    else:
        out = jax_msteps.coupled_multistep_pallas(
            **arr, **static, n_inner=S, fast=fast, tj=n, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("S,fast", [(2, False), (3, False), (4, False),
                                    (4, True)])
def test_plain_k3_fuse_w_matches_pallas(S, fast):
    got = _port_k3w(S, n_inner=S, fast=fast)
    want = _jax_k3w(S, fast)
    assert sorted(got) == sorted(want) == ["mu", "pp", "t", "u", "v", "w",
                                           "ww_row"]
    assert (got["w"] != _k3w_inputs(S)[0]["w"]).any(), "w never moved"
    outputs_allclose(got, want, **KERNEL_TOL)


def test_two_step_fuse_w_matches_pallas_pair():
    got = _port_k3w(2, fn=k3.coupled_two_step)
    outputs_allclose(got, _jax_k3w(2, pair=True), **KERNEL_TOL)
    for name, val in _port_k3w(2, n_inner=2).items():
        np.testing.assert_array_equal(got[name], val, err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
def test_plain_k3_fuse_w_equals_sequential_k1(S):
    """Exact mode with ``fuse_w`` is S of K1's fused scan substeps with
    ``fuse_w`` on the ring-1 layout, bit for bit on the rows both compute
    (w and pp included)."""
    _, static, padded, _ = _k3w_inputs(S)
    got = _port_k3w(S, n_inner=S)
    p = _tensors(padded)
    lean = k1.lean_kwargs(p, static["rdx"], static["rdy"], static["dts"],
                          static["k0"], static["k1"])
    carry = ("ww_row", "mu", "t", "u", "v", "w", "pp")
    state = {k: p.pop(k) for k in carry}
    for _ in range(S):
        out = k1.advance_mu_t_fused_plain(
            **p, **state, **lean, **static, fuse_uv=True, with_tave=False,
            ww_mode="lite", lean=True)
        state = {k: out[k] for k in carry}
    for name, val in arrays_to_numpy(state).items():
        strip = halo.strip_ring(torch.tensor(got[name]), 0, S).numpy()
        np.testing.assert_array_equal(strip[1:-1], val[1:-1], err_msg=name)


def test_k3_fast_solve_differs_from_exact_within_tolerance():
    exact = _port_k3w(4, n_inner=4)
    fast = _port_k3w(4, n_inner=4, fast=True)
    outputs_allclose(fast, exact, **KERNEL_TOL)
    assert not np.array_equal(fast["w"], exact["w"])   # the cumsums ran


def test_k3_fuse_w_contract():
    arr, static, _, _ = _k3w_inputs(2)
    t1 = _tensors(arr)
    out = k3.coupled_multistep(**t1, **static, n_inner=2)
    assert out["w"] is t1["w"] and out["pp"] is t1["pp"]
    for fn, kw in ((k3.coupled_multistep, dict(n_inner=2)),
                   (k3.coupled_two_step, {}),
                   (k3.coupled_multistep_plain, dict(n_inner=2))):
        for missing in ("w", "pp", "rdn"):
            bad = {**_tensors(arr), missing: None}
            with pytest.raises(ValueError,
                               match="fuse_w requires w, pp and rdn"):
                fn(**bad, **static, **kw)
