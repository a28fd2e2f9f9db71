"""The j halo exchange inside the substep kernels (``overlap`` of K1 and K3,
``halo_backend="rdma_overlap"``) through the port, on the CPU, against the
JAX package.

The port's wrappers run their plain versions here (CPU tensors); the JAX
kernels run in Pallas interpret mode on the virtual 1-axis mesh, as
``tests/test_overlap.py`` runs them (the interpreter cannot discharge
remote copies on two mesh axes, so on (2,2) the port is held against its
own ``ppermute`` and ``rdma`` loops).  Both sides get the same seeded
numpy inputs.  Tolerances: the single K1 call rtol 2e-5, atol_scale 1e-6
(``assert_outputs_allclose``'s defaults, the K1 tests'); the loops rtol
5e-5, atol_scale 2e-6 (``tests/test_small_step.py``'s); within the port,
the three backends and every mesh agree BIT FOR BIT, with the memory halo
rows poisoned where a single call is compared.
"""

import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from tests import test_overlap as jax_overlap
from tests.conftest import outputs_allclose
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.parallel.mesh import make_mesh_1d as jax_make_mesh_1d
from wrf_tpu_torch import driver, run_sim
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.parallel.mesh import make_mesh
from wrf_tpu_torch.parallel.sharded import case_to_domain

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol_scale=2e-6)
POISON = 1e30
OUT9 = ("ww", "t", "t_ave", "mu", "muave", "muts", "mudf", "u", "v")
F3, F2, F1 = jax_overlap.F3, jax_overlap.F2, jax_overlap.F1


def _cpu_mesh(shape):
    return make_mesh(["cpu"] * (shape[0] * shape[1]), shape)


def _dims(case):
    return case.bounds.ide, case.bounds.jde, case.bounds.kdim


# ---------------------------------------------------------------------
# one K1 call per shard of a 1-axis ring
# ---------------------------------------------------------------------
def _ring_blocks(g, n_sh):
    """The global fields of ``tests/test_overlap.py`` as the shards' ring-1
    padded blocks (torus topology: the ring wrap is the exchange)."""
    ny = g["t"].shape[0]
    n = ny // n_sh
    blocks = []
    for s in range(n_sh):
        rows = np.arange(s * n - 1, (s + 1) * n + 1) % ny
        blocks.append({k: torch.tensor(g[k][rows] if g[k].ndim > 1
                                       else g[k]) for k in g})
    return blocks, n


def _k1_ring(g, n_sh, *, overlap, mudf=None, smdiv=0.0, fuse_w=False,
             **mode):
    """One fused coupled substep on every shard of a ring of ``n_sh``:
    either on refreshed halos (the ``ppermute`` form) or, with ``overlap``,
    on POISONED halo rows of mu, v and mudf_in plus the neighbours' rows.
    Returns the interiors, concatenated."""
    ny, nx, K = g["t"].shape[0], g["t"].shape[2] - 2, g["t"].shape[1]
    blocks, n = _ring_blocks({**g, **({"mudf_in": mudf}
                                     if mudf is not None else {})}, n_sh)
    outs = []
    for s, b in enumerate(blocks):
        b = {k: v.clone() for k, v in b.items()}
        prv, nxt = blocks[(s - 1) % n_sh], blocks[(s + 1) % n_sh]
        kw = {}
        if overlap:
            rows = dict(mu_lo=prv["mu"][n], mu_hi=nxt["mu"][1],
                        v_hi=nxt["v"][1])
            poisoned = ["mu", "v"]
            if mudf is not None:
                rows.update(mudf_lo=prv["mudf_in"][n],
                            mudf_hi=nxt["mudf_in"][1])
                poisoned.append("mudf_in")
            for name in poisoned:
                b[name][0] = b[name][-1] = POISON
            kw["overlap"] = rows
        if fuse_w:
            rdn = torch.linspace(0.5, 1.5, K)
            kw.update(fuse_w=True, w=b["ww"] * 0.5, pp=b["t_ave"] * 0.25,
                      rdn=rdn, cw=0.2, gw=0.05)
        if mode.get("ww_mode", "full") != "full":
            kw["ww_row"] = b["ww"][:, 0, :].clone()
        if mode.get("lean"):
            kw.update(k1.lean_kwargs(b, 0.1, 0.12, 0.25, 0, K - 2))
        out = k1.advance_mu_t_fused(
            **{k: b[k] for k in F3 + F2 + F1}, rdx=0.1, rdy=0.12, dts=0.25,
            epssm=0.1, window=(1, nx, 0, ny - 1), offsets=(s * n - 1, -1),
            k0=0, k1=K - 2, kde=K - 1, fuse_uv=True, cs2=0.3, smdiv=smdiv,
            mudf_in=b.get("mudf_in"), **mode, **kw)
        outs.append({k: v[1:-1] for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs]).numpy() for k in outs[0]}


@pytest.mark.parametrize("n_sh,tj", [(4, 3), (2, 6)])
def test_k1_overlap_matches_pallas_overlap(n_sh, tj):
    """The port's K1 with poisoned halos and the neighbours' rows against
    ``advance_mu_t_pallas(overlap=...)`` on a ring of 4 and of 2 (rtol
    2e-5, atol_scale 1e-6), and bit-equal to the port's own call on
    refreshed halos."""
    ny, nx, K = 24, 16, 6
    g = jax_overlap._global_fields(ny, nx, K)
    want = jax_overlap._run("overlap", ny, nx, K, n_sh, tj)
    got = _k1_ring(g, n_sh, overlap=True)
    ref = _k1_ring(g, n_sh, overlap=False)
    assert sorted(want) == sorted(got) == sorted(OUT9)
    outputs_allclose(got, want)
    for n in OUT9:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
        assert np.abs(got[n]).max() < 1e20, f"poison leaked into {n}"


@pytest.mark.parametrize("n_sh", [1, 2, 4])
@pytest.mark.parametrize("mode", [
    dict(),
    dict(ww_mode="final", with_tave=True),
    dict(ww_mode="lite", with_tave=False, lean=True),
], ids=["full", "final", "scan"])
@pytest.mark.parametrize("extra", [
    dict(), dict(damp=True), dict(fuse_w=True),
    dict(damp=True, fuse_w=True)], ids=["plain", "smdiv", "w", "smdiv+w"])
def test_k1_overlap_is_bit_equal_to_refreshed_halos(n_sh, mode, extra):
    """Every form the loops launch, on rings of 1, 2 and 4 (a ring of one:
    the neighbour is the shard itself): the poisoned halo rows are never
    read, and the result is the refreshed-halo call's, bit for bit."""
    ny, nx, K = 24, 16, 6
    g = jax_overlap._global_fields(ny, nx, K)
    kw = dict(mode, fuse_w=extra.get("fuse_w", False))
    if extra.get("damp"):
        rng = np.random.default_rng(11)
        kw.update(mudf=rng.standard_normal(g["mu"].shape).astype(np.float32),
                  smdiv=0.1)
    got = _k1_ring(g, n_sh, overlap=True, **kw)
    ref = _k1_ring(g, n_sh, overlap=False, **kw)
    assert sorted(got) == sorted(ref)
    for n in got:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
        assert np.abs(got[n]).max() < 1e20, f"poison leaked into {n}"
    if extra.get("damp"):
        undamped = _k1_ring(g, n_sh, overlap=True, **dict(kw, smdiv=0.0))
        assert not np.array_equal(got["u"], undamped["u"])


def test_k1_overlap_validations():
    """The JAX check that has a counterpart keeps its message; the port's
    own: the rows come all together.  A row may lie in any operand, since
    the launch writes none; the caller's tensors are not written."""
    g = jax_overlap._global_fields(12, 8, 4)
    t = {k: torch.tensor(v) for k, v in g.items()}
    kw = dict(**t, rdx=0.1, rdy=0.1, dts=0.2, epssm=0.1,
              window=(1, 8, 1, 10), k0=0, k1=2, kde=3)
    rows = dict(mu_lo=t["mu"][-2], mu_hi=t["mu"][1], v_hi=t["v"][1])
    with pytest.raises(ValueError, match="overlap requires fuse_uv"):
        k1.advance_mu_t_fused(**kw, overlap=rows)
    with pytest.raises(ValueError, match="overlap requires fuse_uv"):
        k1.advance_mu_t_fused_plain(**kw, overlap=rows)
    with pytest.raises(ValueError, match=r"missing \['v_hi'\]"):
        k1.advance_mu_t_fused(**kw, fuse_uv=True, cs2=0.3,
                              overlap={k: rows[k] for k in ("mu_lo", "mu_hi")})
    with pytest.raises(ValueError, match=r"missing \['mudf_lo', 'mudf_hi'\]"):
        k1.advance_mu_t_fused(**kw, fuse_uv=True, cs2=0.3, overlap=rows,
                              mudf_in=t["mut"], smdiv=0.1)
    with pytest.raises(ValueError, match=r"unknown \['axis_name'\]"):
        k1.advance_mu_t_fused(**kw, fuse_uv=True, cs2=0.3,
                              overlap=dict(rows, axis_name="j"))
    before = {k: v.clone() for k, v in t.items()}
    k1.advance_mu_t_fused(**kw, fuse_uv=True, cs2=0.3,
                          overlap=dict(rows, v_hi=t["t"][1]))
    k1.advance_mu_t_fused(**kw, fuse_uv=True, cs2=0.3, overlap=rows)
    for n in t:
        assert torch.equal(t[n], before[n]), n


# ---------------------------------------------------------------------
# K3 on a ring: ring rows from the neighbours
# ---------------------------------------------------------------------
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("n_sh", [1, 2])
@pytest.mark.parametrize("fuse_w", [False, True], ids=["plain", "w"])
def test_k3_overlap_is_bit_equal_to_refreshed_ring_rows(S, n_sh, fuse_w):
    ny, nx, K = 16, 12, 5
    g = jax_overlap._global_fields(ny, nx, K, seed=5)
    n = ny // n_sh
    names = ("u", "v", "t", "t_1", "u_1", "v_1", "ww_1", "ft", "mu", "muu",
             "muv", "mu_tend", "msfuy", "msfvx_inv", "msftx", "msfty")

    def block(s):   # ring-S rows around shard s, wrapping
        rows = np.arange(s * n - S, (s + 1) * n + S) % ny
        return {k: torch.tensor(g[k][rows]) for k in names}

    vert = {k: torch.tensor(g[k]) for k in F1}
    res = {}
    for overlap in (False, True):
        outs = []
        blocks = [block(s) for s in range(n_sh)]
        for s, b in enumerate(blocks):
            b = {k: v.clone() for k, v in b.items()}
            wide = {**b, **vert}
            const = {"t_1": b["t_1"], "mu_tend": b["mu_tend"],
                     "msftx": b["msftx"], "msfty": b["msfty"], **vert,
                     **k1.lean_kwargs(wide, 0.1, 0.12, 0.25, 0, K - 2),
                     **k3.coupled_lean_kwargs(wide, 0.1, 0.12, 0.25)}
            kw = {}
            if overlap:
                prv, nxt = blocks[(s - 1) % n_sh], blocks[(s + 1) % n_sh]
                rows = {}
                for name in ("mu", "u", "v"):
                    rows[name + "_lo"] = prv[name][n:n + S]
                    rows[name + "_hi"] = nxt[name][S:2 * S]
                    b[name][:S] = b[name][-S:] = POISON
                kw["overlap"] = rows
            if fuse_w:
                kw.update(fuse_w=True, w=b["ft"] * 0.5, pp=b["ww_1"] * 0.25,
                          rdn=torch.linspace(0.5, 1.5, K), cw=0.2, gw=0.05,
                          epssm=0.1)
            out = k3.coupled_multistep(
                u=b["u"], v=b["v"], t=b["t"], mu=b["mu"],
                ww_row=b["ww_1"][:, 0, :].clone(), **const, rdx=0.1,
                rdy=0.12, dts=0.25, cs2=0.3, window=(1, nx, 0, ny - 1),
                offsets=(s * n - 1, -1), k0=0, k1=K - 2, kde=K - 1,
                n_inner=S, **kw)
            outs.append({k: v[S:-S] for k, v in out.items()})
        res[overlap] = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    for name in res[False]:
        assert torch.equal(res[True][name], res[False][name]), name
        assert res[True][name].abs().max() < 1e20, f"poison in {name}"


def test_two_step_takes_no_overlap():
    """K4's counterpart refuses it as the TPU pair kernel does (it has no
    such argument): S=2 with overlap goes through coupled_multistep."""
    with pytest.raises(TypeError, match="overlap"):
        k3.coupled_two_step(overlap={})


# ---------------------------------------------------------------------
# SmallStepLoop(halo_backend="rdma_overlap")
# ---------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _overlap_case(ny):
    return fixtures.make_case(24, ny, 8, halo=3, seed=5)


def _port_loop(case, shape, backend, steps, with_w=False, **kw):
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=steps,
                         device="cpu", with_w=with_w, halo_backend=backend,
                         mesh=_cpu_mesh(shape) if shape else None, **kw)
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


def _jax_loop(case, steps, with_w=False, **kw):
    loop = JaxSmallStepLoop(jax_make_mesh_1d(jax.devices()[:4]),
                            *_dims(case), case.flags, n_steps=steps,
                            halo_backend="rdma_overlap", with_w=with_w, **kw)
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("kw", [
    {}, {"smdiv": 0.1}, {"with_w": True},
], ids=["plain", "smdiv", "with_w"])
def test_overlap_loop_matches_jax_overlap_loop(kw):
    """tests/test_overlap.py::test_overlap_loop_backend's loop, on both
    sides under rdma_overlap (rtol 5e-5, atol_scale 2e-6)."""
    case = _overlap_case(24)
    got = _port_loop(case, (4, 1), "rdma_overlap", 4, **kw)
    want = _jax_loop(case, 4, **kw)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **TOL)
    perm = _port_loop(case, (4, 1), "ppermute", 4, **kw)
    for n in perm:
        np.testing.assert_array_equal(got[n], perm[n], err_msg=n)


@pytest.mark.parametrize("inner", [2, 4])
def test_blocked_overlap_loop_matches_jax(inner):
    """The width-S exchange inside K3 (S=2 runs the general kernel too)."""
    case = _overlap_case(32)
    got = _port_loop(case, (4, 1), "rdma_overlap", 9, inner_steps=inner)
    want = _jax_loop(case, 9, inner_steps=inner)
    outputs_allclose(got, want, **TOL)
    perm = _port_loop(case, (4, 1), "ppermute", 9, inner_steps=inner)
    for n in perm:
        np.testing.assert_array_equal(got[n], perm[n], err_msg=n)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("kw", [
    {}, {"smdiv": 0.1}, {"with_w": True}, {"inner_steps": 2},
    {"inner_steps": 3, "with_w": True}, {"kernel": "plain"},
], ids=["plain", "smdiv", "with_w", "S2", "S3+w", "kernel-plain"])
@pytest.mark.parametrize("dom", [(20, 18, 8), (19, 13, 6)],
                         ids=["20x18x8", "19x13x6"])
def test_overlap_equals_ppermute_and_rdma(dom, shape, kw):
    """The three backends move the same rows: bit for bit on every mesh,
    also on a domain that divides over none of them (19x13x6: the mesh
    padding lies inside the last shards' blocks, the halo row after it)
    and against the one-shard loop."""
    case = fixtures.make_case(*dom, halo=2, seed=7)
    if dom[1] // shape[0] < kw.get("inner_steps", 1):
        pytest.skip("fewer rows per shard than the ring is wide")
    steps = 7
    got = _port_loop(case, shape, "rdma_overlap", steps, **kw)
    refs = {"ppermute": _port_loop(case, shape, "ppermute", steps, **kw),
            "1x1": _port_loop(case, None, "ppermute", steps, **kw)}
    if kw.get("inner_steps", 1) == 1 or shape[0] == 1:
        refs["rdma"] = _port_loop(case, shape, "rdma", steps, **kw)
    for label, ref in refs.items():
        assert sorted(got) == sorted(ref)
        for n in ref:
            np.testing.assert_array_equal(got[n], ref[n],
                                          err_msg=f"{n} vs {label}")


@pytest.mark.parametrize("kw", [{}, {"inner_steps": 2}, {"smdiv": 0.1}],
                         ids=["S1", "S2", "smdiv"])
def test_force_exchange_on_a_ring_of_one(small_case, kw):
    """force_exchange on one shard: the neighbour is the shard itself, and
    the in-kernel self-exchange gives what the ppermute one gives."""
    got = _port_loop(small_case, None, "rdma_overlap", 5,
                     force_exchange=True, **kw)
    ref = _port_loop(small_case, None, "ppermute", 5, force_exchange=True,
                     **kw)
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
    dims, flags = _dims(small_case), small_case.flags
    assert SmallStepLoop(*dims, flags, device="cpu", force_exchange=True,
                         halo_backend="rdma_overlap")._overlap
    assert not SmallStepLoop(*dims, flags, device="cpu",
                             halo_backend="rdma_overlap")._overlap
    # without force_exchange and with an unsharded j the backend changes
    # nothing, as in JAX
    one = _port_loop(small_case, (1, 2), "rdma_overlap", 5, **kw)
    two = _port_loop(small_case, (1, 2), "ppermute", 5, **kw)
    for n in one:
        np.testing.assert_array_equal(one[n], two[n], err_msg=n)


def test_overlap_with_the_eager_kernel_raises(small_case):
    with pytest.raises(ValueError, match="rdma_overlap requires the fused"):
        SmallStepLoop(*_dims(small_case), small_case.flags, kernel="eager",
                      device="cpu", halo_backend="rdma_overlap")
    with pytest.raises(ValueError, match="rdma_overlap requires the fused"):
        JaxSmallStepLoop(jax_make_mesh_1d(jax.devices()[:1]),
                         *_dims(small_case), small_case.flags, kernel="xla",
                         halo_backend="rdma_overlap")


def test_loop_leaves_prepared_blocks_alone_under_overlap(small_case):
    case = small_case
    loop = SmallStepLoop(*_dims(case), case.flags, n_steps=6, device="cpu",
                         inner_steps=2, mesh=_cpu_mesh((2, 2)),
                         halo_backend="rdma_overlap")
    arrays = loop.prepare(case_to_domain(case))
    before = {n: {c: b.clone() for c, b in blocks.items()}
              for n, blocks in arrays.items()}
    loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert all(torch.equal(arrays[n][c], before[n][c])
               for n in arrays for c in arrays[n])


# ---------------------------------------------------------------------
# RK3, run_sim and the driver
# ---------------------------------------------------------------------
def _port_rk3(case, backend, shape=(4, 1), **kw):
    rk3 = RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                        inner_steps=2, device="cpu", mesh=_cpu_mesh(shape),
                        halo_backend=backend, **kw)
    out = rk3.step(rk3.prepare(case_to_domain(case)), case.rdx, case.rdy,
                   case.dts * 4, case.epssm)
    return arrays_to_numpy(out)


def test_rk3_blocked_overlap_matches_jax_and_does_not_warn():
    """tests/test_overlap.py::test_rk3_blocked_overlap_plumbing: stage 3's
    depth-2 trapezoid rides the in-kernel width-2 exchange and stage 2 the
    per-substep one, with no downgrade warning."""
    case = _overlap_case(32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # overlap must NOT warn
        got = _port_rk3(case, "rdma_overlap")
        jrk3 = JaxRK3Integrator(jax_make_mesh_1d(jax.devices()[:4]),
                                *_dims(case), case.flags, acoustic_steps=4,
                                inner_steps=2, halo_backend="rdma_overlap")
    want = jrk3.step(jrk3.prepare(case_to_domain(case)), case.rdx, case.rdy,
                     case.dts * 4, case.epssm)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()}, **TOL)
    perm = _port_rk3(case, "ppermute")
    for n in perm:
        np.testing.assert_array_equal(got[n], perm[n], err_msg=n)
    square = _port_rk3(case, "rdma_overlap", shape=(2, 2))
    for n in perm:
        np.testing.assert_array_equal(square[n], perm[n], err_msg=n)


def test_rk3_rdma_blocked_downgrade_still_warns():
    """The one remaining downgrade keeps its text, as in JAX."""
    case = _overlap_case(32)
    text = ("RK3 blocked stage (inner_steps=2, n_sub=4): halo_backend 'rdma' "
            "has no width-S block exchange — this stage uses the width-S "
            "ppermute refresh instead (use 'rdma_overlap' for an in-kernel "
            "blocked exchange)")
    with pytest.warns(UserWarning) as port:
        RK3Integrator(*_dims(case), case.flags, acoustic_steps=4,
                      inner_steps=2, device="cpu", mesh=_cpu_mesh((4, 1)),
                      halo_backend="rdma")
    with pytest.warns(UserWarning) as ref:
        JaxRK3Integrator(jax_make_mesh_1d(jax.devices()[:4]), *_dims(case),
                         case.flags, acoustic_steps=4, inner_steps=2,
                         halo_backend="rdma")
    assert [str(w.message) for w in port] == [text]
    assert [str(w.message) for w in ref] == [text]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2x2"],
    ["--mesh", "4x1", "--inner-steps", "2"],
    ["--mesh", "2x2", "--with-w"],
], ids=["2x2", "4x1-S2", "2x2-w"])
def test_run_sim_overlap_equals_ppermute(tmp_path, small_case, capsys, flags):
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    state = {}
    for backend in ("rdma_overlap", "ppermute"):
        assert run_sim.main([fx, "--device", "cpu", "--steps", "2", *flags,
                             "--halo-backend", backend, "--checkpoint-dir",
                             str(tmp_path / backend)]) == 0
        state[backend] = checkpoint.load_checkpoint(
            tmp_path / backend / "step_000002")[0]
    assert "halo backend rdma_overlap" in capsys.readouterr().out
    for n in state["ppermute"]:
        np.testing.assert_array_equal(state["rdma_overlap"][n],
                                      state["ppermute"][n], err_msg=n)


def test_run_sim_namelist_smdiv_under_overlap(tmp_path, small_case):
    """The damped main path: mudf's rows ride the in-kernel exchange."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=1))
    nml = tmp_path / "nml.json"
    nml.write_text('{"dx": 12000, "dy": 12000, "time_step": 8, '
                   '"time_step_sound": 4, "epssm": 0.1, "smdiv": 0.1, '
                   '"specified": true}')
    state = {}
    for backend in ("rdma_overlap", "rdma"):
        assert run_sim.main([fx, "--device", "cpu", "--namelist", str(nml),
                             "--mesh", "2x2", "--halo-backend", backend,
                             "--checkpoint-dir",
                             str(tmp_path / backend)]) == 0
        state[backend] = checkpoint.load_checkpoint(
            tmp_path / backend / "step_000001")[0]
    for n in state["rdma"]:
        np.testing.assert_array_equal(state["rdma_overlap"][n],
                                      state["rdma"][n], err_msg=n)


@pytest.mark.parametrize("args", [
    ("--tier", "coupled", "--mesh", "2x2"),
    ("--tier", "coupled", "--mesh", "4x1", "--inner-steps", "2"),
    ("--tier", "coupled", "--mesh", "2x2", "--with-w"),
    ("--tier", "coupled"),
], ids=["2x2", "4x1-S2", "2x2-w", "1x1"])
def test_driver_coupled_tier_under_overlap(tmp_path, small_case, capsys, args):
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=5))
    rc = driver.main([fx, *args, "--halo-backend", "rdma_overlap",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAILED" not in out


def test_driver_all_rows_under_overlap(tmp_path, small_case, capsys):
    """--tier all --halo-backend rdma_overlap: the 18 rows of the JAX
    driver's matrix, all PASS (the eager rows, which have no kernel to
    hold the exchange, run on ppermute)."""
    fx = str(fixtures.write_case(small_case, tmp_path / "fx", steps=3))
    rc = driver.main([fx, "--tier", "all", "--mesh", "2x2",
                      "--halo-backend", "rdma_overlap", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("PASS") == 18 == len(driver.ALL_ROWS)
    with pytest.raises(SystemExit):
        driver.main([fx, "--tier", "cuda", "--halo-backend", "rdma_overlap",
                     "--device", "cpu"])
    assert ("--halo-backend applies to the coupled tiers"
            in capsys.readouterr().err)
