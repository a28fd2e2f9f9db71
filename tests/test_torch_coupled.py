"""The coupled trapezoid in the port (K3, K4 and the blocked SmallStepLoop),
against the JAX package on the CPU.

* The ring-S glue against ``wrf_tpu.parallel.halo.widen_ring_to`` and
  ``coupled_lean_kwargs`` against the JAX one, exact.
* K3's plain PyTorch version (what ``coupled_multistep`` runs on CPU
  tensors) against ``coupled_multistep_pallas`` in interpret mode, and
  ``coupled_two_step`` against ``coupled_two_step_pallas``, on the same
  numpy inputs, at rtol 2e-5, atol_scale 1e-6 (the TPU kernel sums dmdt
  in the compiler's order, the port in k order); in exact mode also bit
  for bit against S sequential K1 plain substeps.
* The port's ``SmallStepLoop(inner_steps=S)`` against the JAX loop on a
  1x1 mesh (rtol 5e-5, atol_scale 2e-6, the loop tolerance of
  tests/test_torch_msteps.py), against its own S=1 loop (2e-5/1e-6) and
  against the numpy golden loop (2e-5/2e-6, tests/test_msteps.py's).
* ``RK3Integrator(inner_steps=2)`` against the JAX integrator.

One small case, 28x20x12 (tests/test_msteps.py's quick case), with the
JAX runs memoised: interpret-mode Pallas builds dominate the cost.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.models.rk3 import RK3Integrator as JaxRK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop as JaxSmallStepLoop
from wrf_tpu.models.small_step import small_step_golden
from wrf_tpu.ops import advance_mu_t_msteps as jax_msteps
from wrf_tpu.parallel import halo as jax_halo
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu_torch.convert import arrays_to_numpy
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import DEFAULT_CS2, SmallStepLoop
from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.parallel import halo
from wrf_tpu_torch.parallel import sharded as port_sharded

torch.set_num_threads(1)

NX, NY, NZ = 28, 20, 12
STEPS = 5
KERNEL_TOL = dict(rtol=2e-5, atol_scale=1e-6)
LOOP_TOL = dict(rtol=5e-5, atol_scale=2e-6)
GOLDEN_TOL = dict(rtol=2e-5, atol_scale=2e-6)
#: loop configurations: (inner_steps, fast)
BLOCKED = [(2, False), (4, False), (4, True)]


@functools.lru_cache(maxsize=None)
def _case():
    return fixtures.make_case(NX, NY, NZ, halo=3, seed=7)


@functools.lru_cache(maxsize=None)
def _k3_inputs(S):
    """One K3 launch's inputs as the blocked loop builds them (numpy): the
    ring-1 padded fields widened to ring S, the lean and coupled constants
    computed on the widened fields, and a scan-seed row; plus the ring-1
    fields for S sequential K1 substeps."""
    case = _case()
    b = case.bounds
    dom = port_sharded.case_to_domain(case)
    padded = {n: port_sharded.pad_halo(torch.tensor(dom[n]))
              for n in port_sharded.FIELDS_3D + port_sharded.FIELDS_2D}
    padded.update({n: torch.tensor(dom[n]) for n in port_sharded.FIELDS_1D})
    i0, i1, j0, j1, k0, k1_ = port_sharded.domain_window(
        b.ide, b.jde, b.kdim, case.flags)
    padded["ww_row"] = (padded["ww"][:, k0, :]
                        + 0.01 * padded["ww_1"][:, k0 + 1, :])
    n = padded["t"].shape[0] - 2
    wide = {k: halo.widen_ring_to(v, 0, S) if v.ndim > 1 else v
            for k, v in padded.items()}
    arr = {k: wide[k] for k in ("u", "v", "t", "t_1", "mu", "mu_tend",
                                "msftx", "msfty", "ww_row", "dnw", "fnm",
                                "fnp", "rdnw")}
    arr.update(k1.lean_kwargs(wide, case.rdx, case.rdy, case.dts, k0, k1_))
    arr.update(k3.coupled_lean_kwargs(wide, case.rdx, case.rdy, case.dts))
    static = dict(window=(i0, i1, j0, j1), offsets=(-1, -1), k0=k0, k1=k1_,
                  kde=b.kdim - 1, rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                  cs2=DEFAULT_CS2)
    return ({k: v.numpy() for k, v in arr.items()}, static,
            {k: v.numpy() for k, v in padded.items()}, n)


def _port_k3(arr, static, fn=k3.coupled_multistep, **mode):
    out = fn(**{k: torch.tensor(v) for k, v in arr.items()}, **static,
             **mode)
    return arrays_to_numpy(out)


@functools.lru_cache(maxsize=None)
def _jax_k3(S, fast=False, pair=False):
    arr, static, _, n = _k3_inputs(S)
    if pair:
        out = jax_msteps.coupled_two_step_pallas(
            **arr, **static, fast=fast, tj=n, interpret=True)
    else:
        out = jax_msteps.coupled_multistep_pallas(
            **arr, **static, n_inner=S, fast=fast, tj=n, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("S", [2, 4])
def test_widen_ring_matches_jax(S):
    """The unsharded ring-S layout of the JAX glue on the 2-D and 3-D
    ring-1 blocks, exact, and the strip back."""
    _, _, padded, n = _k3_inputs(S)
    for name in ("t", "mu"):
        x = padded[name]
        got = halo.widen_ring_to(torch.tensor(x), 0, S)
        want = jax_halo.widen_ring_to(x, 0, None, n, S)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = halo.strip_ring(got, 0, S)
        assert back.is_contiguous()
        np.testing.assert_array_equal(back.numpy(), x)
    x = torch.tensor(padded["t"])
    assert halo.widen_ring_to(x, 0, 1) is x
    assert halo.strip_ring(x, 0, 1) is x


def test_coupled_lean_kwargs_matches_jax():
    _, static, padded, _ = _k3_inputs(2)
    names = ("muu", "muv", "msfuy", "msfvx_inv", "msftx", "msfty")
    padded = {k: padded[k] for k in names}
    got = k3.coupled_lean_kwargs({k: torch.tensor(v) for k, v in
                                  padded.items()}, static["rdx"],
                                 static["rdy"], static["dts"])
    want = jax_msteps.coupled_lean_kwargs(padded, static["rdx"],
                                          static["rdy"], static["dts"])
    assert sorted(got) == sorted(want) == ["cu", "cv", "msft2"]
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("S,fast", [(2, False), (3, False), (4, False),
                                    (4, True)])
def test_plain_matches_pallas(S, fast):
    arr, static, _, _ = _k3_inputs(S)
    got = _port_k3(arr, static, n_inner=S, fast=fast)
    want = _jax_k3(S, fast)
    assert sorted(got) == sorted(want) == ["mu", "t", "u", "v", "ww_row"]
    outputs_allclose(got, want, **KERNEL_TOL)


def test_two_step_matches_pallas_pair():
    arr, static, _, _ = _k3_inputs(2)
    got = _port_k3(arr, static, fn=k3.coupled_two_step)
    assert sorted(got) == ["mu", "t", "u", "v", "ww_row"]
    outputs_allclose(got, _jax_k3(2, pair=True), **KERNEL_TOL)
    outputs_allclose(got, _jax_k3(2), **KERNEL_TOL)
    for name, val in _port_k3(arr, static, n_inner=2).items():
        np.testing.assert_array_equal(got[name], val, err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
def test_plain_exact_equals_sequential_k1(S):
    """Exact mode is S of K1's fused scan substeps (fuse_uv, lean, lite) on
    the ring-1 layout, bit for bit on the rows both compute."""
    arr, static, padded, n = _k3_inputs(S)
    got = _port_k3(arr, static, n_inner=S)
    p = {k: torch.tensor(v) for k, v in padded.items()}
    lean = k1.lean_kwargs(p, static["rdx"], static["rdy"], static["dts"],
                          static["k0"], static["k1"])
    carry = ("ww_row", "mu", "t", "u", "v")
    state = {k: p.pop(k) for k in carry}
    for _ in range(S):
        out = k1.advance_mu_t_fused_plain(
            **p, **state, **lean, **static, epssm=0.0, fuse_uv=True,
            with_tave=False, ww_mode="lite", lean=True)
        state = {k: out[k] for k in carry}
    for name, val in arrays_to_numpy(state).items():
        strip = halo.strip_ring(torch.tensor(got[name]), 0, S).numpy()
        np.testing.assert_array_equal(strip[1:-1], val[1:-1], err_msg=name)


def test_fast_differs_from_exact_within_tolerance():
    arr, static, _, _ = _k3_inputs(4)
    exact = _port_k3(arr, static, n_inner=4)
    fast = _port_k3(arr, static, n_inner=4, fast=True)
    outputs_allclose(fast, exact, **KERNEL_TOL)
    # the cumsum re-associates: bit-identity on every field would mean it
    # never ran
    assert any(not np.array_equal(fast[k], exact[k]) for k in exact)


def test_wrapper_contract():
    """t and ww_row are updated in place and returned; u, v and mu come
    back fresh with the ring rows passed through; the numpy inputs are
    never written through; bad arguments raise."""
    S = 2
    arr, static, _, _ = _k3_inputs(S)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    before = {k: v.clone() for k, v in tarr.items()}
    out = k3.coupled_multistep(**tarr, **static, n_inner=S)
    for name in ("t", "ww_row"):
        assert out[name] is tarr[name]
        assert not torch.equal(out[name], before[name])
    for name in ("u", "v", "mu"):
        assert out[name] is not tarr[name]
        assert torch.equal(tarr[name], before[name])
        assert torch.equal(out[name][:S], tarr[name][:S])
        assert torch.equal(out[name][-S:], tarr[name][-S:])
        assert not torch.equal(out[name], tarr[name])
    # (cu and dvdxi_const are NaN in the zero ring rows, 0/0; the window
    # masks keep them out of every result)
    assert all(np.array_equal(arr[k], before[k].numpy(), equal_nan=True)
               for k in arr)
    with pytest.raises(ValueError, match="n_inner"):
        k3.coupled_multistep(**tarr, **static, n_inner=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k3.coupled_multistep(**tarr, **static, n_inner=S, ti=128)
    with pytest.raises(NotImplementedError,
                       match="own \\(j, i\\) tiles, which plan\\(\\) picks"):
        k3.coupled_multistep(**tarr, **static, n_inner=S, ti=128)
    # overlap and bf16 constant streams were refused until they were
    # ported; now they run.  On a ring of one the neighbours' slabs are the
    # block's own last and first S interior rows: bit-equal to the call on
    # ring rows refreshed with them, the memory ring rows poisoned.
    ref = {k: torch.tensor(v) for k, v in arr.items()}
    ov = {k: torch.tensor(v) for k, v in arr.items()}
    rows = {}
    for n in ("mu", "u", "v"):
        rows[n + "_lo"] = ov[n][-2 * S:-S].clone()
        rows[n + "_hi"] = ov[n][S:2 * S].clone()
        ref[n][:S], ref[n][-S:] = rows[n + "_lo"], rows[n + "_hi"]
        ov[n][:S] = ov[n][-S:] = 1e30
    want = k3.coupled_multistep(**ref, **static, n_inner=S)
    got = k3.coupled_multistep(**ov, **static, n_inner=S, overlap=rows)
    for n in want:
        assert torch.equal(got[n][S:-S], want[n][S:-S]), n
        assert got[n][S:-S].abs().max() < 1e20, f"poison leaked into {n}"
    with pytest.raises(ValueError, match="missing \\['v_hi'\\]"):
        k3.coupled_multistep(**ov, **static, n_inner=S,
                             overlap={k: v for k, v in rows.items()
                                      if k != "v_hi"})
    ref = {k: torch.tensor(v) for k, v in arr.items()}
    ref["t_1"] = ref["t_1"].to(torch.bfloat16).float()
    want = k3.coupled_multistep(**ref, **static, n_inner=S)
    tarr = {k: torch.tensor(v) for k, v in arr.items()}
    tarr["t_1"] = tarr["t_1"].to(torch.bfloat16)
    got = k3.coupled_multistep(**tarr, **static, n_inner=S)
    assert all(torch.equal(got[n], want[n]) for n in want)
    tarr["u"] = tarr["u"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 'u' is not a constant stream"):
        k3.coupled_multistep(**tarr, **static, n_inner=S)


def _dims():
    return NX, NY, NZ


@functools.lru_cache(maxsize=None)
def _port_loop(inner_steps=1, fast=False, kernel="plain"):
    case = _case()
    loop = SmallStepLoop(*_dims(), case.flags, n_steps=STEPS, kernel=kernel,
                         inner_steps=inner_steps, fast=fast, device="cpu")
    out = loop(loop.prepare(port_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return arrays_to_numpy(out)


@functools.lru_cache(maxsize=None)
def _jax_loop(inner_steps, fast):
    case = _case()
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    loop = JaxSmallStepLoop(mesh, *_dims(), case.flags, n_steps=STEPS,
                            kernel="pallas", inner_steps=inner_steps,
                            fast=fast)
    out = loop(loop.prepare(port_sharded.case_to_domain(case)), case.rdx,
               case.rdy, case.dts, case.epssm)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("S,fast", BLOCKED)
def test_loop_matches_jax_loop(S, fast):
    got = _port_loop(S, fast)
    want = _jax_loop(S, fast)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, want, **LOOP_TOL)


@pytest.mark.parametrize("S,fast", BLOCKED)
def test_loop_matches_single_step_loop(S, fast):
    ref = _port_loop()
    blk = _port_loop(S, fast)
    assert sorted(ref) == sorted(blk)
    outputs_allclose(blk, ref, **KERNEL_TOL)
    if not fast:   # "cuda" on CPU tensors runs the same plain versions
        got = _port_loop(S, fast, kernel="cuda")
        for name in blk:
            np.testing.assert_array_equal(got[name], blk[name], err_msg=name)


@pytest.mark.parametrize("S,fast", BLOCKED)
def test_loop_matches_golden(S, fast):
    case = _case()
    got = port_sharded.embed_outputs(case, _port_loop(S, fast))
    gold = small_step_golden(case, STEPS)
    outputs_allclose(got, {k: gold[k] for k in got}, **GOLDEN_TOL)


def test_rk3_blocked_matches_jax():
    """Stages of 1, 4 and 8 substeps at S=2: K3 runs in the last two."""
    case = fixtures.make_case(20, 18, 8, halo=2, seed=7)
    b = case.bounds
    dims = (b.ide, b.jde, b.kdim)
    dt = case.dts * 8
    dom = port_sharded.case_to_domain(case)
    rk3 = RK3Integrator(*dims, case.flags, acoustic_steps=8, kernel="plain",
                        inner_steps=2, device="cpu")
    got = arrays_to_numpy(rk3.step(rk3.prepare(dom), case.rdx, case.rdy, dt,
                                   case.epssm))
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    jrk3 = JaxRK3Integrator(mesh, *dims, case.flags, acoustic_steps=8,
                            kernel="pallas", inner_steps=2)
    want = jrk3.step(jrk3.prepare(dom), case.rdx, case.rdy, dt, case.epssm)
    assert sorted(got) == sorted(want)
    outputs_allclose(got, {k: np.asarray(v) for k, v in want.items()},
                     **LOOP_TOL)


@pytest.mark.parametrize("bad,err", [
    (dict(inner_steps=0), ValueError),
    (dict(fast=True), ValueError),
    (dict(inner_steps=2, smdiv=0.1), ValueError),
    (dict(kernel="pallas"), ValueError),
])
def test_loop_argument_checks(bad, err):
    with pytest.raises(err):
        SmallStepLoop(*_dims(), _case().flags, n_steps=5, device="cpu",
                      **bad)


# --------------------------------------------------------------------------
# The launch plan (which form of the CUDA kernel, on which tile): plain
# Python, so the CPU holds it to the kernel's shared-memory budget and its
# geometry.
# --------------------------------------------------------------------------
PLAN_DEPTHS = range(2, k3.MAX_INNER + 1)
PLAN_K = (32, 50, 100)
PLAN_CONST_BYTES = (4, 2)   # float32 and bf16 constant streams


def _plans(S, K, cb, fw=False):
    """The plan at one shape and ``fuse_w``, whatever ``overlap`` and the
    block's size: all the same."""
    got = {k3.plan(S, K, fw, cb, ov, J2, I) for ov in (False, True)
           for J2, I in ((516, 516), (68, 78), (261, 261))}
    assert len(got) == 1
    return got.pop()


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("cb", PLAN_CONST_BYTES)
@pytest.mark.parametrize("K", PLAN_K)
@pytest.mark.parametrize("S", PLAN_DEPTHS)
def test_plan_fits_shared_memory(S, K, cb, fw):
    p = _plans(S, K, cb, fw)
    assert p.form in k3.FORMS
    assert 0 < p.smem <= k3.SMEM_LIMIT == 232448
    if p.form == "staged":
        assert not fw   # the w solve streams
        assert p.smem == k3.staged_layout(S, K, *p.tile, cb)[1]
        assert p.tile[0] * p.tile[1] >= k3.MIN_OWN


@pytest.mark.parametrize("fw", [False, True])
@pytest.mark.parametrize("cb", PLAN_CONST_BYTES)
@pytest.mark.parametrize("K", PLAN_K)
@pytest.mark.parametrize("S", PLAN_DEPTHS)
def test_plan_streams_exactly_where_nothing_staged_fits(S, K, cb, fw):
    fits = [(tj, ti) for ti in k3.STAGED_TI for tj in k3.STAGED_TJ
            if tj * ti >= k3.MIN_OWN and not fw
            and k3.staged_layout(S, K, tj, ti, cb)[1] <= k3.SMEM_LIMIT]
    p = _plans(S, K, cb, fw)
    assert (p.form == "streaming") == (not fits)
    if not fits:
        assert p.tile == k3.STREAMING_TILE


#: the plan's tiles at K=50 (512x512x50), as PERF.md states them: float32
#: and bf16 constant streams, S=2..5 staged, S=6..8 streamed
K50_TILES = {
    4: {2: (6, 16), 3: (9, 8), 4: (7, 8), 5: (5, 8)},
    2: {2: (5, 24), 3: (5, 16), 4: (8, 8), 5: (6, 8)},
}


@pytest.mark.parametrize("cb", PLAN_CONST_BYTES)
@pytest.mark.parametrize("S", PLAN_DEPTHS)
def test_plan_tiles_at_k50(S, cb):
    p = _plans(S, 50, cb)
    if S in K50_TILES[cb]:
        assert (p.form, p.tile) == ("staged", K50_TILES[cb][S])
    else:
        assert (p.form, p.tile) == ("streaming", k3.STREAMING_TILE)


def test_plan_at_the_main_paths_depths():
    """At K=50 (512x512x50) the S=2 and S=4 launches of run_sim and the
    driver stage their operands, float32 or bf16; S=8 streams, and so does
    every launch with the w solve."""
    for cb in PLAN_CONST_BYTES:
        for S in (2, 4):
            assert k3.plan(S, 50, False, cb, False, 516, 516).form == "staged"
            assert k3.plan(S, 50, True, cb, False, 516, 516).form == \
                "streaming"
    assert k3.plan(8, 50, False, 4, False, 516, 516).form == "streaming"


@pytest.mark.parametrize("S", PLAN_DEPTHS)
@pytest.mark.parametrize("J2,I", [(516, 516), (68, 78), (53, 37), (20, 9)])
def test_tiles_cover_own_columns_once(S, J2, I):
    for cb in PLAN_CONST_BYTES:
        p = _plans(S, 50, cb)
        seen = np.zeros((J2, I), np.int32)
        for rows, cols in k3.tiles(S, J2, I, p.tile):
            assert 0 < len(rows) <= p.tile[0] and 0 < len(cols) <= p.tile[1]
            seen[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (seen[S:J2 - S] == 1).all()
        assert (seen[:S] == 0).all() and (seen[J2 - S:] == 0).all()


@pytest.mark.parametrize("cb", PLAN_CONST_BYTES)
@pytest.mark.parametrize("S", PLAN_DEPTHS)
def test_staged_boxes_aligned_to_16_bytes(S, cb):
    for K in PLAN_K:
        for ti in k3.STAGED_TI:
            assert ti % 8 == 0   # a tile's first column: 16 bytes of bf16
            boxes, _ = k3.staged_layout(S, K, 3, ti, cb)
            for name, b in boxes.items():
                assert b.off % 16 == 0, name
                assert (b.width * b.esize) % 16 == 0, name
                assert (b.lo * b.esize) % 16 == 0, name
                assert b.esize == (cb if name in k3.CONST_STREAMS else 4)


@pytest.mark.parametrize("S", PLAN_DEPTHS)
def test_staged_boxes_hold_every_cell_the_substeps_read(S):
    """Pass 1 at substep s runs on the tile's columns and S-1-s cells
    around them, reading u one column east and v one row north; pass 2
    reads t_1 one cell around the own columns, tconst and t on them."""
    tj, ti = 5, 16
    boxes, _ = k3.staged_layout(S, 50, tj, ti, 4)
    reads = {"u": (S - 1, S - 1, S - 1, S), "v": (S - 1, S, S - 1, S - 1),
             "dvdxi_const": (S - 1,) * 4, "t_1": (1, 1, 1, 1),
             "tconst": (0, 0, 0, 0), "t": (0, 0, 0, 0)}
    assert sorted(boxes) == sorted(reads)
    for name, (up, down, west, east) in reads.items():
        b = boxes[name]
        assert b.top >= up and b.rows - tj - b.top >= down, name
        assert b.lo >= west and b.width - ti - b.lo >= east, name


def test_staged_bytes_of_a_launch():
    S, J2, K, I = 2, 516, 50, 516
    p = k3.plan(S, K, False, 4, False, J2, I)
    n = k3.staged_bytes(p, S, J2, K, I, 4)
    n_tiles = len(list(k3.tiles(S, J2, I, p.tile)))
    # at least every operand once (u, v, dvdxi_const, t_1, tconst, t and
    # mu on the own columns), at most the full boxes of every tile
    assert 6 * (J2 - 2 * S) * K * I * 4 < n <= n_tiles * p.smem
    stream = k3.plan(8, K, False, 4, False, J2, I)
    assert k3.staged_bytes(stream, 8, J2, K, I, 4) == 0
