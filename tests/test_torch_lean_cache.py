"""The stage loops' lean constants (``models/stage_memo.py::StageMemo.lean``):
an RK3 integrator stepped three times equals, bit for bit, one whose memo
keeps nothing, on every fused path, with the kernels' in-place writes seen
only through their wrappers' marks, as on the card; each way an input or
a cached block can change is a miss whose result equals a fresh
``lean_kwargs``; a ``keep=False`` memo keeps nothing; the memo keeps one
entry a part and no old state; and
:data:`~wrf_tpu_torch.models.stage_memo.LEAN` and the ``wrf.loop.inputs``
count read what a warm step built."""

import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# K1, K2 and K3 write unseen but for their wrappers' marks (autouse)
from tests.test_torch_pad_memo import _unseen, unseen_writes  # noqa: F401
from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.models.stage_memo import LEAN, StageMemo
from wrf_tpu_torch.models.tendencies import NudgingTendencies
from wrf_tpu_torch.ops.advance_mu_t_cuda import lean_kwargs
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh
from wrf_tpu_torch.parallel.sharded import (
    case_to_domain, domain_window, pad_local, prepare_arrays,
)
from wrf_tpu_torch.utils import timing

torch.set_num_threads(1)

#: the fused paths whose stages have scan substeps: the fused path with w
#: and damping, without both, bf16 constants, a 2x2 mesh and the in-kernel
#: exchange on 2x2
PATHS = {
    "fused": dict(),
    "bare": dict(with_w=False, smdiv=0.0),
    "bf16": dict(const_dtype=torch.bfloat16),
    "mesh2x2": dict(shape=(2, 2)),
    "rdma_overlap2x2": dict(shape=(2, 2), halo_backend="rdma_overlap"),
}

PARTS = ("dvdxi_const", "ww1_k0", "vert", "tconst")
KWARGS = ("tconst", "dvdxi_const", "ww1_k0")


@pytest.fixture(scope="module")
def case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)


def _integrator(case, shape=None, keep=True, acoustic_steps=6,
                snapshot="base", **kw):
    """A closed-step integrator on the CPU whose K5 writes unseen too;
    ``keep=False``: a cold one, whose memo keeps no pad and no lean
    constant."""
    b = case.bounds
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape) if shape else None
    kw = dict(dict(kernel="cuda", with_w=True, smdiv=0.1), **kw)
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags,
                        acoustic_steps=acoustic_steps, snapshot=snapshot,
                        device="cpu", mesh=mesh, **kw)
    rk3.loops[0].memo.keep = keep
    for loop in rk3.loops:
        loop._rdma = _unseen(loop._rdma)
    return rk3


def _lean(counter):
    """``LEAN`` since ``counter`` (a copy taken before), as
    ``{(what, part): blocks}`` without zeros."""
    return {k: n - counter.get(k, 0) for k, n in LEAN.items()
            if n != counter.get(k, 0)}


def _closed_steps(case, rk3, steps, per_stage=False, acoustic_steps=6):
    """``steps`` closed steps (step, merge, wind damping).  Returns every
    step's outputs, the evolved state at the end, ring-shaped, and each
    step's ``LEAN`` delta."""
    arrays = rk3.prepare(case_to_domain(case, with_w=rk3.loops[0].with_w))
    dt = case.dts * acoustic_steps
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1,
                           per_stage=per_stage)
    outs, counts = [], []
    for _ in range(steps):
        before = dict(LEAN)
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        counts.append(_lean(before))
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        outs.append({k: v.clone() for k, v in out.items()})
    state = rk3.unprepare(arrays, [n for n in rk3._EVOLVED if n in arrays])
    return outs, state, counts


def _assert_bit_equal(got, want):
    (g_outs, g_state), (w_outs, w_state) = got, want
    for step, (g, w) in enumerate(zip(g_outs, w_outs)):
        assert g.keys() == w.keys()
        for n in g:
            assert torch.isfinite(w[n]).all(), (step, n)
            assert torch.equal(g[n], w[n]), (step, n)
    for n in w_state:
        assert torch.equal(g_state[n], w_state[n]), n


def _cached_against_fresh(case, steps=3, **kw):
    """``steps`` closed steps of one integrator with the memo, and of a
    cold one that keeps nothing; returns the first's ``LEAN`` deltas and
    its memo."""
    per_stage = kw.pop("per_stage", False)
    one, cold = _integrator(case, **kw), _integrator(case, keep=False, **kw)
    run = dict(per_stage=per_stage,
               acoustic_steps=kw.get("acoustic_steps", 6))
    g_outs, g_state, counts = _closed_steps(case, one, steps, **run)
    w_outs, w_state, fresh = _closed_steps(case, cold, steps, **run)
    _assert_bit_equal((g_outs, g_state), (w_outs, w_state))
    assert all(("reused", p) not in c for c in fresh for p in PARTS)
    return counts, one.loops[0].memo


def _built(shards, **parts):
    return {("built", p): n * shards for p, n in parts.items()}


def _reused(shards, **parts):
    return {("reused", p): n * shards for p, n in parts.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_bit_equal_to_fresh_constants(case, path):
    """With ``acoustic_steps`` 6 stage 1 has no scan substep and stages 2
    and 3 share dts: step 1 builds every part once, a later step only
    ``tconst`` (the closure's ft is new every step)."""
    kw = dict(PATHS[path])
    shards = 4 if "shape" in kw else 1
    counts, memo = _cached_against_fresh(case, **kw)
    assert sorted(memo.held("lean")) == sorted(PARTS)
    first = {**_built(shards, dvdxi_const=1, ww1_k0=1, vert=1, tconst=1),
             **_reused(shards, dvdxi_const=1, ww1_k0=1, vert=1, tconst=1)}
    warm = {**_built(shards, tconst=1),
            **_reused(shards, dvdxi_const=2, ww1_k0=2, vert=2, tconst=1)}
    assert counts == [first, warm, warm]


# ----------------------------------------------------------------------
# misses, on the padded blocks of a loop
# ----------------------------------------------------------------------
@pytest.fixture(params=[(1, 1), (2, 2)], ids=["1x1", "2x2"])
def padded(request, case):
    """Every shard's padded fields, and the scalars of a lean call."""
    shape = request.param
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    arrays = prepare_arrays(case_to_domain(case), mesh)
    local = pad_local(arrays, mesh, shape[0] > 1, shape[1] > 1)
    b = case.bounds
    k0, k1 = domain_window(b.ide, b.jde, b.kdim, case.flags)[4:]
    return local, (case.rdx, case.rdy, case.dts, k0, k1)


def _same_as_a_fresh_build(got, local, scalars):
    """Bit for bit, NaN included (dvdxi_const is 0/0 in the zero halo of
    an unsharded edge, where no launch reads it)."""
    for c, p in local.items():
        want = lean_kwargs(p, *scalars)
        assert got[c].keys() == want.keys()
        for n in want:
            assert torch.equal(got[c][n].view(torch.int32),
                               want[n].view(torch.int32)), (c, n)


def _nbytes(got, names):
    return sum(kw[n].nbytes for kw in got.values() for n in names)


def test_a_second_call_builds_nothing(padded):
    local, scalars = padded
    memo = StageMemo()
    before = dict(LEAN)
    first, built = memo.lean(local, *scalars)
    again, nothing = memo.lean(local, *scalars)
    # the 3-D blocks: dvdxi_const, tconst and tconst's vert term
    assert built == 3 * _nbytes(first, ("tconst",))
    assert nothing == 0 and len(memo) == len(PARTS)
    n = len(local)
    assert _lean(before) == {**_built(n, dvdxi_const=1, ww1_k0=1, vert=1,
                                      tconst=1),
                             **_reused(n, dvdxi_const=1, ww1_k0=1, vert=1,
                                       tconst=1)}
    for c in first:
        assert again[c] is not first[c]             # new dicts every call
        for k in KWARGS:
            assert again[c][k] is first[c][k], k
    _same_as_a_fresh_build(again, local, scalars)


def test_a_new_tensor_under_the_same_name_is_a_miss(padded):
    local, scalars = padded
    memo = StageMemo()
    first, _ = memo.lean(local, *scalars)
    old = weakref.ref(next(iter(first.values()))["dvdxi_const"])
    local = {c: dict(p, u_1=p["u_1"] * 2.0) for c, p in local.items()}
    before = dict(LEAN)
    got, built = memo.lean(local, *scalars)
    n = len(local)
    assert _lean(before) == {**_built(n, dvdxi_const=1),
                             **_reused(n, ww1_k0=1, vert=1, tconst=1)}
    assert built == _nbytes(got, ("dvdxi_const",))
    assert all(got[c]["tconst"] is first[c]["tconst"] for c in got)
    _same_as_a_fresh_build(got, local, scalars)
    del first
    gc.collect()
    assert old() is None                    # the old entry was let go


def test_an_in_place_write_to_a_source_is_a_miss(padded):
    local, scalars = padded
    memo = StageMemo()
    first, _ = memo.lean(local, *scalars)
    next(iter(local.values()))["ww_1"].add_(1.0)    # one shard's block
    before = dict(LEAN)
    got, built = memo.lean(local, *scalars)
    n = len(local)
    assert _lean(before) == {**_built(n, ww1_k0=1, vert=1, tconst=1),
                             **_reused(n, dvdxi_const=1)}
    assert built == 2 * _nbytes(got, ("tconst",))
    assert all(got[c]["dvdxi_const"] is first[c]["dvdxi_const"]
               for c in got)
    _same_as_a_fresh_build(got, local, scalars)


@pytest.mark.parametrize("part", KWARGS)
def test_an_in_place_write_to_a_cached_block_is_a_miss(padded, part):
    local, scalars = padded
    memo = StageMemo()
    first, _ = memo.lean(local, *scalars)
    next(iter(first.values()))[part].zero_()
    before = dict(LEAN)
    got, _ = memo.lean(local, *scalars)
    assert _lean(before)["built", part] == len(local)
    assert ("built", "vert") not in _lean(before)
    _same_as_a_fresh_build(got, local, scalars)


def test_a_different_dts_rebuilds_only_what_reads_it(padded):
    local, (rdx, rdy, dts, k0, k1) = padded
    memo = StageMemo()
    memo.lean(local, rdx, rdy, dts, k0, k1)
    before = dict(LEAN)
    got, _ = memo.lean(local, rdx, rdy, dts * 0.8, k0, k1)
    n = len(local)
    assert _lean(before) == {**_built(n, vert=1, tconst=1),
                             **_reused(n, dvdxi_const=1, ww1_k0=1)}
    _same_as_a_fresh_build(got, local, (rdx, rdy, dts * 0.8, k0, k1))


# ----------------------------------------------------------------------
# misses, where the RK3 shell changes what the stages read
# ----------------------------------------------------------------------
def test_odd_acoustic_steps_rebuild_the_dts_parts(case):
    """At ``acoustic_steps`` 5 stage 2's dts is dt/4 and stage 3's dt/5:
    ``vert`` and ``tconst`` miss in both, the rest hits."""
    counts, _ = _cached_against_fresh(case, acoustic_steps=5)
    warm = {**_built(1, vert=2, tconst=2),
            **_reused(1, dvdxi_const=2, ww1_k0=2)}
    assert counts[1:] == [warm, warm]
    assert counts[0] == {**_built(1, dvdxi_const=1, ww1_k0=1, vert=2,
                                  tconst=2),
                         **_reused(1, dvdxi_const=1, ww1_k0=1)}


def test_stage_snapshots_hit_within_a_step_and_miss_across(case):
    """``snapshot="stage"``: every stage's *_1 are the step's start state,
    so stage 3 reuses stage 2's constants and the next step misses."""
    counts, _ = _cached_against_fresh(case, snapshot="stage")
    every = {**_built(1, dvdxi_const=1, ww1_k0=1, vert=1, tconst=1),
             **_reused(1, dvdxi_const=1, ww1_k0=1, vert=1, tconst=1)}
    assert counts == [every] * 3


def test_a_per_stage_closure_rebuilds_tconst_alone(case):
    """Tendencies taken every stage: ft is new in stage 3 too."""
    counts, _ = _cached_against_fresh(case, per_stage=True)
    warm = {**_built(1, tconst=2),
            **_reused(1, dvdxi_const=2, ww1_k0=2, vert=2)}
    assert counts[1:] == [warm, warm]


# ----------------------------------------------------------------------
# what the memo holds, and the counters
# ----------------------------------------------------------------------
def test_keep_false_keeps_nothing(padded):
    local, scalars = padded
    memo = StageMemo(keep=False)
    for _ in range(2):
        got, built = memo.lean(local, *scalars)
        assert built == 3 * _nbytes(got, ("tconst",)) and len(memo) == 0
    _same_as_a_fresh_build(got, local, scalars)


def test_a_pad_memo_that_keeps_nothing_turns_the_cache_off(case):
    rk3 = _integrator(case, keep=False)
    _closed_steps(case, rk3, 2)
    assert len(rk3.loops[0].memo) == 0
    b = case.bounds
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=2,
                         device="cpu", force_exchange=True)
    arrays = loop.prepare(case_to_domain(case))
    before = dict(LEAN)
    for _ in range(2):
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert len(loop.memo) == 0
    assert _lean(before) == _built(2, dvdxi_const=1, ww1_k0=1, vert=1,
                                   tconst=1)
    mesh = Mesh(["cpu"] * 4, (2, 2), owners=[0, 0, 1, 1], rank=0,
                backend="gloo")
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, device="cpu",
                         mesh=mesh)
    assert loop.memo.keep is False          # and so it keeps no constant


def test_one_entry_per_part_and_no_old_state(case):
    rk3 = _integrator(case)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    memo = rk3.loops[0].memo
    old = []
    for _ in range(6):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        assert sorted(memo.held("lean")) == sorted(PARTS)
        old.append(weakref.ref(memo.held("lean")["tconst"][0, 0]))
    del out
    gc.collect()
    assert [r() is None for r in old] == [True] * 5 + [False]


def test_a_warm_step_builds_one_tconst_and_counts_its_bytes(case):
    """The ``wrf.loop.inputs`` count is the bytes of the 3-D blocks the
    call built: 0 in stage 1 (no scan substep), one ``tconst`` in stage 2,
    0 in stage 3."""
    rk3 = _integrator(case)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    for step in range(2):
        timing.SPANS.clear()
        before = dict(LEAN)
        with profile(activities=[ProfilerActivity.CPU]):
            out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                           tendency_fn=fn)
        counts = _lean(before)
        made = [s.count for s in timing.SPANS if s.name == "wrf.loop.inputs"]
        timing.SPANS.clear()
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
    tconst = rk3.loops[0].memo.held("lean")["tconst"][0, 0]
    assert counts == {**_built(1, tconst=1),
                      **_reused(1, dvdxi_const=2, ww1_k0=2, vert=2,
                                tconst=1)}
    assert made == [0, tconst.nbytes, 0]
