"""The stage loops' pad memo (``models/stage_memo.py::StageMemo.pad``): an
RK3 integrator stepped three times equals, bit for bit, one whose memo
keeps nothing, on every path of the loop, with the kernels' in-place
writes seen only through the marks their wrappers make, as on the card;
K1 writes and marks no operand, and the wrappers of K2 and K3 mark
exactly the operands they update in place; so stages 2 and 3 pad nothing
the halo exchange did not write, and the blocks the memo stores for K1's
state stay as they were built; each way an input or a stored pad can
change is a miss; the memo keeps one entry a field and no old state; and
:data:`~wrf_tpu_torch.models.stage_memo.PADS` counts the blocks built and
reused."""

import gc
import weakref

import numpy as np
import pytest
import torch

from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.models import stage_memo
from wrf_tpu_torch.models.stage_memo import PADS, StageMemo
from wrf_tpu_torch.models.tendencies import NudgingTendencies
from wrf_tpu_torch.ops import advance_mu_t_coupled_cuda as k3
from wrf_tpu_torch.ops import advance_mu_t_cuda as k1
from wrf_tpu_torch.ops import advance_mu_t_msteps_cuda as k2
from wrf_tpu_torch.ops.advance_uv import DEFAULT_CS2
from wrf_tpu_torch.parallel import sharded
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh
from wrf_tpu_torch.parallel.sharded import (
    case_to_domain, pad_local, prepare_arrays,
)

torch.set_num_threads(1)

#: the loop's paths: those of ``tests/test_torch_spans.py::PATHS`` (the
#: fused path, the blocked path, the eager path, a 2x2 mesh), then without
#: w and damping, bf16 constants, and the rdma backends on meshes in one
#: process (on 2x1 K5's refresh is the only write to mu's and v's halos)
PATHS = {
    "fused": dict(),
    "blocked": dict(inner_steps=2, smdiv=0.0),
    "eager": dict(kernel="eager"),
    "mesh2x2": dict(shape=(2, 2)),
    "bare": dict(with_w=False, smdiv=0.0),
    "bf16": dict(const_dtype=torch.bfloat16),
    "rdma2x2": dict(shape=(2, 2), halo_backend="rdma"),
    "rdma_overlap2x2": dict(shape=(2, 2), halo_backend="rdma_overlap"),
    "rdma2x1": dict(shape=(2, 1), halo_backend="rdma"),
}

#: the inputs a closed step gives new tensors: the evolved state and the
#: closure's tendencies
CHANGED = ("ww", "u", "v", "t", "t_ave", "w", "pp", "ft", "mu", "mu_tend")


@pytest.fixture(scope="module")
def case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)


def _alias(x):
    """``x`` with every tensor as its ``.data``: the same storage under a
    version counter of its own, so that a write through it is unseen."""
    if isinstance(x, torch.Tensor):
        return x.data
    if isinstance(x, dict):
        return {k: _alias(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_alias(v) for v in x]
    return x


def _unseen(fn):
    def call(*args, **kw):
        return fn(*_alias(list(args)), **_alias(kw))
    return call


@pytest.fixture(autouse=True)
def unseen_writes(monkeypatch):
    """The plain versions of K1, K2 and K3 run on ``.data`` aliases, as the
    kernels write through device pointers: only the dispatchers' marks
    raise a ``_version``, as on the card (K1 writes no operand)."""
    for mod, name in ((k1, "advance_mu_t_fused_plain"),
                      (k2, "advance_mu_t_multistep_plain"),
                      (k3, "coupled_multistep_plain")):
        monkeypatch.setattr(mod, name, _unseen(getattr(mod, name)))


def _integrator(case, shape=None, keep=True, **kw):
    """A closed-step integrator on the CPU whose K5 writes unseen too (the
    one unmarked writer); ``keep=False``: a cold one, whose stages pad
    every call anew."""
    b = case.bounds
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape) if shape else None
    kw = dict(dict(kernel="cuda", with_w=True, smdiv=0.1), **kw)
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, acoustic_steps=6,
                        snapshot="base", device="cpu", mesh=mesh, **kw)
    rk3.loops[0].memo.keep = keep
    for loop in rk3.loops:
        loop._rdma = _unseen(loop._rdma)
    return rk3


def _closed_steps(case, rk3, steps):
    """``steps`` closed steps (step, merge, wind damping).  Returns every
    step's outputs and the evolved state at the end, ring-shaped."""
    arrays = rk3.prepare(case_to_domain(case, with_w=rk3.loops[0].with_w))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    outs = []
    for _ in range(steps):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        outs.append({k: v.clone() for k, v in out.items()})
    return outs, rk3.unprepare(arrays, [n for n in rk3._EVOLVED
                                        if n in arrays])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_bit_equal_to_fresh_pads(case, path):
    kw = dict(PATHS[path])
    one, cold = _integrator(case, **kw), _integrator(case, keep=False, **kw)
    got, got_state = _closed_steps(case, one, 3)
    want, want_state = _closed_steps(case, cold, 3)
    assert len(one.loops[0].memo) > 0 and len(cold.loops[0].memo) == 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for n in g:
            assert torch.equal(g[n], w[n]), (step, n)
    for n in want_state:
        assert torch.equal(got_state[n], want_state[n]), n


# ----------------------------------------------------------------------
# the marks of the kernel wrappers
# ----------------------------------------------------------------------
def _marks(fn, calls):
    """``fn`` recording, per call, each tensor operand's rise in
    ``_version`` (the ones that rose)."""
    def call(**kw):
        tensors = {n: x for n, x in kw.items() if isinstance(x, torch.Tensor)}
        before = {n: x._version for n, x in tensors.items()}
        out = fn(**kw)
        calls.append({n: x._version - before[n] for n, x in tensors.items()
                      if x._version != before[n]})
        return out
    return call


@pytest.mark.parametrize("fuse_w", [False, True])
@pytest.mark.parametrize("ww_mode", ["full", "lite", "final"])
def test_k1_marks_exactly_what_it_updates_in_place(case, ww_mode, fuse_w):
    """K1 marks nothing: it writes its results to fresh tensors, so no
    operand's ``_version`` rises and none changes."""
    kw = case.kernel_kwargs()
    ops = {n: torch.tensor(np.asarray(x, np.float32)) for n, x in kw.items()
           if hasattr(x, "ndim")}
    sc = {n: kw[n] for n in ("rdx", "rdy", "dts", "epssm")}
    b = case.bounds
    i0, i1, j0, j1, k0, kk1 = b.loop_bounds(case.flags)
    lite = ww_mode == "lite"
    if ww_mode != "full":
        ops["ww_row"] = ops["ww"][:, k0, :] + 0.01
    if lite:
        ops.update(k1.lean_kwargs(ops, sc["rdx"], sc["rdy"], sc["dts"], k0,
                                  kk1))
    if fuse_w:
        ops.update({n: torch.tensor(np.asarray(case.fields["grid_" + n],
                                               np.float32))
                    for n in ("w", "pp", "rdn")})
    before = {n: x.clone() for n, x in ops.items()}
    calls = []
    out = _marks(k1.advance_mu_t_fused, calls)(
        **ops, **sc, window=(i0, i1, j0, j1), k0=k0, k1=kk1,
        kde=b.mem(b.kde, "k"), fuse_uv=True, cs2=DEFAULT_CS2,
        ww_mode=ww_mode, with_tave=not lite, lean=lite, fuse_w=fuse_w)
    assert calls == [{}]
    assert all(torch.equal(x.nan_to_num(), before[n].nan_to_num())
               for n, x in ops.items())
    assert not torch.equal(out["t"], ops["t"])


def test_k3_marks_exactly_what_it_updates_in_place(case):
    """The blocked loop's K3 launch: t, ww_row, w and pp of its ring-S
    copies."""
    b = case.bounds
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=3,
                         inner_steps=2, with_w=True, device="cpu")
    calls = []
    loop._block = _marks(loop._block, calls)
    loop(loop.prepare(case_to_domain(case, with_w=True)), case.rdx, case.rdy,
         case.dts, case.epssm)
    assert calls == [dict.fromkeys(("t", "ww_row", "w", "pp"), 1)]


def test_k2_marks_exactly_what_it_updates_in_place(case, monkeypatch):
    """The mu/t loop's blocked K2 launch: t, mu and ww_row."""
    b = case.bounds
    calls = []
    monkeypatch.setattr(sharded, "advance_mu_t_multistep",
                        _marks(k2.advance_mu_t_multistep, calls))
    loop = sharded.ShardedAdvanceMuT(b.ide, b.jde, b.kdim, case.flags,
                                     n_steps=3, inner_steps=2, device="cpu")
    loop(loop.prepare(case_to_domain(case)), case.rdx, case.rdy, case.dts,
         case.epssm)
    assert calls == [dict.fromkeys(("t", "mu", "ww_row"), 1)]


# ----------------------------------------------------------------------
# misses
# ----------------------------------------------------------------------
@pytest.fixture(params=[(1, 1), (2, 2)], ids=["1x1", "2x2"])
def prepared(request, case):
    shape = request.param
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    sh = (shape[0] > 1, shape[1] > 1)
    return prepare_arrays(case_to_domain(case, with_w=True), mesh,
                          extra=("w", "pp", "rdn")), mesh, sh


def _bytes(local, names):
    return sum(p[n].nbytes for p in local.values() for n in names)


def _same_as_a_fresh_pad(got, arrays, mesh, sh):
    want = pad_local(arrays, mesh, *sh)
    for c in want:
        for n in want[c]:
            assert torch.equal(got[c][n], want[c][n]), (c, n)


def _padded(arrays):
    return [n for n, b in arrays.items() if next(iter(b.values())).ndim > 1]


def test_a_second_pad_of_the_same_inputs_builds_nothing(prepared):
    arrays, mesh, sh = prepared
    memo = StageMemo()
    first, built = memo.pad(arrays, mesh, *sh)
    again, nothing = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, _padded(arrays)) > 0 and nothing == 0
    assert len(memo) == len(_padded(arrays))
    for c in first:
        assert again[c] is not first[c]             # new dicts every call
        for n in arrays:
            assert again[c][n] is first[c][n], n
    _same_as_a_fresh_pad(again, arrays, mesh, sh)


def test_an_in_place_write_to_a_source_is_a_miss(prepared):
    arrays, mesh, sh = prepared
    memo = StageMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    next(iter(arrays["t"].values())).add_(1.0)
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["t"])
    assert all(got[c]["t"] is not first[c]["t"] for c in got)
    assert all(got[c]["u"] is first[c]["u"] for c in got)
    _same_as_a_fresh_pad(got, arrays, mesh, sh)


def test_a_new_tensor_under_the_same_name_is_a_miss(prepared):
    arrays, mesh, sh = prepared
    memo = StageMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    old = weakref.ref(next(iter(first.values()))["mu"])
    arrays = dict(arrays, mu={c: x * 2.0 for c, x in arrays["mu"].items()})
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["mu"])
    _same_as_a_fresh_pad(got, arrays, mesh, sh)
    del first
    gc.collect()
    assert old() is None                    # the old entry was let go


def test_an_in_place_write_to_a_stored_pad_is_a_miss(prepared):
    arrays, mesh, sh = prepared
    memo = StageMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    next(iter(first.values()))["v"].zero_()
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["v"])
    _same_as_a_fresh_pad(got, arrays, mesh, sh)


def test_a_marked_write_to_a_stored_pad_is_a_miss(prepared):
    """A write through the pointer is unseen until the wrapper marks it:
    unmarked, the stale block would come back."""
    arrays, mesh, sh = prepared
    memo = StageMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    blocks = [p["t"] for p in first.values()]
    for x in blocks:
        x.data.add_(1.0)
    stale, nothing = memo.pad(arrays, mesh, *sh)
    assert nothing == 0
    assert all(stale[c]["t"] is first[c]["t"] for c in stale)
    k1.mark_in_place(blocks)
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["t"])
    assert all(got[c]["t"] is not first[c]["t"] for c in got)
    _same_as_a_fresh_pad(got, arrays, mesh, sh)


def test_force_exchange_never_uses_the_memo(case):
    b = case.bounds
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=2,
                         device="cpu", force_exchange=True)
    arrays = loop.prepare(case_to_domain(case))
    before = dict(PADS)
    for _ in range(2):
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert loop.memo.keep is False and len(loop.memo) == 0
    assert PADS["reused"] == before.get("reused", 0)
    assert PADS["built"] - before.get("built", 0) == 2 * 19


def test_a_mesh_over_processes_keeps_no_pad(case):
    b = case.bounds
    mesh = Mesh(["cpu"] * 4, (2, 2), owners=[0, 0, 1, 1], rank=0,
                backend="gloo")
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, device="cpu",
                         mesh=mesh)
    assert loop.memo.keep is False
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, kernel="plain",
                        device="cpu")
    assert rk3.loops[0].memo.keep is True
    assert all(loop.memo is rk3.loops[0].memo for loop in rk3.loops)


# ----------------------------------------------------------------------
# what the memo holds, and the counter
# ----------------------------------------------------------------------
def test_one_entry_per_field_and_no_old_state(case):
    """Every padded field has its entry after a step, K1's five too (held
    until the next stage 1 drops them for the merged state's), and no input
    is held."""
    rk3 = _integrator(case)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    first_u = weakref.ref(arrays["u"])
    memo = rk3.loops[0].memo
    names = set(rk3.loops[0]._names) - {"dnw", "fnm", "fnp", "rdnw", "rdn"}
    for _ in range(6):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        assert set(memo.held("pad")) == names
    del out
    gc.collect()
    assert first_u() is None        # held by weak reference only


def test_counter_reads_built_and_reused_blocks(case):
    """On the fused path with w: the first step builds all 21 blocks in
    stage 1 and reuses them in stages 2 and 3 (21 built, 42 reused); a
    later step builds the 10 changed inputs' blocks in stage 1 and nothing
    after (10 built, 53 reused)."""
    rk3 = _integrator(case)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    counts = []
    for _ in range(3):
        before = dict(PADS)
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        counts.append(tuple(PADS[k] - before.get(k, 0)
                            for k in ("built", "reused")))
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
    assert len(CHANGED) == 10
    assert counts == [(21, 2 * 21), (10, 11 + 2 * 21), (10, 53)]


#: the paths on which stages 2 and 3 pad again only what the halo exchange
#: rewrote before the first substep, in place: mu's and v's j and i halos
#: on a 2x2 mesh under ppermute, mu's i halo under rdma_overlap (its j
#: leg is K1's own)
REPADS = {"fused": (), "bare": (), "bf16": (), "mesh2x2": ("mu", "v"),
          "rdma_overlap2x2": ("mu",)}


@pytest.mark.parametrize("path", sorted(REPADS))
def test_stages_2_and_3_build_no_pad(case, path, monkeypatch):
    """Every stage restarts from the step-start state, which K1 does not
    write: on a warm step stage 1 pads the changed inputs and stages 2 and
    3 pad nothing (on a mesh, only the fields whose halos the first
    substep's exchange rewrote)."""
    stages = []      # the fields each stage's pad built

    def recording(arrays, *args):
        stages[-1].extend(sorted(arrays))
        return pad_local(arrays, *args)

    monkeypatch.setattr(stage_memo, "pad_local", recording)
    rk3 = _integrator(case, **PATHS[path])
    memo = rk3.loops[0].memo
    pad = memo.pad

    def per_stage(*args):
        stages.append([])
        return pad(*args)

    memo.pad = per_stage
    _closed_steps(case, rk3, 3)
    padded = sorted(set(rk3.loops[0]._names) & set(CHANGED))
    want = sorted(REPADS[path])
    assert stages[3:] == [padded, want, want] * 2


@pytest.mark.parametrize("name", ["t", "w", "pp", "ww", "t_ave"])
def test_stored_block_of_k1_state_unchanged_by_a_stage(case, name):
    """The blocks the memo stores for K1's carried state after stage 1 are
    the blocks stages 2 and 3 get back, with the same bits and
    ``_version`` after the step."""
    rk3 = _integrator(case)
    memo = rk3.loops[0].memo
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    held = {}

    def tendencies(stage, out, stage_arrays):
        if stage == 1:   # stage 1 has run
            held.update({c: (x, x.clone(), x._version)
                         for c, x in memo.held("pad")[name].items()})
        return fn(stage, out, stage_arrays)

    for _ in range(2):
        held.clear()
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=tendencies)
        now = memo.held("pad")[name]
        assert held and now.keys() == held.keys()
        for c, (x, bits, version) in held.items():
            assert now[c] is x and x._version == version
            assert torch.equal(x, bits)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
