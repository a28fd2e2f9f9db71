"""The loops' pad memo (``parallel/sharded.py::PadMemo``): an RK3 integrator
stepped three times equals, bit for bit, fresh integrators that pad every
stage anew, on every path of the loop, with the kernels' in-place writes
unseen by ``_version`` as on the card; each way an input or a stored pad
can change is a miss; the memo keeps one entry a field and no old state;
and :data:`~wrf_tpu_torch.parallel.sharded.PADS` counts the blocks built
and reused."""

import gc
import weakref

import pytest
import torch

from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.models.tendencies import NudgingTendencies
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh
from wrf_tpu_torch.parallel.sharded import (
    PADS, PadMemo, case_to_domain, pad_local, prepare_arrays,
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
#: the state K1 updates in place, padded again by every stage
K1_STATE = ("ww", "t_ave", "t", "w", "pp")


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


def _integrator(case, shape=None, keep=True, **kw):
    """A closed-step integrator whose K1, K3 and K5 write in place where
    no ``_version`` sees it, as the kernels do through device pointers;
    ``keep=False``: its stages pad every call anew."""
    b = case.bounds
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape) if shape else None
    kw = dict(dict(kernel="cuda", with_w=True, smdiv=0.1), **kw)
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, acoustic_steps=6,
                        snapshot="base", device="cpu", mesh=mesh, **kw)
    memo = PadMemo(keep=keep)
    for loop in rk3.loops:
        loop._step, loop._block, loop._rdma = (
            _unseen(f) for f in (loop._step, loop._block, loop._rdma))
        loop.pad_memo = memo
    return rk3


def _closed_steps(case, make, steps):
    """``steps`` closed steps (step, merge, wind damping); ``make()`` gives
    the integrator of each step.  Returns every step's outputs and the
    evolved state at the end, ring-shaped."""
    rk3 = make()
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
        thomas, rk3 = rk3.loops[0].thomas, make()
        for loop in rk3.loops:
            loop.thomas = thomas
    return outs, rk3.unprepare(arrays, [n for n in rk3._EVOLVED
                                        if n in arrays])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_three_steps_bit_equal_to_fresh_pads(case, path):
    kw = dict(PATHS[path])
    one = _integrator(case, **kw)
    got, got_state = _closed_steps(case, lambda: one, 3)
    want, want_state = _closed_steps(
        case, lambda: _integrator(case, keep=False, **kw), 3)
    assert len(one.loops[0].pad_memo) > 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for n in g:
            assert torch.equal(g[n], w[n]), (step, n)
    for n in want_state:
        assert torch.equal(got_state[n], want_state[n]), n


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
    memo = PadMemo()
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
    memo = PadMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    next(iter(arrays["t"].values())).add_(1.0)
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["t"])
    assert all(got[c]["t"] is not first[c]["t"] for c in got)
    assert all(got[c]["u"] is first[c]["u"] for c in got)
    _same_as_a_fresh_pad(got, arrays, mesh, sh)


def test_a_new_tensor_under_the_same_name_is_a_miss(prepared):
    arrays, mesh, sh = prepared
    memo = PadMemo()
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
    memo = PadMemo()
    first, _ = memo.pad(arrays, mesh, *sh)
    next(iter(first.values()))["v"].zero_()
    got, built = memo.pad(arrays, mesh, *sh)
    assert built == _bytes(first, ["v"])
    _same_as_a_fresh_pad(got, arrays, mesh, sh)


def test_written_fields_are_padded_on_every_call(prepared):
    arrays, mesh, sh = prepared
    memo = PadMemo()
    first, _ = memo.pad(arrays, mesh, *sh, written=K1_STATE)
    got, built = memo.pad(arrays, mesh, *sh, written=K1_STATE)
    assert built == _bytes(first, K1_STATE)
    assert len(memo) == len(_padded(arrays)) - len(K1_STATE)
    assert all(got[c]["t"] is not first[c]["t"] for c in got)


def test_force_exchange_never_uses_the_memo(case):
    b = case.bounds
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, n_steps=2,
                         device="cpu", force_exchange=True)
    arrays = loop.prepare(case_to_domain(case))
    before = dict(PADS)
    for _ in range(2):
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    assert loop.pad_memo.keep is False and len(loop.pad_memo) == 0
    assert PADS["reused"] == before.get("reused", 0)
    assert PADS["built"] - before.get("built", 0) == 2 * 19


def test_a_mesh_over_processes_keeps_no_pad(case):
    b = case.bounds
    mesh = Mesh(["cpu"] * 4, (2, 2), owners=[0, 0, 1, 1], rank=0,
                backend="gloo")
    loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, device="cpu",
                         mesh=mesh)
    assert loop.pad_memo.keep is False
    rk3 = RK3Integrator(b.ide, b.jde, b.kdim, case.flags, kernel="plain",
                        device="cpu")
    assert rk3.loops[0].pad_memo.keep is True
    assert all(loop.pad_memo is rk3.loops[0].pad_memo for loop in rk3.loops)


# ----------------------------------------------------------------------
# what the memo holds, and the counter
# ----------------------------------------------------------------------
def test_one_entry_per_field_and_no_old_state(case):
    rk3 = _integrator(case)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 6
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)
    first_u = weakref.ref(arrays["u"])
    memo = rk3.loops[0].pad_memo
    names = set(rk3.loops[0]._names) - {"dnw", "fnm", "fnp", "rdnw", "rdn"}
    for _ in range(6):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        arrays = rk3.merge_evolved(arrays, out)
        fn.damp_winds(arrays)
        assert set(memo._entries) == names - set(K1_STATE)
    del out
    gc.collect()
    assert first_u() is None        # held by weak reference only


def test_counter_reads_built_and_reused_blocks(case):
    """On the fused path with w: the first step builds all 21 blocks in
    stage 1 and K1's five in stages 2 and 3 (31 built, 32 reused); a later
    step builds the 10 changed inputs' blocks in stage 1 and K1's five in
    each later stage (20 built, 43 reused)."""
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
    assert counts == [(21 + 2 * 5, 2 * 16), (10 + 2 * 5, 11 + 2 * 16),
                      (20, 43)]
