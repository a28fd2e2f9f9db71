"""Meshes over several cards in one process, as far as the CPU can check
them: where ``mesh_from_spec`` and ``make_mesh`` put the shards when 1-4
cards are visible (the visible count and the peer table are stood in for;
nothing touches a card), that a pair of neighbouring cards without peer
access raises by name, that ``Mesh.join_streams`` does nothing on one
device, and that the ``rdma_overlap`` loop orders the
cards around every launch and keeps the neighbours' blocks referenced
until after the second ordering (so that no card's allocator hands them
to new work while another card's kernel still reads them).
"""

import weakref

import pytest
import torch

from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.io import fixtures
from wrf_tpu_torch.parallel import mesh as mesh_mod
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_from_spec
from wrf_tpu_torch.parallel.sharded import case_to_domain

torch.set_num_threads(1)


@pytest.fixture
def cards(monkeypatch):
    """Stand in for ``n`` visible cards with full peer access (returns the
    setter); the peer table records every pair asked about."""
    asked = []

    def visible(n, peer=lambda a, b: True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

        def can(a, b):
            asked.append((a, b))
            return peer(a, b)

        monkeypatch.setattr(torch.cuda, "can_device_access_peer", can)
        return asked

    return visible


@pytest.mark.parametrize("spec,n,want", [
    ("2x2", 4, [0, 1, 2, 3]), ("3x1", 4, [0, 1, 2]), ("2x1", 4, [0, 1]),
    ("2x2", 2, [0, 1, 0, 1]), ("3x1", 3, [0, 1, 2]), ("2x2", 1, [0] * 4)])
def test_mesh_from_spec_puts_shard_s_on_card_s(cards, spec, n, want):
    cards(n)
    mesh = mesh_from_spec(spec, "cuda")
    assert [mesh.device(c) for c in mesh.coords()] == [
        torch.device("cuda", i) for i in want]
    assert len(mesh.unique_devices()) == len(set(want))
    assert f"on {len(set(want))} device(s)" in mesh_mod.describe(mesh)


def test_make_mesh_takes_every_visible_card(cards):
    cards(4)
    mesh = make_mesh()
    assert mesh.shape == (2, 2)
    assert mesh.unique_devices() == [torch.device("cuda", i)
                                     for i in range(4)]


def test_neighbours_are_checked_for_peer_access_both_ways(cards):
    asked = cards(4)
    make_mesh([f"cuda:{i}" for i in range(4)], (2, 2))
    # every ring pair of the (2,2) mesh, both directions
    assert {(0, 2), (2, 0), (1, 3), (3, 1), (0, 1), (1, 0), (2, 3),
            (3, 2)} <= set(asked)


@pytest.mark.parametrize("blocked", [(0, 1), (3, 1)])
def test_a_pair_without_peer_access_raises_by_name(cards, blocked):
    cards(4, peer=lambda a, b: (a, b) != blocked)
    with pytest.raises(RuntimeError) as e:
        make_mesh([f"cuda:{i}" for i in range(4)], (2, 2))
    for i in blocked:
        assert f"cuda:{i}" in str(e.value)
    assert "peer access" in str(e.value)


def test_a_mesh_that_mixes_the_cpu_and_a_card_raises(cards):
    cards(1)
    with pytest.raises(ValueError, match="mixes device types"):
        Mesh(["cpu", "cuda:0"], (2, 1))


def test_one_device_needs_no_ordering(monkeypatch):
    """``join_streams`` records no event on one device or on the CPU."""
    def boom(*a, **k):
        raise AssertionError("an event was recorded")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    make_mesh(["cpu"] * 4, (2, 2)).join_streams()


def test_overlap_keeps_the_neighbours_blocks_until_the_second_join(
        monkeypatch):
    """Under ``rdma_overlap`` every substep's launches sit between two
    ``join_streams`` calls, and the neighbour rows the launches read (views
    of the state of before the substep) are still alive when the second
    join runs: only after it may they be freed, and a card's caching
    allocator then hands their memory only to work that its stream orders
    after the other cards' reads."""
    case = fixtures.make_case(16, 14, 6, halo=2, seed=3)
    b = case.bounds
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    for kw in (dict(n_steps=4), dict(n_steps=9, inner_steps=4)):
        loop = SmallStepLoop(b.ide, b.jde, b.kdim, case.flags, device="cpu",
                             mesh=mesh, halo_backend="rdma_overlap", **kw)
        arrays = loop.prepare(case_to_domain(case))
        events, pending = [], []

        def launch_spy(real):
            def launch(**kw):
                pending.extend(weakref.ref(r) for r in kw["overlap"].values())
                events.append("launch")
                return real(**kw)
            return launch

        def join():
            if events and events[-1] == "launch":   # the second join
                events.append(("join", all(w() is not None
                                           for w in pending)))
                pending.clear()
            else:
                events.append(("join", None))

        loop._step = launch_spy(loop._step)
        loop._block = launch_spy(loop._block)
        monkeypatch.setattr(mesh, "join_streams", join)
        loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
        # S=1: 4 substeps; S=4: 2 blocks of 4 and the final substep
        groups = {4: 4, 9: 3}[kw["n_steps"]]
        assert events == ([("join", None), *["launch"] * 4, ("join", True)]
                          * groups)
