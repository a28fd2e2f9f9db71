"""K5's launch planning on the CPU: the segment table each device launches
per exchange, the plan each launch takes, and the events that order the
launches across devices.

The kernel itself runs only on a card (``chip_smoke.py`` holds it against
its plain version there); what decides how many launches an exchange makes
and which plan each launch takes is Python, and is tested here with
stand-in devices, addresses, streams and events, and with CPU blocks for
the addresses.
"""

import ctypes

import pytest
import torch

from wrf_tpu_torch.ops import halo_rdma_cuda as k5
from wrf_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def _rings(devices_by_ring, per_sender):
    """Stand-in rings: sender ``s`` of ring ``r`` owns segments ``(r, s,
    q)`` for ``q < per_sender``; devices are strings."""
    return [([[(r, s, q) for q in range(per_sender)]
              for s in range(len(devs))], devs)
            for r, devs in enumerate(devices_by_ring)]


@pytest.mark.parametrize("devices_by_ring", [
    [["d0"]],                                  # a ring of one
    [["d0"] * 8],                              # a ring of 8 on one card
    [["d0", "d0"], ["d0", "d0"]],              # 2x2 on one card
    [["d0", "d1"], ["d0", "d1"]],              # 2x2, one card per j row
    [["d0", "d1", "d2", "d3"]],                # a ring over four cards
])
def test_tables_hold_each_devices_senders_in_ring_then_sender_order(
        devices_by_ring):
    rings = _rings(devices_by_ring, per_sender=3)
    tables = k5.segment_tables(rings)
    assert set(tables) == {d for devs in devices_by_ring for d in devs}
    for dev, tabs in tables.items():
        want = [(r, s, q) for r, devs in enumerate(devices_by_ring)
                for s, d in enumerate(devs) if d == dev for q in range(3)]
        assert [seg for tab in tabs for seg in tab] == want
        assert len(tabs) == 1      # at most 64 segments: one launch


@pytest.mark.parametrize("n,sizes", [
    (1, [1]), (63, [63]), (64, [64]), (65, [64, 1]), (128, [64, 64]),
    (160, [64, 64, 32]),
])
def test_tables_split_past_the_launch_limit(n, sizes):
    rings = [([[("seg", q) for q in range(n)]], ["d0"])]
    tabs = k5.segment_tables(rings)["d0"]
    assert [len(t) for t in tabs] == sizes
    assert [seg for t in tabs for seg in t] == [("seg", q) for q in range(n)]
    assert k5.MAX_SEGMENTS == 64


@pytest.mark.parametrize("shape,fields,launches", [
    ((1, 1), 2, 1), ((2, 2), 2, 1), ((4, 1), 3, 1), ((8, 1), 3, 1),
    ((8, 2), 3, 2), ((16, 2), 3, 3),
])
def test_one_launch_per_device_for_a_mesh_on_one_card(shape, fields,
                                                      launches):
    """The loop's exchange (mu both ways, v up, mudf both ways) on every
    shard of one device: one table, cut only past 64 segments."""
    n = shape[0] * shape[1]
    mesh = make_mesh(["cpu"] * n, shape)
    blocks = [{c: torch.zeros((6, 3, 5) if f == 1 else (6, 5))
               for c in mesh.coords()} for f in range(fields)]
    ro = ("", "hi", "")[:fields]
    tables = k5.segment_tables(k5._refresh_rings(blocks, "j", mesh, 4, ro))
    assert list(tables) == [torch.device("cpu")]
    tabs = tables[torch.device("cpu")]
    per_shard = 2 * fields - 1
    assert sum(len(t) for t in tabs) == n * per_shard
    assert len(tabs) == launches


def test_addresses_are_row_pointers_of_the_blocks():
    src = torch.arange(60, dtype=torch.float32).view(4, 3, 5)
    dst = torch.zeros(4, 3, 5)
    (s, d, n), = k5.addresses([(src, 2, dst, 0)])
    assert (s, d, n) == (src.data_ptr() + 4 * 15 * 2, dst.data_ptr(), 15)
    assert ctypes.c_float.from_address(s).value == float(src[2, 0, 0])
    with pytest.raises(ValueError, match="rows of 15 elements into rows of 4"):
        k5.addresses([(src, 1, torch.zeros(4, 4), 0)])


def test_plan_holds_the_tables_pointers_and_counts():
    addrs = ((4096, 8192, 3000), (4100, 12288, 259), (16, 32, 1))
    dev, srcs, dsts, counts, n, blocks = k5._plan(torch.device("cpu"), addrs)
    assert n == 3
    assert list(srcs) == [4096, 4100, 16]
    assert list(dsts) == [8192, 12288, 32]
    assert list(counts) == [3000, 259, 1]
    assert blocks == 3             # the longest row over 1024 per block


def test_plan_put_refuses_what_one_launch_cannot_move():
    rows = [(torch.zeros(3, 4), 1, torch.zeros(3, 4), 0)] * 65
    with pytest.raises(ValueError, match="65 segments in one launch"):
        k5.plan_put(rows)
    with pytest.raises(ValueError, match="a launch's rows lie on cpu"):
        k5.plan_put(rows[:1])
    assert k5.LAUNCHES == 0


class _Blk:
    """A stand-in block: only its device is read by the planning."""

    def __init__(self, device):
        self.device = device


class _Log:
    """Recording stand-ins for the CUDA streams, events and the launch."""

    def __init__(self):
        self.ops = []
        self.streams = {}

    def stream(self, dev):
        log = self

        class Stream:
            def wait_event(self, ev):
                log.ops.append(("wait", dev, ev.n))

        return self.streams.setdefault(dev, Stream())

    def event(self):
        log = self

        class Event:
            n = len([o for o in self.ops if o[0] == "new"])

            def record(self, stream):
                dev = next(d for d, s in log.streams.items() if s is stream)
                log.ops.append(("record", dev, self.n))

        self.ops.append(("new",))
        return Event()


@pytest.mark.parametrize("devices_by_ring", [
    [["d0", "d1"]],                            # a ring over two cards
    [["d0", "d1", "d2", "d3"]],                # a ring over four cards
    [["d0", "d1"], ["d0", "d1"]],              # 2x2, one card per j row
    [["d0", "d0", "d1", "d1"]],                # two shards a card
])
def test_launches_wait_for_the_devices_they_write_and_are_waited_for(
        monkeypatch, devices_by_ring):
    """Across cards: before a device's launch its stream waits on the
    ready event of exactly each OTHER device it writes into (recorded on
    that device's stream before any launch), and every receiver's stream
    then waits on the done event of each device that wrote into it
    (recorded on the writer's stream after its launches)."""
    log = _Log()
    monkeypatch.setattr(torch.cuda, "current_stream", log.stream)
    monkeypatch.setattr(torch.cuda, "Event", log.event)
    monkeypatch.setattr(k5, "plan_put", lambda tab: (tab[0][0].device, tab))
    monkeypatch.setattr(k5, "put", lambda plan: log.ops.append(
        ("put", plan[0])))
    rings = []
    for devs in devices_by_ring:
        m = len(devs)
        blk = [_Blk(d) for d in devs]
        rings.append(([[(blk[s], 0, blk[(s + 1) % m], 0),
                        (blk[s], 1, blk[(s - 1) % m], 1)]
                       for s in range(m)], devs))
    plans, into = k5._plan_exchange(rings)
    want_into = {}
    for devs in devices_by_ring:
        m = len(devs)
        for s, d in enumerate(devs):
            want_into.setdefault(d, set()).update(
                {devs[(s + 1) % m], devs[(s - 1) % m]} - {d})
    assert into == want_into
    k5._launch((plans, into))
    ops = log.ops
    puts = [i for i, o in enumerate(ops) if o[0] == "put"]
    assert sorted(ops[i][1] for i in puts) == sorted(plans)
    first_put = puts[0]
    ready = {o[1]: o[2] for o in ops[:first_put] if o[0] == "record"}
    assert set(ready) == set().union(*into.values())
    for dev in plans:
        p = next(i for i in puts if ops[i][1] == dev)
        waits = {o[2] for o in ops[first_put:p] + ops[:first_put]
                 if o[0] == "wait" and o[1] == dev}
        assert waits == {ready[d] for d in into[dev]}
        done = [o for o in ops[p + 1:] if o[0] == "record" and o[1] == dev]
        assert len(done) == 1
        later = ops[ops.index(done[0]) + 1:]
        for d in into[dev]:        # every receiver waits for this writer
            assert ("wait", d, done[0][2]) in later
    last_put = puts[-1]
    assert not [o for o in ops[last_put + 1:] if o[0] == "put"]


def test_one_device_exchanges_without_events(monkeypatch):
    log = _Log()
    monkeypatch.setattr(torch.cuda, "current_stream", log.stream)
    monkeypatch.setattr(torch.cuda, "Event", log.event)
    monkeypatch.setattr(k5, "plan_put", lambda tab: (tab[0][0].device, tab))
    monkeypatch.setattr(k5, "put", lambda plan: log.ops.append(
        ("put", plan[0])))
    blk = [_Blk("d0") for _ in range(4)]
    rings = [([[(blk[s], 0, blk[(s + 1) % 4], 0)] for s in range(4)],
              ["d0"] * 4)]
    k5._launch(k5._plan_exchange(rings))
    assert log.ops == [("put", "d0")]
