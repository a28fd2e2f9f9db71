"""The rdma exchange across processes (``ops/halo_rdma_cuda.py``:
``Mailbox``, the signalled put and the wait of ``csrc/halo_ipc.cu``) on
the CPU.

(a) The mailbox plan (``Mesh.mailbox_plan``) and the kernels' launch tables
(``_tables``) on fake owner tables: the two ends of every message agree on
its slot, offsets, parity, counters and release, and executing the tables
by hand moves exactly what the plain exchange moves.  (b) and (c) run
``multihost_check``'s "chip" suite once per process count: every program,
the loops under ``rdma`` and ``rdma_overlap`` and ``rdma_rows`` /
``remote_refresh_multi`` alone, bit-equal to one process; in one process
the rdma programs are bit-equal to the ``ppermute`` ones (which
``tests/test_torch_overlap.py`` and ``tests/test_torch_mesh.py`` tie to
JAX), and the transport to JAX's ``_rdma_rows`` and
``remote_refresh_axis`` in interpret mode on a virtual ring.  (d)
Neighbours on two hosts, on cards without peer access, or a rank's
boundary shards on two cards, refuse the rdma backends by name.  The two
kernels themselves run in ``tests/test_torch_ipc_card.py`` (needs a card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from wrf_tpu.parallel import halo as jax_halo
from wrf_tpu_torch.models.rk3 import RK3Integrator
from wrf_tpu_torch.models.small_step import SmallStepLoop
from wrf_tpu_torch.ops import halo_rdma_cuda as k5
from wrf_tpu_torch.parallel import distributed
from wrf_tpu_torch.parallel.mesh import Mesh, make_mesh
from wrf_tpu_torch.parallel.sharded import ShardedAdvanceMuT, pad_local
from wrf_tpu_torch.tools import multihost_check as mh

torch.set_num_threads(1)

GRID = (24, 20, 8)
SHAPE = (2, 2)


def fake_mesh(nproc, rank, shape, **kw):
    n = shape[0] * shape[1]
    return Mesh(["cpu"] * n, shape, owners=[k // (n // nproc)
                                            for k in range(n)],
                rank=rank, backend="gloo", **kw)


# --------------------------------------------------------------------------
# (a) the plan and the launch tables
# --------------------------------------------------------------------------
PLANS = [((2, 1), 2), ((3, 1), 3), ((2, 2), 2), ((2, 2), 4), ((4, 2), 2),
         ((4, 2), 4)]


def _fields(mesh, seed, nj_loc=3, k=2, ni=5):
    """mu (2-D) and v (3-D) padded blocks of this rank's shards, filled from
    one global array per field (so every rank's shard sees the same
    values)."""
    rng = np.random.default_rng(seed)
    nj, ni_ = mesh.shape
    mu_g = rng.standard_normal((nj, nj_loc + 2, ni_, ni)).astype(np.float32)
    v_g = rng.standard_normal((nj, nj_loc + 2, k, ni_, ni)).astype(
        np.float32)
    mu = {c: torch.from_numpy(mu_g[c[0], :, c[1]].copy())
          for c in mesh.local_coords()}
    v = {c: torch.from_numpy(v_g[c[0], :, :, c[1]].copy())
         for c in mesh.local_coords()}
    return mu, v, nj_loc


def _refresh_items(mu, v, n):
    names = k5._field_names(2)
    return ([(names[0], mu, n, 1, mu, 0)],
            [(names[0], mu, 1, 1, mu, n + 1), (names[1], v, 1, 1, v, n + 1)])


@pytest.mark.parametrize("shape,nproc", PLANS)
def test_mailbox_plan_and_tables_agree_on_both_ends(shape, nproc):
    meshes = [fake_mesh(nproc, r, shape) for r in range(nproc)]
    plans = [m.mailbox_plan("j") for m in meshes]
    for r, (out, inc, into, back, counts) in enumerate(plans):
        _, ex_out, ex_in = meshes[r].exchange_plan("j")
        # the exchange plan's messages, order and tags
        assert out == ex_out
        assert [(s, t, d) for s, t, d, _ in inc] == ex_in
        assert counts[r] == (len(inc), len(out))
        for k, (dst, tag, src_shard, slot) in enumerate(out):
            q = into[k]
            src, tag2, dst_shard, slot2 = plans[dst][1][q]
            assert (src, tag2, slot2) == (r, tag, slot)
            assert dst_shard == meshes[r].neighbour(src_shard, "j",
                                                    1 if slot == 0 else -1)
            assert plans[dst][3][q] == k
    # the tables of two exchanges (both parities) of a refresh of mu and v
    boxes, fields = [], []
    for m in meshes:
        mu, v, n = _fields(m, seed=3)
        items = _refresh_items(mu, v, n)
        lay = [k5._layout(it) for it in items]
        slot = max(end for *_, end in lay)
        boxes.append(k5.Mailbox(m, "j", slot, "cpu", signalled=False))
        fields.append((items, lay))
    for seq in (0, 1):
        tabs = []
        for box, (items, lay) in zip(boxes, fields):
            box.seq = seq
            tabs.append(k5._tables(box, items, lay, seq % 2))
        for r, (box, tab) in enumerate(zip(boxes, tabs)):
            puts_to = [[] for _ in boxes]
            for x, row, dst, w, n, k in tab["puts"]:
                q = box.into[k]
                theirs = boxes[dst]
                lo = theirs.head + (2 * q + seq % 2) * theirs.slot
                assert lo <= w and w + n <= lo + theirs.slot
                assert w % k5._ALIGN == 0
                puts_to[dst].append((k, w, n))
            for k, (dst, word, free, target) in enumerate(tab["msgs"]):
                assert word == box.into[k]
                assert free == len(box.incoming) + k
                assert target == (seq - 1) & k5._MASK
            # a receiver's gain is what its senders' put blocks add
            for q, (src, *_) in enumerate(box.incoming):
                sent = [s for s in tabs[src]["puts"]
                        if s[2] == r and boxes[src].into[s[5]] == q]
                assert tab["gain"][q] == tab["blocks"] * len(sent)
            # a release names the sender's free counter of that message
            assert len(tab["release"]) == (len(box.incoming) if seq else 0)
            for q, (src, w) in enumerate(tab["release"]):
                k = box.back[q]
                assert tabs[src]["msgs"][k][2] == w
            # no two segments into one mailbox overlap
            for spans in puts_to:
                spans = sorted((w, w + n) for _, w, n in spans)
                assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("shape,nproc", PLANS)
def test_tables_executed_by_hand_move_what_the_plain_exchange_moves(
        shape, nproc):
    """Every rank's puts written into the receivers' mailboxes (host
    memory standing in for the IPC mappings), the data counters advanced
    as the blocks would, the waits' targets met exactly, then the scatter
    (and K5's segments between shards of one rank): the refreshed blocks
    equal the one-process plain refresh, over three exchanges of
    alternating parity."""
    meshes = [fake_mesh(nproc, r, shape) for r in range(nproc)]
    one = Mesh(["cpu"] * (shape[0] * shape[1]), shape)
    ref_mu, ref_v, n = _fields(one, seed=11)
    want = k5.remote_refresh_multi_plain([ref_mu, ref_v], "j", one, n,
                                         recv_only=("", "hi"))
    ranks = []
    for m in meshes:
        mu, v, _ = _fields(m, seed=11)
        items = _refresh_items(mu, v, n)
        lay = [k5._layout(it) for it in items]
        box = k5.Mailbox(m, "j", max(e for *_, e in lay), "cpu",
                         signalled=False)
        ranks.append((box, items, lay, mu, v))
    for seq in range(3):
        for m, (_, _, _, mu, v) in zip(meshes, ranks):
            # the rows between shards of one rank: K5's segments, plain
            k5._exchange([mu, v], k5._field_names(2), k5._refresh_rings(
                [mu, v], "j", m, n, ("", "hi")), True)
        tabs = [k5._tables(box, items, lay, seq % 2)
                for box, items, lay, _, _ in ranks]
        for r, ((box, *_), tab) in enumerate(zip(ranks, tabs)):
            for x, row, dst, w, nf, k in tab["puts"]:
                free = box.counters[tab["msgs"][k][2]].item()
                assert free - tab["msgs"][k][3] >= 0 or seq < 2
                theirs = ranks[dst][0]
                theirs.buf[w:w + nf] = x[row:].reshape(-1)[:nf]
                theirs.counters[tab["msgs"][k][1]] += tab["blocks"]
        for (box, *_), tab in zip(ranks, tabs):
            for q, g in enumerate(tab["gain"]):
                box.targets[q] += g
                assert box.counters[q].item() == box.targets[q]
            for src, w in tab["release"]:
                ranks[src][0].counters[w] += 1
            for w, dst, dr, nf in tab["scatter"]:
                dst[dr:].reshape(-1)[:nf] = box.buf[w:w + nf]
            box.seq += 1
        # every free counter counts the releases of the exchanges before
        for box, *_ in ranks:
            for k in range(len(box.outgoing)):
                assert box.counters[len(box.incoming) + k].item() == seq
    for box, _, _, mu, v in ranks:
        for c in mu:
            assert torch.equal(mu[c], want[0][c]), c
            assert torch.equal(v[c], want[1][c]), c


def test_a_timed_out_wait_raises_by_name():
    box = k5.Mailbox(fake_mesh(2, 0, (2, 2)), "j", 8, "cpu",
                     signalled=False)
    box.raise_if_failed()
    box.signalled = True
    box.counters[len(box.incoming) + len(box.outgoing)] = 2 | (1 << 8)
    with pytest.raises(RuntimeError, match="wait waited for incoming "
                                           "message 1"):
        box.raise_if_failed()
    mesh = fake_mesh(2, 0, (2, 2))
    mesh.mailboxes["x"] = box
    with pytest.raises(RuntimeError, match="more than 10 s"):
        distributed.close_mailboxes(mesh)
    assert not mesh.mailboxes


# --------------------------------------------------------------------------
# (b), (c) the chip suite across 2 and 4 processes, and one process vs JAX
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chip_suite():
    progs = mh.suite("chip", GRID)
    doms = mh.domains(progs)
    return doms, mh.reference(progs, doms, "cpu", SHAPE, 1)


RDMA_PROGRAMS = {"coupled S=1 rdma": "coupled S=1",
                 "coupled S=1 rdma_overlap": "coupled S=1",
                 "coupled S=2 rdma_overlap": "coupled S=2",
                 "rk3 rdma_overlap": "rk3"}


@pytest.mark.parametrize("nproc", [2, 4])
def test_chip_suite_across_processes_is_bit_equal(nproc, chip_suite):
    """Every program of the suite, the rdma ones and the transport alone
    included, over ``nproc`` gloo processes (plain versions, every rank's
    j neighbours in another process) equals one process bit for bit."""
    doms, ref = chip_suite
    res = mh.run(nproc, "cpu", suite_name="chip", grid=GRID,
                 mesh_shape=SHAPE, timeout=240, doms=doms, ref=ref)
    assert res["different"] and not any(res["different"].values()), \
        {k: d for k, d in res["different"].items() if d}
    for tag in RDMA_PROGRAMS:
        assert f"{tag}/t" in res["different"]
    for key in ("rdma exchange/rows", "rdma exchange/mu",
                "rdma exchange/v"):
        assert key in res["different"]
    assert len(res["ranks"]) == nproc
    for rep in res["ranks"]:
        assert len(rep["shards"]) == 4 // nproc
        for tag, r in rep["programs"].items():
            # no kernel on the CPU: the plain versions count nothing
            assert not any(r["launches"].values()), (tag, r["launches"])


def test_one_process_rdma_programs_equal_ppermute(chip_suite):
    """In one process the rdma programs are bit-equal to the same programs
    under ppermute (the chain to JAX: tests/test_torch_overlap.py,
    tests/test_torch_mesh.py)."""
    _, (ref, _) = chip_suite
    for tag, base in RDMA_PROGRAMS.items():
        fields = [k.split("/")[1] for k in ref if k.startswith(base + "/")]
        assert fields
        for f in fields:
            np.testing.assert_array_equal(ref[f"{tag}/{f}"],
                                          ref[f"{base}/{f}"],
                                          err_msg=f"{tag}/{f}")


@functools.lru_cache(maxsize=None)
def _ring2():
    return jax.make_mesh((SHAPE[0],), ("j",), devices=jax.devices()[:2])


def _jax_ring(fn, x):
    f = jax.shard_map(fn, mesh=_ring2(), in_specs=(P("j"),),
                      out_specs=P("j"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def test_one_process_transport_matches_pallas_interpret(chip_suite):
    """The transport program's one-process results (which the processes
    equal, above): ``rdma_rows`` of v's staged edge rows against JAX's
    ``_rdma_rows``, and the refreshed mu and v against JAX's
    ``remote_refresh_axis``, per column ring of the (2,2) mesh, bit for
    bit."""
    doms, (ref, _) = chip_suite
    case, dom = doms[GRID, "balanced"]
    mesh = make_mesh(["cpu"] * 4, SHAPE)
    loop = ShardedAdvanceMuT(*GRID, case.flags, device="cpu", mesh=mesh)
    arrays = loop.prepare(dom)
    local = pad_local({k: arrays[k] for k in ("v", "mu")}, mesh, True, True)
    v = {c: p["v"] for c, p in local.items()}
    mu = {c: p["mu"] for c, p in local.items()}
    nj_loc = next(iter(v.values())).shape[0] - 2
    rows = mh.rdma_rows_input(v, nj_loc)
    width = {"rows": rows[0, 0].shape[-1], "mu": mu[0, 0].shape[-1],
             "v": v[0, 0].shape[-1]}
    for ii in range(SHAPE[1]):
        col = {name: np.concatenate([blocks[jj, ii].numpy()
                                     for jj in range(SHAPE[0])])
               for name, blocks in (("rows", rows), ("mu", mu), ("v", v))}
        want = {
            "rows": _jax_ring(lambda r: jax_halo._rdma_rows(r, "j", 0, True),
                              col["rows"]),
            "mu": _jax_ring(lambda b: jax_halo.remote_refresh_axis(
                b, "j", interpret=True), col["mu"]),
            "v": _jax_ring(lambda b: jax_halo.remote_refresh_axis(
                b, "j", interpret=True), col["v"])}
        for name, w in want.items():
            got = ref[f"rdma exchange/{name}"]
            got = got[..., ii * width[name]:(ii + 1) * width[name]]
            np.testing.assert_array_equal(got, w, err_msg=f"{name} {ii}")


# --------------------------------------------------------------------------
# (d) what the rdma backends refuse
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["rdma", "rdma_overlap"])
def test_neighbours_on_two_hosts_refuse_the_rdma_backends(backend,
                                                          small_case):
    case = small_case
    dims = (case.bounds.ide, case.bounds.jde, case.bounds.kdim)
    two = fake_mesh(2, 0, (2, 2), hosts=["node-a", "node-b"])
    for build in (
            lambda m: SmallStepLoop(*dims, case.flags, n_steps=3,
                                    device="cpu", mesh=m,
                                    halo_backend=backend),
            lambda m: RK3Integrator(*dims, case.flags, acoustic_steps=2,
                                    device="cpu", mesh=m,
                                    halo_backend=backend)):
        with pytest.raises(ValueError, match="two hosts.*node-a.*|"
                                             ".*node-a.*node-b"):
            build(two)
        build(fake_mesh(2, 0, (2, 2), hosts=["node-a", "node-a"]))
    SmallStepLoop(*dims, case.flags, n_steps=3, device="cpu", mesh=two)
    blocks = {c: torch.zeros(6, 4) for c in two.local_coords()}
    with pytest.raises(ValueError, match="two hosts"):
        k5.remote_refresh_multi_plain([blocks], "j", two)
    with pytest.raises(ValueError, match="two hosts"):
        k5.rdma_rows_plain({c: torch.zeros(2, 4) for c in blocks}, "j", two)
    # i neighbours on two hosts are the ppermute form's: no refusal
    Mesh(["cpu"] * 4, (2, 2), owners=[0, 1, 0, 1], backend="gloo",
         hosts=["node-a", "node-b"]).require_one_host("rdma")


def test_pairs_the_mailbox_cannot_serve_raise_by_name(monkeypatch):
    """Neighbours in two processes on cards without peer access, and a rank
    whose boundary shards sit on two cards; no card is touched."""
    cards = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {0, 2})
    mesh = Mesh(cards, (2, 2), owners=[0, 0, 1, 1], backend="nccl")
    with pytest.raises(ValueError, match="cuda:0.*cuda:2.*peer access"):
        mesh.require_one_host("the rdma exchange")
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    mesh = Mesh(cards, (2, 2), owners=[0, 0, 1, 1], backend="nccl")
    with pytest.raises(ValueError, match="rank 0's shards.*two|"
                                         "rank 0's shards.*cuda:0.*cuda:1"):
        mesh.require_one_host("the rdma exchange")
    # one card per rank, and a one-process mesh, pass
    Mesh(cards, (4, 1), owners=[0, 1, 2, 3], backend="nccl"
         ).require_one_host("the rdma exchange")
    Mesh(["cpu"] * 4, (2, 2)).require_one_host("the rdma exchange")
