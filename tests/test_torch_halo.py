"""The port's halo exchange (``parallel/halo.py``, the ``ppermute`` backend,
and ``ops/halo_rdma_cuda.py``, K5's plain version) against the JAX package's
``parallel/halo.py`` under ``shard_map`` on the virtual CPU devices.

Every comparison is exact: an exchange moves values, it computes nothing.
The JAX functions take one local block inside ``shard_map``; the port's take
all the blocks of a field (``scatter`` of the same global numpy array) and
the mesh.  The per-shard padded blocks are compared through their
concatenation (``out_specs`` on the JAX side, ``gather`` on the port's).
The Pallas remote-DMA exchange runs in interpret mode on a one-axis mesh of
8, as tests/test_sharded.py runs it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from wrf_tpu.parallel import halo as jax_halo
from wrf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_tpu_torch.ops import halo_rdma_cuda as k5
from wrf_tpu_torch.parallel import halo
from wrf_tpu_torch.parallel.mesh import make_mesh, make_mesh_1d
from wrf_tpu_torch.parallel.sharded import gather, scatter

torch.set_num_threads(1)

MESHES = [(8, 1), (2, 2)]
NJ_LOC, NI_LOC, NK = 4, 6, 3


def _meshes(shape):
    n = shape[0] * shape[1]
    return (jax_make_mesh(jax.devices()[:n], shape),
            make_mesh(["cpu"] * n, shape))


def _field(shape, ndim, seed, pad=0):
    """A global array whose local blocks are (NJ_LOC+pad, [NK,] NI_LOC+pad)."""
    rng = np.random.default_rng(seed)
    J, I = shape[0] * (NJ_LOC + pad), shape[1] * (NI_LOC + pad)
    dims = (J, NK, I) if ndim == 3 else (J, I)
    return rng.standard_normal(dims).astype(np.float32)


def _spec(ndim):
    return P("j", None, "i") if ndim == 3 else P("j", "i")


def _jax_run(fn, jmesh, *xs):
    specs = tuple(_spec(x.ndim) for x in xs)
    f = jax.shard_map(fn, mesh=jmesh, in_specs=specs,
                      out_specs=specs if len(xs) > 1 else specs[0],
                      check_vma=False)
    out = jax.jit(f)(*(jnp.asarray(x) for x in xs))
    return [np.asarray(o) for o in out] if len(xs) > 1 else np.asarray(out)


def _port_run(fn, mesh, x):
    return gather(fn(scatter(x, mesh)), mesh).numpy()


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_halo_construction_matches_jax(shape, ndim):
    """halo3/halo2: exchanged on the sharded axes, zero-padded elsewhere."""
    jmesh, mesh = _meshes(shape)
    j_sh, i_sh = shape[0] > 1, shape[1] > 1
    x = _field(shape, ndim, seed=1)
    jfn, pfn = ((jax_halo.halo3, halo.halo3) if ndim == 3
                else (jax_halo.halo2, halo.halo2))
    want = _jax_run(lambda b: jfn(b, j_sh, i_sh), jmesh, x)
    got = _port_run(lambda b: pfn(b, mesh, j_sh, i_sh), mesh, x)
    np.testing.assert_array_equal(got, want)
    # the constructors return new blocks and leave their input alone
    blocks = scatter(x, mesh)
    before = {c: b.clone() for c, b in blocks.items()}
    pfn(blocks, mesh, j_sh, i_sh)
    assert all(torch.equal(blocks[c], before[c]) for c in blocks)


@pytest.mark.parametrize("axis_name", ["j", "i"])
@pytest.mark.parametrize("shape", MESHES)
def test_exchange_axis_matches_jax(shape, axis_name):
    """A ring of one (the i axis of the (8,1) mesh) exchanges with itself."""
    jmesh, mesh = _meshes(shape)
    x = _field(shape, 3, seed=2)
    axis = 0 if axis_name == "j" else 2
    want = _jax_run(lambda b: jax_halo.exchange_axis(b, axis, axis_name),
                    jmesh, x)
    got = _port_run(lambda b: halo.exchange_axis(b, axis, axis_name, mesh),
                    mesh, x)
    np.testing.assert_array_equal(got, want)


def test_pad_axis_matches_jax():
    x = _field((1, 1), 3, seed=3)
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(
            halo.pad_axis(torch.tensor(x), axis).numpy(),
            np.asarray(jax_halo.pad_axis(jnp.asarray(x), axis)))


@pytest.mark.parametrize("n_interior", [None, NJ_LOC - 1])
@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_refresh_axis_matches_jax(shape, ndim, n_interior):
    """Already-padded blocks (random halo cells): both axes refreshed in
    the loop's order, in place on the port's side; ``n_interior`` one less
    than the block's own leaves a row of alignment padding after the high
    halo, as the JAX loop's blocks have."""
    jmesh, mesh = _meshes(shape)
    x = _field(shape, ndim, seed=4, pad=2)
    i_axis = ndim - 1
    ni = None if n_interior is None else NI_LOC - 1

    def jfn(b):
        b = jax_halo.refresh_axis(b, 0, "j", n_interior)
        return jax_halo.refresh_axis(b, i_axis, "i", ni)

    def pfn(blocks):
        out = halo.refresh_axis(blocks, 0, "j", mesh, n_interior)
        assert out is blocks
        return halo.refresh_axis(blocks, i_axis, "i", mesh, ni)

    np.testing.assert_array_equal(_port_run(pfn, mesh, x),
                                  _jax_run(jfn, jmesh, x))


@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_widen_and_refresh_ring_match_jax(shape, ndim, width):
    """Ring-1 blocks grown to ring-S from the neighbours' interiors on the
    sharded axes (zeros elsewhere), then every ring cell refreshed with one
    width-S exchange per direction."""
    jmesh, mesh = _meshes(shape)
    jn = "j" if shape[0] > 1 else None
    inn = "i" if shape[1] > 1 else None
    i_axis = ndim - 1
    x = _field(shape, ndim, seed=5, pad=2)

    def jwiden(b):
        b = jax_halo.widen_ring_to(b, 0, jn, NJ_LOC, width)
        return jax_halo.widen_ring_to(b, i_axis, inn, NI_LOC, width)

    def pwiden(blocks):
        blocks = halo.widen_ring_to(blocks, 0, width, jn, mesh, NJ_LOC)
        return halo.widen_ring_to(blocks, i_axis, width, inn, mesh, NI_LOC)

    wide_j = _jax_run(jwiden, jmesh, x)
    wide = _port_run(pwiden, mesh, x)
    np.testing.assert_array_equal(wide, wide_j)

    def jrefresh(b):
        b = jax_halo.refresh_axis_w(b, 0, "j", NJ_LOC, width)
        return jax_halo.refresh_axis_w(b, i_axis, "i", NI_LOC, width)

    def prefresh(blocks):
        halo.refresh_axis_w(blocks, 0, "j", mesh, NJ_LOC, width)
        return halo.refresh_axis_w(blocks, i_axis, "i", mesh, NI_LOC, width)

    # from noise in the ring cells, so a cell left alone would show
    noisy = wide + np.random.default_rng(6).standard_normal(
        wide.shape).astype(np.float32)
    np.testing.assert_array_equal(_port_run(prefresh, mesh, noisy),
                                  _jax_run(jrefresh, jmesh, noisy))
    # strip_ring is the inverse of the widening on every block
    for c, b in pwiden(scatter(x, mesh)).items():
        back = halo.strip_ring(halo.strip_ring(b, 0, width), i_axis, width)
        assert torch.equal(back, scatter(x, mesh)[c])


def test_widen_ring_needs_enough_interior_cells():
    _, mesh = _meshes((2, 2))
    blocks = scatter(_field((2, 2), 3, seed=7, pad=2), mesh)
    with pytest.raises(ValueError, match="ring-5 needs >= 5 interior cells "
                                         "per shard along 'j', got 4"):
        halo.widen_ring_to(blocks, 0, 5, "j", mesh, NJ_LOC)
    with pytest.raises(ValueError, match="ring-5 needs"):
        jax_halo.widen_ring_to(jnp.zeros((6, 3, 8)), 0, "j", NJ_LOC, 5)
    same = halo.widen_ring_to(blocks, 0, 1, "j", mesh, NJ_LOC)
    assert same is blocks


# ---------------------------------------------------------------------
# K5's plain version against the Pallas remote-DMA exchange (interpret
# mode, one-axis mesh of 8: tests/test_sharded.py's three cases)
# ---------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ring8():
    return (jax.make_mesh((8,), ("j",), devices=jax.devices()[:8]),
            make_mesh_1d(["cpu"] * 8))


def _jax_ring(fn, *xs):
    jmesh, _ = _ring8()
    specs = tuple(P("j") for _ in xs)
    f = jax.shard_map(fn, mesh=jmesh, in_specs=specs,
                      out_specs=specs if len(xs) > 1 else specs[0],
                      check_vma=False)
    out = jax.jit(f)(*(jnp.asarray(x) for x in xs))
    return [np.asarray(o) for o in out] if len(xs) > 1 else np.asarray(out)


def test_rdma_rows_plain_matches_pallas_interpret():
    """The bare 2-slot exchange: slot 0 to the next shard's slot 0, slot 1
    to the previous shard's slot 1.  The TPU buffer is (2, 1, flat) per
    shard with flat a multiple of 128; the port's has no such rules."""
    _, mesh = _ring8()
    rows = np.random.default_rng(8).standard_normal(
        (8 * 2, 1, 128)).astype(np.float32)
    want = _jax_ring(lambda r: jax_halo._rdma_rows(r, "j", 0, True), rows)
    blocks = scatter(rows, mesh)
    got = k5.rdma_rows(blocks, "j", mesh)          # CPU blocks: the plain one
    np.testing.assert_array_equal(gather(got, mesh).numpy(), want)
    plain = k5.rdma_rows_plain(blocks, "j", mesh)
    assert all(torch.equal(plain[c], got[c]) for c in got)
    assert all(got[c] is not blocks[c] for c in got)
    # an odd, unpadded row length is fine here
    odd = scatter(rows[:, :, :37].copy(), mesh)
    recv = k5.rdma_rows_plain(odd, "j", mesh)
    assert torch.equal(recv[3, 0][0], odd[2, 0][0])
    assert torch.equal(recv[3, 0][1], odd[4, 0][1])


def test_remote_refresh_axis_matches_pallas_interpret():
    _, mesh = _ring8()
    x = np.random.default_rng(5).standard_normal(
        (8 * 6, 4, 16)).astype(np.float32)
    want = _jax_ring(lambda b: jax_halo.remote_refresh_axis(
        jax_halo.pad_axis(b, 0), "j", interpret=True), x)
    padded = {c: halo.pad_axis(b, 0) for c, b in scatter(x, mesh).items()}
    got = k5.remote_refresh_axis(padded, "j", mesh)
    assert got is padded
    np.testing.assert_array_equal(gather(got, mesh).numpy(), want)
    # ... which is what the ppermute refresh gives
    perm = halo.refresh_axis({c: halo.pad_axis(b, 0) for c, b in
                              scatter(x, mesh).items()}, 0, "j", mesh)
    assert all(torch.equal(perm[c], got[c]) for c in got)


def test_remote_refresh_inside_a_loop_matches_pallas_interpret():
    """The exchange composed as the loop uses it: refresh, then an interior
    update that reads the fresh halo rows, three times (the JAX side under
    ``lax.scan``)."""
    _, mesh = _ring8()
    x = np.random.default_rng(9).standard_normal(
        (8 * 4, 3, 16)).astype(np.float32)

    def local(blk):
        def body(state, _):
            state = jax_halo.remote_refresh_axis(state, "j", interpret=True)
            upd = state[:-2] + state[2:]
            return state.at[1:-1].set(0.5 * upd), None
        return jax.lax.scan(body, jax_halo.pad_axis(blk, 0), length=3)[0]

    want = _jax_ring(local, x)
    state = {c: halo.pad_axis(b, 0) for c, b in scatter(x, mesh).items()}
    for _ in range(3):
        k5.remote_refresh_axis(state, "j", mesh)
        state = {c: torch.cat([s[:1], 0.5 * (s[:-2] + s[2:]), s[-1:]])
                 for c, s in state.items()}
    np.testing.assert_array_equal(gather(state, mesh).numpy(), want)


def test_remote_refresh_multi_matches_pallas_interpret():
    """One exchange for a field set, 3-D and 2-D mixed, one field
    receive-only ("hi": its low halo row is left alone)."""
    _, mesh = _ring8()
    rng = np.random.default_rng(11)
    a3 = rng.standard_normal((8 * 4, 3, 20)).astype(np.float32)
    b2 = rng.standard_normal((8 * 4, 20)).astype(np.float32)
    c3 = rng.standard_normal((8 * 4, 3, 20)).astype(np.float32)

    def local(a, b, c):
        a, b, c = (jax_halo.pad_axis(x, 0) for x in (a, b, c))
        return tuple(jax_halo.remote_refresh_multi(
            [a, b, c], "j", a.shape[0] - 2, recv_only=("", "", "hi"),
            interpret=True))

    want = _jax_ring(local, a3, b2, c3)
    fields = [{c: halo.pad_axis(b, 0) for c, b in scatter(x, mesh).items()}
              for x in (a3, b2, c3)]
    got = k5.remote_refresh_multi(fields, "j", mesh, 4,
                                  recv_only=("", "", "hi"))
    assert got is fields
    for g, w in zip(got, want):
        np.testing.assert_array_equal(gather(g, mesh).numpy(), w)
    assert all(not b[0].any() for b in got[2].values())     # low halo: zeros
    assert all(b[0].any() for b in got[0].values())


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2)])
def test_remote_refresh_on_a_2d_mesh_equals_ppermute(shape):
    """Every mesh column runs its own j ring (a ring of one on 1x1: both
    rows come back to the sender)."""
    _, mesh = _meshes(shape)
    x3 = _field(shape, 3, seed=12, pad=2)
    x2 = _field(shape, 2, seed=13, pad=2)
    got = k5.remote_refresh_multi_plain([scatter(x3, mesh), scatter(x2, mesh)],
                                        "j", mesh, NJ_LOC)
    want = [halo.refresh_axis(scatter(x, mesh), 0, "j", mesh, NJ_LOC)
            for x in (x3, x2)]
    for g, w in zip(got, want):
        assert all(torch.equal(g[c], w[c]) for c in w)
    if shape == (1, 1):
        b = got[0][0, 0]
        assert torch.equal(b[0], b[NJ_LOC])
        assert torch.equal(b[NJ_LOC + 1], b[1])


def test_exchange_argument_checks():
    _, mesh = _meshes((2, 2))
    good = scatter(_field((2, 2), 3, seed=14, pad=2), mesh)
    with pytest.raises(TypeError, match="float32"):
        k5.remote_refresh_axis({c: b.double() for c, b in good.items()}, "j",
                               mesh)
    with pytest.raises(ValueError, match="contiguous"):
        k5.remote_refresh_axis({c: b.transpose(1, 2) for c, b in
                                good.items()}, "j", mesh)
    with pytest.raises(ValueError, match="2-slot"):
        k5.rdma_rows(good, "j", mesh)
    assert k5.LAUNCHES == 0      # nothing here ran on a card
