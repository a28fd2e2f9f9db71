"""The port's traffic model (``wrf_tpu_torch/utils/traffic.py``) beside the
JAX package's (``wrf_tpu/utils/traffic.py``), and the kernel bounds that
``chip_smoke.py`` computes from it, pinned.

The two models count different kernels: the JAX one the Pallas kernels'
BlockSpecs on (ny+2, nz, nx+2) blocks, with j-tile terms in ``tj`` (a
``3/tj`` boundary-row term, and for the coupled trapezoid ``(6S-3)/tj``);
the port's the CUDA kernels' own streams on the (ny+4, nz, nx+4) block the
loops hand them, with K3's staged overlap as its tile term and no ``tj``.
So each case pins both numbers and the pass term they differ by; where no
tile term enters (what ``with_w`` adds, what bf16 saves) the two agree.
"""

import pytest

import chip_smoke
from wrf_tpu.utils.traffic import substep_traffic as jax_traffic
from wrf_tpu_torch.utils import traffic

GRID = (512, 512, 50)
TJ = 8   # the JAX model's default j-tile

#: case: (keywords, port big_passes, port bytes_per_substep, JAX big_passes,
#: JAX bytes_per_substep), at GRID
CASES = {
    'mu/t S=1': ({'coupled': False}, 7.0, 388734560.0, 7.375, 398143372.0),
    'mu/t S=8': ({'coupled': False, 'S': 8},
        0.875, 47659924.0, 0.921875, 49767921.5),
    'coupled S=1': ({'coupled': True}, 9.0, 496301984.0, 9.375, 509105692.0),
    'coupled S=2': ({'coupled': True, 'S': 2},
        4.5, 365058928.0, 5.0625, 274631742.0),
    'coupled S=4': ({'coupled': True, 'S': 4},
        2.25, 258690336.0, 2.90625, 157262669.0),
    'coupled S=8': ({'coupled': True, 'S': 8},
        1.125, 63037240.0, 1.828125, 98578132.5),
    'coupled S=1 +w': ({'coupled': True, 'with_w': True},
        13.0, 709307784.0, 13.375, 720462492.0),
    'coupled S=2 +w': ({'coupled': True, 'with_w': True, 'S': 2},
        6.5, 353355636.0, 7.0625, 380310142.0),
    'coupled S=8 +w': ({'coupled': True, 'with_w': True, 'S': 8},
        1.625, 90385365.0, 2.328125, 124997732.5),
    'mu/t S=1 bf16': ({'coupled': False, 'bf16': True},
        4.5, 255606560.0, 4.875, 266045372.0),
    'mu/t S=8 bf16': ({'coupled': False, 'S': 8, 'bf16': True},
        0.5625, 31018924.0, 0.609375, 33255671.5),
    'coupled S=1 bf16': ({'coupled': True, 'bf16': True},
        7.5, 416425184.0, 7.875, 429846892.0),
    'coupled S=2 bf16': ({'coupled': True, 'S': 2, 'bf16': True},
        3.75, 299347168.0, 4.3125, 235002342.0),
}

#: chip_smoke.kernel_bounds() rows before the counts moved into
#: utils/traffic.py: (bound_ms, bound_by)
BOUNDS = {
    'k1': (0.14814984597014924, 'bytes'),
    'k1 smdiv': (0.14846776358208955, 'bytes'),
    'k1 full': (0.17898785432835823, 'bytes'),
    'k1 capture': (0.19615540537313433, 'bytes'),
    'k3 S=2': (0.07356416, 'bytes'),
    'k3 S=4': (0.03706611104477612, 'bytes'),
    'k3 S=8': (0.01881708656716418, 'bytes'),
    'k1+w': (0.21173366686567166, 'bytes'),
    'k3 S=2+w': (0.1054792943283582, 'bytes'),
    'k3 S=4+w': (0.053146902089552236, 'bytes'),
    'k3 S=8+w': (0.026980705970149253, 'bytes'),
    'k2 S=8': (0.014226842985074628, 'bytes'),
    'k2 fast S=32': (0.003556710746268657, 'bytes'),
    'k1 lite_ws': (0.1160401671641791, 'bytes'),
    'k1 bf16': (0.12430602507462686, 'bytes'),
    'k1 lite_ws bf16': (0.0763004656716418, 'bytes'),
    'k2 S=8 bf16': (0.009259380298507463, 'bytes'),
    'k3 S=2 bf16': (0.06159604059701492, 'bytes'),
    'k3 S=4 bf16': (0.031035842388059703, 'bytes'),
    'k3 S=8 bf16': (0.01575574328358209, 'bytes'),
    'k1 shard': (0.03732530865671642, 'bytes'),
    'k3 S=2 shard': (0.01874864537313433, 'bytes'),
}


def jax_tile_term(kw) -> float:
    """The JAX model's pass terms that describe Pallas j-tiles: 3/tj boundary
    rows (the mu/t loop, and the coupled loop at S=1), (6S-3)/tj overlap per
    S above."""
    S = kw.get("S", 1)
    if kw["coupled"] and S > 1:
        return (6.0 * S - 3.0) / TJ / S
    return 3.0 / TJ / S


@pytest.mark.parametrize("case", sorted(CASES))
def test_substep_traffic_pinned_beside_jax(case):
    kw, passes, nbytes, jax_passes, jax_bytes = CASES[case]
    t = traffic.substep_traffic(*GRID, **kw)
    assert (t.big_passes, t.bytes_per_substep) == (passes, nbytes)
    j = jax_traffic(*GRID, **kw)
    assert (j.big_passes, j.bytes_per_substep) == (jax_passes, jax_bytes)
    # the passes differ by the JAX model's tile term alone
    assert j.big_passes - t.big_passes == pytest.approx(jax_tile_term(kw),
                                                        rel=1e-12)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_with_w_adds_the_same_passes(S):
    """w and pp read and written: 4 passes per launch in both models."""
    port = [traffic.substep_traffic(*GRID, coupled=True, S=S, with_w=w)
            for w in (False, True)]
    jax = [jax_traffic(*GRID, coupled=True, S=S, with_w=w)
           for w in (False, True)]
    assert port[1].big_passes - port[0].big_passes == 4.0 / S
    assert jax[1].big_passes - jax[0].big_passes == 4.0 / S


@pytest.mark.parametrize("coupled,S,saved", [
    (False, 1, 2.5), (False, 8, 2.5 / 8), (True, 1, 1.5), (True, 2, 0.75),
    (True, 8, 1.5 / 8)])
def test_bf16_halves_only_the_constant_streams(coupled, S, saved):
    """bf16 narrows u, v, t_1, tconst and dvdxi_const in the mu/t loop (5
    half passes) and t_1, tconst and dvdxi_const in the coupled one (3), in
    both models."""
    def passes(model, bf16):
        return model(*GRID, coupled=coupled, S=S, bf16=bf16).big_passes
    for model in (traffic.substep_traffic, jax_traffic):
        assert passes(model, False) - passes(model, True) == saved


def test_with_w_needs_the_coupled_loop():
    with pytest.raises(ValueError, match="coupled"):
        traffic.substep_traffic(*GRID, coupled=False, with_w=True)
    with pytest.raises(ValueError, match="coupled"):
        jax_traffic(*GRID, coupled=False, with_w=True)


def test_k3_tile_term_is_the_staged_overlap():
    """K3's staged form reads its tiles' surroundings beyond one pass of the
    staged operands; the streaming form (S=8, every fuse_w launch) has no
    tile term."""
    for S in (2, 4):
        t = traffic.substep_traffic(*GRID, coupled=True, S=S)
        tile = traffic.k3_tile_bytes(*GRID, S)
        assert tile > 0 and t.tile_bytes == tile / S
        assert t.bytes_per_substep == (traffic.stream_bytes(
            "k3", traffic.padded_block(*GRID, S)) + tile) / S
    assert traffic.k3_tile_bytes(*GRID, 8) == 0
    assert traffic.k3_tile_bytes(*GRID, 2, with_w=True) == 0


def test_stream_counts():
    assert traffic.streams("k1 scan") == (9, 16, 4)
    assert traffic.streams("k1 scan", with_w=True) == (13, 16, 9)
    assert traffic.streams("k1 lite") == (7, 15, 4)
    assert traffic.streams("k1 full") == (11, 13, 4)
    assert traffic.streams("k2", bf16=True) == (4.5, 8, 4)
    assert traffic.streams("k3", bf16=True) == (7.5, 11, 4)
    assert traffic.padded_block(*GRID) == (516, 50, 516)
    assert traffic.padded_block(*GRID, S=4) == (522, 50, 516)


@pytest.mark.parametrize("row", sorted(BOUNDS))
def test_kernel_bounds_rows_unchanged(row):
    """Every row of the kernels line's bounds keeps its value now that the
    counts come from utils/traffic.py."""
    assert chip_smoke.kernel_bounds()[row] == BOUNDS[row]


def test_kernel_bounds_rows_are_all_pinned():
    assert chip_smoke.kernel_bounds().keys() == BOUNDS.keys()
