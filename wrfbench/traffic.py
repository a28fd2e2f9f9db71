"""Frozen copy of the port's traffic model (``wrf_tpu_torch/utils/traffic.py``).

The benchmark's yardstick: the bytes each kernel form moves and the float32
operations per cell, counted from the kernels' streams.  It is a copy and
imports nothing of the program, so a change to the program cannot move the
bound a roofline share is read against; ``wrfbench/tests/test_wrfbench_traffic.py``
holds it equal to the program's model at the cells' shapes.  Left out of
the copy: K3's staged-tile term (``k3_tile_bytes``), which needs the
program's tile plan; no cell's path launches K3, and
:func:`substep_traffic` refuses the K3 form.

The model's own description follows.

Device-memory traffic of the port's kernels: the streams each form moves.

Port of ``wrf_tpu/utils/traffic.py``.  The JAX model enumerates the Pallas
kernels' operand streams from their BlockSpecs; this one counts the port
kernels' own streams, from their arguments, per launch:

* K1's fused scan substep (``advance_mu_t_fused(fuse_uv=True)``, the
  coupled loop at S=1) reads u, v, t, t_1, tconst and dvdxi_const and
  writes u, v and t: 9 passes, with 11 2-D fields in and 5 out and the 4
  vertical vectors; ``fuse_w`` adds w and pp read and written (13 passes)
  and 5 K-vectors;
* K1's lean lite substep (the mu/t loop at S=1) reads the same six and
  writes t: 7 passes, 10 2-D fields in and 5 out;
* K1's plain full call (the reference's) reads ww_1, u, u_1, v, v_1, t,
  t_1 and ft and writes ww, t and t_ave: 11 passes, 9 2-D in and 4 out;
  damping reads one more 2-D field (mudf_in), and the capture writes one
  more 3-D and four more 2-D fields;
* K2 (the blocked mu/t loop) moves K1-lite's 7 passes, 6 2-D fields in
  and 2 out, once per launch of S substeps;
* K3 (the coupled trapezoid) moves K1-scan's 9 passes with 9 2-D fields
  in and 2 out, once per launch of S substeps, at its ring-S block, (J +
  2(S-1), K, I).  Its staged form (``ops/advance_mu_t_coupled_cuda.py``,
  ``plan``) fills shared memory per tile with the rows and columns around
  the tile as well: :func:`substep_traffic` counts ``staged_bytes`` per
  launch less the one pass of the staged operands already counted (the
  tile term).  The streaming form stages nothing, and its per-substep
  re-reads, which go through L1 and L2, are not modelled.

bf16 constant streams count at half width: K1's scan and K3 narrow t_1,
tconst and dvdxi_const (3 of 9 passes), K1's lite substep and K2 also u and
v (5 of 7).

The JAX model's ``tj`` argument, its ``3/tj`` boundary-row term and its
``(6S-3)/tj`` overlap term describe Pallas j-tiles that the port does not
have, so there is no ``tj`` here: the port's tile term is K3's staged
overlap above.  Every block is the one the loops hand the kernels: the
ring-shaped domain with its 1-cell halo, (ny+4, nz, nx+4), where the JAX
model counts (ny+2, nz, nx+2).

``chip_smoke.py::kernel_bounds`` divides these bytes by the card's memory
rate for the bound of each kernel row; the float32 operations per cell
(:data:`OPS_PER_CELL`) give the other side of that bound.
"""

from __future__ import annotations

from dataclasses import dataclass

#: float32 operations per cell (one level of one column) and substep,
#: counted from the kernels' arithmetic: K1's fused scan substep (wind
#: rebuild, dvdxi, dmdt, ww scan, theta), K2's lean substep (winds scaled,
#: no wind update), and what the w/pp solve adds (rhs, two sweeps, pp);
#: K2's fast form per cell and LAUNCH, whatever S (its two passes: the
#: column sums, the cumsums, the G terms and the summed update)
OPS_PER_CELL = {"k1": 46, "k2": 42, "w": 25, "k2 fast": 67}

#: (3-D passes, 2-D fields, vertical vectors) one launch of each form moves
STREAMS = {
    "k1 scan": (9, 16, 4),
    "k1 smdiv": (9, 17, 4),
    "k1 full": (11, 13, 4),
    "k1 capture": (12, 17, 4),
    "k1 lite": (7, 15, 4),
    "k2": (7, 8, 4),
    "k3": (9, 11, 4),
}
#: what ``fuse_w`` adds: w and pp read and written, and 5 K-vectors
W_STREAMS = (4, 0, 5)
#: the 3-D passes of each form that bf16 constant streams narrow
BF16_NARROWED = {"k1 scan": 3, "k1 lite": 5, "k2": 5, "k3": 3}


def field_bytes(shape, n3, n2, n1) -> int:
    """Bytes of ``n3`` 3-D, ``n2`` 2-D and ``n1`` vertical float32 fields
    of a (J, K, I) block (a bf16 field counts as half a field)."""
    J, K, I = shape
    return int(4 * (n3 * J * K * I + n2 * J * I + n1 * K))


def streams(form: str, *, with_w: bool = False, bf16: bool = False):
    """(3-D passes, 2-D fields, vertical vectors) of one launch of
    ``form`` (a key of :data:`STREAMS`)."""
    n3, n2, n1 = STREAMS[form]
    if with_w:
        n3, n2, n1 = n3 + W_STREAMS[0], n2 + W_STREAMS[1], n1 + W_STREAMS[2]
    if bf16:
        n3 -= 0.5 * BF16_NARROWED[form]
    return n3, n2, n1


def stream_bytes(form: str, shape, *, with_w: bool = False,
                 bf16: bool = False) -> int:
    """Bytes one launch of ``form`` moves on a ``shape`` block, each
    stream read or written once."""
    return field_bytes(shape, *streams(form, with_w=with_w, bf16=bf16))


def padded_block(nx: int, ny: int, nz: int, S: int = 1) -> tuple:
    """The block the loops hand the kernels for an nx x ny x nz domain on
    one shard: the ring-shaped arrays with their 1-cell halo, widened to
    ring S in j for K3."""
    return (ny + 4 + 2 * (S - 1), nz, nx + 4)


@dataclass(frozen=True)
class Traffic:
    bytes_per_substep: float
    big_passes: float          # 3-D passes per substep at ``block``
    detail: str
    block: tuple = ()
    tile_bytes: float = 0.0    # per substep, in bytes_per_substep


def substep_traffic(nx: int, ny: int, nz: int, *, coupled: bool,
                    with_w: bool = False, S: int = 1,
                    bf16: bool = False) -> Traffic:
    """Modelled device-memory bytes per substep of a loop's scan body on an
    nx x ny x nz domain on one shard: the mu/t loop (K1 lite at S=1, K2
    per S above) or the coupled loop (K1 scan at S=1, K3 per S above, with
    its tile term); ``with_w`` (coupled only) adds the w/pp solve and
    ``bf16`` the narrow constant streams."""
    if S < 1:
        raise ValueError("S must be >= 1")
    if with_w and not coupled:
        raise ValueError("with_w requires the coupled loop")
    if not coupled:
        form = "k1 lite" if S == 1 else "k2"
    else:
        form = "k1 scan" if S == 1 else "k3"
    block = padded_block(nx, ny, nz, S if form == "k3" else 1)
    n3, n2, n1 = streams(form, with_w=with_w, bf16=bf16)
    per_launch = field_bytes(block, n3, n2, n1)
    if form == "k3":
        raise ValueError("K3's staged-tile term is not frozen here: no "
                         "cell's path launches K3")
    tile = 0
    det = (f"{form} S={S}{' +w' if with_w else ''}{' bf16' if bf16 else ''}"
           f": ({n3:g} 3-D + {n2:g} 2-D + {n1:g} vectors at "
           f"{'x'.join(map(str, block))}"
           + (f" + {tile / 1e6:.1f} MB staged overlap" if tile else "")
           + (f")/{S}" if S > 1 else ")"))
    return Traffic(bytes_per_substep=(per_launch + tile) / S,
                   big_passes=n3 / S, detail=det, block=block,
                   tile_bytes=tile / S)
