"""Grid index bookkeeping: domain / memory / tile index triples.

Every field in the framework carries three inclusive 1-based index triples, the
WRF convention used throughout the reference:

  * domain  ``ids:ide, jds:jde, kds:kde`` — the global physical grid,
  * memory  ``ims:ime, jms:jme, kms:kme`` — domain plus halo padding; this is
    the allocated extent of every array,
  * tile    ``its:ite, jts:jte, kts:kte`` — the patch this worker owns.

Arrays are stored as ``(j, k, i)`` C-order ``float32`` — ``i`` is the
contiguous, vectorized dimension (TPU lanes), ``k`` the vertical (sublanes),
``j`` the outermost/decomposed dimension.  This mirrors the reference layout
``I3(i,k,j) = j*kdim*idim + k*idim + i`` (reference: advance_mu_t.c:8-9).

The boundary-condition-aware loop-bound shrinking implemented by
:meth:`GridBounds.loop_bounds` reproduces the logic of the reference kernels
(reference: module_small_step_em.f90:91-106, advance_mu_t.c:84-99).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConfigFlags:
    """The three boundary-condition flags the dynamics kernel consumes.

    (reference: advance_mu_t.h:3-8; only ``periodic_x``, ``specified`` and
    ``nested`` are ever read by the kernel, advance_mu_t.c:90-99.)
    """

    nested: bool = False
    periodic_x: bool = False
    specified: bool = True


@dataclasses.dataclass(frozen=True)
class GridBounds:
    """Domain / memory / tile triples, 1-based inclusive (WRF convention)."""

    ids: int
    ide: int
    jds: int
    jde: int
    kds: int
    kde: int
    ims: int
    ime: int
    jms: int
    jme: int
    kms: int
    kme: int
    its: int
    ite: int
    jts: int
    jte: int
    kts: int
    kte: int

    # ------------------------------------------------------------------ #
    # Constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def for_domain(
        nx: int,
        ny: int,
        nz: int,
        halo: int = 3,
        *,
        origin: int = 1,
    ) -> "GridBounds":
        """Bounds for a single tile covering an ``nx × ny × nz`` domain.

        ``nx``/``ny`` are the *staggered* domain extents (``ide``/``jde``);
        unstaggered mass points run ``ids..ide-1``.  The memory window pads
        the horizontal dimensions by ``halo`` cells on each side, matching the
        reference driver's memory/domain distinction.
        """
        ids, jds, kds = origin, origin, origin
        ide, jde, kde = ids + nx - 1, jds + ny - 1, kds + nz - 1
        return GridBounds(
            ids=ids, ide=ide, jds=jds, jde=jde, kds=kds, kde=kde,
            ims=ids - halo, ime=ide + halo,
            jms=jds - halo, jme=jde + halo,
            kms=kds, kme=kde,
            its=ids, ite=ide, jts=jds, jte=jde, kts=kds, kte=kde,
        )

    # ------------------------------------------------------------------ #
    # Memory extents
    # ------------------------------------------------------------------ #
    @property
    def idim(self) -> int:
        return self.ime - self.ims + 1

    @property
    def jdim(self) -> int:
        return self.jme - self.jms + 1

    @property
    def kdim(self) -> int:
        return self.kme - self.kms + 1

    @property
    def shape3(self) -> tuple[int, int, int]:
        """Allocated array shape ``(jdim, kdim, idim)``."""
        return (self.jdim, self.kdim, self.idim)

    @property
    def shape2(self) -> tuple[int, int]:
        """Allocated array shape ``(jdim, idim)``."""
        return (self.jdim, self.idim)

    # ------------------------------------------------------------------ #
    # 0-based memory offsets (the reference's normalization prologue,
    # advance_mu_t.c:33-55)
    # ------------------------------------------------------------------ #
    def mem(self, idx: int, axis: str) -> int:
        """Convert a 1-based index on ``axis`` ('i'|'j'|'k') to a 0-based
        offset into the allocated array."""
        base = {"i": self.ims, "j": self.jms, "k": self.kms}[axis]
        return idx - base

    def loop_bounds(self, flags: ConfigFlags) -> tuple[int, int, int, int, int, int]:
        """Boundary-condition-aware compute window, as 0-based *inclusive*
        memory offsets ``(i_start, i_end, j_start, j_end, k_start, k_end)``.

        Mirrors the bound shrinking of the reference kernels
        (module_small_step_em.f90:91-106): the staggered domain edge is
        always excluded (``min(ite, ide-1)``), and under specified/nested
        (non-periodic) boundaries one extra row/column is excluded on every
        global domain edge.
        """
        i_start = self.its
        i_end = min(self.ite, self.ide - 1)
        j_start = self.jts
        j_end = min(self.jte, self.jde - 1)
        k_start = self.kts
        k_end = self.kte - 1
        if not flags.periodic_x and (flags.specified or flags.nested):
            i_start = max(self.its, self.ids + 1)
            i_end = min(self.ite, self.ide - 2)
        if flags.specified or flags.nested:
            j_start = max(self.jts, self.jds + 1)
            j_end = min(self.jte, self.jde - 2)
        return (
            self.mem(i_start, "i"),
            self.mem(i_end, "i"),
            self.mem(j_start, "j"),
            self.mem(j_end, "j"),
            self.mem(k_start, "k"),
            self.mem(k_end, "k"),
        )

    # ------------------------------------------------------------------ #
    # Serialization order used by the binary fixture codec
    # ------------------------------------------------------------------ #
    FIELD_ORDER = (
        "ids", "ide", "jds", "jde", "kds", "kde",
        "ims", "ime", "jms", "jme", "kms", "kme",
        "its", "ite", "jts", "jte", "kts", "kte",
    )

    def as_tuple(self) -> tuple[int, ...]:
        return tuple(getattr(self, name) for name in self.FIELD_ORDER)
