"""Differential-verification comparators.

The reference validates every implementation tier against golden outputs with
a fixed metric suite: exact-equal / different counts, max relative error, max
absolute error, max ULP distance (lexicographic two's-complement
reinterpretation) and RMSE, with NaN tripwires that abort the comparison
(reference: advance_mu_t_driver.c:543-653, common.cu:51-164).  This module is
the framework-native version of that suite, vectorized with numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class NaNError(ValueError):
    """Raised when either side of a comparison contains a NaN
    (the reference aborts on NaN at compare time,
    advance_mu_t_driver.c:584-593)."""


def float_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise ULP distance between two float32 arrays.

    Reinterprets the bits as int32 and maps negative floats onto a
    lexicographically ordered two's-complement scale so that adjacent
    representable floats differ by exactly 1
    (reference: common.cu:51-66, advance_mu_t_driver.c:656-671).
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return np.abs(ai - bi)


@dataclasses.dataclass(frozen=True)
class CompareResult:
    """The reference's per-field verification report
    (advance_mu_t_driver.c:639-650), extended with the element-wise
    acceptance verdict when tolerances were supplied to :func:`compare`."""

    name: str
    n: int
    equal: int
    different: int
    max_rel_err: float
    max_abs_err: float
    max_ulp: int
    rmse: float
    max_abs_pos: int
    max_rel_pos: int
    #: element-wise acceptance (set when tolerances were given to compare):
    #: max over elements of |a-g| / (atol + rtol*|g|); pass iff <= 1
    max_scaled_err: float | None = None
    #: number of elements outside the per-element tolerance envelope
    n_far: int | None = None

    @property
    def all_equal(self) -> bool:
        return self.different == 0

    @property
    def passed(self) -> bool:
        """Element-wise acceptance: every element satisfies
        ``|a-g| <= atol + rtol*|g|`` (the tests' ``assert_allclose``
        convention — strictly stronger than any gate on the recorded
        maxima).  Requires tolerances to have been passed to
        :func:`compare`."""
        if self.max_scaled_err is None:
            raise ValueError(
                f"{self.name}: compare() was called without tolerances; "
                "pass rtol/atol (or atol_scale) to enable acceptance")
        return self.max_scaled_err <= 1.0

    def __str__(self) -> str:  # mirrors the reference report format
        s = (
            f"{self.name}: equal={self.equal} different={self.different} "
            f"max_rel={self.max_rel_err:.6e} max_abs={self.max_abs_err:.6e} "
            f"max_ulp={self.max_ulp} rmse={self.rmse:.6e}"
        )
        if self.max_scaled_err is not None:
            s += f" scaled_err={self.max_scaled_err:.3f} far={self.n_far}"
        return s


def compare(
    actual: np.ndarray,
    golden: np.ndarray,
    name: str = "field",
    *,
    nan_check: bool = True,
    rtol: float | None = None,
    atol: float | None = None,
    atol_scale: float | None = None,
) -> CompareResult:
    """Full-array comparison with the reference metric suite
    (advance_mu_t_driver.c:543-653).

    When ``rtol`` is given, also records the ELEMENT-WISE acceptance
    ``|a-g| <= atol + rtol*|g|`` (``CompareResult.passed``).  ``atol`` is
    the absolute floor; ``atol_scale`` instead derives it per field as
    ``atol_scale * max(1, max|golden|)`` — reduction reassociation produces
    absolute errors proportional to the field scale, which near-zero
    elements would otherwise turn into unbounded relative errors."""
    actual = np.asarray(actual, dtype=np.float32)
    golden = np.asarray(golden, dtype=np.float32)
    if actual.shape != golden.shape:
        raise ValueError(
            f"{name}: shape mismatch {actual.shape} vs {golden.shape}"
        )
    a = actual.ravel()
    g = golden.ravel()
    if nan_check:
        if np.isnan(a).any():
            raise NaNError(f"{name}: actual output contains NaN")
        if np.isnan(g).any():
            raise NaNError(f"{name}: golden data contains NaN")

    abs_err = np.abs(g - a)
    denom = np.maximum(np.abs(g), np.abs(a))
    # Where either side is exactly zero the reference uses the magnitude of
    # the other side as the "relative" error (advance_mu_t_driver.c:595-598).
    both_nonzero = (np.abs(g) != 0.0) & (np.abs(a) != 0.0)
    rel_err = np.where(both_nonzero, abs_err / np.where(denom == 0, 1, denom), denom)

    ulp = float_ulps(g, a)
    eq = a == g
    n = a.size
    rmse = float(np.sqrt(np.mean(abs_err.astype(np.float64) ** 2))) if n else 0.0

    max_scaled_err = None
    n_far = None
    if rtol is not None:
        if atol is None:
            scale = float(np.abs(g).max()) if n else 1.0
            atol = (atol_scale or 0.0) * max(scale, 1.0)
        tol = atol + rtol * np.abs(g)
        scaled = abs_err / np.maximum(tol, np.finfo(np.float32).tiny)
        max_scaled_err = float(scaled.max()) if n else 0.0
        n_far = int((abs_err > tol).sum())

    return CompareResult(
        name=name,
        n=n,
        equal=int(eq.sum()),
        different=int(n - eq.sum()),
        max_rel_err=float(rel_err.max()) if n else 0.0,
        max_abs_err=float(abs_err.max()) if n else 0.0,
        max_ulp=int(ulp.max()) if n else 0,
        rmse=rmse,
        max_abs_pos=int(abs_err.argmax()) if n else -1,
        max_rel_pos=int(rel_err.argmax()) if n else -1,
        max_scaled_err=max_scaled_err,
        n_far=n_far,
    )


def assert_outputs_allclose(actual: dict, golden: dict, *,
                            rtol: float = 2e-5, atol_scale: float = 1e-6,
                            fields=None) -> None:
    """Assert two output dicts agree element-wise within fp32 tolerances —
    THE shared acceptance function (driver gate and test suite use the same
    formula: ``|a-g| <= atol_scale*max(1,max|g|) + rtol*|g|``)."""
    for name in fields or actual.keys():
        r = compare(actual[name], golden[name], name,
                    rtol=rtol, atol_scale=atol_scale)
        if not r.passed:
            raise AssertionError(f"field {name} outside tolerance: {r}")


def compare_window(
    actual: np.ndarray,
    golden: np.ndarray,
    name: str,
    i_slice: slice,
    j_slice: slice,
    k_slice: slice | None = None,
    s_slice: slice | None = None,
    **kw,
) -> CompareResult:
    """Windowed comparison restricted to a tile/interior region.

    The reference deliberately excludes halo/boundary cells from the pass
    criteria for 2-D outputs and for multi-GPU runs
    (advance_mu_t_driver.c:417-541 ``compare_2d_t``,
    advance_mu_t_driver.cu:190-203); its 4-D variant windows the species
    axis too (``compare_4d``, common.cu:344-427).  ``actual``/``golden``
    are ``(j, i)``, ``(j, k, i)`` or ``(s, j, k, i)`` arrays.
    """
    if actual.ndim == 2:
        return compare(actual[j_slice, i_slice], golden[j_slice, i_slice], name, **kw)
    ks = k_slice if k_slice is not None else slice(None)
    if actual.ndim == 3:
        return compare(
            actual[j_slice, ks, i_slice], golden[j_slice, ks, i_slice], name, **kw
        )
    if actual.ndim == 4:
        ss = s_slice if s_slice is not None else slice(None)
        return compare(
            actual[ss, j_slice, ks, i_slice],
            golden[ss, j_slice, ks, i_slice], name, **kw
        )
    raise ValueError(f"{name}: expected 2-4-D array, got ndim={actual.ndim}")
