"""Host-side precompute of the implicit w/pp solve the fused kernels run.

Port of ``_thomas_coeffs``, ``_thomas_hoisted`` and ``_thomas_fast_vectors``
of ``wrf_tpu/ops/advance_mu_t_msteps.py``.  The tridiagonal system of
``ops/advance_w.py`` has level-constant coefficients, the same in every
column and substep, so the K1 and K3 wrappers compute them once, on the
host in float32 numpy, and hand K-vectors to the kernel and to its plain
version: the sub-diagonal ``a``, the Thomas forward-elimination
``c'``/denominator recurrence hoisted to ``cp``/``den``, the rhs row
factors ``crdn``/``erdn`` and, for the plain version's ``fast`` mode, the
scale vectors of the log-depth cumsum form.

The float32 association is the contract (the kernels are held bit for bit
against their plain versions, and those against the numpy golden path):
``((cb*cb)*rdn)*roll(rdnw, 1)``, ``(1 + a) + b``, and the recurrence
``den = d + a*cp_prev; cp = -b/den`` run sequentially, one level at a time.

:func:`thomas_vectors` bundles them for a wrapper, and a loop passes the
bundle to every substep (``thomas=``).  A loop keeps its bundles in its
memo's :class:`ThomasCache` across calls: its ``prepare`` registers host
copies of ``rdn``/``rdnw`` beside the tensors it made, so no call reads
them back from the card, and each stage's ``dts`` uploads its K-vectors
once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = np.float32


def thomas_coeffs(rdn, rdnw, dts, epssm, cw, gw, K: int, k0: int, k1: int):
    """Thomas coefficients of the implicit w/pp system, float32 numpy.
    Returns ``(c_w, g_t, a, b, diag, crdn, erdn)``: two scalars and five
    K-vectors; ``a``/``b`` are zero outside the interior band k0 < k <= k1."""
    dts_f, epssm_f = F32(dts), F32(epssm)
    c_w = F32(cw) * dts_f
    g_t = dts_f * F32(gw)
    beta = F32(0.5) * (F32(1.0) + epssm_f)
    alfa = F32(1.0) - beta
    cb = c_w * beta
    rdn = np.asarray(rdn, F32)
    rdnw = np.asarray(rdnw, F32)
    kv = np.arange(K)
    band = (kv > k0) & (kv <= k1)
    a = np.where(band, ((cb * cb) * rdn) * np.roll(rdnw, 1), F32(0.0))
    b = np.where(band, ((cb * cb) * rdn) * rdnw, F32(0.0))
    diag = (F32(1.0) + a) + b
    crdn = c_w * rdn
    erdn = ((c_w * beta) * (c_w * alfa)) * rdn
    return c_w, g_t, a, b, diag, crdn, erdn


def thomas_hoisted(a, b, diag):
    """The forward-elimination recurrence as K-vectors ``(cp, den)``:
    ``den_k = diag_k + a_k*cp_{k-1}``, ``cp_k = -b_k/den_k``, ``cp`` seeded
    at 0 — the float32 operations a per-column sweep performs, in its
    order.  Outside the interior band ``a = b = 0`` and ``diag = 1``, so
    ``den = 1`` and ``cp = 0`` fall out without masking."""
    K = len(a)
    cp = np.zeros(K, F32)
    den = np.zeros(K, F32)
    cp_prev = F32(0.0)
    for k in range(K):
        den[k] = diag[k] + a[k] * cp_prev
        cp[k] = -b[k] / den[k]
        cp_prev = cp[k]
    return cp, den


def thomas_fast_vectors(a, cp, den, K: int, k0: int, k1: int):
    """Scale vectors ``(fws, fwp, bws, bwp)`` of the log-depth (``fast``)
    solve.  Forward: ``dpw[k] = P_k * cumsum(rhs/(den P))`` with ``P`` the
    cumulative product of ``a/den`` over the interior band; backward:
    ``w[k] = M_k * revcumsum(dpw/M)`` with ``M_k`` the product of ``-cp``
    from k up to the band top.  Both factors are below 1 in magnitude, so
    the products decay geometrically; beyond about 120 interior levels they
    leave the float32 range and the exact solve must be used."""
    one, zero = F32(1.0), F32(0.0)
    kv = np.arange(K)
    band = (kv > k0) & (kv <= k1)
    alpha = np.where(band, a / den, one)
    P = np.cumprod(alpha, dtype=F32)
    fws = np.where(band, one / (den * P), zero)
    fwp = np.where(band, P, zero)
    mm = np.where((kv > k0) & (kv < k1), -cp, one)
    M = np.cumprod(mm[::-1], dtype=F32)[::-1]
    bws = np.where(band, one / M, zero)
    bwp = np.where(band, M, zero)
    return fws, fwp, bws, bwp


@dataclasses.dataclass(frozen=True)
class ThomasVectors:
    """What a fused w/pp solve needs besides the fields: float32 scalars
    (Python floats) and ``(K,)`` float32 tensors on the fields' device."""

    c_w: float
    g_t: float
    beta: float
    alfa: float
    a: torch.Tensor
    cp: torch.Tensor
    den: torch.Tensor
    crdn: torch.Tensor
    erdn: torch.Tensor
    #: (fws, fwp, bws, bwp), or None when built without ``fast``
    fast: tuple | None = None


def _host(x) -> np.ndarray:
    """A ``(K,)`` vector on the host: numpy as it is, a tensor read back
    (on the card, a device-to-host copy and a synchronise)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, F32)


def thomas_vectors(*, rdn, rdnw, dts, epssm, cw, gw, k0: int, k1: int,
                   fast: bool = False, device=None) -> ThomasVectors:
    """The bundle for one ``(dts, epssm, cw, gw, k0, k1)``, from the ``(K,)``
    vectors ``rdn`` and ``rdnw``: numpy arrays, or tensors (read back to the
    host once).  The K-vectors go to ``device`` (default: ``rdnw``'s, which
    must then be a tensor); to a card from pinned memory, without a
    synchronise."""
    dev = torch.device(device) if device is not None else rdnw.device
    rdn, rdnw = _host(rdn), _host(rdnw)
    K = rdnw.shape[0]
    c_w, g_t, a, b, diag, crdn, erdn = thomas_coeffs(
        rdn, rdnw, dts, epssm, cw, gw, K, k0, k1)
    cp, den = thomas_hoisted(a, b, diag)
    beta = F32(0.5) * (F32(1.0) + F32(epssm))

    def dev_vec(x):
        x = torch.from_numpy(np.ascontiguousarray(x, F32))
        if dev.type != "cuda":
            return x.to(dev)
        return x.pin_memory().to(dev, non_blocking=True)

    fast_vecs = None
    if fast:
        fast_vecs = tuple(dev_vec(x) for x in
                          thomas_fast_vectors(a, cp, den, K, k0, k1))
    return ThomasVectors(
        c_w=float(c_w), g_t=float(g_t), beta=float(beta),
        alfa=float(F32(1.0) - beta), a=dev_vec(a), cp=dev_vec(cp),
        den=dev_vec(den), crdn=dev_vec(crdn), erdn=dev_vec(erdn),
        fast=fast_vecs)


class ThomasCache:
    """A loop's Thomas bundles, kept across its calls.

    ``register(tensor, host)`` records the host copy of a vertical vector
    the loop's ``prepare`` put on a device; :meth:`get` builds a bundle
    from the host copies of the tensors it is given (a tensor nobody
    registered is read back once) and returns the same bundle for the
    same tensors and scalars on every later call.  Entries are keyed by
    the tensors' identity and hold them, so an id is never reused while
    its entry lives."""

    def __init__(self):
        self._host = {}
        self._bundles = {}

    def register(self, tensor: torch.Tensor, host) -> None:
        self._host[id(tensor)] = (tensor, np.array(host, F32))

    def _host_copy(self, tensor: torch.Tensor) -> np.ndarray:
        hit = self._host.get(id(tensor))
        if hit is not None and hit[0] is tensor:
            return hit[1]
        host = _host(tensor)
        self.register(tensor, host)
        return host

    def get(self, *, rdn: torch.Tensor, rdnw: torch.Tensor, dts, epssm, cw,
            gw, k0: int, k1: int, fast: bool = False) -> ThomasVectors:
        key = (id(rdn), id(rdnw), dts, epssm, cw, gw, k0, k1, fast)
        hit = self._bundles.get(key)
        if hit is None or hit[0] is not rdn or hit[1] is not rdnw:
            bundle = thomas_vectors(
                rdn=self._host_copy(rdn), rdnw=self._host_copy(rdnw),
                dts=dts, epssm=epssm, cw=cw, gw=gw, k0=k0, k1=k1, fast=fast,
                device=rdnw.device)
            hit = self._bundles[key] = (rdn, rdnw, bundle)
        return hit[2]
