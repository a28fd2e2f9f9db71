"""Golden fixture minting.

The reference's test strategy is differential golden-file testing: binary
dumps of every input and output field from a real WRF run, one big-endian
file per field (reference: advance_mu_t_driver.c:15-24, 60-219).  That
dataset is not shipped with the reference, so this module mints equivalent
fixtures: deterministic, smoothly varying, physically plausible input fields,
with golden outputs produced by the native C++ scalar oracle (built with FMA
contraction off).  File names and formats are byte-compatible with what the
reference drivers read and write.

Field naming (reference: advance_mu_t_driver.c:60-219):
  dims        ids..kte (18 int files)
  scalars     grid_rdx, grid_rdy, dts_rk, grid_epssm
  flags       config_flags_{nested,periodic_x,specified}
  1-D (k)     grid_dnw, grid_fnm, grid_fnp, grid_rdnw
  2-D (j,i)   grid_mut, grid_muu, grid_muv, mu_tend, grid_msfuy,
              grid_msfvx_inv, grid_msftx, grid_msfty, grid_mu_2
  3-D (j,k,i) grid_u_2, grid_u_save, grid_v_2, grid_v_save, grid_t_save,
              t_tend, grid_ww, ww1, grid_t_2, t_2save
  outputs     grid_ww_output, ww1_output, grid_t_2_output, t_2save_output,
              grid_mu_2_output, muave_output, grid_muts_output,
              grid_mudf_output
  extra       steps.bin (int; how many small steps the goldens correspond to)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from ..grid import ConfigFlags, GridBounds
from . import codec

F = np.float32

#: inputs the driver reads, with array rank ("s"=scalar, 1/2/3 = field dims)
INPUT_FIELDS_3D = (
    "grid_u_2", "grid_u_save", "grid_v_2", "grid_v_save",
    "grid_t_save", "t_tend", "grid_ww", "ww1", "grid_t_2", "t_2save",
)
INPUT_FIELDS_2D = (
    "grid_mut", "grid_muu", "grid_muv", "mu_tend", "grid_msfuy",
    "grid_msfvx_inv", "grid_msftx", "grid_msfty", "grid_mu_2",
)
INPUT_FIELDS_1D = ("grid_dnw", "grid_fnm", "grid_fnp", "grid_rdnw")
#: vertical-acoustics extension fields (advance_w substep; absent in older
#: fixture dirs — read_case derives/zeroes them)
W_FIELDS_3D = ("grid_w", "grid_pp")
W_FIELDS_1D = ("grid_rdn",)
OUTPUT_FIELDS = (
    "grid_ww_output", "ww1_output", "grid_t_2_output", "t_2save_output",
    "grid_mu_2_output", "muave_output", "grid_muts_output",
    "grid_mudf_output",
)


@dataclasses.dataclass
class Case:
    """An in-memory fixture: bounds, flags, scalars and all named fields."""

    bounds: GridBounds
    flags: ConfigFlags
    rdx: float
    rdy: float
    dts: float
    epssm: float
    fields: dict[str, np.ndarray]

    def kernel_kwargs(self) -> dict:
        """Map driver field names onto kernel argument names
        (the binding used by the reference driver call,
        advance_mu_t_driver.c:227-239)."""
        f = self.fields
        return dict(
            ww=f["grid_ww"], ww_1=f["ww1"],
            u=f["grid_u_2"], u_1=f["grid_u_save"],
            v=f["grid_v_2"], v_1=f["grid_v_save"],
            mu=f["grid_mu_2"], mut=f["grid_mut"],
            muu=f["grid_muu"], muv=f["grid_muv"],
            t=f["grid_t_2"], t_1=f["grid_t_save"], t_ave=f["t_2save"],
            ft=f["t_tend"], mu_tend=f["mu_tend"],
            rdx=self.rdx, rdy=self.rdy, dts=self.dts, epssm=self.epssm,
            dnw=f["grid_dnw"], fnm=f["grid_fnm"], fnp=f["grid_fnp"],
            rdnw=f["grid_rdnw"],
            msfuy=f["grid_msfuy"], msfvx_inv=f["grid_msfvx_inv"],
            msftx=f["grid_msftx"], msfty=f["grid_msfty"],
            flags=self.flags, bounds=self.bounds,
        )


def _smooth3(rng: np.random.Generator, shape3, amp: float, base: float = 0.0,
             waves: int = 3) -> np.ndarray:
    """Deterministic smooth 3-D field: superposed low-wavenumber modes plus a
    little noise — well-conditioned for 100-step differential runs."""
    jdim, kdim, idim = shape3
    j = np.linspace(0.0, 1.0, jdim, dtype=np.float64)[:, None, None]
    k = np.linspace(0.0, 1.0, kdim, dtype=np.float64)[None, :, None]
    i = np.linspace(0.0, 1.0, idim, dtype=np.float64)[None, None, :]
    out = np.zeros(shape3, dtype=np.float64)
    for _ in range(waves):
        aj, ak, ai = rng.uniform(0.5, 2.5, size=3)
        pj, pk, pi = rng.uniform(0, 2 * np.pi, size=3)
        out += np.sin(2 * np.pi * aj * j + pj) * \
               np.cos(2 * np.pi * ak * k + pk) * \
               np.sin(2 * np.pi * ai * i + pi)
    out = out / waves + 0.05 * rng.standard_normal(shape3)
    return (base + amp * out).astype(F)


def _smooth2(rng, shape2, amp, base=0.0, waves=3) -> np.ndarray:
    jdim, idim = shape2
    return _smooth3(rng, (jdim, 1, idim), amp, base, waves)[:, 0, :]


def make_case(
    nx: int = 74,
    ny: int = 61,
    nz: int = 32,
    *,
    halo: int = 3,
    seed: int = 2026,
    amplitude: float = 1.0,
    flags: ConfigFlags | None = None,
    balanced: bool = False,
) -> Case:
    """Mint a physically plausible advance_mu_t input set.

    Default size matches the reference fixture grid 74×61×32 (BASELINE.md).
    Magnitudes are modeled on WRF: column dry mass ``mut`` ~ tens of kPa,
    mass-coupled winds ``u,v`` ~ mu*u ~ 1e5, theta perturbations ~ O(10),
    map-scale factors ~ 1, eta-layer thicknesses ``dnw`` < 0 summing to -1.

    ``amplitude`` scales the dynamic perturbations (winds, theta, omega).
    The default noise-like fields have no physical balance and are meant
    for differential verification over bounded substep counts.

    ``balanced`` replaces the base-state winds (``grid_u_save`` /
    ``grid_v_save``) with streamfunction-derived fields whose COUPLED mass
    flux (``muu*u_1/msfuy``, ``muv*v_1*msfvx_inv``) is discretely
    non-divergent, so the base state forces no mass drift.  Long-horizon
    integrations (run_sim) use ``balanced=True`` + ``amplitude`` ~ 1e-2
    together with the nudging closure and base-state snapshot mode
    (models/tendencies.py); the degenerate stage-snapshot shell diverges
    regardless (see models/rk3.py).
    """
    flags = flags or ConfigFlags(specified=True)
    b = GridBounds.for_domain(nx, ny, nz, halo=halo)
    rng = np.random.default_rng(seed)
    s3, s2, kdim = b.shape3, b.shape2, b.kdim

    # Vertical coordinate: monotone eta levels, dnw = d(eta) < 0.
    eta_w = np.linspace(1.0, 0.0, nz, dtype=np.float64)  # full (w) levels
    # slight nonuniform stretching
    eta_w = eta_w ** 1.3
    dnw = np.zeros(kdim, dtype=F)
    dnw[: nz - 1] = np.diff(eta_w).astype(F)  # negative
    dnw[nz - 1] = dnw[nz - 2]
    rdnw = np.zeros(kdim, dtype=F)
    rdnw[dnw != 0] = (F(1.0) / dnw[dnw != 0]).astype(F)
    # interpolation weights to w levels (fnm + fnp ~ 1)
    fnm = np.full(kdim, 0.5, dtype=F)
    fnp = np.full(kdim, 0.5, dtype=F)
    for k in range(1, nz - 1):
        d0, d1 = -float(dnw[k - 1]), -float(dnw[k])
        fnm[k] = F(d1 / (d0 + d1))
        fnp[k] = F(d0 / (d0 + d1))

    fields: dict[str, np.ndarray] = {
        "grid_dnw": dnw, "grid_fnm": fnm, "grid_fnp": fnp, "grid_rdnw": rdnw,
        # map-scale factors near 1
        "grid_msfuy": _smooth2(rng, s2, 0.05, 1.0),
        "grid_msfvx_inv": _smooth2(rng, s2, 0.05, 1.0),
        "grid_msftx": _smooth2(rng, s2, 0.05, 1.0),
        "grid_msfty": _smooth2(rng, s2, 0.05, 1.0),
        # column masses (Pa): background ~ 5e4, perturbation mu ~ O(100)
        "grid_mut": _smooth2(rng, s2, 2e3, 5e4),
        "grid_muu": _smooth2(rng, s2, 2e3, 5e4),
        "grid_muv": _smooth2(rng, s2, 2e3, 5e4),
        "grid_mu_2": _smooth2(rng, s2, 1e2),
        "mu_tend": _smooth2(rng, s2, 1e-1),
        # mass-coupled winds ~ mu * u / msf ~ 5e4 * 20
        "grid_u_2": _smooth3(rng, s3, 1e6 * amplitude),
        "grid_u_save": _smooth3(rng, s3, 2e1 * amplitude),
        "grid_v_2": _smooth3(rng, s3, 1e6 * amplitude),
        "grid_v_save": _smooth3(rng, s3, 2e1 * amplitude),
        # theta perturbation and its tendency
        "grid_t_save": _smooth3(rng, s3, 1e1 * amplitude),
        "grid_t_2": _smooth3(rng, s3, 1e4 * amplitude),
        "t_tend": _smooth3(rng, s3, 1e0 * amplitude),
        "t_2save": _smooth3(rng, s3, 1e4 * amplitude),
        # small-step omega
        "grid_ww": _smooth3(rng, s3, 1e-1 * amplitude),
        "ww1": _smooth3(rng, s3, 1e-3 * amplitude),
        # vertical-acoustics extension (advance_w): vertical velocity and
        # pressure-like perturbation on w levels
        "grid_w": _smooth3(rng, s3, 1e0),
        "grid_pp": _smooth3(rng, s3, 1e2),
    }
    from ..ops.advance_w import rdn_from_dnw
    fields["grid_rdn"] = rdn_from_dnw(dnw)

    if balanced:
        # Base winds from a streamfunction on cell corners: with
        # U = rdx*d_j(psi), V = -rdy*d_i(psi) as the COUPLED fluxes, the
        # discrete divergence rdx*d_i(U) + rdy*d_j(V) telescopes to zero
        # exactly (mixed differences commute), cell by cell.  Uncoupling
        # through the mass/map-factor fields puts them in the *_1 slots
        # the flux formula (module_small_step_em.f90:142-146) recouples.
        rdx, rdy = 1.0 / 12000.0, 1.0 / 12000.0
        jdim, kdim2, idim = s3
        jj = np.linspace(0.0, 1.0, jdim + 1)[:, None, None]
        kk = np.linspace(0.0, 1.0, kdim2)[None, :, None]
        ii = np.linspace(0.0, 1.0, idim + 1)[None, None, :]
        psi = np.zeros((jdim + 1, kdim2, idim + 1))
        for _ in range(3):
            aj, ak, ai = rng.uniform(0.5, 2.5, size=3)
            pj, pk, pi = rng.uniform(0, 2 * np.pi, size=3)
            psi += np.sin(2 * np.pi * aj * jj + pj) * \
                   np.cos(2 * np.pi * ak * kk + pk) * \
                   np.sin(2 * np.pi * ai * ii + pi)
        psi *= 1e4 / (3 * max(rdx, rdy))  # coupled-flux scale ~ mut * u_phys
        # discrete curl: U = rdy*d_j(psi), V = -rdx*d_i(psi) — then
        # rdx*d_i(U) + rdy*d_j(V) = rdx*rdy*(d_i d_j - d_j d_i)(psi) = 0
        # term-by-term (the same four corner values cancel exactly)
        cflux_u = (psi[1:, :, :idim] - psi[:jdim, :, :idim]) * rdy
        cflux_v = -(psi[:jdim, :, 1:] - psi[:jdim, :, :idim]) * rdx
        fields["grid_u_save"] = (
            cflux_u * fields["grid_msfuy"][:, None, :]
            / fields["grid_muu"][:, None, :]).astype(F)
        fields["grid_v_save"] = (
            cflux_v / (fields["grid_muv"][:, None, :]
                       * fields["grid_msfvx_inv"][:, None, :])).astype(F)

    return Case(
        bounds=b, flags=flags,
        rdx=1.0 / 12000.0, rdy=1.0 / 12000.0, dts=12.0 / 6.0, epssm=0.1,
        fields=fields,
    )


def run_golden(case: Case, steps: int = 1) -> dict[str, np.ndarray]:
    """Produce golden outputs by iterating the native C++ oracle ``steps``
    times (in/out fields ww, mu, t, t_ave carried between steps)."""
    from ..native import advance_mu_t_native

    kw = case.kernel_kwargs()
    state = {k: kw[k] for k in ("ww", "mu", "t", "t_ave")}
    out = dict(state)
    for _ in range(steps):
        out = advance_mu_t_native(**{**kw, **state})
        state = {k: out[k] for k in ("ww", "mu", "t", "t_ave")}
    return out


def write_case(case: Case, outdir: str | Path, steps: int = 1,
               golden: dict[str, np.ndarray] | None = None) -> Path:
    """Write a full fixture directory (inputs + golden outputs) in the
    reference's binary format."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    b = case.bounds

    for name, value in zip(GridBounds.FIELD_ORDER, b.as_tuple()):
        codec.write_int(outdir / f"{name}.bin", value)
    codec.write_real(outdir / "grid_rdx.bin", case.rdx)
    codec.write_real(outdir / "grid_rdy.bin", case.rdy)
    codec.write_real(outdir / "dts_rk.bin", case.dts)
    codec.write_real(outdir / "grid_epssm.bin", case.epssm)
    codec.write_flag(outdir / "config_flags_nested.bin", case.flags.nested)
    codec.write_flag(outdir / "config_flags_periodic_x.bin", case.flags.periodic_x)
    codec.write_flag(outdir / "config_flags_specified.bin", case.flags.specified)
    codec.write_int(outdir / "steps.bin", steps)

    for name, arr in case.fields.items():
        codec.write_field(outdir / f"{name}.bin", arr)

    if golden is None:
        golden = run_golden(case, steps=steps)
    codec.write_field(outdir / "grid_ww_output.bin", golden["ww"])
    codec.write_field(outdir / "ww1_output.bin", case.fields["ww1"])
    codec.write_field(outdir / "grid_t_2_output.bin", golden["t"])
    codec.write_field(outdir / "t_2save_output.bin", golden["t_ave"])
    codec.write_field(outdir / "grid_mu_2_output.bin", golden["mu"])
    codec.write_field(outdir / "muave_output.bin", golden["muave"])
    codec.write_field(outdir / "grid_muts_output.bin", golden["muts"])
    codec.write_field(outdir / "grid_mudf_output.bin", golden["mudf"])
    return outdir


def read_case(fixture_dir: str | Path) -> tuple[Case, int]:
    """Load a fixture directory back into a :class:`Case`; returns
    ``(case, steps)``."""
    d = Path(fixture_dir)
    dims = {n: codec.read_int(d / f"{n}.bin") for n in GridBounds.FIELD_ORDER}
    b = GridBounds(**dims)
    flags = ConfigFlags(
        nested=codec.read_flag(d / "config_flags_nested.bin"),
        periodic_x=codec.read_flag(d / "config_flags_periodic_x.bin"),
        specified=codec.read_flag(d / "config_flags_specified.bin"),
    )
    fields: dict[str, np.ndarray] = {}
    for name in INPUT_FIELDS_1D:
        fields[name] = codec.read_field(d / f"{name}.bin", (b.kdim,))
    for name in INPUT_FIELDS_2D:
        fields[name] = codec.read_field(d / f"{name}.bin", b.shape2)
    for name in INPUT_FIELDS_3D:
        fields[name] = codec.read_field(d / f"{name}.bin", b.shape3)
    for name in W_FIELDS_3D:   # older fixture dirs predate the w substep
        if (d / f"{name}.bin").exists():
            fields[name] = codec.read_field(d / f"{name}.bin", b.shape3)
        else:
            fields[name] = np.zeros(b.shape3, F)
    if (d / "grid_rdn.bin").exists():
        fields["grid_rdn"] = codec.read_field(d / "grid_rdn.bin", (b.kdim,))
    else:
        from ..ops.advance_w import rdn_from_dnw
        fields["grid_rdn"] = rdn_from_dnw(fields["grid_dnw"])
    case = Case(
        bounds=b, flags=flags,
        rdx=codec.read_real(d / "grid_rdx.bin"),
        rdy=codec.read_real(d / "grid_rdy.bin"),
        dts=codec.read_real(d / "dts_rk.bin"),
        epssm=codec.read_real(d / "grid_epssm.bin"),
        fields=fields,
    )
    steps = 1
    if (d / "steps.bin").exists():
        steps = codec.read_int(d / "steps.bin")
    return case, steps


def read_golden(fixture_dir: str | Path, bounds: GridBounds) -> dict[str, np.ndarray]:
    """Load the golden output fields of a fixture directory."""
    d = Path(fixture_dir)
    return {
        "ww": codec.read_field(d / "grid_ww_output.bin", bounds.shape3),
        "ww_1": codec.read_field(d / "ww1_output.bin", bounds.shape3),
        "t": codec.read_field(d / "grid_t_2_output.bin", bounds.shape3),
        "t_ave": codec.read_field(d / "t_2save_output.bin", bounds.shape3),
        "mu": codec.read_field(d / "grid_mu_2_output.bin", bounds.shape2),
        "muave": codec.read_field(d / "muave_output.bin", bounds.shape2),
        "muts": codec.read_field(d / "grid_muts_output.bin", bounds.shape2),
        "mudf": codec.read_field(d / "grid_mudf_output.bin", bounds.shape2),
    }
