"""The seeded inputs: deterministic by seed, shaped and balanced."""

import torch

from wrfbench_tiny import cfg_of

from wrfbench import inputs


def test_same_seed_same_fields():
    cfg = cfg_of("conus12km", e_we=20, e_sn=16, e_vert=8)
    a = inputs.make_domain(cfg, 2**32 + 5, "cpu")
    b = inputs.make_domain(cfg, 2**32 + 5, "cpu")
    c = inputs.make_domain(cfg, 2**32 + 6, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["t"], c["t"])
    assert torch.equal(a["dnw"], c["dnw"])       # the grid, not the seed


def test_shapes_and_finite():
    cfg = cfg_of("conus2p5km", e_we=20, e_sn=16)
    f = inputs.make_domain(cfg, 1, "cpu")
    s3 = inputs.ring_shape(cfg)
    for n in inputs.FIELDS_3D:
        assert tuple(f[n].shape) == s3 and f[n].dtype == torch.float32
    for n in inputs.FIELDS_2D:
        assert tuple(f[n].shape) == (s3[0], s3[2])
    for n in inputs.FIELDS_1D:
        assert tuple(f[n].shape) == (s3[1],)
    assert all(torch.isfinite(x).all() for x in f.values())


def test_base_flux_is_non_divergent():
    cfg = cfg_of("conus2p5km", e_we=30, e_sn=24, e_vert=6)
    f = inputs.make_domain(cfg, 9, "cpu")
    sc = inputs.scalars(cfg)
    d = {n: f[n].double() for n in f}
    U = d["muu"][:, None, :] * d["u_1"] / d["msfuy"][:, None, :]
    V = d["muv"][:, None, :] * d["v_1"] * d["msfvx_inv"][:, None, :]
    div = (sc["rdx"] * (U[:-1, :, 1:] - U[:-1, :, :-1])
           + sc["rdy"] * (V[1:, :, :-1] - V[:-1, :, :-1]))
    scale = sc["rdx"] * U.abs().max()
    assert (div.abs().max() / scale) < 1e-5


def test_field_by_field_equals_make_domain():
    """The host inputs a run makes, one field at a time, are the fields
    ``make_domain`` draws all at once, bit for bit and in its order."""
    for name, seed in (("conus2p5km", 2**40 + 3), ("conus12km", 11)):
        cfg = cfg_of(name, e_we=22, e_sn=18, e_vert=7)
        whole = inputs.make_domain(cfg, seed, "cpu")
        host = inputs.make_host(cfg, seed, "cpu")
        assert list(host) == list(whole)
        for n, x in whole.items():
            assert host[n].dtype == x.numpy().dtype
            assert (host[n] == x.numpy()).all(), n
