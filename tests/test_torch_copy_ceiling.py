"""K6 in the port on the CPU: the copy probes' plain versions (what
``copy_probe`` runs on CPU tensors) against the functions the JAX probe
family computes (``o = x``, ``o = x + 1``, ``x += 1`` in place), the
wrapper's argument checks, and the refusal to measure a device rate
without a CUDA device."""

import numpy as np
import pytest
import torch

from wrf_tpu_torch.utils import copy_ceiling as k6

torch.set_num_threads(1)


def _x(shape=(6, 5, 7), seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("probe", list(k6.PROBES))
@pytest.mark.parametrize("shape", [(6, 5, 7), (1, 1, 1), (4, 3, 16)])
def test_probe_computes_the_jax_probe_family(probe, shape):
    plus1, in_place = k6.PROBES[probe]
    x_np = _x(shape)
    x = torch.tensor(x_np)
    out = x if in_place else torch.full_like(x, np.nan)
    before = k6.LAUNCHES
    got = k6.copy_probe(x, out, plus1)
    assert got is out and k6.LAUNCHES == before   # no launch on the CPU
    want = x_np + np.float32(1.0) if plus1 else x_np
    np.testing.assert_array_equal(got.numpy(), want)
    if not in_place:
        np.testing.assert_array_equal(x.numpy(), x_np)   # input untouched
    plain = k6.copy_probe_plain(torch.tensor(x_np),
                                torch.empty_like(x), plus1)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_probe_names_and_shapes():
    assert list(k6.PROBES) == ["ab", "ab_plus1", "aliased"]
    assert k6.SHAPES == ((512, 50, 514), (1024, 50, 1502), (516, 50, 516))
    assert k6.HBM_SPEC_GBPS == 3350.0


@pytest.mark.parametrize("bad,err,match", [
    (dict(x=torch.zeros(4, dtype=torch.float64)), TypeError, "float32"),
    (dict(out=torch.zeros(5)), ValueError, "must match"),
    (dict(x=torch.zeros(4, 2).t()[:, :1].expand(2, 2)), ValueError,
     "contiguous"),
])
def test_probe_argument_checks(bad, err, match):
    kw = dict(x=torch.zeros(4), out=torch.zeros(4))
    kw.update(bad)
    if "x" in bad and bad["x"].shape != kw["out"].shape:
        kw["out"] = torch.zeros(bad["x"].shape)
    with pytest.raises(err, match=match):
        k6.copy_probe(**kw)


def test_in_place_identity_is_refused():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="plus1=True"):
        k6.copy_probe(x, x)


@pytest.mark.parametrize("fn", [k6.measure_copy_gbps,
                                k6.measure_copy_ceiling])
def test_measuring_refuses_the_cpu(fn):
    """A rate taken on the CPU is not a device metric: no fallback."""
    with pytest.raises(ValueError, match="CUDA device only"):
        fn((4, 3, 8), device="cpu")


def test_ceiling_reports_one_failed_probe_and_raises_on_more(monkeypatch):
    readings = {"ab": 2500.0, "ab_plus1": 3600.0, "aliased": 2700.0}

    def fake(shape, probe, **kw):
        if isinstance(readings[probe], Exception):
            raise readings[probe]
        return readings[probe]

    monkeypatch.setattr(k6, "measure_copy_gbps", fake)
    seen = {}
    # a reading above the data sheet is discarded, the best other one wins
    assert k6.measure_copy_ceiling((1, 1, 1), readings=seen) == \
        (2700.0, "aliased", "")
    assert seen == readings
    readings["ab"] = RuntimeError("launch failed")
    best, src, err = k6.measure_copy_ceiling((1, 1, 1))
    assert (best, src) == (2700.0, "aliased")
    assert err == "ab: RuntimeError: launch failed"
    readings["aliased"] = RuntimeError("again")
    with pytest.raises(RuntimeError, match="again"):
        k6.measure_copy_ceiling((1, 1, 1))


# ------------------------------------------------- the launch plan --------
@pytest.mark.parametrize("n,aligned", [
    (0, True), (1, True), (3, True), (4, True), (5, True), (1027, True),
    (1024 * 4 - 1, True), (1024 * 4, True), (1024 * 4 + 1, True),
    (1024 * 8, True), (1024 * 8 + 1, True), (516 * 50 * 516, True),
    (105, False), (1, False), (1024, False), (1025, False),
    (1024 * 8 + 3, False),
])
def test_register_plan_covers_every_element_once(n, aligned):
    """The grid: ``vec_blocks`` chunks of WORDS*THREADS float4 words over
    the first n4 words (aligned only), then chunks of WORDS*THREADS floats
    over the rest; together every element exactly once, and no block
    without work."""
    n4, vec_blocks, blocks = k6.launch_plan(n, aligned)
    assert n4 == (n // 4 if aligned else 0)
    chunk = k6.WORDS * k6.THREADS
    assert (vec_blocks - 1) * chunk < n4 <= vec_blocks * chunk or \
        (vec_blocks == 0 and n4 == 0)
    tail = n - 4 * n4
    assert tail <= (3 if aligned else n)
    tail_blocks = blocks - vec_blocks
    assert (tail_blocks - 1) * chunk < tail <= tail_blocks * chunk or \
        (tail_blocks == 0 and tail == 0)
    covered = np.zeros(n, np.int64)
    for b in range(vec_blocks):   # words [b*chunk, (b+1)*chunk) & [0, n4)
        lo, hi = b * chunk, min((b + 1) * chunk, n4)
        covered[4 * lo:4 * hi] += 1
    for b in range(tail_blocks):
        lo = 4 * n4 + b * chunk
        covered[lo:min(lo + chunk, n)] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("n,aligned,want", [
    (4, True, (1, 1, 1)), (5, True, (1, 1, 2)), (4096, True, (1024, 1, 1)),
    (4099, True, (1024, 1, 2)), (4100, True, (1025, 2, 2)),
    (516 * 50 * 516, True, (3328200, 3251, 3251)),
    (1024 * 50 * 1502, True, (19225600, 18775, 18775)),
    (7 * 5 * 3, False, (0, 0, 1)), (1027, False, (0, 0, 2)),
    (0, True, (0, 0, 0)),
])
def test_plan_at_the_probes_shapes_and_edges(n, aligned, want):
    """The grid is the chunk count (1024 words a block, 1024 floats a block
    past them): fewer elements than one chunk take one block, a ragged
    tail one more, an unaligned pointer moves everything as floats, and an
    empty array launches no block."""
    assert k6.launch_plan(n, aligned) == want
