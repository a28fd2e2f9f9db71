"""A cell on a mesh of shards, as data: the ``mesh2x2`` traffic on four
shards of the CPU gives the one-shard cell's check to the digit, the check
reads the mesh's blocks where they lie, and a mesh's faults fail it."""

import json
import time

import pytest
import torch

from wrfbench_tiny import tiny_checkout

from wrfbench import check, run
from wrfbench.check import MESH_FAULTS, Fault
from wrfbench.program import ClosedStep
from wrfbench.run import run_cell

torch.set_num_threads(2)

SEED = 2**33 + 21


def _run(root, cell, make_program=None, seed=SEED):
    return run_cell(root, cell, seed, 0.3, False, "cpu",
                    time.perf_counter(), make_program=make_program)


@pytest.mark.parametrize("backend", ["rdma_overlap", "ppermute"])
def test_mesh_cell_checks_as_one_shard(tmp_path, backend):
    root = tiny_checkout(tmp_path)
    path = root / "wrfbench/traffic/mesh2x2.json"
    mix = json.loads(path.read_text())
    assert mix["mesh"] == [2, 2] and mix["halo_backend"] == "rdma_overlap"
    path.write_text(json.dumps(dict(mix, halo_backend=backend)))
    one = _run(root, "tiny.step")
    mesh = _run(root, "tiny.mesh2x2")
    assert one["correct"] is True and mesh["correct"] is True
    # every mesh is bit-equal to one shard: the first step's error too
    assert (mesh["compared"]["step1_err"]["value"]
            == one["compared"]["step1_err"]["value"])
    assert mesh["failed"] == 0 and mesh["attempted"] > 0


def test_mesh_checksum_sums_the_shards(tmp_path):
    from wrfbench import inputs
    from wrfbench_tiny import cfg_of, mix_of

    cfg = cfg_of("conus12km", e_we=24, e_sn=20, e_vert=10)
    host = inputs.make_host(cfg, 3, "cpu")
    one = ClosedStep(cfg, mix_of(), host, ["cpu"])
    mesh = ClosedStep(cfg, mix_of("mesh2x2"), host, ["cpu"])
    assert isinstance(mesh.state["t"], dict) and len(mesh.state["t"]) == 4
    a, _ = one.step(one.state)
    b, checksum = mesh.step(mesh.state)
    # the mesh padding holds zeros, so the blocks sum to the ring's t
    assert checksum == pytest.approx(a["t"].double().sum().item(), rel=1e-6)
    ev = mesh.evolved(b)
    want = one.evolved(a)
    J, _, I = want["t"].shape
    for n in want:
        assert torch.equal(check.region(ev[n], 0, J, 0, I), want[n])
        assert torch.equal(check.region(ev[n], 3, 17, 5, 21),
                           want[n][3:17, ..., 5:21])


@pytest.mark.parametrize("kind", MESH_FAULTS)
def test_mesh_fault_fails_both_numbers(tmp_path, kind):
    def make(cfg, mix, host, devices):
        return Fault(ClosedStep(cfg, mix, host, devices), kind)

    res = _run(tiny_checkout(tmp_path), "tiny.mesh2x2", make)
    assert res["correct"] is False
    for key in ("step1_err", "window_err"):
        c = res["compared"][key]
        assert c["value"] > c["limit"], (key, c)


def test_main_refuses_a_four_chip_cell_on_fewer_cards(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(run, "ROOT", tiny_checkout(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = run.main(["--workload", "tiny.mesh2x2", "--seed", "7",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    out = capsys.readouterr()
    assert "{" not in out.out and "needs 4 CUDA device(s)" in out.err
