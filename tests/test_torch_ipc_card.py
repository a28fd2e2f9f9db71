"""The two kernels of the rdma exchange across processes
(``csrc/halo_ipc.cu``: the signalled put into a neighbour's mailbox and
the wait on this rank's) in two processes on one card, through CUDA IPC.

Needs a CUDA card (marker ``cuda``; skipped without one): run it there with
``python -m pytest tests/test_torch_ipc_card.py -m cuda --noconftest``
(``tests/conftest.py`` sets up JAX, which the card's machine need not
have).  Two gloo
processes hold one shard each of a (2, 1) mesh on ``cuda:0`` and refresh
the j halos of a 2-D and a 3-D field N times through
``remote_refresh_multi``; afterwards every data counter of each mailbox
holds what N exchanges' put blocks add, every free counter N-1 releases
(the last exchange's slots stay unreleased until the next one), the error
word 0, and the blocks equal the plain version's (``distributed.p2p``) on
the same inputs bit for bit.  This file imports no JAX: the plain
PyTorch version is the reference on the card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
N_EXCHANGES = 5
ROWS, K, I = 6, 7, 300     # padded rows, levels, lanes of a block


def _worker(rank: int, workdir: str) -> None:
    """One rank of the card test: N kernel exchanges and N plain ones on
    the same blocks; writes what it found to ``workdir/rank{rank}.json``."""
    from datetime import timedelta

    from wrf_tpu_torch.ops import halo_rdma_cuda as k5
    from wrf_tpu_torch.parallel import distributed

    distributed.initialize(backend="gloo",
                           init_method=f"file://{workdir}/pg", world_size=2,
                           rank=rank, timeout=timedelta(seconds=120))
    mesh = distributed.global_mesh((2, 1), devices=["cuda:0"])
    g = torch.Generator().manual_seed(7 + rank)
    fields = [{c: torch.randn(ROWS, I, generator=g).cuda()
               for c in mesh.local_coords()},
              {c: torch.randn(ROWS, K, I, generator=g).cuda()
               for c in mesh.local_coords()}]
    plain = [{c: x.clone() for c, x in f.items()} for f in fields]
    for _ in range(N_EXCHANGES):
        k5.remote_refresh_multi(fields, "j", mesh, ROWS - 2,
                                recv_only=("", "hi"))
        k5.remote_refresh_multi_plain(plain, "j", mesh, ROWS - 2,
                                      recv_only=("", "hi"))
    torch.cuda.synchronize()
    (box,) = [b for b in mesh.mailboxes.values() if b.signalled]
    out = {"counters": box.counters.cpu().tolist(),
           "incoming": [list(m) for m in box.incoming],
           "n_out": len(box.outgoing), "head": box.head,
           "equal": all(torch.equal(f[c], p[c])
                        for f, p in zip(fields, plain) for c in f),
           "put": k5.PUT_LAUNCHES, "wait": k5.WAIT_LAUNCHES,
           "k5": k5.LAUNCHES}
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(out))
    distributed.close_mailboxes(mesh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_signalled_put_and_wait_in_two_processes_on_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the signalled put and the wait are "
                    "CUDA kernels with no interpret mode")
    from wrf_tpu_torch import _build

    _build.load()     # once, before the workers start
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    # this file, loaded by its path (a "tests" package elsewhere on the
    # path may shadow the repository's)
    code = ("import importlib.util as u, sys; "
            "s = u.spec_from_file_location('ipc_card', sys.argv[3]); "
            "m = u.module_from_spec(s); s.loader.exec_module(m); "
            "m._worker(int(sys.argv[1]), sys.argv[2])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(tmp_path), __file__], cwd=REPO, env=env)
             for r in range(2)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    # a message from the previous neighbour carries mu's row, one from the
    # next mu's and v's: every put block adds one
    blocks = max(1, min(64, -(-K * I // 1024)))
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        n_in = len(got["incoming"])
        assert n_in == 2 and got["n_out"] == 2
        for q, (_, _, _, slot) in enumerate(got["incoming"]):
            segs = 1 if slot == 0 else 2
            assert got["counters"][q] == N_EXCHANGES * blocks * segs, (r, q)
        for k in range(got["n_out"]):
            assert got["counters"][n_in + k] == N_EXCHANGES - 1, (r, k)
        assert got["counters"][n_in + got["n_out"]] == 0   # no timeout
        assert got["equal"]
        assert (got["put"], got["wait"], got["k5"]) == (N_EXCHANGES,
                                                        N_EXCHANGES, 0)
