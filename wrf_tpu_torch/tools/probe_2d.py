"""K7: the tiling probe, one thread per column against (j, i) tiles.

Port of ``tools/probe_2d.py`` (kernel_1d :54, kernel_2d :58).  The JAX
probe asked whether the TPU compiler takes lane-offset windows; on this card
the question it answers is the one a re-tiling of K3 or of K1's shard
block starts from: on a representative stencil plus k scan, does a block
that stages its (j, i) tile with a lane halo in shared memory beat one
thread per column that reads its neighbours from global memory (L1)?

Both forms compute the probe's ``_body`` on a float32 (J, K, I) array: the
lane stencil ``((x + x[i-1]) + x[i-1]*0.5) + x[i+1]``, then an inclusive
prefix sum over k by DOUBLING (``y[k] += y[k-d]`` for k >= d, d = 1, 2, 4
... < K, every k of a pass from the previous pass's values; not a
sequential cumsum, whose bits differ).  Rows written: 1 .. 1 +
tj*((J-2)//tj).

* :func:`run_1d` (kernel_1d): every lane of those rows; the lane
  neighbours wrap at the array edge.
* :func:`run_2d` (kernel_2d): lanes [halo, halo + ti*((I-2*halo)//ti)) of
  an array laid out ``[halo | interior | halo]``; no wrap reaches them.
  ``halo`` is the input layout's parameter (default 128, the JAX
  probe's), so the same arrays give the same region; the kernel itself
  stages one lane of halo, all the stencil reads, and ``ti`` need not be a
  multiple of 128.  When ``ti`` does not divide the interior, the lanes past
  the last whole tile are not written, as on the TPU.

Nothing outside the written region is touched: an output the wrapper
allocates is NaN there, as the JAX probe's interpret mode leaves it.  CUDA
tensors launch the hand-written kernel (``csrc/probe_2d.cu``) and count one
in :data:`LAUNCHES` (the 2-D form also in :data:`STAGING`, by the path its
slabs took); CPU tensors run the plain versions (:func:`run_1d_plain`,
:func:`run_2d_plain`).  There is no fallback from one to the other.

The kernel instance and launch geometry are pure functions of the shape
(:func:`plan_1d`, :func:`plan_2d`): at K in :data:`UNROLLED_K` the column
lives in registers (the 1-D form takes :data:`LANES_1D` lanes a thread,
one where the pitch or the pointers are not aligned for them), at any
other K in shared memory; the 2-D form stages its slabs by bulk copies
where x and the pitch I*4 are 16-byte aligned, by 4-byte ``cp.async``
elsewhere.

Run on the card:  python -m wrf_tpu_torch.tools.probe_2d [--time]
Run on the CPU:   python -m wrf_tpu_torch.tools.probe_2d --device cpu
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from .. import _build
from ..utils import timing
from ..utils.copy_ceiling import HBM_SPEC_GBPS

#: the JAX probe's lane ring: the default width of the input layout's halo
HALO = 128

#: CUDA kernel launches since import, per form (one per launch, and only
#: there)
LAUNCHES = {"1d": 0, "2d": 0}
#: the 2-D form's launches by the path its slabs took into shared memory
STAGING = {"bulk": 0, "cp.async": 0}

#: the depths whose instances hold the column in registers (the probes' K);
#: every other K takes the run-time-K instance (depth 0)
UNROLLED_K = (50, 16, 8)
#: lanes a thread of the 1-D form at each depth (csrc/probe_2d.cu builds
#: each depth with 1 lane too, for pitches and pointers not aligned to more)
LANES_1D = {50: 1, 16: 1, 8: 4}
THREADS_1D = 128
MAX_THREADS_2D = 256
#: shared memory a block may take, and the 2-D form's two mbarriers
MAX_SMEM = 232448
BARRIER_BYTES = 16

_kernels = None


def written(shape, tj: int, ti: int | None = None,
            halo: int = HALO) -> tuple[slice, slice, slice]:
    """The index region a form writes into a (J, K, I) output:
    :func:`run_1d`'s with ``ti`` None, else :func:`run_2d`'s."""
    J, K, I = shape
    rows = slice(1, 1 + tj * ((J - 2) // tj))
    if ti is None:
        return rows, slice(0, K), slice(0, I)
    ni = I - 2 * halo
    return rows, slice(0, K), slice(halo, halo + ti * (ni // ti))


def compulsory_bytes(shape, tj: int, ti: int | None = None,
                     halo: int = HALO) -> int:
    """Bytes a form must move: its written region written once and the
    lanes it reads (the region, plus one lane each side for the 2-D form)
    read once; the 1-D form reads and writes whole rows."""
    rows, _, lanes = written(shape, tj, ti, halo)
    n_rows = rows.stop - rows.start
    width = lanes.stop - lanes.start
    read = width if ti is None else (width + 2 if width else 0)
    return 4 * n_rows * shape[1] * (read + width)


def instance(K: int) -> int:
    """The compile-time depth of the instance that runs depth ``K`` (0:
    the run-time-K instance)."""
    return K if K in UNROLLED_K else 0


def plan_1d(shape, tj: int, aligned: bool = True) -> dict:
    """The 1-D form's launch at ``shape``: ``kt`` (the instance's depth),
    ``vec`` (lanes a thread), ``threads``, ``grid`` (x, y) and ``smem``
    (dynamic shared bytes).  ``aligned``: x's and out's addresses allow
    loads of ``LANES_1D[kt]`` floats."""
    J, K, I = shape
    kt = instance(K)
    vec = LANES_1D.get(kt, 1)
    if I % vec or not aligned:
        vec = 1
    rows = tj * ((J - 2) // tj)
    return {"kt": kt, "vec": vec, "threads": THREADS_1D,
            "grid": (-(-I // (vec * THREADS_1D)), rows),
            "smem": 0 if kt else 4 * K * THREADS_1D}


def plan_2d(shape, tj: int, ti: int, halo: int = HALO,
            aligned: bool = True) -> dict:
    """The 2-D form's launch at ``shape``: ``kt``, ``path`` ("bulk" where
    the pitch I*4 is a multiple of 16 and x is ``aligned`` to 16 bytes,
    else "cp.async"), ``threads``, ``stages`` (row slabs in flight: two
    where they fit), ``width`` (floats a slab line), ``grid`` (tiles,
    bands) and ``smem``.  Raises ValueError when one slab does not fit."""
    J, K, I = shape
    kt = instance(K)
    threads = min(-(-ti // 32) * 32, MAX_THREADS_2D)
    width = (ti + 8) & ~3
    scratch = 0 if kt else K * threads

    def smem(stages):
        return BARRIER_BYTES + 4 * (stages * K * width + scratch)

    stages = 2 if smem(2) <= MAX_SMEM else 1
    if smem(stages) > MAX_SMEM:
        raise ValueError(f"run_2d: a (K={K}, ti={ti}) slab takes "
                         f"{smem(1)} bytes of shared memory, more than a "
                         f"block's {MAX_SMEM}")
    return {"kt": kt, "path": "bulk" if I % 4 == 0 and aligned
            else "cp.async", "threads": threads, "stages": stages,
            "width": width, "grid": ((I - 2 * halo) // ti, (J - 2) // tj),
            "smem": smem(stages)}


def _body(x: torch.Tensor) -> torch.Tensor:
    """The probe's per-tile compute on (rows, K, lanes), lanes rolled over
    the block's full extent, as the JAX ``_body``."""
    K = x.shape[1]
    xl = torch.roll(x, 1, 2)
    st = (x + xl) + xl * 0.5
    st = st + torch.roll(x, -1, 2)
    kiota = torch.arange(K, device=x.device).view(1, K, 1)
    y = st
    d = 1
    while d < K:
        y = y + torch.where(kiota >= d, torch.roll(y, d % K, 1),
                            torch.zeros((), dtype=y.dtype, device=y.device))
        d *= 2
    return y


def _check(x, out, tj, ti=None, halo=HALO):
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"x: expected a 3-D float32 tensor, got {x.dim()}-D "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if tj < 1 or x.shape[0] < 2:
        raise ValueError(f"tj={tj} and J={x.shape[0]}: need tj >= 1, J >= 2")
    if ti is not None and (ti < 1 or halo < 1 or x.shape[2] < 2 * halo):
        raise ValueError(f"ti={ti}, halo={halo}, I={x.shape[2]}: need ti >= 1,"
                         f" halo >= 1 and I >= 2*halo")
    if out is None:
        return torch.full_like(x, float("nan"))
    if (out.dtype != torch.float32 or out.shape != x.shape
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out: a contiguous float32 tensor of x's shape "
                         f"{tuple(x.shape)} on {x.device}")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not be x: other columns read x's lanes")
    return out


def run_1d_plain(x: torch.Tensor, tj: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`run_1d`, on any device."""
    out = _check(x, out, tj)
    rows, _, _ = written(x.shape, tj)
    out[rows] = _body(x[rows])
    return out


def run_2d_plain(x: torch.Tensor, tj: int, ti: int, halo: int = HALO,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`run_2d`, on any device: the body
    over whole rows (a lane ``halo >= 1`` in from the edge reads no wrapped
    neighbour), kept on the written lanes."""
    out = _check(x, out, tj, ti, halo)
    rows, _, lanes = written(x.shape, tj, ti, halo)
    out[rows, :, lanes] = _body(x[rows])[:, :, lanes]
    return out


def _kernel(name):
    """The C entries of csrc/probe_2d.cu (library built on first use)."""
    global _kernels
    if _kernels is None:
        lib = _build.load()
        k1 = lib.wrf_tpu_torch_probe_2d_1d
        k1.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        k2 = lib.wrf_tpu_torch_probe_2d_2d
        k2.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        k1.restype = k2.restype = ctypes.c_int
        _kernels = {"1d": k1, "2d": k2}
    return _kernels[name]


def _launch(form, x, out, *ints):
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(form)(x.data_ptr(), out.data_ptr(), *x.shape, *ints,
                            stream)
    if err != 0:
        raise RuntimeError(f"probe_2d {form} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[form] += 1
    return out


def _aligned(nbytes, *tensors):
    return all(t.data_ptr() % nbytes == 0 for t in tensors)


def run_1d(x: torch.Tensor, tj: int,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """kernel_1d: every lane of rows 1 .. 1 + tj*((J-2)//tj), one thread
    per column; returns ``out`` (a NaN-filled new tensor when None)."""
    out = _check(x, out, tj)
    if x.device.type == "cpu":
        return run_1d_plain(x, tj, out)
    if x.device.type != "cuda":
        raise ValueError(f"run_1d: unsupported device {x.device}")
    vec = LANES_1D.get(instance(x.shape[1]), 1)
    p = plan_1d(x.shape, tj, _aligned(4 * vec, x, out))
    return _launch("1d", x, out, tj, p["kt"], p["vec"], p["threads"],
                   p["smem"])


def run_2d(x: torch.Tensor, tj: int, ti: int, halo: int = HALO,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """kernel_2d: lanes [halo, halo + ti*((I-2*halo)//ti)) of the same
    rows, one block per (tj, ti) tile, each row's slab (the tile and a lane
    of halo) staged asynchronously in shared memory; returns ``out`` (a
    NaN-filled new tensor when None)."""
    out = _check(x, out, tj, ti, halo)
    if x.device.type == "cpu":
        return run_2d_plain(x, tj, ti, halo, out)
    if x.device.type != "cuda":
        raise ValueError(f"run_2d: unsupported device {x.device}")
    p = plan_2d(x.shape, tj, ti, halo, _aligned(16, x))
    _launch("2d", x, out, tj, ti, halo, p["kt"], p["path"] == "bulk",
            p["threads"], p["stages"], p["smem"])
    STAGING[p["path"]] += 1
    return out


def chain_ms(step, make_bufs, n1: int = 50, n2: int = 250,
             repeats: int = 4) -> tuple[float, float]:
    """Marginal ms per call of ``step(src, dst)`` on the card, between
    chains of ``n1`` and ``n2`` calls that ping-pong two buffers (made once
    by ``make_bufs()``, as the JAX probe's scan carries its array).  Each
    chain is read on two clocks: :func:`timing.per_step_time` on the host
    clock (the chain ends in a synchronise), and CUDA events around the same
    chain (best of the same readings).  Returns ``(host_ms, events_ms)``."""
    bufs = make_bufs()
    best = {}

    def make(n):
        def run():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(n):
                step(bufs[i % 2], bufs[(i + 1) % 2])
            stop.record()
            torch.cuda.synchronize()
            best[n] = min(best.get(n, float("inf")), start.elapsed_time(stop))
        return run

    host = 1e3 * timing.per_step_time(make, n1, n2, repeats)
    return host, (best[n2] - best[n1]) / (n2 - n1)


def device_or_exit(name: str, spec: str) -> torch.device:
    """``--device`` as a torch.device; ``cuda`` without a GPU stops the
    program (nothing carries on on the CPU unless asked)."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: --device cuda, but "
                         "torch.cuda.is_available() is False (no GPU; pass "
                         "--device cpu for the plain PyTorch versions)")
    return device


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.probe_2d",
        description="K7: the 1-D (one thread per column) and 2-D (shared-"
                    "memory tiles) forms of a stencil plus k scan, checked "
                    "bit for bit against each other and optionally timed.")
    ap.add_argument("--shape", type=int, nargs=3, default=[130, 50, 1664],
                    help="J K I (I = 2*halo + interior)")
    ap.add_argument("--tj", type=int, default=4)
    ap.add_argument("--ti", type=int, default=512)
    ap.add_argument("--halo", type=int, default=HALO,
                    help="lanes of halo on each side of the interior")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = device_or_exit("probe_2d", args.device)
    J, K, I = shape = tuple(args.shape)
    print(f"device={device} ({device_name(device)})")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    a = run_1d(x, args.tj)
    b = run_2d(x, args.tj, args.ti, args.halo)
    rows, _, lanes = written(shape, args.tj, args.ti, args.halo)
    ni = I - 2 * args.halo
    covered = lanes.stop - lanes.start
    if covered < ni:
        print(f"2-D form covers {covered} of {ni} interior lanes (ti "
              f"{args.ti} does not divide them); comparing those")
    # the lanes both forms wrote, less the first and last (as the JAX probe)
    ca = a[rows, :, lanes][:, :, 1:-1]
    cb = b[rows, :, lanes][:, :, 1:-1]
    ok = torch.equal(ca, cb)
    print(f"2-D vs 1-D bit-equal (interior lanes): {ok}")
    if not ok:
        d = (ca - cb).abs()
        print("maxabs", float(d.max()), "ndiff", int((d > 0).sum()), "of",
              d.numel())
        return 1

    if args.time:
        if device.type != "cuda":
            print("--time: not timed on the CPU (a CPU time is not a device "
                  "metric)")
            return 0
        forms = (("1d", None, lambda s, d: run_1d(s, args.tj, out=d)),
                 ("2d", args.ti, lambda s, d: run_2d(s, args.tj, args.ti,
                                                     args.halo, out=d)))
        for name, ti, step in forms:
            host, ms = chain_ms(step, lambda: (x.clone(), x.clone()))
            bound = (compulsory_bytes(shape, args.tj, ti, args.halo)
                     / (HBM_SPEC_GBPS * 1e9) * 1e3)
            gbs = 2 * J * K * I * 4 / (ms * 1e-3) / 1e9
            print(f"{name}: {ms:.4f} ms/call (host clock {host:.4f})  "
                  f"{gbs:.0f} GB/s  ({100 * bound / ms:.1f} % of the "
                  f"{bound:.4f} ms bound) ({device_name(device)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
