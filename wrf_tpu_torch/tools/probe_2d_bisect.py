"""K8: the feature ladder from K7's stencil to K3's tile shape.

Port of ``tools/probe_2d_bisect.py``, whose nine rungs bisected which lane-
tiling feature crashed the TPU compiler.  On this card each rung is one
hand-written launch (``csrc/probe_2d_bisect.cu``), so a timed ladder gives
the cost of each feature of the production kernel.  Every rung computes
``_compute`` on a float32 (J, K, I) array, ``y = x + x[i-1]*0.5`` then
``y + y[(k-1) mod K]*0.25``, over rows 1 .. 1 + tj*((J-2)//tj); the lane
roll wraps at the edge of the rung's block, and that is part of the output:

  a  all lanes, one thread per column (a flat grid); wrap at the array edge
  b  the same values, one block per tj-row band on a (bands, 1) grid
  c  exact ti windows at RING + gi*ti: the roll wraps INSIDE each window
  d  the wide window: centre ti lanes of each tile, no wrap reaches them,
     so d equals a on d's region
  e  d * s + x (s a 1-element operand, SMEM on the TPU) and a second
     output 2*x; returns the first (``out1=`` receives the second)
  f  d * thin + vec, thin a (J, 1, I) and vec a (1, K) tensor of ones,
     real operands the kernel loads
  h  d, then a SEQUENTIAL prefix sum over k in a shared-memory scratch
  i  d, plus ``t + 1`` written in place into the aliased operand ``t``
     over d's region (a clone of x unless given: JAX calls ``(x, x)``
     without donation, so its alias is a copy); returns the first output
  j  h with the k loops unrolled at compile time (K in
     :data:`UNROLLED_K` on the card); bit-equal to h

Rungs c .. j write lanes [RING, RING + ti*((I-2*RING)//ti)).  Nothing
outside a rung's region is touched: an output the wrapper allocates is NaN
there, as the JAX probe's interpret mode leaves it.  CUDA tensors launch
the kernel and count one in :data:`LAUNCHES`; CPU tensors run the plain
versions (``rung_*_plain``).  There is no fallback from one to the other.
The instance (:func:`instance`: only j unrolls its k loops, at K in
:data:`UNROLLED_K`) and the launch geometry (:func:`plan`) are pure
functions of the rung and the shape.

Run on the card:  python -m wrf_tpu_torch.tools.probe_2d_bisect <rung>
Run on the CPU:   python -m wrf_tpu_torch.tools.probe_2d_bisect d --device cpu
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import sys

import numpy as np
import torch

from .. import _build
from ..utils.copy_ceiling import HBM_SPEC_GBPS
from .probe_2d import chain_ms, device_name, device_or_exit

RING = 128
RUNGS = "abcdefhij"
#: the depths rung j's unrolled kernel is built for (the probes' K)
UNROLLED_K = (16, 50)

#: CUDA kernel launches since import, per rung (one per launch, and only
#: there)
LAUNCHES = dict.fromkeys(RUNGS, 0)

THREADS_FLAT = 256       # rung a
THREADS_BAND = 1024      # rung b
MAX_THREADS_TILE = 512   # rungs c .. j

_kernel_fn = None


def written_region(rung: str, shape, tj: int,
                   ti: int) -> tuple[slice, slice, slice]:
    """The index region rung ``rung`` writes into a (J, K, I) output (and,
    for i, into its aliased operand)."""
    if rung not in RUNGS:
        raise ValueError(f"bad rung {rung!r}; one of {RUNGS}")
    J, K, I = shape
    rows = slice(1, 1 + tj * ((J - 2) // tj))
    if rung in "ab":
        return rows, slice(0, K), slice(0, I)
    return rows, slice(0, K), slice(RING, RING + ti * ((I - 2 * RING) // ti))


def instance(rung: str, K: int) -> int:
    """The compile-time depth of the kernel that runs rung ``rung`` at
    depth ``K``: K for rung j (which runs only at :data:`UNROLLED_K`), 0
    (a run-time k loop) for every other rung."""
    if rung != "j":
        return 0
    if K not in UNROLLED_K:
        raise ValueError(f"rung_j: the unrolled kernel is built for K in "
                         f"{UNROLLED_K}, got K={K}")
    return K


def plan(rung: str, shape, tj: int, ti: int) -> dict:
    """Rung ``rung``'s launch at ``shape``: ``kt`` (:func:`instance`),
    ``threads`` (x, y), ``grid`` and ``smem`` (dynamic shared bytes).  a: a
    flat grid of 256-thread blocks; b: one 1024-thread block per band;
    c .. j: one block per (band, tile), ti lanes (rounded up to a warp, at
    most 512) by as many of the tile's tj rows as fit in 512 threads; h and
    j a K x rows x ti scratch."""
    J, K, I = shape
    bands = (J - 2) // tj
    kt = instance(rung, K)
    if rung == "a":
        return {"kt": kt, "threads": (THREADS_FLAT, 1),
                "grid": (-(-bands * tj * I // THREADS_FLAT),), "smem": 0}
    if rung == "b":
        return {"kt": kt, "threads": (THREADS_BAND, 1), "grid": (bands,),
                "smem": 0}
    tx = min(-(-ti // 32) * 32, MAX_THREADS_TILE)
    ty = max(1, min(tj, MAX_THREADS_TILE // tx))
    return {"kt": kt, "threads": (tx, ty),
            "grid": (bands, (I - 2 * RING) // ti),
            "smem": 4 * K * ty * ti if rung in "hj" else 0}


def compulsory_bytes(rung: str, shape, tj: int, ti: int) -> int:
    """Bytes rung ``rung`` must move: each distinct input read once over
    the lanes its outputs need (the written lanes, and one lane to their
    left where the roll reaches past a window), each output written once
    (e's two outputs, i's ``t`` read and written)."""
    rows, _, lanes = written_region(rung, shape, tj, ti)
    n_rows, K = rows.stop - rows.start, shape[1]
    w = lanes.stop - lanes.start
    cells = n_rows * K * w
    if not cells:
        return 0
    total = n_rows * K * (w if rung in "abc" else w + 1) + cells   # x, out
    if rung == "e":
        total += cells + 1              # out1, s
    elif rung == "f":
        total += n_rows * w + K         # thin, vec
    elif rung == "i":
        total += 2 * cells              # t read and written
    return 4 * total


def _compute(x: torch.Tensor) -> torch.Tensor:
    """The rungs' compute on (rows, K, lanes), lanes rolled over the
    block's extent, as the JAX ``_compute``."""
    K = x.shape[1]
    y = x + torch.roll(x, 1, 2) * 0.5
    return y + torch.roll(y, 1 % K, 1) * 0.25


def _check(rung, x, tj, ti, out):
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"x: expected a 3-D float32 tensor, got {x.dim()}-D "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if tj < 1 or x.shape[0] < 2 or ti < 1:
        raise ValueError(f"tj={tj}, ti={ti}, J={x.shape[0]}: need tj >= 1, "
                         "ti >= 1 and J >= 2")
    if rung not in "ab" and x.shape[2] < 2 * RING:
        raise ValueError(f"rung_{rung}: I={x.shape[2]} leaves no lanes "
                         f"inside the {RING}-lane rings")
    return _operand("out", out, x, tuple(x.shape))


def _operand(name, a, x, shape):
    """``a`` checked as a contiguous float32 tensor of ``shape`` on x's
    device, distinct from x; a NaN-filled new one when None."""
    if a is None:
        return torch.full(shape, float("nan"), dtype=torch.float32,
                          device=x.device)
    if (a.dtype != torch.float32 or tuple(a.shape) != shape
            or a.device != x.device or not a.is_contiguous()):
        raise ValueError(f"{name}: a contiguous float32 tensor of shape "
                         f"{shape} on {x.device}")
    if a.data_ptr() == x.data_ptr():
        raise ValueError(f"{name} must not be x: other blocks read x's "
                         "windows")
    return a


def operands(rung: str, x: torch.Tensor, **given) -> dict:
    """The operands beside ``x`` that rung ``rung`` takes: those ``given``
    (checked), the rest made as the JAX rung makes them: e's second output
    (NaN) and scalar ``s`` (1.0), f's ``thin`` and ``vec`` (ones), i's
    aliased ``t`` (a clone of x).  A chain of calls makes them once and
    passes them, so that no call allocates or fills."""
    J, K, I = x.shape
    ones = functools.partial(torch.ones, dtype=torch.float32, device=x.device)
    made = {"e": {"out1": (tuple(x.shape), None), "s": ((1, 1), ones)},
            "f": {"thin": ((J, 1, I), ones), "vec": ((1, K), ones)},
            "i": {"t": (tuple(x.shape), lambda _: x.clone())}}.get(rung, {})
    if set(given) - set(made):
        raise TypeError(f"rung_{rung}: unexpected operands "
                        f"{sorted(set(given) - set(made))}")
    out = {}
    for name, (shape, make) in made.items():
        a = given.get(name)
        out[name] = (make(shape) if a is None and make is not None
                     else _operand(name, a, x, shape))
    return out


def _centre(rung, x, tj, ti):
    """(region, c): the rung's written region and ``_compute`` on it, taken
    over each block's lane extent."""
    region = written_region(rung, x.shape, tj, ti)
    rows, _, lanes = region
    xr = x[rows]
    if rung in "ab":
        return region, _compute(xr)
    if rung == "c":   # the roll wraps inside each ti window
        w = xr[:, :, lanes]
        R, K, W = w.shape
        c = _compute(w.reshape(R, K, W // ti, ti).permute(0, 2, 1, 3)
                     .reshape(R * (W // ti), K, ti))
        return region, (c.reshape(R, W // ti, K, ti).permute(0, 2, 1, 3)
                        .reshape(R, K, W))
    # the wide window: a centre lane >= 1 lane in reads no wrapped neighbour
    return region, _compute(xr)[:, :, lanes]


def _plain(rung, x, tj, ti, out, **given):
    """The plain PyTorch version of rung ``rung``, on any device."""
    out = _check(rung, x, tj, ti, out)
    ops = operands(rung, x, **given)
    region, c = _centre(rung, x, tj, ti)
    if rung in "hj":   # the sequential k scan: j's unrolled loop is h's
        for k in range(1, c.shape[1]):
            c[:, k] = c[:, k - 1] + c[:, k]
    elif rung == "e":
        xc = x[region]
        c = c * ops["s"][0, 0] + xc
        ops["out1"][region] = xc * 2.0
    elif rung == "f":
        rows, _, lanes = region
        c = c * ops["thin"][rows, :, lanes] + ops["vec"].reshape(1, -1, 1)
    elif rung == "i":
        ops["t"][region] = ops["t"][region] + 1.0
    out[region] = c
    return out


def _kernel():
    """The C entry of csrc/probe_2d_bisect.cu (library built on first use)."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = _build.load().wrf_tpu_torch_probe_2d_bisect
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def _run(rung, x, tj, ti, out, **given):
    """Rung ``rung`` by x's device: the plain version on the CPU, the kernel
    on a CUDA device; returns the first output."""
    if x.device.type == "cpu":
        return _plain(rung, x, tj, ti, out, **given)
    if x.device.type != "cuda":
        raise ValueError(f"rung_{rung}: unsupported device {x.device}")
    out = _check(rung, x, tj, ti, out)
    ops = operands(rung, x, **given)
    p = plan(rung, x.shape, tj, ti)
    if rung == "e":
        ops["xc"] = x     # JAX passes x twice: the wide and the centre window
    ptr = {name: a.data_ptr() for name, a in ops.items()}.get
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(ord(rung), x.data_ptr(), out.data_ptr(), ptr("out1"),
                        ptr("s"), ptr("xc"), ptr("thin"), ptr("vec"),
                        ptr("t"), *x.shape, tj, ti, *p["threads"],
                        p["smem"], stream)
    if err != 0:
        raise RuntimeError(f"probe_2d_bisect rung {rung} kernel launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[rung] += 1
    return out


def rung_a(x, tj, ti, out=None):
    return _run("a", x, tj, ti, out)


def rung_b(x, tj, ti, out=None):
    return _run("b", x, tj, ti, out)


def rung_c(x, tj, ti, out=None):
    return _run("c", x, tj, ti, out)


def rung_d(x, tj, ti, out=None):
    return _run("d", x, tj, ti, out)


def rung_e(x, tj, ti, out=None, out1=None, s=None):
    return _run("e", x, tj, ti, out, out1=out1, s=s)


def rung_f(x, tj, ti, out=None, thin=None, vec=None):
    return _run("f", x, tj, ti, out, thin=thin, vec=vec)


def rung_h(x, tj, ti, out=None):
    return _run("h", x, tj, ti, out)


def rung_i(x, tj, ti, out=None, t=None):
    return _run("i", x, tj, ti, out, t=t)


def rung_j(x, tj, ti, out=None):
    return _run("j", x, tj, ti, out)


def rung_a_plain(x, tj, ti, out=None):
    return _plain("a", x, tj, ti, out)


def rung_b_plain(x, tj, ti, out=None):
    return _plain("b", x, tj, ti, out)


def rung_c_plain(x, tj, ti, out=None):
    return _plain("c", x, tj, ti, out)


def rung_d_plain(x, tj, ti, out=None):
    return _plain("d", x, tj, ti, out)


def rung_e_plain(x, tj, ti, out=None, out1=None, s=None):
    return _plain("e", x, tj, ti, out, out1=out1, s=s)


def rung_f_plain(x, tj, ti, out=None, thin=None, vec=None):
    return _plain("f", x, tj, ti, out, thin=thin, vec=vec)


def rung_h_plain(x, tj, ti, out=None):
    return _plain("h", x, tj, ti, out)


def rung_i_plain(x, tj, ti, out=None, t=None):
    return _plain("i", x, tj, ti, out, t=t)


def rung_j_plain(x, tj, ti, out=None):
    return _plain("j", x, tj, ti, out)


FUNCS = {r: globals()[f"rung_{r}"] for r in RUNGS}
PLAIN = {r: globals()[f"rung_{r}_plain"] for r in RUNGS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m wrf_tpu_torch.tools.probe_2d_bisect",
        description="K8: run one rung of the feature ladder, check its "
                    "written region is finite, optionally time it.")
    ap.add_argument("rung", choices=list(RUNGS))
    ap.add_argument("--shape", type=int, nargs=3, default=[26, 16, 512])
    ap.add_argument("--ti", type=int, default=128)
    ap.add_argument("--tj", type=int, default=4)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = device_or_exit("probe_2d_bisect", args.device)
    shape = tuple(args.shape)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)
    fn = FUNCS[args.rung]
    y = fn(x, args.tj, args.ti)
    region = written_region(args.rung, shape, args.tj, args.ti)
    ok = bool(torch.isfinite(y[region]).all())
    print(f"rung {args.rung}: compiled+ran, finite={ok}", flush=True)
    if args.time:
        if device.type != "cuda":
            print("--time: not timed on the CPU (a CPU time is not a device "
                  "metric)")
        else:
            kw = operands(args.rung, x)
            host, ms = chain_ms(
                lambda s, d: fn(s, args.tj, args.ti, out=d, **kw),
                lambda: (x.clone(), x.clone()))
            nbytes = compulsory_bytes(args.rung, shape, args.tj, args.ti)
            bound = nbytes / (HBM_SPEC_GBPS * 1e9) * 1e3
            print(f"rung {args.rung}: {ms:.4f} ms/call (host clock "
                  f"{host:.4f})  {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s  "
                  f"({100 * bound / ms:.1f} % of the {bound:.4f} ms bound) "
                  f"({device_name(device)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
